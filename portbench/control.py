"""The readings that set a cell's limits of ``correct``.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \
        [--controls 3] [--faults 3] [--seconds S] [--out FILE]

For each seed: the program's prologue and window, as a run of the cell
drives them (``--seconds``, by default the benchmark's ``run_seconds``),
against the reference's (the lower readings); for the first
``--controls`` seeds also the control, the reference computed with TF32
products put in the program's place; for the first ``--faults`` seeds
the planted faults in the reference in the program's place: the loss
over half the positions ("half_batch"), the fresh round's mean left out
("no_exchange"), every fresh round drawing with the first one's key
("stale_key") and a window whose steps update nothing
("frozen_window").  A state left unchanged from the start reads 1 by
construction and needs no run.  One JSON line a reading, to standard
output and ``--out``.  The benchmark's runs do not run this.
"""
import time

START = time.time()

import argparse      # noqa: E402
import json          # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FAULTS = ("half_batch", "no_exchange", "stale_key", "frozen_window")


def readings(name: str, seed: int, device, controls: bool, faults: bool,
             seconds: float, shrink=None, cell=None, matmul: str = "tf32",
             leaves: bool = False):
    """The readings of one seed: [(kind, gaps)]; ``leaves`` adds each
    step's loss gap and each (client, leaf)'s gradient and change gaps."""
    from portbench.harness import cell as cell_run
    from portbench.harness import compare
    c = cell_run.CellRun(name, seed, device, shrink=shrink, cell=cell)
    c.build()
    program = c.prologue()
    steps, _ = c.window(seconds)
    program.update(c.window_end(steps))
    c.release()
    reference = c.reference()

    def gaps(got):
        out = compare.gaps(got, reference)
        if leaves:
            g = reference["grad_norms"]
            out["losses"] = (np.abs(np.subtract(
                got["losses"] + got["window_losses"], reference["losses"]))
                / np.abs(reference["losses"])).tolist()
            out["grad_leaves"] = compare.leaf_gaps(got["grad_norms"],
                                                   g).tolist()
            out["change_leaves"] = compare.leaf_gaps(
                got["change_norms"], reference["change_norms"],
                g >= compare.STILL * np.median(g)).tolist()
        return out

    out = [("program", gaps(program))]
    del program
    if controls:
        out.append(("control", gaps(compare.as_program(
            c.reference(matmul=matmul), cell_run.PROLOGUE))))
    for fault in FAULTS if faults else ():
        out.append((fault, gaps(compare.as_program(
            c.reference(fault=fault), cell_run.PROLOGUE))))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--seconds", type=float)
    parser.add_argument("--out")
    parser.add_argument("--leaves", action="store_true",
                        help="add each step's and each leaf's gaps")
    args = parser.parse_args(argv)
    from portbench.harness import cell as cell_run
    from portbench.harness import spec
    bench = spec.benchmark()
    device = cell_run.card(spec.cell_entry(bench, args.workload)["chips"])
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.time()
        for kind, gaps in readings(args.workload, seed, device,
                                   i < args.controls, i < args.faults,
                                   seconds, leaves=args.leaves):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind, **gaps,
                               "seconds": time.time() - t0})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
