"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those whose loss
was not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown`` of the profiled cycle, and last ``checks``: each number
compared with the reference beside its limit, which also close standard
error.  Without the CUDA devices the cell asks for it prints no result
and exits 3.
"""
import time

START = time.time()

import argparse      # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every cache a run writes stays at a fixed path inside the checkout
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda-cache")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton-cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch-extensions")

TOP = 10


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from portbench.harness import cell, compare, spec
    cell.log(START, "imported")
    try:
        run, checks, attempted, failed = cell.run(
            args.workload, args.seed, args.seconds, bool(args.trace),
            start=START)
    except cell.NoDevice as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    loaded = cell.forbidden(sys.modules)
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    bench = spec.benchmark()
    metrics = {}
    for m in spec.cell_metrics(bench, args.workload, bool(args.trace)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec.cell_entry(bench, args.workload)["chips"],
              "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": compare.correct(checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in run.trace.by_class()[:TOP]],
            "idle_gaps": [[k, v] for k, v in run.trace.idle_gaps()[:TOP]]}
    result["card"] = {"power_limit": power_limit()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
