"""One run of one cell: set-up, the measured window, the traced cycle,
and the comparison with the reference that decides ``correct``.

Set-up, in order: TF32 off; the codec's kernel library built (the
program's ``kernels/build.py`` cache under ``build/`` in the checkout);
the weights and tokens made from the seed; ONE train step object
(``launch.steps.build_train_step``) driven through a prologue of three
steps that visits every branch of the cell's cycle (local, fresh, and
cached where the cycle has a cached step), which is the warm-up.

The window then runs whole cycles of the cell's xi cycle through the
same step object, keys from ``core.rollout.window_streams`` at the
global step counter, and closes at the first cycle boundary at or after
``seconds``.  Once it has closed, the program's side is read: each
window step's loss, every leaf's change since the start, and the cached
target (to the host).  A traced run also times each step (a
synchronize around it) and profiles one more cycle after that.

The reference then follows the whole run, prologue and window, from the
same weights, tokens, xi and keys: each step's loss, the first step's
gradient as the update applied it, every leaf's change after the
prologue and after the window, and the cached target.  Its model is the
one the configuration file names (``spec.reference``): the leaves, the
loss, the weights' scales, and the config fields the program is held to.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from portbench.harness import compare, inputs, spec, trace
from portbench.reference import codecs as ref_codecs
from portbench.reference import draws as ref_draws
from portbench.reference import l2gd as ref_l2gd

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROLOGUE = 3
BRANCHES = ("local", "fresh", "cached")


def forbidden(modules) -> list:
    """The JAX packages among the top-level names of ``modules`` (whole
    names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    shapes: dict
    setup_s: float
    window_s: float
    branches: list                  # window steps' branches, in order
    step_seconds: list              # traced runs: (branch, host seconds)
    peak_bytes: int
    trace: object = None            # traced runs: trace.Trace of one cycle
    trace_fresh_rounds: int = 0     # fresh steps in the profiled cycle

    def steps_of(self, branch: int) -> int:
        return self.branches.count(branch)


def program_config(cfg: dict, shrink: dict = None, references=None):
    """The program's config of a configuration file, held to the file on
    each of its plain model's ``MODEL_KEYS``, with the ``shrink``
    overrides of those keys applied."""
    from repro_torch.configs import get_config
    keys = spec.reference(cfg, references).MODEL_KEYS
    prog = get_config(cfg["arch"])
    for k in keys:
        if k in cfg and getattr(prog, k) != cfg[k]:
            raise ValueError(f"{cfg['arch']}: {k} {getattr(prog, k)!r} != "
                             f"{cfg[k]!r}")
    return dataclasses.replace(prog, **{k: v for k, v in (shrink or {}).items()
                                        if k in keys})


def prologue_xis(cycle: list) -> list:
    """Local, fresh, then cached if the cycle has one (two ones in a
    row, around its end too), else local."""
    ring = cycle + cycle[:1]
    cached = any(a == b == 1 for a, b in zip(ring, ring[1:]))
    return [0, 1, 1 if cached else 0]


def log(start: float, msg: str) -> None:
    print(f"portbench {time.time() - start:8.2f} s  {msg}", file=sys.stderr,
          flush=True)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA device(s)")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


class CellRun:
    """A cell's program and inputs for one seed on one device.  ``shrink``
    overrides configuration sizes, ``cell`` the cell's file, and
    ``configs`` and ``references`` the directories of the configuration
    files and plain models (the CPU tests')."""

    def __init__(self, name: str, seed: int, device, *, shrink=None,
                 cell=None, configs=None, references=None,
                 say=lambda msg: None):
        self.cell = cell or spec.workload(name)
        base = spec.config(self.cell["config"], configs)
        self.ref = spec.reference(base, references)
        self.std = inputs.weight_rule(self.ref)
        self.cfg = {**base, **(shrink or {})}
        self.seed, self.device = int(seed), torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all([self.cell["codec"]["name"]])
            say("kernels built")
        self.prog_cfg = program_config(base, shrink, references)
        self.shapes = self.ref.param_shapes(self.cfg)
        # the plans' shapes; a leaf the program's model does not take, or
        # lacks, fails its first step ("a parameter leaf got no gradient")
        self.meta = inputs.nested({k: torch.empty(s, device="meta")
                                   for k, s in self.shapes.items()})
        self.n = self.cfg["clients"]
        self.cycle = list(self.cell["xi_cycle"])
        self.pro_xis = prologue_xis(self.cycle)
        self.key = ref_draws.key_of(seed)
        self.xis = []                   # the xi of every step driven
        self.batches = [torch.from_numpy(b).to(self.device)
                        for b in inputs.token_batches(
                            seed, range(PROLOGUE + len(self.cycle)), self.n,
                            self.cfg["batch_per_client"], self.cfg["seq_len"],
                            self.cfg["vocab_size"], self.cell["token_noise"])]

    def batch_of(self, k: int) -> dict:
        if k >= PROLOGUE:
            k = PROLOGUE + (k - PROLOGUE) % len(self.cycle)
        return {"tokens": self.batches[k]}

    # -- the program -------------------------------------------------------
    def build(self) -> None:
        from repro_torch.core import (L2GDHyper, init_state, make_compressor,
                                      make_plan)
        from repro_torch.launch.steps import build_train_step
        codec = self.cell["codec"]
        comp = make_compressor(codec["name"], **{k: v for k, v in codec.items()
                                                 if k != "name"})
        self.plan = make_plan(comp, self.meta,
                              transport=self.cell["transport"])
        self.hp = L2GDHyper(eta=self.cell["eta"], lam=self.cell["lam"],
                            p=self.cell["p"], n=self.n)
        self.step = build_train_step(self.prog_cfg, self.hp,
                                     plans=(self.plan, self.plan))
        x0 = inputs.stacked_weights(self.shapes, self.seed, self.n,
                                    self.device, self.std)
        self.state = init_state(inputs.nested(x0))
        self.k = 0

    def drive(self, xis, span=None, sync=False) -> list:
        """Steps with the host draws ``xis`` from the global step counter
        on: [(branch the step reports, loss tensor, host seconds or
        None)].  ``span(branch)`` wraps each step and its synchronize."""
        from repro_torch.core.rollout import window_streams
        xis, keys = window_streams(self.key, self.hp.p, self.k, len(xis),
                                   xi_trace=list(xis))
        out = []
        for xi, key in zip(xis, keys):
            branch = 0 if xi == 0 else (1 if self.state.xi_prev == 0 else 2)
            t0 = time.perf_counter()
            with span(BRANCHES[branch]) if span else contextlib.nullcontext():
                self.state, metrics = self.step(self.state,
                                                self.batch_of(self.k),
                                                int(xi), key)
                if sync:
                    torch.cuda.synchronize(self.device)
            out.append((int(metrics["branch"]), metrics["loss"],
                        time.perf_counter() - t0 if sync else None))
            self.xis.append(int(xi))
            self.k += 1
        return out

    def window(self, seconds: float, sync: bool = False) -> tuple:
        """Whole cycles until ``seconds`` have passed at a cycle's end:
        (steps as ``drive`` gives them, seconds)."""
        on_card = self.device.type == "cuda"
        steps = []
        if on_card:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        while True:
            steps += self.drive(self.cycle, sync=sync and on_card)
            if on_card:
                torch.cuda.synchronize(self.device)
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                return steps, window_s

    def change_norms(self) -> np.ndarray:
        """(n, leaves) norms of each leaf's change since the start."""
        now = inputs.dotted(self.state.params)
        out = np.zeros((self.n, len(self.shapes)))
        for i in range(self.n):
            one = inputs.client_weights(self.shapes, self.seed, i,
                                        self.device, self.std)
            for j, leaf in enumerate(self.shapes):
                out[i, j] = float(torch.linalg.vector_norm(
                    (now[leaf][i] - one[leaf]).reshape(-1),
                    dtype=torch.float64))
            del one
        return out

    def window_end(self, steps: list) -> dict:
        """The program's side of the window, read once it has closed:
        each step's loss, each leaf's change since the start, and the
        cached target, copied to the host."""
        self.compared = self.k
        return {"window_losses": [float(loss) for _, loss, _ in steps],
                "window_change_norms": self.change_norms(),
                "cache": {k: v.to("cpu") for k, v in
                          inputs.dotted(self.state.cache).items()}}

    def prologue(self) -> dict:
        """The prologue's steps; the program's side of the comparison."""
        before = inputs.dotted(self.state.params)
        losses = [float(self.drive(self.pro_xis[:1])[0][1])]
        grad = ref_l2gd.pair_norms(before, inputs.dotted(self.state.params),
                                   float(self.hp.local_scale))
        del before
        losses += [float(loss) for _, loss, _ in
                   self.drive(self.pro_xis[1:])]
        return {"losses": losses, "grad_norms": grad,
                "change_norms": self.change_norms()}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.step = None
        free(self.device)

    # -- the reference -----------------------------------------------------
    def reference(self, fault: str = None, matmul: str = None) -> dict:
        """The reference's run of the prologue and the window from freshly
        made weights; ``matmul`` "tf32" (the card's TF32) or
        "tf32_emulated" makes it the control, ``fault`` plants one (see
        ``l2gd.follow``)."""
        cfg = self.cfg if matmul != "tf32_emulated" else \
            {**self.cfg, "matmul": matmul}
        torch.backends.cuda.matmul.allow_tf32 = matmul == "tf32"
        try:
            x0 = inputs.stacked_weights(self.shapes, self.seed, self.n,
                                        self.device, self.std)
            steps = self.compared
            out = ref_l2gd.follow(self.ref.loss, cfg, self.cell, x0,
                                  [self.batch_of(k)["tokens"]
                                   for k in range(steps)],
                                  self.xis[:steps],
                                  ref_draws.step_keys(self.key, 0, steps),
                                  PROLOGUE, fault=fault)
            del x0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        free(self.device)
        return out

    def round_bits(self) -> int:
        """Bits of one fresh round a client: its message up and the
        master's down."""
        return 2 * ref_codecs.round_bits(self.cell["codec"],
                                         self.cell["transport"],
                                         list(self.shapes.values()))


def run(name: str, seed: int, seconds: float, traced: bool, *, start: float,
        device=None, shrink: dict = None, cell: dict = None, configs=None,
        references=None):
    """One run of cell ``name``: (Run, checks, attempted, failed).
    ``device`` None means the card (raises NoDevice without one); the
    rest as ``CellRun`` takes them."""
    if device is None:
        device = card(spec.cell_entry(spec.benchmark(), name)["chips"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    log(start, f"{device} ready")
    from repro_torch.fl.ledger import BitsLedger
    c = CellRun(name, seed, device, shrink=shrink, cell=cell,
                configs=configs, references=references,
                say=lambda msg: log(start, msg))
    log(start, "tokens made")
    c.build()
    log(start, "weights made, step built")
    program = c.prologue()
    free(c.device)
    log(start, f"prologue {c.pro_xis}: losses {program['losses']}")

    if on_card:
        torch.cuda.synchronize(c.device)
    setup_s = time.time() - start
    steps, window_s = c.window(seconds, sync=traced)
    peak = torch.cuda.max_memory_allocated(c.device) if on_card else 0
    log(start, f"window {window_s:.3f} s, {len(steps)} steps, peak {peak}")
    program.update(c.window_end(steps))
    log(start, "window read")
    tr = trace.profile(lambda span: c.drive(c.cycle, span=span, sync=True)) \
        if traced and on_card else None
    if tr is not None:
        log(start, f"profiled cycle {tr.window_s:.3f} s, {len(tr.ops)} "
            "device operations")
    ledger, bits = BitsLedger(c.n), c.plan.round_bits()
    for branch, _, _ in steps:
        if branch == 1:
            ledger.record_round(bits, bits)
    failed = sum(not np.isfinite(loss) for loss in program["window_losses"])
    c.release()

    reference = c.reference()
    log(start, f"reference: losses {reference['losses']}")
    checks = compare.checks(program, reference, ledger.bits_per_client,
                            reference["rounds"] * c.round_bits(),
                            c.cell["limits"])
    del reference
    free(c.device)
    result = Run(cell=c.cell, config=c.cfg, shapes=c.shapes, setup_s=setup_s,
                 window_s=window_s, branches=[b for b, _, _ in steps],
                 step_seconds=[(b, s) for b, _, s in steps if s is not None],
                 peak_bytes=peak, trace=tr,
                 trace_fresh_rounds=0 if tr is None else sum(
                     1 for branch, _, _ in tr.spans if branch == "fresh"))
    return result, checks, len(steps), failed
