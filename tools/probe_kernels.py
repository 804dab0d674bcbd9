#!/usr/bin/env python3
"""Probe the port's CUDA kernels on one GPU: what ptxas makes of each
source, the flash kernel's warps and m-tiles at D = 64, the selective
scan's lanes a channel, and the tuning of the scan's backward.

    python3 tools/probe_kernels.py [--flash 4x2 4x1 8x1] [--lanes 4 8 16]
                                   [--bwd-variants kBwdGroups=1 ...]
                                   [--scan-baseline OTHER.cu]
                                   [--train-baseline OTHER_CHECKOUT]

1. Compiles every kernel source with ``-Xptxas -v`` and prints the
   registers, spills and shared memory of the flash kernels, of the
   scan's kernels at N = 16 (the forward, the backward's carry pass and
   chunk kernel) and of the backward's index-order sum; with ``--sass``
   also the instructions cuobjdump finds in the backward's two kernels.
2. Builds ``flash_attention.cu`` once per ``kWarps64`` x ``kMTiles64``
   pair (the source's constants, patched in a copy under
   ``build/probe/``) and, at the stablelm-1.6b
   prefill shape (B = 2, S = T = 4096, H = 32, D = 64, causal f32),
   checks each build against the plain version (2e-5) and times it
   with CUDA events (median of 10 launches, in turns, beside
   scaled_dot_product_attention).
3. Builds ``selective_scan.cu`` once per ``kLanes`` value and, at
   the falcon-mamba-7b and hymba-1.5b prefill shapes (B = 2, L = 4096,
   N = 16, E = 8192 / 1600, f32), checks each build against the plain
   version (16 float32 ulps of max |y|) and times it (median of 25
   launches, in turns).
4. With ``--bwd-variants``, builds ``selective_scan.cu`` once per
   variant (``NAME=V[,NAME=V]``, each a ``constexpr int`` of the source,
   say ``kBwdGroups=4`` or ``kCarrySteps=16``) and, at the hymba-1.5b and
   falcon-mamba-7b train shapes (B = 1, L = 4096, N = 16, E = 1600 /
   8192, f32), checks each backward and this checkout's against the
   plain backward (2e-5 x max |plain| each gradient) and times them in
   turns: the whole backward and its carry pass and chunk kernel alone
   (median of 25 launches each).
5. With ``--scan-baseline``, builds that copy of ``selective_scan.cu``
   (another commit's, say ``git show REV:src/repro_torch/kernels/
   selective_scan/csrc/selective_scan.cu``) and, at both prefill shapes,
   times its forward against this checkout's, without and with the
   state checkpoints, in turns (median of 25 launches each, CUDA events
   around the ctypes call alone); the outputs must agree bit for bit.
   Then, at both train shapes, each build's backward on the checkpoints
   its own forward wrote, in turns (baseline, current, current,
   baseline), with the largest difference between the two on each
   gradient.
6. With ``--train-baseline``, runs ``chip_smoke.py``'s Mamba train phases
   (hymba-1.5b at full depth with leafwise natural, falcon-mamba-7b at 8
   layers with leafwise QSGD; each checkout's own ``MAMBA_TRAIN`` and
   ``phase_train``) from another checkout (say a parent commit unpacked
   with ``git archive`` under ``build/``) and this one in turns (other,
   this; this, other), a fresh process each from the checkout's root, and
   prints their step-time, launch and profile lines tagged with the
   checkout: a change's end-to-end step times on one card in one call.
   ``--train-archs`` picks the archs, ``--train-turns`` the turns.
Needs nvcc and a CUDA device; prints the card's name and power limit.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCAN_ULPS = 16
# the scan backward: chip_smoke.py's bound against the plain backward, and
# the train shapes (B = 1, L = 4096, N = 16) of its width phase
SCAN_BWD_RTOL = 2e-5
SCAN_GRADS = ("ddt", "dB", "dC", "dx", "dA")
TRAIN_SHAPES = (("hymba-1.5b", 1600), ("falcon-mamba-7b", 8192))


def ptxas_report(build):
    """Registers, spills and shared memory of every kernel, per source."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, rel in build.SOURCES.items():
        src = build._KERNELS / rel
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out_dir / f"ptxas-{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print_ptxas(log, name)


def print_ptxas(log, tag):
    """ptxas's registers, spills and shared memory of the flash kernels,
    the N = 16 instantiations of the scan's and the backward's sum, from
    one `-Xptxas -v` build log."""
    func = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = m.group(1)
        elif func and ("flash_fwd" in func or "Li16EE" in func
                       or "sum_middle" in func) and (
                "registers" in line or "spill" in line):
            print(f"ptxas {tag} {func}: "
                  f"{line.split(':', 1)[-1].strip()}", flush=True)


def sass_report(build):
    """The instructions cuobjdump finds in the scan backward's kernels at
    N = 16, this checkout's build: the total and the most common
    opcodes of each."""
    import collections
    path = build.build_all(["selective_scan"])["selective_scan"]
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(r"scan_bwd_(chunk|carry)ILi16E", name):
            continue
        ops = collections.Counter()
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", block):
            ops[m.group(1)] += 1
        print(f"sass {name}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)),
              flush=True)


def variant_libs(build, name, variants):
    """One library a variant of one kernel source: each variant gives
    other values to some of its constants ({name: value}, each a
    `constexpr int` of the source), patched into a copy under
    build/probe/.  One nvcc a variant, all started together."""
    procs = []
    for constants in variants:
        text = (build._KERNELS / build.SOURCES[name]).read_text()
        for const, value in constants.items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise ValueError(f"{name}: no single constant {const}")
        tag = "-".join(f"{k}{v}" for k, v in constants.items())
        src = build.BUILD_DIR / "probe" / f"{name}-{tag}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        out = src.with_suffix(".so")
        procs.append((subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    libs = []
    for proc, out in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {out.stem}:\n{log}")
        print_ptxas(log, out.stem)
        libs.append(ctypes.CDLL(str(out)))
    return libs


def variant(build, name, constants, signature):
    """The entry point of one kernel source built with other values of
    its constants (see variant_libs)."""
    fn = getattr(variant_libs(build, name, [constants])[0], name)
    fn.argtypes = signature
    fn.restype = ctypes.c_int
    return fn


def time_ms(fn, reps=25, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def flash_tiles(build, shapes):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attn_scale
    fns = {sh: variant(build, "flash_attention",
                       {"kWarps64": sh[0], "kMTiles64": sh[1]},
                       fk._SIGNATURE) for sh in shapes}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S, H, D = 2, 4096, 32, 64
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               for _ in range(3))
    plain = fk._plain(q, k, v, True, None)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0,
                 B, S, S, H, H, D, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], 1, 0, attn_scale(D), stream)
        if err:
            raise RuntimeError(f"flash_attention launch: {err}")

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    for sh in shapes:
        run(fns[sh])
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        if err > 2e-5:
            raise AssertionError(f"flash {sh}: max |d| {err:.3g}")
        print(f"flash warps x m-tiles {sh[0]}x{sh[1]}: max |d| {err:.3g} "
              "from the plain version", flush=True)
    times = {sh: [] for sh in shapes}
    sdpa_ms = [time_ms(sdpa, reps=10)]
    for sh in list(shapes) + list(reversed(shapes)):
        times[sh].append(time_ms(lambda: run(fns[sh]), reps=10))
    sdpa_ms.append(time_ms(sdpa, reps=10))
    for sh in shapes:
        print(f"time flash warps x m-tiles {sh[0]}x{sh[1]} (B={B} S=T={S} "
              f"H={H} D={D} causal f32): {min(times[sh]):.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in times[sh])}); SDPA "
              f"{', '.join(f'{t:.3f}' for t in sdpa_ms)} ms", flush=True)
    del q, k, v, plain, out, qt, kt, vt
    torch.cuda.empty_cache()


def scan_lanes(build, lanes_list):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    libs = {k: variant(build, "selective_scan", {"kLanes": k},
                       sk._SIGNATURE) for k in lanes_list}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    for arch, E in (("falcon-mamba-7b", 8192), ("hymba-1.5b", 1600)):
        B, L, N = 2, 4096, 16
        dt = F.softplus(torch.randn((B, L, E), generator=gen,
                                    device=dev)) * 0.2
        Bm, Cm = (torch.randn((B, L, N), generator=gen, device=dev)
                  for _ in range(2))
        x = torch.randn((B, L, E), generator=gen, device=dev)
        A = -torch.randn((E, N), generator=gen, device=dev).abs()
        plain = selective_scan_ref(dt, Bm, Cm, x, A)
        ulp = float(np.spacing(np.float32(float(plain.abs().max()))))
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib):
            err = lib(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                      x.data_ptr(), A.data_ptr(), y.data_ptr(), None, 0, B,
                      L, E, N, stream)
            if err:
                raise RuntimeError(f"selective_scan launch: {err}")

        times = {k: [] for k in lanes_list}
        for k in lanes_list:
            run(libs[k])
            torch.cuda.synchronize()
            d = float((y - plain).abs().max()) / ulp
            if d > SCAN_ULPS:
                raise AssertionError(f"lanes {k} at {arch}: {d:.2f} ulps")
            print(f"scan lanes {k} at {arch}: {d:.2f} ulps of max |y|")
        order = list(lanes_list) + list(reversed(lanes_list))
        for k in order:   # in turns: a, b, c, c, b, a
            times[k].append(time_ms(lambda: run(libs[k])))
        for k in lanes_list:
            print(f"time scan lanes {k} ({arch}: B={B} L={L} E={E} N={N} "
                  f"f32): {min(times[k]):.3f} ms (turns "
                  f"{', '.join(f'{t:.3f}' for t in times[k])})", flush=True)
        del dt, Bm, Cm, x, A, plain, y
        torch.cuda.empty_cache()


def train_inputs(gen, E, B=1, L=4096, N=16):
    """The scan's operands and dL/dy at a train shape, drawn as
    chip_smoke.py draws them."""
    import torch
    import torch.nn.functional as F
    dev = gen.device
    dt = F.softplus(torch.randn((B, L, E), generator=gen, device=dev)) * 0.2
    Bm, Cm = (torch.randn((B, L, N), generator=gen, device=dev)
              for _ in range(2))
    x = torch.randn((B, L, E), generator=gen, device=dev)
    A = -torch.randn((E, N), generator=gen, device=dev).abs()
    g = torch.randn((B, L, E), generator=gen, device=dev)
    return dt, Bm, Cm, x, A, g


class BwdCall:
    """One build's ``selective_scan_bwd`` on its own outputs and scratch,
    at the operands ``ops`` (dt, Bm, Cm, x, A, g) and checkpoints ``h``.
    ``plan`` None takes the interface of the single walk over L without
    a plan (a dB / dC partial a block of 128 threads, dA partials (B, E,
    N)); else this checkout's with ``plan`` = (split, groups).  Its carry
    pass (split only) and chunk kernel run alone as ``run("carry")`` and
    ``run("chunks")``."""

    def __init__(self, lib, ops, h, plan):
        import torch
        from repro_torch.kernels.selective_scan import kernel as sk
        dt, Bm, Cm, x, A, g = ops
        B, L, E = x.shape
        N = Bm.shape[2]
        dev = x.device
        self.ddt, self.dx = torch.empty_like(x), torch.empty_like(x)
        self.dBC = torch.empty((2, B, L, N), device=dev)
        self.dA = torch.empty((E, N), device=dev)
        fn = lib.selective_scan_bwd
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        ins = [t.data_ptr() for t in (dt, Bm, Cm, x, A, h, g)]
        outs = [self.ddt.data_ptr(), self.dx.data_ptr()]
        if plan is None:
            fn.argtypes = sk._BWD_SIGNATURE[:9] + sk._BWD_SIGNATURE[10:18] \
                + sk._BWD_SIGNATURE[20:]
            per = 128 // sk.lane_split(N)[0]
            self.scratch = [torch.empty((2, B, L, -(-E // per), N),
                                        device=dev),
                            torch.empty((B, E, N), device=dev)]
            ptrs = [t.data_ptr() for t in self.scratch]
            self.calls = {"whole": (fn, ins + outs + ptrs + [
                self.dBC.data_ptr(), self.dA.data_ptr(), B, L, E, N,
                stream])}
            return
        split, groups = plan
        fn.argtypes = sk._BWD_SIGNATURE
        self.scratch = sk._bwd_scratch(B, L, E, N, split, groups, dev)
        carry, part, dA_part = (t.data_ptr() if t is not None else None
                                for t in self.scratch)
        self.calls = {"whole": (fn, ins + outs + [
            carry, part, dA_part, self.dBC.data_ptr(), self.dA.data_ptr(),
            B, L, E, N, int(split), groups, stream])}
        fk = lib.selective_scan_bwd_chunks
        fk.argtypes, fk.restype = sk._BWD_CHUNKS_SIGNATURE, ctypes.c_int
        self.calls["chunks"] = (fk, ins[:6] + [carry, ins[6]] + outs + [
            part, dA_part, B, L, E, N, int(split), groups, stream])
        if split:
            fc = lib.selective_scan_bwd_carry
            fc.argtypes, fc.restype = sk._BWD_CARRY_SIGNATURE, ctypes.c_int
            self.calls["carry"] = (fc, [ins[0], ins[2], ins[4], ins[6],
                                        carry, B, L, E, N, stream])

    def run(self, what="whole"):
        fn, args = self.calls[what]
        err = fn(*args)
        if err:
            raise RuntimeError(f"selective_scan_bwd ({what}): cudaError_t "
                               f"{err}")

    def grads(self):
        return self.ddt, self.dBC[0], self.dBC[1], self.dx, self.dA


def bwd_diffs(got, want):
    """max |got - want| and its ratio to max |want|, each gradient."""
    out = []
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        out.append((err, err / max(float(b.abs().max()), 1e-30)))
    return out


def clocks_during(fn, seconds=1.0):
    """The SM clock and power nvidia-smi reads while ``fn`` runs back to
    back for about ``seconds``: 'MHz W' samples."""
    import threading
    import torch
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip()
            samples.append(out.replace(",", " MHz") + " W")
            done.wait(0.2)

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, int(seconds * 1e3 / max(start.elapsed_time(end), 1e-3)))
    thread = threading.Thread(target=sample)
    thread.start()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    done.set()
    thread.join()
    return samples


def scan_bwd_variants(build, specs):
    """This checkout's backward and each variant's, with L split (the
    build's kBwdGroups) and walked whole (the plan's groups, or 1), at
    both train shapes: checked against the plain backward, timed whole
    and by kernel, in turns."""
    import torch
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    variants = [dict((kv.split("=")[0], int(kv.split("=")[1]))
                     for kv in spec.split(",")) for spec in specs]
    libs = {"current": build.library("selective_scan")}
    libs.update(zip(specs, variant_libs(build, "selective_scan", variants)))
    consts = {"current": {}}
    consts.update(zip(specs, variants))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    for arch, E in TRAIN_SHAPES:
        ops = train_inputs(gen, E)
        dt, Bm, Cm, x, A, g = ops
        B, N = x.shape[0], Bm.shape[2]
        plan = sk.bwd_plan(B, E, N, sk.bwd_slots(dev, N))
        _, h = sk._launch(dt, Bm, Cm, x, A, ckpt=True)
        want = selective_scan_bwd_ref(dt, Bm, Cm, x, A, h, g,
                                      sk.ckpt_chunk(N))
        calls = {}
        for name, lib in libs.items():
            groups = consts[name].get("kBwdGroups", sk.BWD_GROUPS)
            walk = min(plan[1] if not plan[0] else 1,
                       consts[name].get("kWalkGroups", sk.WALK_GROUPS))
            for p in ((True, groups), (False, walk)):
                calls[f"{name} {p}"] = BwdCall(lib, ops, h, p)
        for name, call in calls.items():
            call.run()
            torch.cuda.synchronize()
            for grad, (err, rel) in zip(SCAN_GRADS,
                                        bwd_diffs(call.grads(), want)):
                if not rel <= SCAN_BWD_RTOL:
                    raise AssertionError(f"backward {name} at {arch}: {grad}"
                                         f" {rel:.3g} x max |plain|")
        order = list(calls) + list(reversed(calls))
        for what in ("whole", "carry", "chunks"):
            names = [n for n in order if what in calls[n].calls]
            times = {n: [] for n in calls if what in calls[n].calls}
            for name in names:   # in turns: a, b, c, c, b, a
                times[name].append(time_ms(lambda: calls[name].run(what)))
            print(f"time scan backward {what} at {arch} (B={B} L=4096 E={E} "
                  f"N={N} f32; plan {plan}), turns: " + "; ".join(
                      f"{k} {', '.join(f'{t:.3f}' for t in v)} ms"
                      for k, v in times.items()), flush=True)
        for what in ("carry", "chunks"):
            name = f"current {(True, sk.BWD_GROUPS)}"
            print(f"clocks during the {what} at {arch} ({name}): "
                  + "; ".join(clocks_during(lambda: calls[name].run(what))),
                  flush=True)
        print(f"scan backward variants at {arch}: each gradient within "
              f"{SCAN_BWD_RTOL} x max |plain| of the plain backward",
              flush=True)
        del ops, dt, Bm, Cm, x, A, g, h, want, calls
        torch.cuda.empty_cache()


def scan_baseline(build, path):
    import ctypes
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.selective_scan import kernel as sk
    text = open(path).read()
    out = build.BUILD_DIR / "probe" / "selective_scan-baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), path],
                   check=True)
    base = ctypes.CDLL(str(out)).selective_scan
    # a source without the checkpoint pointer takes one argument less
    has_ckpt = "void* h_ckpt" in text
    base.argtypes = sk._SIGNATURE if has_ckpt else \
        sk._SIGNATURE[:6] + sk._SIGNATURE[7:]
    base.restype = ctypes.c_int
    cur = build.library("selective_scan").selective_scan
    cur.argtypes, cur.restype = sk._SIGNATURE, ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for arch, E in (("falcon-mamba-7b", 8192), ("hymba-1.5b", 1600)):
        B, L, N = 2, 4096, 16
        dt = F.softplus(torch.randn((B, L, E), generator=gen,
                                    device=dev)) * 0.2
        Bm, Cm = (torch.randn((B, L, N), generator=gen, device=dev)
                  for _ in range(2))
        x = torch.randn((B, L, E), generator=gen, device=dev)
        A = -torch.randn((E, N), generator=gen, device=dev).abs()
        y0, y1 = torch.empty_like(x), torch.empty_like(x)
        h = torch.empty((B, -(-L // sk.ckpt_chunk(N)), E, N), device=dev)
        ptrs = [t.data_ptr() for t in (dt, Bm, Cm, x, A)]
        runs = {
            "baseline": lambda: base(*ptrs, y0.data_ptr(),
                                     *([None] if has_ckpt else []), 0, B, L,
                                     E, N, stream),
            "current": lambda: cur(*ptrs, y1.data_ptr(), None, 0, B, L, E, N,
                                   stream),
            "current+ckpt": lambda: cur(*ptrs, y1.data_ptr(), h.data_ptr(),
                                        0, B, L, E, N, stream),
        }
        for name, fn in runs.items():
            if fn():
                raise RuntimeError(f"selective_scan {name} launch failed")
            torch.cuda.synchronize()
            if name != "baseline" and not torch.equal(y0, y1):
                raise AssertionError(f"{name} at {arch}: y differs from the "
                                     "baseline's")
        times = {k: [] for k in runs}
        order = list(runs) + list(reversed(runs))
        for name in order:   # in turns: a, b, c, c, b, a
            times[name].append(time_ms(runs[name]))
        print(f"time scan forward at {arch} (B={B} L={L} E={E} N={N} f32), "
              "turns: " + "; ".join(
                  f"{k} {', '.join(f'{t:.3f}' for t in v)} ms"
                  for k, v in times.items()), flush=True)
        del dt, Bm, Cm, x, A, y0, y1, h
        torch.cuda.empty_cache()
    m = re.search(r'extern "C" int selective_scan_bwd\((.*?)\)', text, re.S)
    if m is None or not has_ckpt:
        print("scan backward baseline: the source has no backward",
              flush=True)
        return
    # the single walk without a plan has 13 pointers; a source with the
    # plan's arguments runs this checkout's plan
    planned = m.group(1).count("void*") == 14
    for arch, E in TRAIN_SHAPES:
        ops = train_inputs(gen, E)
        dt, Bm, Cm, x, A, g = ops
        B, L, E = x.shape
        N = Bm.shape[2]
        slots = sk.bwd_slots(dev, N)
        plan = sk.bwd_plan(B, E, N, slots)
        hs = {}
        for name, fn in (("baseline", base), ("current", cur)):
            y = torch.empty_like(x)
            hs[name] = torch.empty((B, -(-L // sk.ckpt_chunk(N)), E, N),
                                   device=dev)
            if fn(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
                  A.data_ptr(), y.data_ptr(), hs[name].data_ptr(), 0, B, L,
                  E, N, stream):
                raise RuntimeError(f"selective_scan {name} launch failed")
        calls = {"baseline": BwdCall(ctypes.CDLL(str(out)), ops,
                                     hs["baseline"],
                                     plan if planned else None),
                 "current": BwdCall(build.library("selective_scan"), ops,
                                    hs["current"], plan)}
        for call in calls.values():
            call.run()
        torch.cuda.synchronize()
        diffs = bwd_diffs(calls["current"].grads(),
                          calls["baseline"].grads())
        times = {name: [] for name in calls}
        for name in ("baseline", "current", "current", "baseline"):
            times[name].append(time_ms(calls[name].run))
        stages = {what: time_ms(lambda: calls["current"].run(what))
                  for what in ("carry", "chunks")
                  if what in calls["current"].calls}
        print(f"time scan backward at {arch} (B={B} L={L} E={E} N={N} f32),"
              " turns: " + "; ".join(
                  f"{k} {', '.join(f'{t:.3f}' for t in v)} ms"
                  for k, v in times.items())
              + f"; current's plan (split, groups) {plan} (the card holds "
              f"{slots} chunk-kernel blocks at once), alone: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
              + "; checkpoints bit-identical "
              f"{bool(torch.equal(hs['baseline'], hs['current']))}; current"
              " - baseline: " + ", ".join(
                  f"{k} max |d| {err:.3g} ({rel:.3g} x max |baseline|)"
                  for k, (err, rel) in zip(SCAN_GRADS, diffs)), flush=True)
        del ops, dt, Bm, Cm, x, A, g, hs, calls
        torch.cuda.empty_cache()


TRAIN_RUN = """
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for arch, layers, name in cs.MAMBA_TRAIN:
    if arch in {archs!r}:
        cs.phase_train(dev, name, arch, layers)
        torch.cuda.empty_cache()
"""


def train_baseline(other, archs, turns):
    """The Mamba train phases of another checkout and this one, in turns,
    a process each; the first process of a checkout builds its kernels
    into its own build/."""
    trees = {"other": os.path.abspath(other), "this": ROOT}
    for turn in range(turns):
        order = ("other", "this") if turn % 2 == 0 else ("this", "other")
        for tag in order:
            proc = subprocess.run(
                [sys.executable, "-c", TRAIN_RUN.format(archs=list(archs))],
                cwd=trees[tag], capture_output=True, text=True)
            for line in proc.stdout.splitlines():
                if line.startswith(("phase train", "profile train")):
                    print(f"[{tag} turn {turn}] {line}", flush=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise RuntimeError(f"train phases of {tag} failed")


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--flash", nargs="*", default=["4x2", "4x1", "8x1"],
                    help="kWarps64 x kMTiles64 pairs")
    ap.add_argument("--lanes", type=int, nargs="*", default=[4, 8, 16])
    ap.add_argument("--sass", action="store_true",
                    help="count the scan backward kernels' instructions "
                         "(cuobjdump)")
    ap.add_argument("--bwd-variants", nargs="*", default=[],
                    help="NAME=V[,NAME=V] constants of selective_scan.cu "
                         "to time the scan backward with")
    ap.add_argument("--scan-baseline", default=None,
                    help="another copy of selective_scan.cu to time the "
                         "forward and backward against")
    ap.add_argument("--train-baseline", default=None,
                    help="root of another checkout whose Mamba train "
                         "phases to time against this one's")
    ap.add_argument("--train-archs", nargs="*",
                    default=["hymba-1.5b", "falcon-mamba-7b"])
    ap.add_argument("--train-turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ptxas_report(build)
    if args.sass:
        sass_report(build)
    if args.flash:
        flash_tiles(build, [tuple(map(int, f.split("x")))
                            for f in args.flash])
    if args.lanes:
        scan_lanes(build, args.lanes)
    if args.bwd_variants:
        scan_bwd_variants(build, args.bwd_variants)
    if args.scan_baseline:
        scan_baseline(build, args.scan_baseline)
    if args.train_baseline:
        train_baseline(args.train_baseline, args.train_archs,
                       args.train_turns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
