#!/usr/bin/env python3
"""Probe the port's CUDA kernels on one GPU: what ptxas makes of each
source, the flash kernel's warps and m-tiles at D = 64, and the
selective scan's lanes a channel.

    python3 tools/probe_kernels.py [--flash 4x2 4x1 8x1] [--lanes 4 8 16]
                                   [--scan-baseline OTHER.cu]

1. Compiles every kernel source with ``-Xptxas -v`` and prints the
   registers, spills and shared memory of the flash kernels and of the
   scan at N = 16.
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
4. With ``--scan-baseline``, builds that copy of ``selective_scan.cu``
   (another commit's, say ``git show REV:src/repro_torch/kernels/
   selective_scan/csrc/selective_scan.cu``) and, at both prefill shapes,
   times its forward against this checkout's, without and with the
   state checkpoints, in turns (median of 25 launches each, CUDA events
   around the ctypes call alone); the outputs must agree bit for bit.
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
        func = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                func = m.group(1)
            elif func and ("flash_fwd" in func or "Li16EE" in func) and (
                    "registers" in line or "spill" in line):
                print(f"ptxas {name} {func}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)


def variant(build, name, constants, signature):
    """The entry point of one kernel source built with other values of
    its constants ({name: value}, each a `constexpr int` of the
    source), from a patched copy under build/probe/."""
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
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    fn = getattr(ctypes.CDLL(str(out)), name)
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


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--flash", nargs="*", default=["4x2", "4x1", "8x1"],
                    help="kWarps64 x kMTiles64 pairs")
    ap.add_argument("--lanes", type=int, nargs="*", default=[4, 8, 16])
    ap.add_argument("--scan-baseline", default=None,
                    help="another copy of selective_scan.cu to time the "
                         "forward against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ptxas_report(build)
    if args.flash:
        flash_tiles(build, [tuple(map(int, f.split("x")))
                            for f in args.flash])
    if args.lanes:
        scan_lanes(build, args.lanes)
    if args.scan_baseline:
        scan_baseline(build, args.scan_baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
