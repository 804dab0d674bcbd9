#!/usr/bin/env python3
"""Time the serve step's decode loop of two checkouts of the port on one
GPU, in turns, so that a change to the decode path is held against its
parent on the same card.

    python3 tools/decode_ab.py PARENT_CHECKOUT CHANGE_CHECKOUT
                               [--archs stablelm-1.6b hymba-1.5b]
                               [--rounds 3]

Each round runs the parent and the change, each in a process of its
own, alternating which runs first.  A process builds each arch at full
size (f32, TF32 off, weights from a seeded generator), fills a cache of
two requests with 16 warm-up steps of ``build_serve_step`` and times 64
more on the host clock, between two ``torch.cuda.synchronize()``.  Decode
launches no hand-written kernel, so nothing is built.  Prints one JSON
line a run, ``{"tree": "parent" | "change", "ms": {arch: ms a step}}``,
and the medians last.
"""
import argparse
import json
import statistics
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import init_caches, init_params
ms = {}
for arch in sys.argv[2:]:
    cfg = get_config(arch)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    serve = build_serve_step(cfg)
    caches = init_caches(cfg, 2, 80, device="cuda")
    tokens = {"tokens": torch.zeros((2, 1), dtype=torch.long, device="cuda")}
    for i in range(16):
        serve(params, caches, i, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(16, 80):
        serve(params, caches, i, tokens)
    torch.cuda.synchronize()
    ms[arch] = (time.perf_counter() - t0) / 64 * 1e3
    del params, caches
    torch.cuda.empty_cache()
print(json.dumps(ms))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--archs", nargs="+",
                    default=["stablelm-1.6b", "hymba-1.5b"])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    runs = {"parent": [], "change": []}
    for r in range(args.rounds):
        order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for tree in order:
            out = subprocess.run(
                [sys.executable, "-c", CHILD, getattr(args, tree)]
                + args.archs, capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stderr[-4000:])
                return out.returncode
            ms = json.loads(out.stdout.strip().splitlines()[-1])
            runs[tree].append(ms)
            print(json.dumps({"tree": tree, "ms": ms}), flush=True)
    print(json.dumps({"median": {
        tree: {a: statistics.median(m[a] for m in ms) for a in args.archs}
        for tree, ms in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
