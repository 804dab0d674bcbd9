#!/usr/bin/env python3
"""What is alive at the device-memory peak of ``stacked_grad_fn``: the
local step's gradient of ``chip_smoke.py``'s mistral mesh2d train phase
(mistral-large-123b at full width and one layer, two clients, one
4096-token sequence each, float32, TF32 off), with a cache-sized buffer
allocated beside the params as the train state holds one.

    python3 tools/mem_peak.py [--layers 1] [--remat full|dots]

Records the CUDA caching allocator's history through the gradient
(``torch.cuda.memory._record_memory_history``), replays its alloc and
free events to the highest total, and prints the blocks alive there by
size and allocating Python frame (no frame: the autograd engine's
backward).  Prints the card's name and power limit first.  Needs a GPU.
"""
import argparse
import collections
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def live_at_peak(trace):
    """(bytes above the start, {addr: event}) at the trace's highest
    total of allocated bytes."""
    live, cur, best, best_live = {}, 0, -1, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > best:
                best, best_live = cur, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    return best, best_live


def where(ev) -> str:
    frames = ev.get("frames", [])
    own = [f for f in frames if "repro_torch" in f["filename"]]
    return " <- ".join(f"{os.path.basename(f['filename'])}:{f['line']} "
                       f"{f['name']}" for f in (own[:5] or frames[:3]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=("full", "dots"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mem_peak: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import stacked_grad_fn
    from repro_torch.launch.train import init_stacked_params
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mistral-large-123b"),
                              n_layers=args.layers, remat_policy=args.remat)
    params = init_stacked_params(cfg, 2, 0, dev)
    cache = [torch.empty_like(a[0]) for a in tree_leaves(params)]
    stream = TokenStream(n_clients=2, vocab=cfg.vocab_size, batch=1,
                         seq=4096)
    batch = {"tokens": torch.from_numpy(stream.batch_at(0)).to(dev)}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(max_entries=200000,
                                             stacks="python")
    losses, grads = stacked_grad_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"mistral-large-123b {args.layers} layer(s), remat "
          f"{args.remat}: params and cache {base / 1e9:.2f} GB, peak "
          f"{peak / 1e9:.2f} GB", flush=True)
    above, live = live_at_peak(snap["device_traces"][0])
    print(f"alive at the peak above params and cache: {above / 1e9:.2f} GB",
          flush=True)
    groups = collections.Counter((ev["size"], where(ev))
                                 for ev in live.values())
    for (size, frame), k in sorted(groups.items(),
                                   key=lambda t: -t[0][0] * t[1])[:20]:
        print(f"{k} x {size / 1e9:.3f} GB  {frame or '(backward)'}",
              flush=True)
    del params, cache, grads, losses
    return 0


if __name__ == "__main__":
    sys.exit(main())
