#!/usr/bin/env python3
"""Time a checkpoint commit of the width cell's dense snapshot with the
container CRC taken in parallel pieces (a copy here of the design the
port dropped) and with the package's one serial ``zlib.crc32`` pass a
file (``checkpoint.io.crc32``), in turns, on this host.

    python3 tools/crc_ab.py [--clients 8] [--rounds 2] [--dir DIR]

The snapshot is what ``chip_smoke.py``'s checkpoint width phase commits:
stablelm-1.6b's tree at full width and 4 layers, stacked for n clients
(the params) and once more unstacked (the cache), float32 host tensors
(filled with a pattern: the CRC and the writes do not depend on the
values).  Each commit is ``save_sharded`` into a fresh directory under
``--dir`` (default: the temp directory), the shards written together,
every file fsynced, then deleted.  The rounds alternate which variant
goes first (pieces, serial, serial, pieces, ...).  The CRC of the
largest leaf alone is timed both ways too.  Prints one JSON line a
commit and the medians last.  Needs no GPU.
"""
import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import io as ckio  # noqa: E402
from repro_torch.checkpoint.manager import save_sharded  # noqa: E402

# stablelm-1.6b: vocab, d_model, d_ff; 4 of its 24 layers
VOCAB, D_MODEL, D_FF, LAYERS = 100_352, 2048, 5632, 4


def width_tree(lead):
    """The width cell's tree, every leaf shaped ``lead + shape``."""
    V, D, F, L = VOCAB, D_MODEL, D_FF, LAYERS

    def make(shape):
        return torch.full(lead + shape, 0.5)

    return {
        "embed": {"table": make((V, D))},
        "final_norm": {"scale": make((D,))},
        "layers": {
            "attn": {k: make((L, D, D)) for k in ("wq", "wk", "wv", "wo")},
            "ffn": {"w_gate": make((L, D, F)), "w_up": make((L, D, F)),
                    "w_down": make((L, F, D))},
            "ln1": {"scale": make((L, D))},
            "ln2": {"scale": make((L, D))},
        },
    }


SERIAL = ckio.crc32         # the package's: one zlib.crc32 pass
PIECE = 64 << 20            # bytes a CRC thread takes at a time
CRC_POLY = 0xEDB88320       # CRC-32, reflected


def gf2_times(mat, vec):
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def zeros_operator(nbytes):
    """The GF(2) matrix that advances a CRC-32 register over ``nbytes``
    zero bytes (zlib's ``crc32_combine`` squaring)."""
    op = [CRC_POLY] + [1 << k for k in range(31)]      # one zero bit
    for _ in range(3):                                  # one zero byte
        op = [gf2_times(op, op[k]) for k in range(32)]
    result = None
    while nbytes:
        if nbytes & 1:
            result = op if result is None else \
                [gf2_times(op, result[k]) for k in range(32)]
        nbytes >>= 1
        if nbytes:
            op = [gf2_times(op, op[k]) for k in range(32)]
    return result


def pieces_crc(chunks):
    """CRC-32 of the chunks: above 256 MiB in 64 MiB pieces on a thread
    pool, their CRCs combined as zlib's ``crc32_combine`` does."""
    views = [memoryview(c).cast("B") for c in chunks]
    if sum(v.nbytes for v in views) <= 4 * PIECE:
        return SERIAL(views)
    pieces = [v[i:i + PIECE] for v in views
              for i in range(0, v.nbytes, PIECE)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        crcs = list(pool.map(zlib.crc32, pieces))
    ops, crc = {}, 0
    for piece, c in zip(pieces, crcs):
        if piece.nbytes:
            if piece.nbytes not in ops:
                ops[piece.nbytes] = zeros_operator(piece.nbytes)
            crc = gf2_times(ops[piece.nbytes], crc) ^ c
    return crc


def commit(tree, parent):
    root = tempfile.mkdtemp(prefix="crc-ab-", dir=parent)
    try:
        t0 = time.perf_counter()
        save_sharded(os.path.join(root, "step"), tree)
        seconds = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(root) for f in fs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return seconds, nbytes


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    tree = {"params": width_tree((args.clients,)), "cache": width_tree(())}
    big = tree["params"]["embed"]["table"].numpy()
    variants = {"pieces": pieces_crc, "serial": SERIAL}
    crc_s = {}
    for name, fn in variants.items():
        t0 = time.perf_counter()
        value = fn([big])
        crc_s[name] = time.perf_counter() - t0
        crc_s[name + "_value"] = value
    assert crc_s["pieces_value"] == crc_s["serial_value"]
    print(json.dumps({"crc_largest_leaf_gb": big.nbytes / 1e9,
                      "pieces_s": crc_s["pieces"],
                      "serial_s": crc_s["serial"],
                      "cpus": os.cpu_count()}), flush=True)
    times = {name: [] for name in variants}
    order = ["pieces", "serial"]
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            ckio.crc32 = variants[name]
            try:
                seconds, nbytes = commit(tree, args.dir)
            finally:
                ckio.crc32 = SERIAL
            times[name].append(seconds)
            print(json.dumps({"round": r, "crc": name, "commit_s": seconds,
                              "gb": nbytes / 1e9,
                              "gb_per_s": nbytes / 1e9 / seconds}),
                  flush=True)
    print(json.dumps({"median_commit_s": {k: statistics.median(v)
                                          for k, v in times.items()}}))


if __name__ == "__main__":
    main()
