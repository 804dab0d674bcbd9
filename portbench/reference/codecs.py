"""Plain versions of the codecs the cells run and of the compressed
average, computed from the model, the key and nothing else.

A codec is a dict: ``{"name": "natural"}`` or ``{"name": "qsgd",
"levels": 127}``.  Two transports:

  * leafwise: each leaf of each client is compressed on its own, the
    noise drawn from threefry with the leaf's key (natural: one uniform
    an element; QSGD: one an element of the leaf padded to buckets of
    2048);
  * flat: a client's leaves are raveled in tree order into one buffer,
    padded to buckets (natural 128, QSGD 2048) and compressed with the
    counter hash of each element's index in that buffer.

Natural compression keeps sign and exponent and bumps the exponent when
the uniform lies below mantissa / 2^23.  QSGD takes each bucket's norm,
rounds ``levels * |x| / norm`` down or up by the uniform, and decodes to
``sign * q * (norm * float32(1 / levels))``, zero for a zero bucket.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import draws

QSGD_BUCKET = 2048
NATURAL_BUCKET = 128
CHUNK = 1 << 24         # elements a flat chunk takes at once


def _natural(x: torch.Tensor, up_test) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32).to(torch.int64) & draws.MASK
    special = (bits & 0x7F800000) == 0x7F800000
    up = up_test(bits & 0x7FFFFF) & ~special
    out = (bits & 0xFF800000) + (up.to(torch.int64) << 23)
    out = torch.where(special, bits, out)
    return (out - ((out >> 31) << 32)).to(torch.int32).view(torch.float32)


def _qsgd(x2d: torch.Tensor, noise: torch.Tensor, levels: int) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x2d * x2d, dim=-1, keepdim=True))
    safe = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    scaled = torch.abs(x2d) / safe * float(levels)
    lo = torch.floor(scaled)
    q = lo + (noise < (scaled - lo)).to(torch.float32)
    out = torch.sign(x2d) * q * (norm * float(np.float32(1.0) / np.float32(levels)))
    return torch.where(norm == 0.0, torch.zeros_like(out), out)


def compress_leaf(codec: dict, key, x: torch.Tensor) -> torch.Tensor:
    """One client's leaf, leafwise."""
    flat = x.reshape(-1).to(torch.float32)
    d = flat.numel()
    if codec["name"] == "natural":
        noise = draws.uniform23(key, d, x.device)
        return _natural(flat, lambda m: noise < m.to(torch.float32)
                        * (1.0 / (1 << 23))).reshape(x.shape)
    pad = (-d) % QSGD_BUCKET
    xp = torch.nn.functional.pad(flat, (0, pad)).view(-1, QSGD_BUCKET)
    noise = draws.uniform23(key, xp.numel(), x.device).view(xp.shape)
    return _qsgd(xp, noise, codec["levels"]).reshape(-1)[:d].reshape(x.shape)


def flat_bucket(codec: dict, d: int) -> int:
    b = QSGD_BUCKET if codec["name"] == "qsgd" else NATURAL_BUCKET
    if d < b:       # one bucket, padded to whole lanes of 128
        return max(-(-d // NATURAL_BUCKET) * NATURAL_BUCKET, NATURAL_BUCKET)
    return b


def compress_flat(codec: dict, key, flat: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """One client's raveled model (d,), flat transport, into ``out``
    (default a new buffer; may be ``flat`` itself)."""
    d = flat.numel()
    b = flat_bucket(codec, d)
    rows = -(-d // b)
    seeds = draws.seeds_of(key)
    out = torch.empty_like(flat) if out is None else out
    step = max(CHUNK // b, 1)
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        lo, hi = r0 * b, min(r1 * b, d)
        x = flat[lo:hi]
        pad = (r1 - r0) * b - (hi - lo)
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        rbits = draws.counter_bits(seeds, lo, r1 * b, flat.device)
        if codec["name"] == "natural":
            y = _natural(x, lambda m: (rbits >> 8) < (m << 1))
        else:
            noise = (rbits >> 8).to(torch.float32) * (1.0 / (1 << 24))
            y = _qsgd(x.view(-1, b), noise.view(-1, b),
                      codec["levels"]).reshape(-1)
        out[lo:hi] = y[:hi - lo]
    return out


def mean_scale(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def compressed_average(codec: dict, transport: str, key, leaves: list,
                       fault: str = None) -> list:
    """The target ``C_M(mean_i C_i(x_i))`` of client-stacked leaves (tree
    order): ``split(key)`` gives the clients' and the master's keys,
    ``split`` of each into one key a leaf (leafwise).  ``fault=
    "no_exchange"`` leaves the mean out: client 0's message alone."""
    n = leaves[0].shape[0]
    k_clients, k_master = draws.split(key)
    client_keys = draws.split(k_clients, n)
    clients = 1 if fault == "no_exchange" else n
    if transport == "leafwise":
        leaf_keys = draws.split(client_keys, len(leaves))
        down_keys = draws.split(k_master, len(leaves))
        out = []
        for j, a in enumerate(leaves):
            acc = compress_leaf(codec, leaf_keys[0, j], a[0])
            for i in range(1, clients):
                acc += compress_leaf(codec, leaf_keys[i, j], a[i])
            acc *= mean_scale(clients)
            out.append(compress_leaf(codec, down_keys[j], acc))
            del acc
        return out
    acc = None
    for i in range(clients):
        flat = torch.cat([a[i].reshape(-1).to(torch.float32) for a in leaves])
        y = compress_flat(codec, client_keys[i], flat, out=flat)
        acc = y if acc is None else acc.add_(y)
        del flat, y
    acc /= float(clients)
    compress_flat(codec, k_master, acc, out=acc)
    out, lo = [], 0
    for a in leaves:
        size = math.prod(a.shape[1:])
        out.append(acc[lo:lo + size].view(a.shape[1:]))
        lo += size
    return out


def round_bits(codec: dict, transport: str, shapes: list) -> int:
    """Wire bits of one message: natural 8 bits an element plus a sign
    bitmap padded to bytes; QSGD one int8 code an element plus a float32
    norm a bucket; the flat transport pays for its padded buckets."""
    if transport == "leafwise":
        total = 0
        for shape in shapes:
            d = math.prod(shape)
            if codec["name"] == "natural":
                total += 8 * d + 8 * (-(-d // 8))
            else:
                total += 8 * d + 32 * (-(-d // QSGD_BUCKET))
        return total
    d = sum(math.prod(s) for s in shapes)
    b = flat_bucket(codec, d)
    rows = -(-d // b)
    if codec["name"] == "natural":
        return rows * b * 8 + rows * (b // 8) * 8
    return rows * b * 8 + rows * 32
