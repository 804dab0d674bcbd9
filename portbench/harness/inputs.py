"""The inputs both sides get, made from ``--seed``: the clients' weights
on the device and the clients' token streams.

Weights: client i's random leaves come from one ``torch.randn`` on the
device, a generator seeded from (seed, i), cut into the leaves in name
order and scaled by the plain model's ``weight_std(name, shape)``, a
leaf whose scale is 0 made of ones.  A model without that rule takes
this module's: the table by 0.02, every matrix by its fan-in ** -0.5
(the second-to-last axis); norm scales are ones.

Tokens: client i follows its own affine law ``t_{j+1} = (a_i t_j + b_i +
eps) mod V``, eps a uniform token with probability ``noise`` (the
repository's synthetic stream, one law a client), the draws of step k
from ``numpy.random.default_rng((seed, i, k))``.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _std(name: str, shape) -> float:
    if name.endswith(".scale"):
        return 0.0
    if name == "embed.table":
        return 0.02
    return shape[-2] ** -0.5


def weight_rule(ref):
    """The scale of each leaf of the plain model ``ref``."""
    return getattr(ref, "weight_std", _std)


def client_weights(shapes: dict, seed: int, i: int, device, std) -> dict:
    """Client i's leaves ({name: tensor}), views of one buffer, scaled by
    ``std(name, shape)``."""
    random = [k for k in shapes if std(k, shapes[k])]
    total = sum(math.prod(shapes[k]) for k in random)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + i + 1) % (1 << 63))
    buf = torch.randn((total,), generator=gen, device=device)
    out, lo = {}, 0
    for name, shape in shapes.items():
        scale = std(name, shape)
        if not scale:
            out[name] = torch.ones(shape, device=device)
            continue
        size = math.prod(shape)
        out[name] = buf[lo:lo + size].view(shape).mul_(scale)
        lo += size
    return out


def stacked_weights(shapes: dict, seed: int, n: int, device, std) -> dict:
    """{name: (n, *shape)} for n clients."""
    out = {k: torch.empty((n,) + tuple(s), device=device)
           for k, s in shapes.items()}
    for i in range(n):
        one = client_weights(shapes, seed, i, device, std)
        for k in shapes:
            out[k][i].copy_(one[k])
        del one
    return out


def nested(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for name, value in flat.items():
        node = out
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def dotted(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(dotted(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def token_batches(seed: int, steps, n: int, batch: int, seq: int,
                  vocab: int, noise: float) -> list:
    """(n, batch, seq) int32 token arrays, one a step of ``steps``."""
    seed = int(seed) % (1 << 64)
    rng = np.random.default_rng(seed)
    a = (rng.integers(1, max(vocab // 2, 2), n) * 2 + 1) % vocab
    b = rng.integers(0, vocab, n)
    out = []
    for k in steps:
        arr = np.empty((n, batch, seq), np.int32)
        for i in range(n):
            r = np.random.default_rng((seed, i, int(k)))
            t = r.integers(0, vocab, batch)
            eps = r.integers(0, vocab, (seq, batch)) * (r.random((seq, batch)) < noise)
            for j in range(seq):
                arr[i, :, j] = t
                t = (a[i] * t + b[i] + eps[j]) % vocab
        out.append(arr)
    return out
