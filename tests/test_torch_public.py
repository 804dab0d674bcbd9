"""The port's package-level names cover the reference's, and
``qsgd_compress`` (the single-array QSGD through the flat bucketizer)
equals the reference's: outputs exact in every bucket whose norm is
bit-equal, within one level elsewhere (the layered rule of
tests/test_torch_qsgd.py).  Importing the kernels package builds
nothing."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import repro.core
import repro.kernels
import repro_torch.core
import repro_torch.kernels
from repro.kernels import qsgd_compress as jcompress
from repro.kernels.qsgd.kernel import qsgd_pack as jpack
from repro_torch.core import prng
from repro_torch.core.flatbuf import bucketize, seeds_of
from repro_torch.kernels import qsgd_compress
from repro_torch.kernels.qsgd.kernel import qsgd_pack

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
NORM_ULPS = 4
#: the reference's TPU-only dispatch helpers (its sharded layer's names
#: are ported since the multi-device launch slice)
EXEMPT = {"on_tpu", "autotune_rows", "default_interpret"}
KERNEL_NAMES = ["qsgd_compress", "qsgd_pack", "qsgd_fused", "qsgd_unpack",
                "natural_compress", "natural_fused", "selective_scan_op",
                "flash_attention_op"]


def test_core_names_cover_reference():
    missing = [n for n in repro.core.__all__
               if n not in EXEMPT and not hasattr(repro_torch.core, n)]
    assert missing == []
    for name in ("FlatLayout", "flat_tree_apply", "index_bits", "pack_tree",
                 "pack_tree_qsgd", "pack_tree_natural", "unpack_tree",
                 "narrow_tree_qsgd", "widen_tree_qsgd",
                 "reduce_payload_mean", "supports_fused_reduce"):
        assert name in repro_torch.core.__all__


def test_kernel_names_cover_reference():
    ref = [n for n in dir(repro.kernels) if not n.startswith("_")
           and callable(getattr(repro.kernels, n))]
    missing = [n for n in ref
               if n not in EXEMPT and not hasattr(repro_torch.kernels, n)]
    assert missing == []
    assert sorted(repro_torch.kernels.__all__) == sorted(KERNEL_NAMES)


@pytest.mark.parametrize("shape,levels,bucket", [
    ((1000,), 127, 2048), ((33, 70), 7, 128), ((5, 4, 300), 1, 256),
    ((4096,), 127, 512)])
def test_qsgd_compress_equals_reference(shape, levels, bucket):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jcompress(key, jnp.asarray(x), levels=levels,
                                bucket=bucket))
    got = qsgd_compress(prng.PRNGKey(6), torch.from_numpy(x),
                        levels=levels, bucket=bucket)
    assert got.shape == x.shape and got.dtype == torch.float32
    # the bucket norms of both sides, on the same seeds
    x2d = bucketize(torch.from_numpy(x).reshape(-1), bucket).contiguous()
    seeds = seeds_of(prng.PRNGKey(6))
    _, tn = qsgd_pack(x2d, seeds, levels=levels)
    _, jn = jpack(jnp.asarray(x2d.numpy()), jnp.asarray(seeds),
                  levels=levels)
    tn, jn = tn.numpy()[:, 0], np.asarray(jn)[:, 0]
    assert np.max(np.abs(tn - jn) / np.spacing(np.maximum(np.abs(jn),
                                                           1e-30))) \
        <= NORM_ULPS
    same = np.repeat(tn == jn, bucket)[:x.size]
    flat_got, flat_want = got.numpy().reshape(-1), want.reshape(-1)
    np.testing.assert_array_equal(flat_got[same], flat_want[same])
    level = np.repeat(jn / levels, bucket)[:x.size]
    assert np.all(np.abs(flat_got - flat_want) <= level * (1 + 1e-6))


def test_kernels_import_builds_nothing():
    code = textwrap.dedent("""
        import sys
        import repro_torch.kernels as k
        from repro_torch.kernels import build
        assert not build._LOADED
        assert "triton" not in sys.modules
        assert not any(m == "jax" or m.startswith("jax.")
                       for m in sys.modules)
        print(len(k.__all__))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "8"
