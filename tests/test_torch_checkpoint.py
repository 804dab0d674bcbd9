"""The port's checkpoint format against the reference's
(``repro_torch.checkpoint`` vs ``repro.checkpoint``).

Exact throughout: for the same numpy tree both packages write the same
MessagePack bytes and the same container files (the port through its own
MessagePack codec, ``checkpoint/mpack.py``), each restores the other's
single files and sharded directories bit for bit (bfloat16 included),
and the manager, corruption checks and lazy views behave as the
reference's.
"""
import os
import threading
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro import checkpoint as jck
from repro.checkpoint import pack as jpack
from repro.core import flatbuf as jflat
from repro.core import make_compressor as jmake
from repro.core import make_plan as jplan
from repro.core import narrow_tree_qsgd as jnarrow
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import mpack
from repro_torch.checkpoint import io as ckio
from repro_torch.checkpoint import pack as tpack
from repro_torch.checkpoint.io import CheckpointCorruptError
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            step_dir)
from repro_torch.core import flatbuf as tflat
from repro_torch.core import make_compressor, make_plan, narrow_tree_qsgd
from repro_torch.core import prng

RNG = np.random.default_rng(0)


def _bf16(n):
    return RNG.standard_normal(n).astype(np.float32).astype(
        ml_dtypes.bfloat16)


def _as_torch(tree):
    """The numpy tree with every array a CPU tensor (bfloat16 too)."""
    if isinstance(tree, np.ndarray):
        if tree.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(tree.view(np.int16).copy()) \
                .view(torch.bfloat16)
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_torch(v) for v in tree)
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return tree


def _host(x):
    """A restored leaf as numpy (bfloat16 tensors as their raw words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _same(a, b):
    """Structure, dtypes and bits equal (arrays of either package)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) \
            and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic, torch.Tensor, jax.Array)):
        x, y = _host(a), _host(b)
        return x.dtype == y.dtype and x.shape == y.shape \
            and x.tobytes() == y.tobytes()
    return a == b and type(a) is type(b)


TREES = {
    "escaped": {"__arr__": np.arange(3, dtype=np.float32),
                "__esc__x": {"__scalar__": 5, "__tuple__": [1, 2]},
                "__ref__": "s", "plain": -7},
    "containers": {"t": (1, 2.5, "x" * 40, None, True, b"raw"),
                   "l": [np.int8(3), [], (), {}], "big": 2 ** 40,
                   "neg": -(2 ** 33), "neg8": -100},
    "dtypes": {"f32": RNG.standard_normal((3, 5)).astype(np.float32),
               "i8": np.arange(-64, 64, dtype=np.int8),
               "u32": np.arange(70_000, dtype=np.uint32) * 61_441,
               "f64": RNG.standard_normal(300),
               "bf16": _bf16(257), "empty": np.zeros((0, 3), np.float32),
               "scalar": np.asarray(7, np.int32)},
}


@pytest.mark.parametrize("name", list(TREES))
def test_same_msgpack_and_container_bytes(name, tmp_path):
    tree = TREES[name]
    want = jpack.pack_bytes(tree)
    assert tpack.pack_bytes(tree) == want
    assert tpack.pack_bytes(_as_torch(tree)) == want
    jck.save(str(tmp_path / "j.ckpt"), tree)
    tck.save(str(tmp_path / "t.ckpt"), _as_torch(tree))
    assert (tmp_path / "t.ckpt").read_bytes() \
        == (tmp_path / "j.ckpt").read_bytes()


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.5, -1e300, "", "a" * 31, "a" * 32, "é" * 200, "b" * 70000,
    b"", b"x" * 255, b"x" * 256, b"y" * 65536, [1] * 15, [1] * 16,
    [0] * 70000, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {1: None, 2: True, 3: False}])
def test_mpack_equals_msgpack(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert mpack.packb(value) == want
    back = mpack.unpack(want)
    if isinstance(value, bytes):
        back = bytes(back)
    assert back == value


def _tree_model():
    return {"w": RNG.standard_normal((33, 7)).astype(np.float32),
            "layers": [{"b": RNG.standard_normal(65).astype(np.float32)}],
            "head": RNG.standard_normal(5).astype(np.float32)}


def _payload_pair(kind):
    """(reference payload, the port's payload of the same arrays)."""
    tree = _tree_model()
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = _as_torch(tree)
    key = prng.PRNGKey(4)
    if kind == "dense":
        jp = jplan(jmake("identity"), jtree, transport="leafwise").encode(
            jax.random.PRNGKey(4), jtree)
        tp = make_plan(make_compressor("identity"), ttree,
                       transport="leafwise").encode(key, ttree)
        return jp, tp
    if kind == "natural":
        jp, _ = jflat.pack_tree_natural(jax.random.PRNGKey(4), jtree)
        tp, _ = tflat.pack_tree_natural(key, ttree)
        return jp, tp
    levels = 7 if kind == "narrow" else 127
    jp, _ = jflat.pack_tree_qsgd(jax.random.PRNGKey(4), jtree,
                                 levels=levels, bucket=128)
    tp, _ = tflat.pack_tree_qsgd(key, ttree, levels=levels, bucket=128)
    # the same wire arrays (the codes are exact given the norms, which
    # may differ in ulps: tests/test_torch_qsgd.py)
    import dataclasses
    tp = dataclasses.replace(
        tp, codes=torch.from_numpy(np.array(jp.codes)),
        norms=torch.from_numpy(np.array(jp.norms)))
    if kind == "narrow":
        return jnarrow(jp), narrow_tree_qsgd(tp)
    return jp, tp


@pytest.mark.parametrize("kind", ["dense", "natural", "qsgd", "narrow"])
def test_payload_bytes_equal_reference(kind):
    """QSGDPayload, NarrowQSGDPayload, NaturalPayload and a TreePayload of
    DensePayloads (with its treedef), their FlatLayouts included."""
    jp, tp = _payload_pair(kind)
    assert type(tp).__name__ == type(jp).__name__
    want = jpack.pack_bytes({"p": jp})
    assert tpack.pack_bytes({"p": tp}) == want
    back = tpack.unpack_bytes(want, device="cpu")["p"]
    assert type(back) is type(tp)
    assert tpack.pack_bytes({"p": back}) == want


def test_layout_bytes_equal_reference():
    tree = _tree_model()
    jl = jflat.layout_of(jax.tree.map(jnp.asarray, tree), 2048)
    tl = tflat.layout_of(_as_torch(tree), 2048)
    sk = jpack._pack_layout(jl)
    assert mpack.packb(tpack._pack_layout(tl)) \
        == msgpack.packb(sk, use_bin_type=True)
    assert tpack._unpack_layout(sk) == tl


def _mixed_tree():
    jp, tp = _payload_pair("natural")
    tree = {"a": RNG.standard_normal((4, 9)).astype(np.float32),
            "bf": _bf16(33), "i": np.arange(5, dtype=np.int64),
            "t": (np.float64(1.5), [np.uint8(3)])}
    return {**tree, "p": jp}, {**_as_torch(tree), "p": tp}


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_each_package_restores_the_others(layout, tmp_path):
    jtree, ttree = _mixed_tree()
    if layout == "single":
        jck.save(str(tmp_path / "j"), jtree)
        tck.save(str(tmp_path / "t"), ttree)
        from_j = tck.restore(str(tmp_path / "j"), device="cpu")
        from_t = jck.restore(str(tmp_path / "t"))
    else:
        jck.save_sharded(str(tmp_path / "j"), jtree, shard_bytes=256)
        tck.save_sharded(str(tmp_path / "t"), ttree, shard_bytes=256)
        assert sorted(os.listdir(tmp_path / "t")) \
            == sorted(os.listdir(tmp_path / "j"))
        for f in os.listdir(tmp_path / "j"):
            assert (tmp_path / "t" / f).read_bytes() \
                == (tmp_path / "j" / f).read_bytes()
        from_j = tck.restore_sharded(str(tmp_path / "j"), device="cpu")
        from_t = jck.restore_sharded(str(tmp_path / "t"))
    for k in ("a", "bf", "i", "t"):
        assert _same(from_j[k], jtree[k]), k
        assert _same(from_t[k], jtree[k]), k
    assert isinstance(from_j["a"], torch.Tensor)
    assert tpack.pack_bytes({"p": from_j["p"]}) \
        == jpack.pack_bytes({"p": jtree["p"]})
    assert jpack.pack_bytes({"p": from_t["p"]}) \
        == jpack.pack_bytes({"p": jtree["p"]})


@pytest.mark.parametrize("damage", ["truncated", "bitflip", "empty"])
def test_corruption_raises(damage, tmp_path):
    path = str(tmp_path / "c.ckpt")
    tck.save(path, {"w": torch.arange(100, dtype=torch.float32)})
    raw = bytearray(open(path, "rb").read())
    if damage == "truncated":
        raw = raw[:-7]
    elif damage == "bitflip":
        raw[40] ^= 0x10
    else:
        raw = bytearray()
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        tck.restore(path, device="cpu")


@pytest.mark.parametrize("sizes", [(40_000,), (1, 16_385, 0, 23_001),
                                   (4096 * 5, 4095, 4097, 3)])
def test_crc_over_chunks_equals_zlib(sizes, tmp_path):
    """A payload given as chunks (a shard's leaves, empty ones included)
    has the CRC of its bytes laid end to end, and its container is the
    one the whole payload gives."""
    chunks = [RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in sizes]
    whole = b"".join(chunks)
    assert ckio.crc32(chunks) == zlib.crc32(whole)
    ckio.write_durable(str(tmp_path / "chunks"), chunks)
    ckio.write_durable(str(tmp_path / "whole"), whole)
    assert (tmp_path / "chunks").read_bytes() \
        == (tmp_path / "whole").read_bytes()
    assert bytes(ckio.read_durable(str(tmp_path / "chunks"))) == whole


def test_legacy_headerless_file_loads(tmp_path):
    path = tmp_path / "legacy.mp"
    path.write_bytes(jpack.pack_bytes({"w": np.arange(4, dtype=np.int32)}))
    got = tck.restore(str(path), device="cpu")
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.int32))


def test_lazy_restore_returns_views(tmp_path):
    path = str(tmp_path / "v.ckpt")
    tree = {"w": RNG.standard_normal(64).astype(np.float32),
            "bf": _bf16(16)}
    jck.save(path, tree)
    got = tck.restore(path, lazy=True)
    assert isinstance(got["w"], np.ndarray) and not got["w"].flags.writeable
    assert got["w"].base is not None and not got["w"].flags.owndata
    assert np.array_equal(got["w"], tree["w"])
    assert got["bf"].dtype == torch.bfloat16
    assert _same(got["bf"], tree["bf"])
    d = str(tmp_path / "s")
    tree["v"] = np.arange(7, dtype=np.float64)
    tck.save_sharded(d, _as_torch(tree))
    got = tck.restore_sharded(d, lazy=True)
    assert not got["w"].flags.writeable and not got["w"].flags.owndata
    # leaves sit at 64-byte offsets from the shard payload's start
    base = got["w"].ctypes.data
    assert (got["v"].ctypes.data - base) % 64 == 0
    assert np.array_equal(got["v"], tree["v"])


def test_restore_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    path = str(tmp_path / "d.ckpt")
    tck.save(path, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.restore(path)


def _tree(step):
    return {"w": torch.full((5,), float(step)), "step": step}


def test_manager_latest_pruning_and_fallback(tmp_path):
    root = str(tmp_path / "ck")
    with CheckpointManager(root, max_to_keep=2, shard_bytes=64) as mgr:
        for s in (1, 2, 3):
            mgr.save(s, _tree(s))
        mgr.wait_until_finished()
        assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
        assert torch.equal(mgr.restore(device="cpu")["w"], _tree(3)["w"])
    # the reference's manager reads the port's directories
    assert jck.latest_step(root) == 3
    assert np.array_equal(np.asarray(jck.CheckpointManager(root)
                                     .restore(2)["w"]), np.full(5, 2.0))
    # a torn newer step (a shard missing) and a dangling pointer: the
    # fallback scan resolves the newest complete step
    os.makedirs(step_dir(root, 9))
    tck.save_sharded(step_dir(root, 9), _tree(9))
    os.remove(os.path.join(step_dir(root, 9), "shard_00000.ckpt"))
    with open(os.path.join(root, "latest"), "wb") as f:
        f.write(b"garbage")
    assert latest_step(root) == 3
    os.makedirs(os.path.join(root, ".tmp-step_0000000011"))
    assert CheckpointManager(root).all_steps() == [2, 3]


def test_manager_failed_commit_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, {"bad": {1, 2}})             # a set cannot be packed
    with pytest.raises(TypeError):
        mgr.wait_until_finished()
    mgr2 = CheckpointManager(str(tmp_path / "b"))
    fut = mgr2.save(1, {"bad": {1, 2}})
    fut.exception()
    with pytest.raises(TypeError):
        mgr2.save(2, {"ok": torch.ones(2)})
    mgr.close()
    mgr2.close()


def test_manager_snapshot_is_a_copy(tmp_path):
    """save() copies before it returns: writing the caller's tensor in
    place afterwards (as the engines do) changes nothing committed."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    gate = threading.Event()
    real = mgr._commit
    mgr._commit = lambda *a: (gate.wait(), real(*a))[1]
    w = torch.ones(16)
    fut = mgr.save(1, {"w": w, "n": np.ones(3)})
    w.fill_(-1.0)
    gate.set()
    fut.result()
    assert torch.equal(mgr.restore(1, device="cpu")["w"], torch.ones(16))
    mgr.close()
