"""The port's launch layer against the JAX reference: the sharding rules
(``launch.sharding``), the meta-device specs of ``launch.steps``, the
mesh builders (``launch.mesh``, a world of one on gloo in this process),
``build_average_fn``'s spellings, the analytic roofline
(``launch.roofline``), the meta-device dry run (``launch.dryrun``) and
mistral-large-123b's full size.

The rules are pure functions of paths and shapes: every registered
architecture's full-size tree, at model sizes 1, 2 and 16, with no client
axis, with ("clients",) and with ("pod", "data"), serving and training,
gives the reference's ``PartitionSpec``s entry for entry; so do the
decode caches and the train state.
"""
import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from _torch_threads import torch_one_thread  # noqa: F401
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.core import make_compressor as jmake
from repro.launch import roofline as jroofline
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import init_caches as jinit_caches
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import make_compressor, make_plan
from repro_torch.core.l2gd import UPDATE_CHUNK
from repro_torch.core.tree import spec_leaves, tree_leaves
from repro_torch.launch import dryrun, mesh, roofline, sharding, steps
from repro_torch.models import param_count

MISTRAL_PARAMS = 122_207_416_320


def _jspecs(tree):
    """The reference's spec tree as a list of tuples (tree order)."""
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))
    return [tuple(s) for s in leaves]


def _meta_shapes(jtree):
    return [tuple(s.shape) for s in jax.tree.leaves(jtree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_pspecs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    state, jstate = steps.state_specs(cfg, 4), jsteps.state_specs(jcfg, 4)
    assert [tuple(a.shape) for a in tree_leaves(state)] == \
        _meta_shapes(jstate)
    for size in (1, 2, 16):
        for cax in ((), ("clients",), ("pod", "data")):
            tree, jtree = (state.params, jstate.params) if cax \
                else (state.cache, jstate.cache)
            for serve in (False, True):
                got = spec_leaves(sharding.param_pspecs(
                    tree, size, cax, serve_mode=serve))
                want = _jspecs(jsharding.param_pspecs(
                    jtree, size, cax, serve_mode=serve))
                assert got == want, (size, cax, serve)
        got = sharding.train_state_pspecs(state, size)
        want = jsharding.train_state_pspecs(jstate, size)
        assert spec_leaves(got.params) == _jspecs(want.params)
        assert spec_leaves(got.cache) == _jspecs(want.cache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_and_meta_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    caches = steps.cache_specs(cfg, 16, 64)
    jcaches = jax.eval_shape(lambda: jinit_caches(jcfg, 16, 64))
    assert [tuple(a.shape) for a in tree_leaves(caches)] == \
        _meta_shapes(jcaches)
    assert all(a.device.type == "meta" for a in tree_leaves(caches))
    for size in (1, 2, 16):
        for batch_axis, seq_axis in (("data", None), (None, "data"),
                                     (("pod", "data"), None), (None, None)):
            sizes = {"pod": 2, "data": 8}
            got = spec_leaves(sharding.cache_pspecs(
                caches, size, batch_axis=batch_axis, seq_axis=seq_axis,
                axis_sizes=sizes))
            want = _jspecs(jsharding.cache_pspecs(
                jcaches, size, batch_axis=batch_axis, seq_axis=seq_axis,
                axis_sizes=sizes))
            assert got == want
    for name, shape in INPUT_SHAPES.items():
        got = steps.input_specs(cfg, shape, 16)
        want = jsteps.input_specs(jcfg, JSHAPES[name], 16)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert sharding.batch_pspec(("clients",), 3) == \
        tuple(jsharding.batch_pspec(("clients",), 3))


def test_mistral_full_size_on_meta():
    cfg = get_config("mistral-large-123b")
    params = steps.param_shapes(cfg)
    assert all(a.device.type == "meta" for a in tree_leaves(params))
    assert param_count(params) == MISTRAL_PARAMS
    for layers, count in ((1, 1_786_810_368), (2, 3_170_955_264)):
        cut = dataclasses.replace(cfg, n_layers=layers)
        assert param_count(steps.param_shapes(cut)) == count
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jget_config("mistral-large-123b"))


def test_mesh_builders_world_of_one():
    client = mesh.make_client_mesh(device="cpu")
    assert client.mesh_dim_names == ("clients",)
    assert mesh.client_axes(client) == ("clients",)
    assert mesh.n_clients_of(client) == 1
    assert mesh.model_shards_of(client) == 1
    train = mesh.make_train_mesh(model_shards=1, device="cpu")
    assert train.mesh_dim_names == ("clients", "model")
    assert mesh.model_shards_of(train) == 1
    prod = mesh.make_production_mesh(clients=1, model=1, device="cpu")
    assert prod.mesh_dim_names == ("clients", "model")
    axis = mesh.mesh_axis(train, ("clients", "model"))
    assert (axis.size, axis.index) == (1, 0)
    for bad in (dict(model_shards=0), dict(clients=2, model_shards=1),
                dict(model_shards=2)):
        with pytest.raises(ValueError):
            mesh.make_train_mesh(device="cpu", **bad)
    with pytest.raises(ValueError, match="256 processes"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="multi_pod"):
        mesh.make_production_mesh(multi_pod=True, clients=1, device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        mesh.mesh_axis(client, "model")


def test_entry_points_need_cuda_by_default():
    """Without a GPU and without device="cpu" the mesh layer raises, as
    every entry point of the port does (checked in a fresh process: this
    one has joined a gloo group)."""
    import subprocess
    import sys
    import os
    code = ("from repro_torch.launch.mesh import make_client_mesh\n"
            "try:\n    make_client_mesh()\n"
            "except RuntimeError as e:\n    print('RAISED', e)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), os.pardir, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "RAISED no CUDA device" in out.stdout, out.stdout + out.stderr


def test_world_of_one_store_removed_at_exit(tmp_path):
    """The world of one's FileStore directory lives in the temp dir while
    the process runs and is gone once it exits."""
    import os
    import subprocess
    import sys
    code = ("import glob, os, tempfile\n"
            "from repro_torch.launch.mesh import make_client_mesh\n"
            "make_client_mesh(device='cpu')\n"
            "print('DIRS', len(glob.glob(os.path.join(tempfile.gettempdir(),"
            " 'repro_pg_*'))))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=os.path.join(
        os.path.dirname(__file__), os.pardir, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "DIRS 1" in out.stdout, out.stdout + out.stderr
    assert not list(tmp_path.glob("repro_pg_*"))


def test_build_average_fn_spellings():
    from repro_torch.core.aggregation import make_packed_sharded_average
    m = mesh.make_client_mesh(1, device="cpu")
    specs = {"w": ("clients", None)}
    nat = make_compressor("natural")
    params = {"w": __import__("torch").ones(3, 4)}
    key = np.array([0, 3], np.uint32)
    plan = make_plan(make_compressor("qsgd"), {"w": np.zeros(4)},
                     transport="packed")
    fn = steps.build_average_fn(m, ("clients",), specs, nat, uplink=plan)
    with pytest.warns(DeprecationWarning):
        legacy = steps.build_average_fn("packed", m, ("clients",), specs,
                                        nat)
    packed = make_packed_sharded_average(m, ("clients",), specs, nat)
    a, b, c = (f(key, params)["w"] for f in (fn, legacy, packed))
    assert bool((a == b).all()) and bool((a == c).all())
    wire = steps.build_average_fn(m, ("clients",), specs, nat)
    assert wire(key, params)["w"].shape == (4,)
    with pytest.raises(TypeError, match="levels"):
        steps.build_average_fn(m, ("clients",), specs, nat, levels=7)
    with pytest.raises(ValueError, match="uplink"):
        steps.build_average_fn(m, ("clients",), specs, nat, uplink="bf16")
    with pytest.raises(ValueError, match="kind"):
        with pytest.warns(DeprecationWarning):
            steps.build_average_fn("int4", m, ("clients",), specs, nat)


def test_build_train_step_takes_an_average_fn():
    """The average_fn hook of build_train_step: a per-shard payload
    average on one process gives the same step as the default aggregation
    of the same packed plan."""
    import torch
    from repro_torch.core import L2GDHyper, init_state
    from repro_torch.launch.train import init_stacked_params
    cfg = dataclasses.replace(
        get_config("stablelm-1.6b").reduced(), n_layers=1, d_model=32,
        d_ff=64, n_heads=2, n_kv_heads=2, head_dim=16, vocab_size=64)
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.5, n=2)
    params = init_stacked_params(cfg, 2, 0, "cpu")
    m = mesh.make_client_mesh(1, device="cpu")
    shapes = steps.param_shapes(cfg)
    plan = make_plan(make_compressor("natural"), shapes, transport="packed")
    from repro_torch.core.tree import tree_map
    specs = tree_map(lambda a: ("clients",) + (None,) * (a.dim() - 1),
                     steps.stacked_param_shapes(cfg, 2))
    avg = steps.build_average_fn(m, ("clients",), specs,
                                 make_compressor("identity"), uplink=plan)
    step = steps.build_train_step(cfg, hp, plan, make_compressor("identity"),
                                  average_fn=avg)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 1, 8)).astype(np.int32))}
    key = np.array([0, 5], np.uint32)
    st, m1 = step(init_state(params)._replace(xi_prev=0), batch, 1, key)
    assert m1["branch"] == 1
    # the target is the packed payload's mean of the clients' local mean
    from repro_torch.core.aggregation import client_mean
    from repro_torch.core import prng
    k_up, _ = prng.split(key)
    mean = tree_map(lambda a: client_mean(a.float()), params)
    want = plan.decode(plan.encode(prng.fold_in(k_up, 0), mean))
    for a, b in zip(tree_leaves(st.cache), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_and_dry_run(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n_act = dryrun.n_params_active(cfg)
    from repro.launch.dryrun import n_params_active as jn_act
    assert n_act == jn_act(jcfg)
    for name, shape in INPUT_SHAPES.items():
        assert roofline.analytic_flops(cfg, shape, n_act) == \
            jroofline.analytic_flops(jcfg, JSHAPES[name], n_act)
    assert roofline.model_flops(n_act, 7) == jroofline.model_flops(n_act, 7)
    t = roofline.roofline_terms(67e12, 3.35e12, 0.0)
    assert (t["compute_s"], t["memory_s"], t["dominant"]) == \
        (1.0, 1.0, "compute")
    rec = dryrun.dry_run(arch, "train_4k", (16, 16))
    cfg16 = dryrun.production_cfg(cfg)
    up = make_plan(make_compressor("natural"), steps.param_shapes(cfg16),
                   transport="leafwise").round_bits()
    assert rec["aggregation"]["all_gather_bytes_per_process"] == 16 * up / 8
    state = steps.state_specs(cfg16, 16)
    specs = sharding.train_state_pspecs(state, 16, client_axis="data")
    total = sum(a.numel() * a.element_size()
                for a in tree_leaves(state.params))
    assert rec["memory_per_process"]["params_bytes"] <= total // 16
    assert rec["memory_per_process"]["params_bytes"] == \
        dryrun.sharded_bytes(state.params, specs.params,
                             {"data": 16, "model": 16})
    # a step of the 2-D engine, activations left out: a local step holds
    # the state and the gradient's blocks, plus the largest layer and the
    # table whole with their gradients or the new blocks with the
    # updates' float32 work on a chunk, whichever is more; an aggregation
    # step on 16 rows of one client the state and the target's blocks,
    # plus the new blocks with that work or the largest leaf piece (a
    # layer of a stack's leaf) at four float32 copies with the 16
    # clients' natural payloads of it, whichever is more
    shapes = steps.param_shapes(cfg16)
    nbytes = lambda tree: sum(a.numel() * a.element_size()
                              for a in tree_leaves(tree))
    depth = {"layers": cfg16.n_layers - cfg16.first_dense_layers,
             "dense_layers": cfg16.first_dense_layers,
             "encoder": cfg16.encoder_layers}
    layer = max(nbytes(shapes[g]) // n for g, n in depth.items()
                if g in shapes)
    if cfg16.is_encdec:
        layer = max(layer, (nbytes(shapes["layers"]) + nbytes(shapes["cross"]))
                    // cfg16.n_layers)
    mem = rec["memory_per_process"]
    params, cache = mem["params_bytes"], mem["cache_bytes"]
    work = 2 * UPDATE_CHUNK * 4
    local = 2 * params + cache + max(2 * (layer + nbytes(shapes["embed"])),
                                     params + work)
    stacked = set(depth) | {"cross"}
    piece = max(a.numel() // (a.shape[0] if g in stacked else 1)
                for g in shapes for a in tree_leaves(shapes[g]))
    transient = 16 * piece + 16 * (piece + -(-piece // 8))
    agg = 2 * params + cache + max(params + work, transient)
    assert rec["engine_step_bytes_per_process"] == max(local, agg)
    # below what gathering the row's whole models held: the state, the
    # whole model and its gradient, and the 16 clients' whole payloads
    assert rec["engine_step_bytes_per_process"] < \
        sum(mem.values()) + 2 * total // 16 + 16 * up / 8
    if arch == "mistral-large-123b":
        # 122.2 B bf16 params over 16 clients: one client's model a
        # client row, cut 16 ways over "model"
        assert rec["memory_per_process"]["params_bytes"] == \
            pytest.approx(2 * MISTRAL_PARAMS / 16, rel=0.01)
    assert math.isfinite(rec["roofline"]["compute_s"])
