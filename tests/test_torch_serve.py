"""The port's serving stack (``repro_torch.serve``, ``launch/serve.py``)
against the reference's (``repro.serve``).

Exact: the store's base, payload bytes per codec and transport (QSGD by
the layered rule of tests/test_torch_qsgd.py: bucket norms within
NORM_ULPS, codes equal wherever the norms are, everything else equal),
``models_per_gb`` (by cohort too) and ``dense_models_per_gb``, the files
each package's store saves and loads, ``from_checkpoint`` from all three
sources (a delta snapshot the reference wrote among them), the LRU's
eviction sequence and counters, ``prng.randint`` against
``jax.random.randint``.  Materialized tenants equal the reference's
given the same payload, and are within one quantization level of it from
the port's own QSGD payload.

The engine: mixed-tenant logits equal solo logits BIT FOR BIT (each row
runs its own batch-1 decode step, as the reference's ``lax.map``); the
greedy tokens equal the reference engine's up to the first step whose
top-2 logit gap is within 2 x DECODE_TOL (chip_smoke.top2_gap's rule:
the reference's and the port's float sums may order the two top logits
differently there); ``vmap`` tokens equal ``map`` tokens.
"""
import copy
import dataclasses
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
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import pack as jpack
from repro.configs.base import get_config as jget_config
from repro.core import L2GDHyper as JHyper
from repro.core import make_compressor as jmake
from repro.core import make_plan as jplan
from repro.core import widen_tree_qsgd as jwiden
from repro.fl import run_l2gd as jrun
from repro.fl.fleet import FleetPlan as JFleet
from repro.models import init_params as jinit_params
from repro.serve import DeltaModelStore as JStore
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.checkpoint import CheckpointPolicy
from repro_torch.checkpoint import pack as tpack
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import (L2GDHyper, Identity, NarrowQSGDPayload,
                              make_compressor, make_plan, prng)
from repro_torch.core.flatbuf import widen_tree_qsgd
from repro_torch.core.tree import tree_leaves
from repro_torch.fl import run_l2gd
from repro_torch.fl.fleet import FleetPlan
from repro_torch.launch import serve as tserve
from repro_torch.serve import DeltaModelStore, Request, ServingEngine

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
NORM_ULPS = 4                  # tests/test_torch_qsgd.py
DECODE_TOL = 2e-4              # chip_smoke.DECODE_TOL
COMBOS = [("identity", "leafwise"), ("qsgd", "leafwise"),
          ("natural", "leafwise"), ("qsgd", "flat"), ("qsgd", "packed"),
          ("natural", "flat"), ("natural", "packed"), ("qsgd4", "packed")]


def _stacked(n=3, seed=0):
    """(reference, port) client-stacked trees of mixed shapes with ragged
    buckets, from one seed."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    j = {"w": jax.random.normal(ks[0], (n, 33, 7)),
         "layers": [{"b": jax.random.normal(ks[1], (n, 65))}],
         "head": jax.random.normal(ks[2], (n, 5))}
    return j, params_from_numpy(jax.tree.map(np.asarray, j))


def _plans(codec, transport):
    """(reference plan, port plan, narrow)."""
    if codec == "qsgd4":
        return (jplan(jmake("qsgd", levels=7), transport=transport),
                make_plan(make_compressor("qsgd", levels=7),
                          transport=transport), True)
    return (jplan(jmake(codec), transport=transport),
            make_plan(make_compressor(codec), transport=transport), False)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arrays(p):
    """{path: array} of a payload's wire arrays (TreePayload: per leaf)."""
    if hasattr(p, "leaves"):
        out = {}
        for i, q in enumerate(p.leaves):
            out.update({f"{i}.{k}": v for k, v in _arrays(q).items()})
        return out
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)
            if isinstance(getattr(p, f.name), (torch.Tensor, jax.Array))}


def _with_arrays(p, arrays, prefix=""):
    """The port payload ``p`` carrying the given wire arrays."""
    if hasattr(p, "leaves"):
        return dataclasses.replace(p, leaves=tuple(
            _with_arrays(q, arrays, f"{prefix}{i}.")
            for i, q in enumerate(p.leaves)))
    return dataclasses.replace(p, **{
        f.name: torch.from_numpy(np.array(arrays[prefix + f.name]))
        for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)})


def _wide(p):
    if type(p).__name__ != "NarrowQSGDPayload":
        return p
    return widen_tree_qsgd(p) if isinstance(p, NarrowQSGDPayload) \
        else jwiden(p)


def _assert_layered(jp, tp):
    """Bucket norms within NORM_ULPS, codes equal wherever the norms are,
    every other array equal, and given the reference's arrays the
    port's payload packs to the reference's bytes."""
    want, got = _arrays(_wide(jp)), _arrays(_wide(tp))
    assert set(want) == set(got)
    for name in want:
        w, g = _np(want[name]), _np(got[name])
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if not name.endswith("norms"):
            continue
        assert np.max(np.abs(w - g) / np.spacing(np.maximum(
            np.abs(w), 1e-30))) <= NORM_ULPS, name
        same = (w == g)[..., 0]
        codes = name[:-len("norms")] + "codes"
        cw, cg = _np(want[codes]), _np(got[codes])
        if cw.ndim == same.ndim + 1:           # (nb, bucket) flat codes
            np.testing.assert_array_equal(cg[same], cw[same])
        else:                                  # leafwise: (d,) codes
            b = cw.shape[-1] // max(same.shape[-1], 1) or 1
            mask = np.repeat(same, b)[:cw.shape[-1]]
            np.testing.assert_array_equal(cg[mask], cw[mask])
    for name in want:
        if not (name.endswith("norms") or name.endswith("codes")):
            np.testing.assert_array_equal(_np(got[name]), _np(want[name]))
    given = _with_arrays(tp, {k: _np(v) for k, v in _arrays(jp).items()})
    assert tpack.pack_bytes({"p": given}) == jpack.pack_bytes({"p": jp})
    return given


@pytest.mark.parametrize("codec,transport", COMBOS)
def test_store_equals_reference(codec, transport):
    jstacked, tstacked = _stacked()
    jp, tp, narrow = _plans(codec, transport)
    js = JStore.from_params(jstacked, jp, key=jax.random.PRNGKey(3),
                            narrow=narrow)
    ts = DeltaModelStore.from_params(tstacked, tp, key=prng.PRNGKey(3),
                                     narrow=narrow)
    for a, b in zip(tree_leaves(ts.base), jax.tree_util.tree_leaves(js.base)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ts.tenants == js.tenants
    for tid in ts.tenants:
        jpay, tpay = js.payload(tid), ts.payload(tid)
        assert type(tpay).__name__ == type(jpay).__name__
        assert ts.tenant_bits(tid) == js.tenant_bits(tid)
        given = _assert_layered(jpay, tpay)
        # given the reference's payload, the tenant equals the
        # reference's bit for bit.  The flat engine's materialize as the
        # reference's engine calls it (its decode is a compiled kernel);
        # the leafwise codecs' compiled, as the reference runs them
        # inside its steps (XLA divides by a constant as a multiply by
        # its reciprocal, as the port does; tests/test_torch_leafwise.py)
        # — except leafwise QSGD, whose one-leaf scale ``norm / levels``
        # the reference rounds in another order eagerly (a division) and
        # compiled (reassociated into the product): held within one ulp
        materialize = lambda: js.materialize(tid)
        if transport == "leafwise":
            materialize = jax.jit(materialize)
        want = jax.tree_util.tree_leaves(materialize())
        mine = copy.copy(ts)
        mine._payloads = {tid: given}
        for a, b in zip(tree_leaves(mine.materialize(tid)), want):
            b = np.asarray(b)
            ulp = np.spacing(np.abs(b).max()) \
                if (codec, transport) == ("qsgd", "leafwise") else 0.0
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ulp)
        # the port's own payload: within one level of the reference
        for a, b in zip(tree_leaves(ts.materialize(tid)), want):
            b = np.asarray(b)
            level = 0.0 if "qsgd" not in codec else 4 * 8 / 7
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=level + np.spacing(
                                           np.abs(b).max()))
    for f in ("models_per_gb", "base_bits", "total_bits"):
        assert getattr(ts, f)() == getattr(js, f)()
    for bits in (16.0, 32.0):
        assert ts.dense_models_per_gb(bits) == js.dense_models_per_gb(bits)


def test_models_per_gb_by_cohort_equals_reference():
    jstacked, tstacked = _stacked(n=6)
    specs = [("identity", "leafwise", {}), ("natural", "flat", {}),
             ("qsgd", "packed", {"levels": 4, "narrow": True})]
    jcoh, tcoh = [], []
    for name, transport, kw in specs:
        levels = {"levels": kw["levels"]} if "levels" in kw else {}
        narrow = kw.get("narrow", False)
        jcoh.append(jplan(jmake(name, **levels), transport=transport,
                          narrow=narrow))
        tcoh.append(make_plan(make_compressor(name, **levels),
                              transport=transport, narrow=narrow))
    assignment = (0, 1, 2, 1, 2, 0)
    js = JStore.from_params(jstacked, JFleet(tuple(jcoh), assignment),
                            key=jax.random.PRNGKey(2))
    ts = DeltaModelStore.from_params(tstacked, FleetPlan(tuple(tcoh),
                                                         assignment),
                                     key=prng.PRNGKey(2))
    assert ts.models_per_gb_by_cohort() == js.models_per_gb_by_cohort()
    assert len(ts.models_per_gb_by_cohort()) == 3
    assert ts.models_per_gb() == js.models_per_gb()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_files_cross_load(writer, tmp_path):
    jstacked, tstacked = _stacked()
    jp, tp, _ = _plans("natural", "packed")
    js = JStore.from_params(jstacked, jp, key=jax.random.PRNGKey(5),
                            ids=["a", "b", "c"])
    ts = DeltaModelStore.from_params(tstacked, tp, key=prng.PRNGKey(5),
                                     ids=["a", "b", "c"])
    jq = jplan(jmake("qsgd", levels=7), transport="packed", narrow=True)
    tq = make_plan(make_compressor("qsgd", levels=7), transport="packed",
                   narrow=True)
    one_j = jax.tree.map(lambda a: a[0] * 0.5, jstacked)
    js.add_tenant("q", one_j, plan=jq)
    ts.add_tenant("q", params_from_numpy(jax.tree.map(np.asarray, one_j)),
                  plan=tq)
    path = str(tmp_path / "store.ckpt")
    if writer == "port":
        ts.save(path)
        back = JStore.load(path)
        src = ts
    else:
        js.save(path)
        back = DeltaModelStore.load(path, device="cpu")
        src = js
    assert back.tenants == ["a", "b", "c", "q"]
    assert back.tenant_plan("q").narrow and back.plan.transport == "packed"
    # each side packs and flattens with its own package
    pack_src, pack_back = (tpack, jpack) if writer == "port" \
        else (jpack, tpack)
    leaves = {tpack: tree_leaves, jpack: jax.tree_util.tree_leaves}
    for tid in back.tenants:
        assert pack_back.pack_bytes({"p": back.payload(tid)}) \
            == pack_src.pack_bytes({"p": src.payload(tid)})
        for a, b in zip(leaves[pack_back](back.materialize(tid)),
                        leaves[pack_src](src.materialize(tid))):
            np.testing.assert_array_equal(_np(a), _np(b))
    assert back.models_per_gb() == src.models_per_gb()


N, D = 4, 12


def _quad(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def test_from_checkpoint_three_sources(tmp_path):
    """A save_state file, a dense rollout snapshot (plans re-encode) and
    a delta snapshot the reference wrote (payloads adopted as stored)."""
    jstacked, tstacked = _stacked()
    plan = make_plan(make_compressor("natural"), transport="packed")
    path = str(tmp_path / "state.ckpt")
    checkpoint.save_state(path, tstacked, {"round": 9})
    mem = DeltaModelStore.from_params(tstacked, plan, key=prng.PRNGKey(13))
    ck = DeltaModelStore.from_checkpoint(path, plan, key=prng.PRNGKey(13),
                                         device="cpu")
    for tid in mem.tenants:
        assert tpack.pack_bytes(ck.payload(tid)) \
            == tpack.pack_bytes(mem.payload(tid))

    batch = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(7), (N, D))))
    hp = L2GDHyper(eta=0.1, lam=0.5, p=0.4, n=N)
    root = str(tmp_path / "dense")
    pol = CheckpointPolicy(root)
    run = run_l2gd(prng.PRNGKey(3), {"w": torch.zeros(N, D)}, _quad, hp,
                   lambda k: batch, 12, client_comp=make_compressor("qsgd"),
                   chunk=6, checkpoint_policy=pol, device="cpu")
    pol.resolve().close()
    with pytest.raises(ValueError, match="plan"):
        DeltaModelStore.from_checkpoint(root, device="cpu")
    dense = DeltaModelStore.from_checkpoint(root, plan=Identity(),
                                            device="cpu")
    np.testing.assert_allclose(dense.materialize("1")["w"].numpy(),
                               run.state.params["w"][1].numpy(), rtol=0,
                               atol=1e-6)

    droot = str(tmp_path / "delta")
    jpol = JPolicy(droot, mode="delta", delta_plan=jmake("natural"))
    jrun(jax.random.PRNGKey(3), {"w": jnp.zeros((N, D))},
         lambda p, b: (0.5 * jnp.sum((p["w"] - b) ** 2),
                       {"w": p["w"] - b}),
         JHyper(eta=0.1, lam=0.5, p=0.4, n=N), lambda k: batch.numpy(), 12,
         client_comp=jmake("qsgd"), chunk=6, checkpoint_policy=jpol)
    jpol.resolve().close()
    jstore = JStore.from_checkpoint(droot)
    tstore = DeltaModelStore.from_checkpoint(droot, device="cpu")
    assert tstore.tenants == jstore.tenants == [str(i) for i in range(N)]
    for tid in tstore.tenants:
        assert tpack.pack_bytes({"p": tstore.payload(tid)}) \
            == jpack.pack_bytes({"p": jstore.payload(tid)})
        np.testing.assert_array_equal(
            tstore.materialize(tid)["w"].numpy(),
            np.asarray(jstore.materialize(tid)["w"]))
    # the port's own delta snapshot too
    proot = str(tmp_path / "pdelta")
    pol = CheckpointPolicy(proot, mode="delta",
                           delta_plan=make_compressor("natural"))
    run_l2gd(prng.PRNGKey(3), {"w": torch.zeros(N, D)}, _quad, hp,
             lambda k: batch, 12, client_comp=make_compressor("qsgd"),
             chunk=6, checkpoint_policy=pol, device="cpu")
    pol.resolve().close()
    assert len(DeltaModelStore.from_checkpoint(proot, device="cpu")) == N


def test_lru_eviction_equals_reference():
    jstacked, tstacked = _stacked(n=4)
    jp, tp, _ = _plans("identity", "leafwise")
    cfg, jcfg = _cfgs("stablelm-1.6b")
    je = JEngine(JStore.from_params(jstacked, jp), jcfg, cache_capacity=2)
    te = ServingEngine(DeltaModelStore.from_params(tstacked, tp), cfg,
                       cache_capacity=2)
    for tid in ["0", "1", "0", "2", "3", "1", "0", "0", "2"]:
        je.params_for(tid)
        te.params_for(tid)
    assert te.metrics.eviction_log == je.metrics.eviction_log \
        == ["1", "0", "2", "3", "1"]
    assert (te.metrics.hits, te.metrics.misses) \
        == (je.metrics.hits, je.metrics.misses)
    assert te.resident_tenants == je.resident_tenants


def test_engine_and_request_validation():
    _, tstacked = _stacked()
    store = DeltaModelStore.from_params(tstacked, Identity())
    encdec = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                                 is_encdec=True)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(store, encdec)
    with pytest.raises(ValueError, match="batch_mode"):
        ServingEngine(store, get_config("stablelm-1.6b").reduced(),
                      batch_mode="pmap")
    with pytest.raises(ValueError, match="prompt"):
        Request("0", (), gen=2)
    with pytest.raises(ValueError, match="gen"):
        Request("0", (1, 2), gen=0)
    with pytest.raises(ValueError, match="narrow"):
        DeltaModelStore.from_params(tstacked, make_plan(
            make_compressor("qsgd"), transport="packed"), narrow=True)


# ---------------------------------------------------------------------------
# the engine on reduced models with the reference's weights
# ---------------------------------------------------------------------------

PROMPT = (3, 7, 11, 2)
GEN = 4


def _cfgs(arch):
    return (dataclasses.replace(get_config(arch).reduced(), vocab_size=64),
            dataclasses.replace(jget_config(arch).reduced(), vocab_size=64))


def _served(arch):
    """Both engines on a 3-tenant natural store of the reference's
    weights: the port mixed (map), each tenant solo, mixed (vmap); the
    reference mixed."""
    cfg, jcfg = _cfgs(arch)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jstacked = jax.vmap(lambda k: jinit_params(k, jcfg))(keys)
    tstacked = params_from_numpy(jax.tree.map(np.asarray, jstacked))
    jp, tp, _ = _plans("natural", "packed")
    js = JStore.from_params(jstacked, jp, key=jax.random.PRNGKey(1))
    ts = DeltaModelStore.from_params(tstacked, tp, key=prng.PRNGKey(1))
    prompts = [PROMPT, (5, 1, 9, 60), (63, 0, 2, 2)]
    reqs = [Request(t, p, gen=GEN) for t, p in zip(ts.tenants, prompts)]
    eng = ServingEngine(ts, cfg, cache_capacity=2, max_batch=3)
    mixed = eng.serve(reqs, return_logits=True)
    solo = [ServingEngine(ts, cfg, cache_capacity=1, max_batch=1)
            .serve([r], return_logits=True)[0] for r in reqs]
    vmapped = ServingEngine(ts, cfg, cache_capacity=3, max_batch=3,
                            batch_mode="vmap").serve(reqs)
    ref = JEngine(js, jcfg, cache_capacity=2, max_batch=3).serve(
        [JRequest(r.tenant, r.prompt, gen=GEN) for r in reqs])
    return eng, mixed, solo, vmapped, ref


@pytest.fixture(scope="module", params=["stablelm-1.6b", "gemma3-1b"])
def served(request):
    return _served(request.param)


def test_mixed_tenant_logits_equal_solo(served):
    """KEYSTONE: one batch mixing 3 tenants gives each request the
    logits and tokens of serving it alone, bit for bit."""
    _, mixed, solo, _, _ = served
    assert all(r["batch_size"] == 3 for r in mixed)
    for m, s in zip(mixed, solo):
        assert m["tenant"] == s["tenant"] and s["batch_size"] == 1
        assert m["logits"].shape == (len(PROMPT) + GEN - 1, 64)
        assert np.array_equal(m["logits"], s["logits"])
        assert np.array_equal(m["tokens"], s["tokens"])
        assert len(m["tokens"]) == len(PROMPT) + GEN


def test_greedy_tokens_equal_reference(served):
    _, mixed, _, _, ref = served
    P = len(PROMPT)
    for m, r in zip(mixed, ref):
        top = np.sort(m["logits"], axis=-1)
        clear = (top[:, -1] - top[:, -2]) > 2 * DECODE_TOL
        assert np.array_equal(m["tokens"][:P], r["tokens"][:P])
        for j in range(GEN):
            if not clear[P - 1 + j]:
                break
            assert m["tokens"][P + j] == r["tokens"][P + j]
        assert clear[P - 1]        # the first generated token is compared


def test_vmap_tokens_equal_map(served):
    _, mixed, _, vmapped, _ = served
    for m, v in zip(mixed, vmapped):
        assert np.array_equal(m["tokens"], v["tokens"])


def test_cold_then_warm_metrics(served):
    eng, _, _, _, _ = served
    cold = eng.metrics.snapshot()
    assert cold["misses"] == 3 and cold["batches"] == 1
    eng.serve([Request(t, PROMPT, gen=GEN) for t in eng.store.tenants[1:]])
    warm = eng.metrics.snapshot()
    assert warm["hits"] > cold["hits"] and warm["batches"] == 2
    for tid in eng.store.tenants[1:]:
        s = warm["tenants"][tid]
        assert s["requests"] == 2 and s["tokens_generated"] == 2 * GEN
        assert s["mean_ttft_s"] > 0 and s["tokens_per_s"] > 0


@pytest.mark.parametrize("shape,lo,hi", [
    ((4, 8), 0, 512), ((1000,), 0, 100_000), ((777,), -7, 13),
    ((300,), 5, 5), ((64,), 10, 2), ((50,), -2 ** 31, 2 ** 31 - 1),
    ((2000,), 0, 3), ((3, 5), 0, 262_144)])
def test_randint_equals_jax(shape, lo, hi):
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, shape, lo, hi, jnp.int32))
        got = prng.randint(np.asarray(key), shape, lo, hi)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", tserve.CODECS)
def test_serve_cli_runs_on_the_cpu(codec, capsys):
    store, engine, results = tserve.main(
        ["--device", "cpu", "--codec", codec, "--tenants", "2",
         "--prompt-len", "3", "--gen", "2", "--arch", "stablelm-1.6b"])
    out = capsys.readouterr().out
    assert "models/GB" in out and "hits=" in out
    assert len(results) == 2 and all(len(r["tokens"]) == 5 for r in results)
    want = np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(0), 3), (2, 3), 0, 512,
        jnp.int32))
    assert [list(r["tokens"][:3]) for r in results] == want.tolist()
    assert engine.metrics.misses == 2


def test_serve_path_loads_no_jax(tmp_path):
    """The checkpoint and serve paths import neither jax nor the JAX
    package: a run with snapshots and its resume, a train CLI run that
    saves its params, and the serve CLI ingesting that file."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        import repro_torch.kernels
        from repro_torch.checkpoint import CheckpointPolicy
        from repro_torch.core import L2GDHyper, make_compressor, prng
        from repro_torch.fl import run_l2gd
        from repro_torch.launch import serve, train

        def quad(p, b):
            g = p["w"] - b
            return 0.5 * torch.sum(g ** 2, dim=1), {{"w": g}}

        root = {str(tmp_path / "ck")!r}
        kw = dict(client_comp=make_compressor("natural"), chunk=2,
                  device="cpu")
        args = (prng.PRNGKey(0), {{"w": torch.zeros(2, 5)}}, quad,
                L2GDHyper(eta=0.1, lam=0.5, p=0.4, n=2),
                lambda k: torch.ones(2, 5), 4)
        pol = CheckpointPolicy(root)
        run_l2gd(*args, checkpoint_policy=pol, **kw)
        pol.resolve().close()
        run_l2gd(*args, resume_from=root, resume_step=2, **kw)
        single = {str(tmp_path / "final.ckpt")!r}
        train.main(["--clients", "2", "--batch", "1", "--seq", "4",
                    "--steps", "1", "--ckpt", single], device="cpu")
        serve.main(["--device", "cpu", "--arch", "stablelm-1.6b",
                    "--ckpt", single, "--gen", "2", "--prompt-len", "2",
                    "--codec", "qsgd4"])
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "repro"
               or m.startswith("repro.") or m == "msgpack"]
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ingested 2 tenants" in out.stdout
