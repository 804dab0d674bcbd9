"""Rank functions for the multi-process tests of the port
(``repro_torch.launch.mesh.run_cpu_ranks``): each runs in a spawned CPU
process of a gloo group and returns numpy, and imports neither jax nor
the reference, so a spawn pays only for torch.

Not a test module (no ``test_`` prefix): the spawned processes import it
by name from the tests directory, which the parent puts on ``sys.path``.
"""
import dataclasses

import numpy as np
import torch

N, D = 4, 12


def _quad_grad(params, batch):
    g = params["w"] - batch
    return 0.5 * torch.sum(g ** 2, dim=1), {"w": g}


def quad_plan(name, transport, d=D):
    from repro_torch.core import make_compressor, make_plan
    return make_plan(make_compressor(name), {"w": torch.zeros(d)},
                     transport=transport)


def mixed_fleet(d=D, n=N):
    """Three cohorts over n clients: packed QSGD, flat natural, leafwise
    identity (client i in cohort i % 3)."""
    from repro_torch.fl.fleet import FleetPlan
    plans = (quad_plan("qsgd", "packed", d), quad_plan("natural", "flat", d),
             quad_plan("identity", "leafwise", d))
    return FleetPlan(cohorts=plans,
                     assignment=tuple(i % 3 for i in range(n)))


def _quad_runs(cases, batch, key, mesh):
    from repro_torch.core import init_state, make_hyper
    from repro_torch.core.rollout import rollout_l2gd, rollout_l2gd_sharded
    hp = make_hyper(eta=0.3, lam=1.0, p=0.5, n=N)
    out = []
    for name, transport, participation, xi in cases:
        up = mixed_fleet() if name == "fleet" else quad_plan(name, transport)
        down = quad_plan("identity", "leafwise") if name == "fleet" else up
        kw = dict(grad_fn=_quad_grad, client_comp=up, master_comp=down,
                  participation=participation, batch_axis=None)
        xi = None if xi is None else np.asarray(xi, np.int32)
        st0 = init_state({"w": torch.zeros(N, D)})
        sh, shtr = rollout_l2gd_sharded(key, st0, hp, batch, xi, mesh=mesh,
                                        steps=None if xi is not None else 14,
                                        **kw)
        stk, stktr = rollout_l2gd(key, st0, hp, batch, xi,
                                  steps=None if xi is not None else 14, **kw)
        out.append({"params": sh.params["w"].numpy(),
                    "cache": sh.cache["w"].numpy(),
                    "losses": shtr.losses.numpy(), "xis": shtr.xis,
                    "stacked_params": stk.params["w"].numpy(),
                    "stacked_cache": stk.cache["w"].numpy(),
                    "stacked_losses": stktr.losses.numpy(),
                    "stacked_xis": stktr.xis,
                    "counts": (shtr.n_local, shtr.n_agg_comm,
                               shtr.n_agg_cached)})
    return out


def sharded_quad_rollouts(rank, world, cases, batch_np, key):
    """The client-sharded rollout of the quadratic fixture, each case also
    run stacked in-process; this rank's params, the cache, losses, xis."""
    from repro_torch.launch.mesh import make_client_mesh
    mesh = make_client_mesh(world, device="cpu")
    return _quad_runs(cases, torch.from_numpy(batch_np), key, mesh)


def shard_averages(rank, world, params_np, key):
    """The per-shard averages at ``world`` processes on a ("clients",)
    mesh, each process holding its block of the stacked params: packed
    QSGD and packed natural payloads, the bf16 wire, and
    compressed_average_wire with one client a process; and this process's
    packed QSGD message (codes and norms)."""
    from repro_torch.core import make_compressor, prng
    from repro_torch.core.aggregation import (client_mean,
                                              compressed_average_wire,
                                              make_payload_sharded_average,
                                              make_sharded_average)
    from repro_torch.core.collective import GATHERED, reset_gathered
    from repro_torch.launch.mesh import make_client_mesh, mesh_axis
    from repro_torch.launch.sharding import local_slice
    mesh = make_client_mesh(world, device="cpu")
    spec = ("clients", None)
    params = {"w": torch.from_numpy(params_np)}
    local = {"w": local_slice(mesh, spec, params["w"])}
    d = params_np.shape[1]
    out = {}
    reset_gathered()
    for name in ("qsgd", "natural"):
        fn = make_payload_sharded_average(
            mesh, ("clients",), {"w": spec}, make_compressor("identity"),
            quad_plan(name, "packed", d))
        out["payload_" + name] = fn(key, local)["w"].numpy()
    out["gathered_bytes"] = GATHERED["bytes"]
    # this process's packed QSGD message, as the payload average builds it
    msg = quad_plan("qsgd", "packed", d).encode(
        prng.fold_in(prng.split(key)[0], rank),
        {"w": client_mean(local["w"].float())})
    out["qsgd_codes"], out["qsgd_norms"] = msg.codes.numpy(), \
        msg.norms.numpy()
    wire = make_sharded_average(mesh, ("clients",), {"w": spec},
                                make_compressor("natural"))
    out["wire"] = wire(key, local)["w"].numpy()
    one = {"w": local_slice(mesh, spec, params["w"][:world])[0]}
    out["wire_one"] = compressed_average_wire(
        key, one, make_compressor("identity"),
        mesh_axis(mesh, "clients"))["w"].numpy()
    return out


def _tiny_lm(dtype="float32", remat_policy="full"):
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("stablelm-1.6b").reduced(), n_layers=2, d_model=64,
        d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=256,
        param_dtype=dtype, compute_dtype=dtype, remat_policy=remat_policy)


def mesh2d_rollouts(rank, world, params_np, tokens_np, key):
    """The 2-D engine of the tiny LM on a (1, world) and a (world, 1) mesh
    (natural both ways, leafwise; each layer gathered whole,
    ``gather_layers``, with remat on, which that needs on more than one
    model shard), each against build_rollout_fn run in-process without
    remat, and the sharding helpers on the (1, world) mesh."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import init_state, make_compressor, make_hyper
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import (build_rollout_fn,
                                          build_sharded_rollout_fn)
    init_process_group("cpu")
    cfg = _tiny_lm(remat_policy="dots")
    n = tokens_np.shape[1]
    hp = make_hyper(eta=0.1, lam=0.5, p=0.5, n=n)
    comp = make_compressor("natural")
    params = params_from_numpy(params_np)
    batches = {"tokens": torch.from_numpy(tokens_np)}
    length = tokens_np.shape[0]
    kw = dict(client_comp=comp, master_comp=comp, length=length)
    ref, rtr = build_rollout_fn(dataclasses.replace(cfg,
                                                    remat_policy="full"),
                                hp, **kw)(init_state(params), batches, key)
    out = {"ref_xis": rtr.xis, "ref_losses": rtr.losses.numpy(),
           "ref_params": [a.numpy() for a in tree_leaves(ref.params)],
           "ref_cache": [a.numpy() for a in tree_leaves(ref.cache)]}
    for shape in ((1, world), (world, 1)):
        mesh = make_mesh(shape, ("clients", "model"), "cpu")
        roll = build_sharded_rollout_fn(dataclasses.replace(cfg, remat=True),
                                        hp, mesh=mesh, gather_layers=True,
                                        **kw)
        st, tr = roll(init_state(params), batches, key)
        full = roll.full_state(st)
        out[shape] = {
            "xis": tr.xis, "losses": tr.losses.numpy(),
            "params": [a.numpy() for a in tree_leaves(full.params)],
            "cache": [a.numpy() for a in tree_leaves(full.cache)],
            "local_shapes": [tuple(a.shape) for a in tree_leaves(st.params)]}
    # the sharding helpers on the (1, world) mesh
    mesh = make_mesh((1, world), ("clients", "model"), "cpu")
    table = params["embed"]["table"]
    spec = sharding.param_pspecs({"embed": {"table": table}}, world,
                                 client_axes=("clients",))["embed"]["table"]
    out["table_spec"] = spec
    out["placements"] = [repr(p) for p in sharding.placements(mesh, spec)]
    out["table_local"] = sharding.local_slice(mesh, spec, table).numpy()
    state = sharding.train_state_shardings(mesh, init_state(params))
    out["state_local_shapes"] = [tuple(a.shape)
                                 for a in tree_leaves(state.params)]
    bl = sharding.train_batch_shardings(mesh, batches)
    out["batch_local_shape"] = tuple(bl["tokens"].shape)
    return out


def _same_bits(a, b):
    """Every leaf of two float32 trees equal bit for bit (NaNs too)."""
    from repro_torch.core.tree import tree_leaves
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def whole_tree_average(key, tree, plan, mask=None, guarded=True):
    """The leafwise average written as one call a tree: every client's
    whole tree through ``plan`` (keys of the global schedule), the mean
    over clients (``guarded``: clients with a non-finite leaf leave it
    unless all are finite, as one client row averages; else the plain
    masked mean of the decoded payloads, as several rows do), then C_M on
    the whole mean."""
    from repro_torch.core import prng
    from repro_torch.core.aggregation import (all_finite, masked_client_mean,
                                              stacked_finite_mask,
                                              weighted_client_sum)
    from repro_torch.core.tree import tree_leaves, tree_map
    n = tree_leaves(tree)[0].shape[0]
    k_clients, k_master = prng.split(key)
    keys = prng.split(k_clients, n)
    if not guarded:
        ybar = masked_client_mean(plan.decode(plan.encode(keys, tree)), mask)
        return plan.apply(k_master, ybar)
    c = plan.apply(keys, tree)
    fin = stacked_finite_mask(c)
    w = fin if mask is None else mask.to(torch.float32) * fin
    safe = torch.where(w.sum() > 0, w.sum(), torch.ones(()))
    plain = masked_client_mean(c, mask)
    ybar = plain if bool(all_finite(fin)) else tree_map(
        lambda s_: s_ / safe.to(s_.dtype), weighted_client_sum(c, w))
    return plan.apply(k_master, ybar)


def _peak_of(fn):
    """(fn(), the most bytes of gathered whole tensors that it made alive
    at once, over those alive before it ran)."""
    from repro_torch.core.collective import GATHERED, reset_gathered
    reset_gathered()
    before = GATHERED["live"]
    out = fn()
    return out, GATHERED["peak"] - before


def mesh2d_layer_runs(rank, world, cases, key, local_key, agg_vocab):
    """For each case (name, arch, config changes, remat policy, stacked
    numpy params, numpy batches over steps): build_rollout_fn (remat off)
    and the 2-D engine gathering each layer whole (``gather_layers``) on
    a (1, world) mesh (remat on), the engine's gathered state; then the
    engine's peak of gathered bytes over one local step (``local_key``
    draws xi 0 first), and the leafwise average
    a leaf piece at a time against the whole-tree averages (one row;
    several rows' path on the size-1 clients axis) with the first case's
    config at vocab ``agg_vocab``, natural and QSGD, unmasked and masked,
    on its seeded params and with client 1's table made non-finite in one
    element; and the engine's error with remat off."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import init_state, make_compressor, make_hyper
    from repro_torch.core import make_plan
    from repro_torch.core.aggregation import (ModelCut, compressed_average,
                                              make_client_sharded_average)
    from repro_torch.core.collective import MeshAxis
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import (_ModelShards, build_rollout_fn,
                                          build_sharded_rollout_fn,
                                          param_shapes, stacked_param_shapes)
    from repro_torch.launch.train import init_stacked_params
    from repro_torch.models.model import layer_stacks
    init_process_group("cpu")
    mesh = make_mesh((1, world), ("clients", "model"), "cpu")
    comp = make_compressor("natural")
    out = {}
    for name, arch, changes, policy, params_np, batches_np in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        engine_cfg = dataclasses.replace(cfg, remat=True,
                                         remat_policy=policy)
        n = next(iter(batches_np.values())).shape[1]
        length = next(iter(batches_np.values())).shape[0]
        hp = make_hyper(eta=0.1, lam=0.5, p=0.5, n=n)
        kw = dict(client_comp=comp, master_comp=comp, length=length)
        params = params_from_numpy(params_np)
        batches = {k: torch.from_numpy(v) for k, v in batches_np.items()}
        ref, rtr = build_rollout_fn(cfg, hp, **kw)(init_state(params),
                                                  batches, key)
        roll = build_sharded_rollout_fn(engine_cfg, hp, mesh=mesh,
                                        gather_layers=True, **kw)
        st, tr = roll(init_state(params), batches, key)
        full = roll.full_state(st)
        one = dict(kw, length=1)
        local = build_sharded_rollout_fn(engine_cfg, hp, mesh=mesh,
                                         gather_layers=True, **one)
        (_, ltr), step_peak = _peak_of(lambda: local(
            init_state(params), tree_map(lambda a: a[:1], batches),
            local_key))
        out[name] = {
            "ref_xis": rtr.xis, "ref_branches": rtr.branches,
            "ref_losses": rtr.losses.numpy(),
            "ref_params": [a.numpy() for a in tree_leaves(ref.params)],
            "ref_cache": [a.numpy() for a in tree_leaves(ref.cache)],
            "xis": tr.xis, "losses": tr.losses.numpy(),
            "params": [a.numpy() for a in tree_leaves(full.params)],
            "cache": [a.numpy() for a in tree_leaves(full.cache)],
            "local_shapes": [tuple(a.shape) for a in tree_leaves(st.params)],
            "local_branches": ltr.branches, "step_peak": step_peak}
    # the aggregation a leaf piece at a time, on a narrow-vocab case of the
    # first family (a layer of a stack outweighs the table), natural and
    # QSGD (its buckets divide a layer)
    name, arch, changes, _, params_np, _ = cases[0]
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              **dict(changes, vocab_size=agg_vocab))
    n = tree_leaves(params_np)[0].shape[0]
    shapes = param_shapes(cfg)
    p_specs = sharding.param_pspecs(stacked_param_shapes(cfg, n), world,
                                    client_axes=("clients",))
    p_shards = _ModelShards(mesh, p_specs)
    c_shards = _ModelShards(
        mesh, sharding.param_pspecs(shapes, world, client_axes=()))
    stacks = layer_stacks(cfg)
    cut = ModelCut(p_shards.axis, tuple(tree_leaves(p_shards.dims)),
                   tuple(tree_leaves({k: tree_map(lambda _: k in stacks, v)
                                      for k, v in shapes.items()})))
    clients = MeshAxis(mesh, "clients")
    whole = init_stacked_params(cfg, n, 0, "cpu")
    poisoned = tree_map(lambda a: a.clone(), whole)
    poisoned["embed"]["table"][1, 0, 0] = float("inf")
    agg = {}
    for codec in ("natural", "qsgd"):
        plan = make_plan(make_compressor(codec), shapes,
                         transport="leafwise")
        for what, tree in (("finite", whole), ("non-finite", poisoned)):
            local = p_shards.local(tree)
            for mask in (None, torch.tensor([1.0] + [0.0] * (n - 1))):
                want = c_shards.local(whole_tree_average(key, tree, plan,
                                                         mask))
                got, peak = _peak_of(lambda: compressed_average(
                    key, local, plan, plan, mask=mask, cut=cut))
                rows_want = c_shards.local(whole_tree_average(
                    key, tree, plan, mask, guarded=False))
                rows, rows_peak = _peak_of(
                    lambda: make_client_sharded_average(
                        clients, n, plan, plan, cut)(key, local, mask))
                agg[(codec, what, mask is not None)] = {
                    "equal": _same_bits(got, want),
                    "rows_equal": _same_bits(rows, rows_want),
                    "finite": all(bool(torch.isfinite(a).all())
                                  for a in tree_leaves(got)),
                    "peak": peak, "rows_peak": rows_peak}
    out["aggregation"] = agg
    try:
        build_sharded_rollout_fn(cfg, make_hyper(0.1, 0.5, 0.5, n),
                                 mesh=mesh, client_comp=comp,
                                 master_comp=comp, gather_layers=True)
        out["remat_off"] = None
    except ValueError as e:
        out["remat_off"] = str(e)
    return out


def _replicated_leaves(tree, specs):
    """The leaves of ``tree`` whose specs name no "model" dim."""
    from repro_torch.core.tree import spec_leaves, tree_leaves
    return [a.numpy() for a, s in zip(tree_leaves(tree), spec_leaves(specs))
            if "model" not in s]


def _split_grads(cfg, params, batches, mesh, world):
    """One client's gradient through the split (this process's blocks)
    and through one process (cut to the blocks), each as numpy leaves."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import (_ModelShards, param_shapes,
                                          stacked_grad_fn,
                                          stacked_param_shapes)
    from repro_torch.models.model import model_shards
    n = tree_leaves(params)[0].shape[0]
    p_shards = _ModelShards(mesh, sharding.param_pspecs(
        stacked_param_shapes(cfg, n), world, client_axes=("clients",)))
    c_shards = _ModelShards(mesh, sharding.param_pspecs(
        param_shapes(cfg), world, client_axes=()))
    batch = tree_map(lambda a: a[0], batches)
    plain = dataclasses.replace(cfg, remat=False)
    want = p_shards.local(stacked_grad_fn(plain)(params, batch)[1])
    with model_shards(split=c_shards.layer_split(cfg)):
        got = stacked_grad_fn(cfg)(p_shards.local(params), batch)[1]
    return ([a.numpy() for a in tree_leaves(got)],
            [a.numpy() for a in tree_leaves(want)])


def _region_checks(rank, world, mesh):
    """f, g and the vocab-parallel embedding and loss on the model axis
    against one process's values and gradients; and on a size-1 axis
    (a (world, 1) mesh) the identity."""
    from repro_torch.core.collective import (MeshAxis, ModelSplit, copy_to,
                                             reduce_from)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks
    axis = MeshAxis(mesh, "model")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 8, generator=gen)
    w1 = torch.randn(8, 12, generator=gen)
    w2 = torch.randn(12, 8, generator=gen)
    g_out = torch.randn(2, 6, 8, generator=gen)
    out = {}
    # f alone: the identity forward, the backward the rank-ordered sum
    parts = [torch.randn(2, 6, 8, generator=gen) for _ in range(world)]
    xf = x.clone().requires_grad_()
    y = copy_to(xf, axis)
    y.backward(parts[rank])
    want = parts[0].clone()
    for p in parts[1:]:
        want += p
    out["f"] = bool(torch.equal(y, x)) and bool(torch.equal(xf.grad, want))
    # g alone: the rank-ordered sum forward, the identity backward
    xg = parts[rank].clone().requires_grad_()
    y = reduce_from(xg, axis)
    y.backward(g_out)
    out["g"] = bool(torch.equal(y, want)) \
        and bool(torch.equal(xg.grad, g_out))
    # a column product then a row product between f and g
    cols = slice(rank * 12 // world, (rank + 1) * 12 // world)
    plain = [t.clone().requires_grad_() for t in (x, w1, w2)]
    ref = torch.tanh(plain[0] @ plain[1]) @ plain[2]
    ref.backward(g_out)
    mine = [t.clone().requires_grad_() for t in (x, w1[:, cols], w2[cols])]
    got = reduce_from(torch.tanh(copy_to(mine[0], axis) @ mine[1])
                      @ mine[2], axis)
    got.backward(g_out)
    out["fg"] = [(got.detach().numpy(), ref.detach().numpy())] + [
        (m.grad.numpy(), r.grad[..., cols].numpy() if i == 1 else
         r.grad[cols].numpy() if i == 2 else r.grad.numpy())
        for i, (m, r) in enumerate(zip(mine, plain))]
    # the vocab-parallel embedding and loss, V = 10 on the axis
    V, rows = 10, 10 // world
    table = torch.randn(V, 8, generator=gen)
    tokens = torch.randint(0, V, (2, 6), generator=gen)
    split = ModelSplit(axis, {"table": 0})
    block = table[rank * rows:(rank + 1) * rows]
    out["embed"] = bool(torch.equal(
        blocks.embed({"table": block}, tokens, split=split),
        blocks.embed({"table": table}, tokens)))
    logits = (4 * torch.randn(2, 6, V, generator=gen)).requires_grad_()
    ref = blocks.cross_entropy_loss(logits, tokens)
    ref.backward()
    mine = logits.detach()[..., rank * rows:(rank + 1) * rows] \
        .clone().requires_grad_()
    got = blocks.cross_entropy_loss(mine, tokens, split=split)
    got.backward()
    out["loss"] = [(got.detach().numpy(), ref.detach().numpy()),
                   (mine.grad.numpy(),
                    logits.grad[..., rank * rows:(rank + 1) * rows].numpy())]
    # one model shard: the identity, bit for bit
    one = MeshAxis(make_mesh((world, 1), ("clients", "model"), "cpu"),
                   "model")
    split1 = ModelSplit(one, {"table": 0})
    out["one"] = copy_to(x, one) is x and reduce_from(x, one) is x \
        and bool(torch.equal(
            blocks.cross_entropy_loss(logits.detach(), tokens,
                                      split=split1),
            blocks.cross_entropy_loss(logits.detach(), tokens))) \
        and bool(torch.equal(
            blocks.embed({"table": table}, tokens, split=split1),
            blocks.embed({"table": table}, tokens)))
    return out


def mesh2d_split_runs(rank, world, cases, key, local_key):
    """For each case (name, arch, config changes, remat policy, stacked
    numpy params, numpy batches over steps): the 2-D engine's split on a
    (1, world) mesh (remat on) over the batches' steps, its gathered
    state and this rank's replicated leaves; one client's gradient
    blocks against one process's; the ``GATHERED`` and ``REDUCED``
    counts of one local step from this rank's blocks (``local_key`` draws
    xi 0 first); then the region functions' checks."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import init_state, make_compressor, make_hyper
    from repro_torch.core.collective import (GATHERED, REDUCED,
                                             reset_gathered, reset_reduced)
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import build_sharded_rollout_fn
    init_process_group("cpu")
    mesh = make_mesh((1, world), ("clients", "model"), "cpu")
    comp = make_compressor("natural")
    out = {}
    for name, arch, changes, policy, params_np, batches_np in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        engine_cfg = dataclasses.replace(cfg, remat=True,
                                         remat_policy=policy)
        n = next(iter(batches_np.values())).shape[1]
        length = next(iter(batches_np.values())).shape[0]
        hp = make_hyper(eta=0.1, lam=0.5, p=0.5, n=n)
        kw = dict(client_comp=comp, master_comp=comp)
        params = params_from_numpy(params_np)
        batches = {k: torch.from_numpy(v) for k, v in batches_np.items()}
        roll = build_sharded_rollout_fn(engine_cfg, hp, mesh=mesh,
                                        length=length, **kw)
        st, tr = roll(init_state(params), batches, key)
        full = roll.full_state(st)
        specs = sharding.train_state_pspecs(init_state(params), world)
        got, want = _split_grads(engine_cfg, params, batches, mesh, world)
        local = build_sharded_rollout_fn(engine_cfg, hp, mesh=mesh,
                                         length=1, **kw)
        reset_gathered()
        reset_reduced()
        # from this rank's blocks (the engine cuts a whole state itself);
        # the recompute runs each layer's forward whole: every reduce and
        # gather of the forward twice
        blocks = sharding.train_state_shardings(mesh, init_state(params))
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            _, ltr = local(blocks, tree_map(lambda a: a[:1], batches),
                           local_key)
        out[name] = {
            "xis": tr.xis, "branches": tr.branches,
            "losses": tr.losses.numpy(),
            "params": [a.numpy() for a in tree_leaves(full.params)],
            "cache": [a.numpy() for a in tree_leaves(full.cache)],
            "replicated": _replicated_leaves(st.params, specs.params)
            + _replicated_leaves(st.cache, specs.cache),
            "grads": got, "want_grads": want,
            "local_branches": ltr.branches,
            "gathered": (GATHERED["calls"], GATHERED["bytes"]),
            "reduced": (REDUCED["calls"], REDUCED["bytes"])}
    out["regions"] = _region_checks(rank, world, mesh)
    return out
