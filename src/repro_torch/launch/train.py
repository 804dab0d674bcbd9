"""Federated training entry point (one process) — the counterpart of
``repro.launch.train``.

Runs compressed L2GD (Algorithm 1) over n clients on heterogeneous
synthetic token streams with the bits/n ledger, through
:func:`repro_torch.fl.run_l2gd` with auto plans, as the reference's
``driver`` engine does.  The clients' models start from
``init_params`` with one seeded ``torch.Generator`` per client (the
reference's ``jax.random`` init gives other numbers).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --clients 4 --steps 200 --compressor natural --p 0.2 --lam 0.5

Checkpoints: ``--ckpt FILE`` saves the final stacked params as one file
(``repro_torch.checkpoint.save_state``); ``--ckpt DIR --ckpt-every N``
snapshots the rollout every N chunks into a manager root, and
``--resume`` continues bit for bit from its newest snapshot:

  PYTHONPATH=src python -m repro_torch.launch.train --steps 40 \\
      --ckpt runs/ck --ckpt-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --steps 40 \\
      --ckpt runs/ck --ckpt-every 1 --resume

The audio and vision architectures take stub frontend embeddings, drawn
on the run's device for each step k as the reference's CLI draws them:
``0.02 * normal(fold_in(PRNGKey(seed + 1), k), (n, batch, P, d_model))``
patches (internvl2-26b) and the same with ``seed + 2`` for frames
(whisper-medium).  The vision prefix takes its P positions out of
``--seq``, as the reference's ``input_specs`` does: a client's sequence
is P patches and ``seq - P`` tokens.

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-26b \\
      --seq 80

``--engine mesh2d --model-shards M`` runs the 2-D (clients x model)
mesh engine (``launch.steps.build_sharded_rollout_fn``, one call over
the whole run; the ledger replayed from its xi trace, tokens/s printed)
over the processes of the group: ``torchrun --nproc-per-node K`` on the
cards, a world of one without ``torchrun``, or ``--cpu-ranks K`` spawned
CPU processes (``launch.mesh.run_cpu_ranks``; with ``device="cpu"``).
More than one model shard runs the Megatron split (each shard its block
of every product that splits on whole heads, experts or channels):

  PYTHONPATH=src python -m repro_torch.launch.train --engine mesh2d \
      --model-shards 2 --clients 1 --cpu-ranks 2 --steps 4

``--trace-out FILE`` records the run's spans and counters
(``repro_torch.tracing``) and writes them at its end as one Chrome-trace
JSON file (the lead process's, on several):

  PYTHONPATH=src python -m repro_torch.launch.train --steps 20 \
      --trace-out runs/trace.json

Runs on the GPU; ``main(argv, device="cpu")`` runs the plain PyTorch
versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch import checkpoint, tracing
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import L2GDHyper, make_compressor, prng
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.data import TokenStream
from repro_torch.fl import run_l2gd
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.steps import stacked_grad_fn, stacked_loss_fn
from repro_torch.models import init_params, param_count
from repro_torch.models.frontends import (stub_frame_embeddings,
                                          stub_patch_embeddings)

__all__ = ["build", "tokens_processed", "init_stacked_params",
           "batch_fn", "run_mesh2d", "Mesh2DRun", "main"]


def build(cfg, overrides):
    changes = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **changes)


def tokens_processed(n_local: int, n_agg: int, local_steps: int, n: int,
                     batch: int, seq: int) -> int:
    """Tokens put through the model by a run: every protocol step
    forwards the full n x batch x seq token batch at least once (the
    aggregation branches evaluate the pre-update loss), and local steps
    run ``local_steps`` gradient passes over it."""
    passes = n_local * int(local_steps) + n_agg
    return passes * n * batch * seq


def init_stacked_params(cfg, n: int, seed: int, device):
    """n clients' ``init_params``, client i from a generator seeded
    ``seed + i``, stacked over a leading client axis.  Each client's
    tree is copied in and freed before the next is drawn."""
    stacked = None
    for i in range(n):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        leaves, treedef = tree_flatten(init_params(gen, cfg, device))
        if stacked is None:
            stacked = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                                   device=device) for a in leaves]
        for dst, a in zip(stacked, leaves):
            dst[i].copy_(a)
        del leaves
    return tree_unflatten(treedef, stacked)


def batch_fn(cfg, stream, seed: int, device):
    """``batch(k)``: step k's stacked token batch from ``stream`` (numpy),
    with the stub patches (vision) or frames (encoder-decoder) of the
    reference's CLI drawn on ``device``."""
    n, b = stream.n_clients, stream.batch

    def batch(k):
        out = {"tokens": stream.batch_at(k)}
        if cfg.frontend == "vision":
            out["patches"] = stub_patch_embeddings(
                prng.fold_in(prng.PRNGKey(seed + 1), k), cfg, n, b,
                device=device)
        if cfg.is_encdec:
            out["frames"] = stub_frame_embeddings(
                prng.fold_in(prng.PRNGKey(seed + 2), k), cfg, n, b,
                device=device)
        return out

    return batch


@dataclasses.dataclass
class Mesh2DRun:
    """What ``--engine mesh2d`` returns: this process's final state, the
    trace, the ledger replayed from it, and the seconds of the run."""

    state: object
    trace: object
    ledger: object
    seconds: float


def _stack_steps(batches: list, device):
    """Step batches (dicts of numpy token arrays and device tensors)
    stacked over a leading steps axis on ``device``."""
    out = {}
    for name in batches[0]:
        parts = [b[name] for b in batches]
        out[name] = torch.stack(parts) if isinstance(parts[0], torch.Tensor) \
            else torch.from_numpy(np.stack(parts)).to(device)
    return out


def run_mesh2d(args, cfg, hp, params, comp, mcomp, batch, n: int,
               device) -> Mesh2DRun:
    """The 2-D mesh engine leg of the CLI: ONE ``build_sharded_rollout_fn``
    call over the whole run on ``make_train_mesh(model_shards=...)`` (the
    group's processes), the ledger replayed from the trace with leafwise
    plans, tokens/s printed by rank 0.  More model shards divide a
    step's memory and its FLOPs (the engine's split: each shard runs its
    block of each split product); a layer whose leaves the split still
    gathers needs remat, which the CLI turns on."""
    from repro_torch.core import init_state, make_plan
    from repro_torch.fl.ledger import BitsLedger
    from repro_torch.launch.mesh import make_train_mesh, model_shards_of
    from repro_torch.launch.steps import build_sharded_rollout_fn, lacks_remat

    mesh = make_train_mesh(model_shards=args.model_shards, device=device)
    lead = _is_lead()
    say = print if lead else (lambda *a, **k: None)
    if lacks_remat(cfg, model_shards_of(mesh)):
        # the reduced configs run without remat, which the engine refuses
        # where the split gathers a layer's leaves (it changes no bit)
        say(f"mesh2d: remat on ({cfg.remat_policy}), which "
            f"{model_shards_of(mesh)} model shards need", flush=True)
        cfg = dataclasses.replace(cfg, remat=True)
    clients_axis = mesh.shape[mesh.mesh_dim_names.index("clients")]
    say(f"mesh2d: clients axis={clients_axis} "
        f"model shards={model_shards_of(mesh)} dtype={cfg.param_dtype} "
        f"local_steps={args.local_steps}", flush=True)
    rollout = build_sharded_rollout_fn(
        cfg, hp, mesh=mesh, client_comp=comp, master_comp=mcomp,
        length=args.steps, local_steps=args.local_steps)
    one_client = tree_map(lambda a: a[0], params)
    up_plan = make_plan(comp, one_client, transport="leafwise")
    down_plan = make_plan(mcomp, one_client, transport="leafwise")
    batches = _stack_steps([batch(k) for k in range(args.steps)], device)
    # the reference's mesh2d leg passes PRNGKey(seed + 3) unfolded
    key = prng.PRNGKey(args.seed + 3)

    t0 = time.time()
    state, trace = rollout(init_state(params), batches, key)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    ledger = BitsLedger(n)
    ledger.replay_xi_trace(np.asarray(trace.xis), up_plan.round_bits(),
                           down_plan.round_bits())
    losses = trace.losses.cpu().numpy()
    for i in range(0, len(losses), max(args.log_every, 1)):
        say(f"step {i:5d}  client-mean loss {float(losses[i]):8.4f}")
    if len(losses):
        say(f"final loss {float(losses[-1]):.4f}")
    n_agg = trace.n_agg_comm + trace.n_agg_cached
    toks = tokens_processed(trace.n_local, n_agg, args.local_steps, n,
                            args.batch, args.seq)
    say(f"steps/s={args.steps / dt:.2f}  tokens/s={toks / dt:.0f}  "
        f"rounds={ledger.rounds}  bits/n={ledger.bits_per_client:.3e}  "
        f"local={trace.n_local} aggC={trace.n_agg_comm} "
        f"aggK={trace.n_agg_cached}")
    if args.ckpt:
        full = rollout.full_state(state)
        if lead:
            checkpoint.save_state(
                args.ckpt, full.params,
                {"arch": cfg.name, "steps": args.steps,
                 "bits_per_client": ledger.bits_per_client})
            say(f"checkpoint -> {args.ckpt}")
    return Mesh2DRun(state=state, trace=trace, ledger=ledger, seconds=dt)


def _is_lead() -> bool:
    """True outside a process group and on its rank 0."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _mesh2d_rank(rank, world, argv):
    """One of ``--cpu-ranks``' processes: the CLI on the CPU; returns
    the rank's (xis, rounds, bits/n, counts)."""
    run = main(argv, device="cpu")
    return (np.asarray(run.trace.xis), run.ledger.rounds,
            run.ledger.bits_per_client, run.trace.n_local,
            run.trace.n_agg_comm, run.trace.n_agg_cached)


def main(argv=None, device=None):
    """CLI entry point; returns the run's ``L2GDRun``.  ``argv``
    (optional list) replaces ``sys.argv[1:]``; ``device`` is CUDA unless
    the caller names another (the tests pass ``"cpu"``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (default: reduced)")
    ap.add_argument("--layers", type=int)
    ap.add_argument("--d-model", type=int)
    ap.add_argument("--d-ff", type=int)
    ap.add_argument("--heads", type=int)
    ap.add_argument("--kv-heads", type=int)
    ap.add_argument("--vocab", type=int)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--p", type=float, default=0.2)
    ap.add_argument("--compressor", default="natural")
    ap.add_argument("--master-compressor", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint destination: a file (the final "
                         "params, saved at the end), or with --ckpt-every"
                         "/--resume a CheckpointManager root of step-"
                         "tagged snapshots")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="snapshot the rollout every N chunks into the "
                         "--ckpt directory (0 disables)")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="keep only the newest N snapshots (0 = all)")
    ap.add_argument("--resume", action="store_true",
                    help="resume bit for bit from the newest snapshot "
                         "under --ckpt")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=1,
                    help="gradient passes per LOCAL protocol step (wire "
                         "bits per round unchanged)")
    ap.add_argument("--engine", choices=("driver", "mesh2d"),
                    default="driver",
                    help="driver: run_l2gd (default); mesh2d: the 2-D "
                         "(clients x model) mesh engine via "
                         "build_sharded_rollout_fn")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="size of the mesh's model axis (mesh2d engine; "
                         "clients x model-shards processes needed)")
    ap.add_argument("--cpu-ranks", type=int, default=0,
                    help="mesh2d on the CPU: spawn this many gloo "
                         "processes (launch.mesh.run_cpu_ranks)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default=None,
                    help="override param+compute dtype")
    ap.add_argument("--attn-impl", choices=("dense", "flash"), default=None,
                    help="train-path attention (the flash kernel has no "
                         "backward: training needs dense)")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's spans and counters to this "
                         "Chrome-trace JSON file")
    args = ap.parse_args(argv)
    if (args.ckpt_every or args.resume) and not args.ckpt:
        ap.error("--ckpt-every/--resume need --ckpt (the manager root)")
    if args.engine == "mesh2d" and (args.ckpt_every or args.resume):
        ap.error("--engine mesh2d has no checkpoint manager yet; "
                 "use the driver engine for --ckpt-every/--resume")
    if args.cpu_ranks and args.engine != "mesh2d":
        ap.error("--cpu-ranks runs the mesh2d engine")
    if args.cpu_ranks > 1:
        from repro_torch.launch.mesh import run_cpu_ranks
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--cpu-ranks")
        rest = argv[:i] + argv[i + 2:]
        return run_cpu_ranks(_mesh2d_rank, args.cpu_ranks, rest)
    device = resolve_device("cpu" if args.cpu_ranks else device)
    if not args.trace_out:
        return _train(args, ap, device)
    tracing.reset()
    with tracing.recording():
        run = _train(args, ap, device)
    if _is_lead():
        tracing.write(args.trace_out)
        print(f"trace -> {args.trace_out}")
    return run


def _train(args, ap, device):
    """The run ``main`` parsed: the driver or the mesh2d engine."""
    base = get_config(args.arch) if args.full \
        else get_config(args.arch).reduced()
    cfg = build(base, {"n_layers": args.layers, "d_model": args.d_model,
                       "d_ff": args.d_ff, "n_heads": args.heads,
                       "n_kv_heads": args.kv_heads,
                       "vocab_size": args.vocab,
                       "head_dim": None if args.d_model else base.head_dim,
                       "param_dtype": args.dtype, "compute_dtype": args.dtype,
                       "attn_impl": args.attn_impl})
    n = args.clients
    # the vision prefix's patches take P of the --seq positions
    seq = args.seq - (cfg.n_frontend_tokens if cfg.frontend == "vision"
                      else 0)
    if seq < 2:
        ap.error(f"--seq {args.seq} leaves {seq} tokens after the "
                 f"{cfg.n_frontend_tokens} patches; next-token loss "
                 "needs 2")
    ts = TokenStream(n_clients=n, vocab=cfg.vocab_size, batch=args.batch,
                     seq=seq, seed=args.seed)
    params = init_stacked_params(cfg, n, args.seed, device)
    if _is_lead():
        print(f"arch={cfg.name} params/client={param_count(params) // n:,} "
              f"clients={n}", flush=True)

    hp = L2GDHyper(eta=args.eta, lam=args.lam, p=args.p, n=n)
    comp = make_compressor(args.compressor)
    mcomp = make_compressor(args.master_compressor or args.compressor)

    batch = batch_fn(cfg, ts, args.seed, device)
    if args.engine == "mesh2d":
        return run_mesh2d(args, cfg, hp, params, comp, mcomp, batch, n,
                          device)

    # the reference's CLI passes key seed + 3 and the deprecated seed=
    # seed + 4, which its run_l2gd folds into the key
    key = prng.fold_in(prng.PRNGKey(args.seed + 3), args.seed + 4)
    policy = None
    if args.ckpt_every:
        policy = checkpoint.CheckpointPolicy(
            args.ckpt, every_n_chunks=args.ckpt_every,
            max_to_keep=args.ckpt_keep or None)
    resume_from = args.ckpt if args.resume else None
    if resume_from is not None:
        step = checkpoint.latest_step(resume_from)
        print(f"resuming from {resume_from} step {step}", flush=True)
    t0 = time.time()
    run = run_l2gd(key, params, stacked_grad_fn(cfg),
                   hp, batch, args.steps,
                   client_comp=comp, master_comp=mcomp,
                   checkpoint_policy=policy, resume_from=resume_from,
                   local_steps=args.local_steps,
                   loss_fn=stacked_loss_fn(cfg), device=device)
    if policy is not None:
        policy.resolve().close()   # join the commits in flight
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    losses = run.losses
    for i in range(0, len(losses), max(args.log_every, 1)):
        k, l = losses[i]
        print(f"step {k:5d}  client-mean loss {l:8.4f}")
    if losses:
        print(f"final loss {losses[-1][1]:.4f}  "
              f"({np.mean([l for _, l in losses[-5:]]):.4f} tail-5 mean)")
    toks = tokens_processed(run.n_local, run.n_agg_comm + run.n_agg_cached,
                            args.local_steps, n, args.batch, args.seq)
    print(f"steps/s={args.steps / dt:.2f}  tokens/s={toks / dt:.0f}  "
          f"rounds={run.ledger.rounds}  "
          f"bits/n={run.ledger.bits_per_client:.3e}  "
          f"local={run.n_local} aggC={run.n_agg_comm} aggK={run.n_agg_cached}")
    if args.ckpt and not (args.ckpt_every or args.resume):
        # the single-file path; manager runs committed during the rollout
        checkpoint.save_state(args.ckpt, run.state.params,
                              {"arch": cfg.name, "steps": args.steps,
                               "bits_per_client": run.ledger.bits_per_client})
        print(f"checkpoint -> {args.ckpt}")
    elif args.ckpt_every:
        print(f"checkpoints -> {args.ckpt} "
              f"(latest step {checkpoint.latest_step(args.ckpt)})")
    return run


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():       # the mesh2d engine's group
        dist.destroy_process_group()
