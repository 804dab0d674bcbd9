"""Serving entry point: multi-tenant personalized serving through the
base-plus-delta store and the batching engine — the counterpart of
``repro.launch.serve``.

Every client of personalized FL has its own model x_i.  The server keeps
the global mean resident once and each tenant as a compressed delta
(:class:`repro_torch.serve.DeltaModelStore`), materialized on demand
into a bounded LRU; each batch teacher-forces its prompts and decodes
greedily, with no host read per token.  Like the reference, it serves
``.reduced()`` configs.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --tenants 4 --cache 2 --codec natural --prompt-len 8 --gen 32

  # serve a federated checkpoint written by the train CLI:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --ckpt runs/ck.ckpt --codec qsgd4

Runs on the GPU unless ``--device cpu`` is given.  The synthetic
tenants come from ``init_params`` with one seeded ``torch.Generator``
each (the reference's ``jax.random`` init gives other numbers); the
prompts are the reference's, drawn with ``prng.randint`` from
``fold_in(key, 3)``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import make_compressor, make_plan, prng
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.train import init_stacked_params
from repro_torch.serve import DeltaModelStore, Request, ServingEngine

__all__ = ["CODECS", "build_plan", "main"]

CODECS = ("identity", "natural", "qsgd", "qsgd4")


def build_plan(name: str):
    """CLI codec name -> (CompressionPlan, narrow flag).  ``qsgd4`` is
    QSGD levels=7 narrowed to 4-bit storage codes."""
    if name == "identity":
        return make_plan(make_compressor("identity"),
                         transport="leafwise"), False
    if name == "natural":
        return make_plan(make_compressor("natural"),
                         transport="packed"), False
    if name == "qsgd":
        return make_plan(make_compressor("qsgd"), transport="packed"), False
    if name == "qsgd4":
        return make_plan(make_compressor("qsgd", levels=7),
                         transport="packed"), True
    raise ValueError(f"unknown codec {name!r}; have {CODECS}")


def main(argv=None):
    """CLI entry point; returns (store, engine, results).  ``argv``
    (optional list) replaces ``sys.argv[1:]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--tenants", type=int, default=4,
                    help="synthetic tenants when no --ckpt is given")
    ap.add_argument("--cache", type=int, default=2,
                    help="LRU capacity: tenants resident materialized")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--batch-mode", choices=("map", "vmap"), default="map")
    ap.add_argument("--codec", choices=CODECS, default="natural")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt", default=None,
                    help="federated checkpoint (stacked client params) "
                         "to ingest as tenants")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    plan, narrow = build_plan(args.codec)
    key = prng.PRNGKey(args.seed)

    if args.ckpt:
        store = DeltaModelStore.from_checkpoint(
            args.ckpt, plan, key=prng.fold_in(key, 1), narrow=narrow,
            device=device)
        print(f"ingested {len(store)} tenants from {args.ckpt}")
    else:
        stacked = init_stacked_params(cfg, args.tenants, args.seed + 2,
                                      device)
        store = DeltaModelStore.from_params(
            stacked, plan, key=prng.fold_in(key, 1), narrow=narrow)
        del stacked

    engine = ServingEngine(store, cfg, cache_capacity=args.cache,
                           max_batch=args.max_batch,
                           batch_mode=args.batch_mode)
    prompts = prng.randint(prng.fold_in(key, 3),
                           (len(store.tenants), args.prompt_len), 0,
                           cfg.vocab_size)
    requests = [Request(tid, tuple(int(t) for t in prompts[i]),
                        gen=args.gen)
                for i, tid in enumerate(store.tenants)]

    results = engine.serve(requests)

    ratio_f32 = store.models_per_gb() / store.dense_models_per_gb(32.0)
    ratio_bf16 = store.models_per_gb() / store.dense_models_per_gb(16.0)
    print(f"arch={cfg.name} codec={args.codec} tenants={len(store)} "
          f"cache={args.cache} mode={args.batch_mode} device={device}")
    print(f"residency: {store.models_per_gb():.1f} models/GB "
          f"({ratio_f32:.2f}x dense f32, {ratio_bf16:.2f}x dense bf16)")
    for r in results[:4]:
        print(f"  tenant {r['tenant']}: ttft={r['ttft_s'] * 1e3:.1f}ms "
              f"batch={r['batch_size']} tokens={r['tokens'][:12].tolist()}"
              f"{'...' if len(r['tokens']) > 12 else ''}")
    snap = engine.metrics.snapshot()
    agg_tok = sum(s.tokens_generated for s in engine.metrics.tenants.values())
    agg_t = max(s.gen_time_s for s in engine.metrics.tenants.values())
    print(f"cache: hits={snap['hits']} misses={snap['misses']} "
          f"evictions={snap['evictions']}; "
          f"throughput ~{agg_tok / agg_t:.1f} tokens/s "
          f"over {snap['batches']} batches")
    return store, engine, results


if __name__ == "__main__":
    main()
