"""Meta-device dry run — the counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape x mesh shape) this reports, from
the sharding rules (``launch.sharding``) and shapes on the ``meta``
device, with no allocation and no process group:

  * the bytes a process holds: the train state (client-stacked params
    and the cache), the serving params, and the decode caches, each leaf
    divided by the mesh axes its spec names.  For the train state this is
    the layout at rest, between steps.  A train record's
    ``engine_step_bytes_per_process`` is the most that a step of the
    port's 2-D engine (``launch.steps.build_sharded_rollout_fn``) holds
    a process, activations left out (:func:`engine_step_bytes`): a local
    step adds the gradient's blocks and the leaves the split gathers
    whole (one layer's at a time), an aggregation step the leafwise
    average's blocks and one leaf piece whole at a time.  That holds for the leafwise uplink the record
    prices; a flat or packed uplink (or a fleet) gathers the row's whole
    models for the aggregation;
  * the aggregation collective's bytes a round: each client's uplink
    message is ``round_bits() / 8`` bytes, and the payload ``all_gather``
    delivers all n of them to every process;
  * the analytic FLOPs (``launch.roofline``) and the roofline terms on
    the H100 at the compute dtype's peak.  A train record's
    ``analytic_per_process`` is what the 2-D engine's split runs on one
    process (:func:`per_process_flops`): a product split on whole heads,
    experts or channels is divided by the chips, one the split runs
    whole on every model shard (a leaf whole on every process, or
    gathered) by the client rows only; GQA's kv projections where the kv
    heads do not divide run the kv heads each process's query heads
    read.  Prefill and decode records divide evenly by the chips (the
    reference's GSPMD layout; the port has no sharded serving engine).

The reference lowers and compiles each combination with XLA on 512
placeholder devices; that lowering has no counterpart here.

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch mistral-large-123b --shape train_4k --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, ArchConfig, get_config
from repro_torch.core import make_compressor, make_plan
from repro_torch.core.l2gd import UPDATE_CHUNK
from repro_torch.core.tree import spec_leaves, tree_leaves
from repro_torch.launch.roofline import (analytic_flops, model_flops,
                                         roofline_terms)
from repro_torch.launch.sharding import (cache_pspecs, param_pspecs,
                                         train_state_pspecs)
from repro_torch.launch.steps import (cache_specs, model_dims, param_shapes,
                                      split_gathers, state_specs)
from repro_torch.models.model import layer_stacks

__all__ = ["n_params_active", "sharded_bytes", "engine_step_bytes",
           "flop_terms", "per_process_flops", "dry_run", "main"]


def production_cfg(cfg: ArchConfig) -> ArchConfig:
    """bf16 params and compute, the at-scale numerics."""
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def n_params_active(cfg: ArchConfig) -> float:
    """Active parameters a token, for MODEL_FLOPS = 6 N_active D."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.mixer == "mla":
        attn = d * cfg.n_heads * (cfg.mla_nope_dim + cfg.mla_rope_dim) \
            + d * (cfg.kv_lora_rank + cfg.mla_rope_dim) \
            + cfg.kv_lora_rank * cfg.n_heads \
            * (cfg.mla_nope_dim + cfg.mla_v_dim) \
            + cfg.n_heads * cfg.mla_v_dim * d
    elif cfg.mixer == "mamba":
        e = cfg.ssm_expand * d
        attn = 2 * d * e + e * (max(d // 16, 1) + 2 * cfg.ssm_state) \
            + max(d // 16, 1) * e + e * d
    elif cfg.mixer == "hybrid":
        e = cfg.ssm_expand * d
        attn = d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * cfg.hd * d \
            + 2 * d * e + e * (max(d // 16, 1) + 2 * cfg.ssm_state) \
            + max(d // 16, 1) * e + e * d
    else:
        attn = d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * cfg.hd * d
    if cfg.ffn == "moe":
        ffn = 3 * d * cfg.moe_d_ff * (cfg.experts_per_token
                                      + cfg.n_shared_experts)
    elif cfg.ffn == "none":
        ffn = 0
    else:
        ffn = 3 * d * cfg.d_ff
    emb = cfg.vocab_size * d   # the unembed matmul is per-token compute
    enc = 0
    if cfg.is_encdec:
        enc = cfg.encoder_layers * (4 * d * cfg.n_heads * cfg.hd
                                    + 3 * d * cfg.d_ff)
        attn += 4 * d * cfg.n_heads * cfg.hd   # cross attention
    return float(L * (attn + ffn) + emb + enc)


def flop_terms(cfg: ArchConfig, shape, size: int) -> list:
    """``launch.roofline.analytic_flops`` (with :func:`n_params_active`)
    by product: [(what, global FLOPs, the share of a client row's work
    one of its ``size`` model shards runs)], the FLOPs summing to
    ``analytic_flops``.  The share is 1 / size where the 2-D engine's
    split runs the product on blocks, 1 where every model shard runs it
    whole, and for GQA's kv projections that fall back, the kv heads
    one shard's query heads read over n_kv (the most of any shard)."""
    from repro_torch.launch.roofline import analytic_flops
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks
    from repro_torch.models import mamba as mb
    from repro_torch.models import moe as moe_lib
    S, B = shape.seq_len, shape.global_batch
    tokens = B * S if shape.kind != "decode" else B
    mult = 3.0 if shape.kind == "train" else 1.0
    dims = model_dims(cfg, size)
    d, L, H, hd = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.hd
    layer = dims["layers"]
    one = 1.0 / size

    def share(split):
        return one if split else 1.0

    def mm(params):     # a product's FLOPs a step from its params a token
        return mult * 2.0 * params * tokens

    terms = []
    heads = attn.heads_split(layer.get("attn", {}), H, size) \
        and (cfg.mixer == "mla" or cfg.is_encdec
             or cfg.attn_layout == "fused")
    if cfg.mixer == "mla":
        terms += [("attn q, uk, uv, o", mm(L * (
            d * H * (cfg.mla_nope_dim + cfg.mla_rope_dim)
            + cfg.kv_lora_rank * H * (cfg.mla_nope_dim + cfg.mla_v_dim)
            + H * cfg.mla_v_dim * d)), share(heads)),
            ("attn dkv", mm(L * d * (cfg.kv_lora_rank + cfg.mla_rope_dim)),
             1.0)]
    if cfg.mixer in ("mamba", "hybrid"):
        e = cfg.ssm_expand * d
        split = mb.channels_split(layer["mixer" if cfg.mixer == "mamba"
                                        else "mamba"])
        terms += [("mamba", mm(L * (2 * d * e + e * (max(d // 16, 1)
                                                     + 2 * cfg.ssm_state)
                                    + max(d // 16, 1) * e + e * d)),
                   share(split)),
                  ("scan", mult * L * 10.0 * tokens * e * cfg.ssm_state,
                   share(split))]
    if cfg.mixer in ("gqa", "hybrid"):
        kv = cfg.n_kv_heads
        if not heads:
            kv_share = 1.0
        elif attn.kv_split(layer["attn"], kv, size):
            kv_share = one
        else:       # the kv heads of one shard's H / size query heads
            local, group = H // size, H // kv
            kv_share = max((r * local + local - 1) // group
                           - r * local // group + 1
                           for r in range(size)) / kv
        terms += [("attn q, o", mm(L * 2 * d * H * hd), share(heads)),
                  ("attn k, v", mm(L * 2 * d * kv * hd), kv_share)]
    if cfg.is_encdec:
        terms += [("cross q, k, v, o", mm(L * 4 * d * H * hd),
                   share(heads)),
                  ("encoder attn", mm(cfg.encoder_layers * 4 * d * H * hd),
                   share(heads)),
                  ("encoder mlp", mm(cfg.encoder_layers * 3 * d * cfg.d_ff),
                   share(blocks.mlp_splits(dims["encoder"]["ffn"])))]
    for group, n in (("dense_layers", cfg.first_dense_layers),
                     ("layers", L - cfg.first_dense_layers)):
        ffn = dims.get(group, {}).get("ffn")
        kind = "dense" if group == "dense_layers" else cfg.ffn
        if not n or kind == "none":
            continue
        if kind == "dense":
            terms.append(("mlp " + group, mm(n * 3 * d * cfg.d_ff),
                          share(blocks.mlp_splits(ffn))))
            continue
        terms += [("experts", mm(n * 3 * d * cfg.moe_d_ff
                                 * cfg.experts_per_token),
                   share(moe_lib.experts_split(ffn, cfg.moe_impl)))]
        if cfg.n_shared_experts:
            terms.append(("shared experts", mm(n * 3 * d * cfg.moe_d_ff
                                               * cfg.n_shared_experts),
                          share(moe_lib.shared_split(ffn))))
    terms.append(("unembed", mm(cfg.vocab_size * d),
                  share(dims["embed"]["table"] is not None)))
    # the attention scores and values, by the heads
    rest = analytic_flops(cfg, shape, n_params_active(cfg)) \
        - sum(f for _, f, _ in terms)
    if cfg.mixer != "mamba":
        terms.append(("scores", rest, share(heads)))
    return terms


def per_process_flops(cfg: ArchConfig, shape, sizes: dict) -> float:
    """One process's FLOPs of a train step of the 2-D engine on a mesh of
    these axis sizes (:func:`flop_terms`): each product's FLOPs over the
    client rows, times the share of a row its model shard runs."""
    rows = math.prod(v for k, v in sizes.items() if k != "model")
    return sum(f * part for _, f, part in
               flop_terms(cfg, shape, sizes["model"])) / rows


def _entries(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_bytes(tree, spec_tree, axis_sizes: dict) -> int:
    """Bytes one process holds of ``tree`` (meta tensors) under the spec
    tree: each leaf's bytes over the sizes of the axes its spec names."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree), spec_leaves(spec_tree)):
        split = math.prod(axis_sizes[a] for e in spec for a in _entries(e))
        total += leaf.numel() * leaf.element_size() // split
    return int(total)


def engine_step_bytes(cfg: ArchConfig, params_bytes: int, cache_bytes: int,
                      n_clients: int, m: int = 1, codec=None,
                      model_shards: int = 1) -> int:
    """The most a 2-D engine step holds a process, activations left out,
    for ``n_clients`` clients, ``m`` of them on each client row, a
    leafwise uplink of ``codec`` (natural if None), and the split on
    ``model_shards`` model shards.  With P = ``params_bytes`` and C =
    ``cache_bytes`` (this process's blocks of the state at rest) and U
    the updates' float32 work on one chunk (2 x m x
    ``l2gd.UPDATE_CHUNK`` x 4 bytes), the larger of:

    * a local step, 2P + C + max(G, P + U): the state, the gradient's
      blocks, and the larger of what the layer loop gathers (G: the
      leaves of ``launch.steps.split_gathers`` of the largest layer
      whole with their whole gradient, plus the model shards' whole
      gradients of its largest such leaf, gathered to be summed; an
      encoder-decoder layer counts its cross-attention; the split
      gathers no table) and the new params with U;
    * an aggregation step, P + C + P/m + max(P + U, R + T): the state,
      the target's blocks, and the larger of the new params with U and
      what the average holds besides (R: the clients' compressed blocks,
      P on one client row, none on several; T: the largest leaf piece S,
      a layer of a layer stack's leaf or another leaf whole, at four
      float32 copies for the row's m clients, 16 m S bytes, plus on
      several rows the n clients' payloads of it)."""
    shapes = param_shapes(cfg)
    stacks = layer_stacks(cfg)
    codec = codec or make_compressor("natural")
    gathers = split_gathers(cfg, model_shards)
    # a stack's leaves carry its layers on their first axis
    sizes = {key: [a.numel() * a.element_size() // a.shape[0] for a, g in
                   zip(tree_leaves(shapes[key]), tree_leaves(gathers[key]))
                   if g] for key in stacks}
    layer = {key: sum(v) for key, v in sizes.items()}
    if cfg.is_encdec:
        layer["layers"] += layer.pop("cross")
    largest = max((b for v in sizes.values() for b in v), default=0)
    gathered = 2 * max(layer.values()) + model_shards * largest
    piece = max(a.numel() // (a.shape[0] if key in stacks else 1)
                for key in shapes for a in tree_leaves(shapes[key]))
    work = 2 * m * UPDATE_CHUNK * 4
    several = n_clients > m
    transient = 16 * m * piece + (n_clients * codec.payload_spec(
        (piece,)).nbits / 8 if several else 0)
    local = 2 * params_bytes + cache_bytes \
        + max(gathered, params_bytes + work)
    agg = params_bytes + cache_bytes + params_bytes // m + max(
        params_bytes + work,
        (0 if several else params_bytes) + transient)
    return int(max(local, agg))


def _mesh_axes(mesh: tuple) -> dict:
    """(clients, model) or (pod, data, model) sizes by name."""
    if len(mesh) == 3:
        return dict(zip(("pod", "data", "model"), mesh))
    return dict(zip(("data", "model"), mesh))


def dry_run(arch: str, shape_name: str, mesh=(16, 16)) -> dict:
    """One combination's record (module docstring); the train step's
    compressor is natural both ways, as the reference's dry run's."""
    cfg = production_cfg(get_config(arch))
    shape = INPUT_SHAPES[shape_name]
    sizes = _mesh_axes(tuple(mesh))
    cax = tuple(a for a in ("pod", "data") if a in sizes)
    n_clients = math.prod(sizes[a] for a in cax)
    chips = math.prod(sizes.values())
    msize = sizes["model"]
    rec = {"arch": arch, "shape": shape_name, "mesh": list(mesh),
           "mesh_axes": list(sizes), "n_clients": n_clients,
           "kind": shape.kind}
    if shape.kind == "decode" and shape_name == "long_500k" \
            and not cfg.supports_long_context():
        return {**rec, "status": "SKIP",
                "skipped": "full-attention arch at 500k"}
    lead = cax if len(cax) > 1 else cax[0]
    mem = {}
    if shape.kind == "train":
        state = state_specs(cfg, n_clients)
        specs = train_state_pspecs(state, msize, client_axis=lead)
        mem["params_bytes"] = sharded_bytes(state.params, specs.params,
                                            sizes)
        mem["cache_bytes"] = sharded_bytes(state.cache, specs.cache, sizes)
        rec["engine_step_bytes_per_process"] = engine_step_bytes(
            cfg, mem["params_bytes"], mem["cache_bytes"], n_clients,
            model_shards=msize)
        bits = make_plan(make_compressor("natural"), param_shapes(cfg),
                         transport="leafwise").round_bits()
        rec["aggregation"] = {
            "codec": "natural", "uplink_bytes_per_client": bits / 8.0,
            "downlink_bytes": bits / 8.0,
            "all_gather_bytes_per_process": n_clients * bits / 8.0}
        wire = n_clients * bits / 8.0
    else:
        params = param_shapes(cfg)
        mem["params_bytes"] = sharded_bytes(
            params, param_pspecs(params, msize, (),
                                 serve_mode=shape.kind == "decode"), sizes)
        wire = 0.0
        if shape.kind == "decode":
            caches = cache_specs(cfg, shape.global_batch, shape.seq_len)
            batch_axis = lead if shape.global_batch % n_clients == 0 \
                and shape.global_batch > 1 else None
            seq_axis = lead if batch_axis is None else None
            axis_sizes = dict(sizes)
            mem["caches_bytes"] = sharded_bytes(caches, cache_pspecs(
                caches, msize, batch_axis=batch_axis, seq_axis=seq_axis,
                axis_sizes=axis_sizes), sizes)
    rec["memory_per_process"] = mem
    n_act = n_params_active(cfg)
    tokens = shape.global_batch * shape.seq_len if shape.kind != "decode" \
        else shape.global_batch
    flops = analytic_flops(cfg, shape, n_act)
    mf = model_flops(n_act, tokens) / (1.0 if shape.kind == "train" else 3.0)
    per = per_process_flops(cfg, shape, sizes) \
        if shape.kind == "train" else flops / chips
    rec.update({
        "status": "OK", "tokens": tokens,
        "flops": {"analytic_global": flops, "analytic_per_process": per},
        "model_flops_global": mf,
        "roofline": roofline_terms(per, float(sum(mem.values())),
                                   wire, dtype=cfg.compute_dtype)})
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="16x16",
                    help="data x model (16x16) or pod x data x model "
                         "(2x16x16)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for one JSON record a combination")
    args = ap.parse_args(argv)
    mesh = tuple(int(x) for x in args.mesh.split("x"))
    combos = ([(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    for arch, shape in combos:
        rec = dry_run(arch, shape, mesh)
        tag = f"{arch}__{shape}__{args.mesh}"
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        extra = ""
        if rec["status"] == "OK":
            r = rec["roofline"]
            extra = (f" dominant={r['dominant']} c/m/x="
                     f"{r['compute_s']:.3g}/{r['memory_s']:.3g}/"
                     f"{r['collective_s']:.3g}s")
        print(f"[{rec['status']}] {tag}{extra}", flush=True)


if __name__ == "__main__":
    main()
