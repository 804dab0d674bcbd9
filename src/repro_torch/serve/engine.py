"""Multi-tenant decode engine over a :class:`DeltaModelStore` — the
counterpart of ``repro.serve.engine``.

One shared base stays resident; tenant params materialize on demand
(base + payload decode) into a bounded LRU with deterministic eviction
(least recently used first: the cache is an ``OrderedDict``, so the
eviction sequence of a fixed request trace is reproducible).

Continuous batching: requests of DIFFERENT tenants with the same
(prompt_len, gen) geometry are served as one batch against the one
base residency, chunked to ``max_batch``.

  * ``batch_mode="map"`` (default) runs each row as its own batch-1
    ``decode_step`` on that row's own caches — the computation a solo
    request runs, so mixed-tenant logits equal solo logits bit for bit
    (the reference's ``jax.lax.map`` of the row step);
  * ``batch_mode="vmap"`` runs the rows as one batch through
    ``torch.func.vmap`` over the tenants' stacked params and caches; it
    gives the same greedy tokens on the configurations tested, but its
    batched products may round differently, so only its tokens are held.

Generation per batch: the prompt is teacher-forced through the decode
steps (prefill; its last step emits the first generated token), then
greedy argmax feedback gives the other ``gen - 1`` tokens.  Tokens stay
on the device until the batch ends — no per-token host read — and TTFT
and the generation time are host clocks around work that ends in a
device synchronization.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import decode_step, init_caches
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.store import DeltaModelStore

__all__ = ["Request", "ServingEngine"]

BATCH_MODES = ("map", "vmap")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: ``tenant``'s model, greedy-decode ``gen``
    tokens after teacher-forcing ``prompt``."""

    tenant: str
    prompt: Tuple[int, ...]
    gen: int = 16

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(int(t) for t in self.prompt))
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.gen < 1:
            raise ValueError("gen must be >= 1")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Serve many tenants from one base + compressed-delta store.

    Args:
      store: the :class:`DeltaModelStore` holding base and payloads.
      cfg: model config (``get_config(arch).reduced()`` etc.);
        encoder-decoder configs are rejected.
      cache_capacity: most tenants resident materialized at once.
      max_batch: most requests served in one batch.
      batch_mode: ``"map"`` (default, bit-exact with solo serving) or
        ``"vmap"`` (one vectorized batch).
    """

    def __init__(self, store: DeltaModelStore, cfg, *,
                 cache_capacity: int = 4, max_batch: int = 4,
                 batch_mode: str = "map"):
        if getattr(cfg, "is_encdec", False):
            raise ValueError(
                f"arch {cfg.name!r} is encoder-decoder; the serving engine "
                "only handles decoder-only caches")
        if batch_mode not in BATCH_MODES:
            raise ValueError(f"batch_mode {batch_mode!r} not in {BATCH_MODES}")
        if cache_capacity < 1 or max_batch < 1:
            raise ValueError("cache_capacity and max_batch must be >= 1")
        self.store = store
        self.cfg = cfg
        self.cache_capacity = int(cache_capacity)
        self.max_batch = int(max_batch)
        self.batch_mode = batch_mode
        self.metrics = ServeMetrics()
        self._cache: "OrderedDict[str, object]" = OrderedDict()

    # -- tenant residency (LRU, deterministic eviction) ---------------------
    def params_for(self, tenant):
        """Materialized params of ``tenant`` through the LRU cache."""
        tid = str(tenant)
        if tid in self._cache:
            self._cache.move_to_end(tid)
            self.metrics.record_hit(tid)
            return self._cache[tid]
        self.metrics.record_miss(tid)
        params = self.store.materialize(tid)
        self._cache[tid] = params
        while len(self._cache) > self.cache_capacity:
            evicted, _ = self._cache.popitem(last=False)
            self.metrics.record_eviction(evicted)
        return params

    @property
    def resident_tenants(self) -> List[str]:
        return list(self._cache)

    # -- generation ---------------------------------------------------------
    def _step_fn(self, params):
        """``step(caches, i, tok) -> (logits (B, V), caches)`` of one
        batch: per row (map) or vectorized (vmap)."""
        cfg = self.cfg
        if self.batch_mode == "map":
            def step(caches, i, tok):
                outs = [decode_step(p, cfg, c, i, {"tokens": t})
                        for p, c, t in zip(params, caches, tok)]
                return [lg[:, 0] for lg, _ in outs], [c for _, c in outs]
            return step
        stacked = tree_map(lambda *xs: torch.stack(xs), *params)

        def step(caches, i, tok):
            logits = torch.func.vmap(
                lambda p, c, t: decode_step(p, cfg, c, i,
                                            {"tokens": t})[0][:, 0])(
                stacked, caches, tok)
            return logits, caches
        return step

    @torch.no_grad()
    def _generate(self, params, prompts: torch.Tensor, G: int,
                  keep_logits: bool = False):
        """(first tokens (B,), the other tokens (B, G-1), ttft, total
        seconds, logits (B, P + G - 1, V) or None) of one batch;
        ``prompts`` (B, P) int64 on the device."""
        B, P = prompts.shape
        device = prompts.device
        step = self._step_fn(params)
        one = init_caches(self.cfg, 1, P + G, device=device)
        if self.batch_mode == "map":
            caches = [tree_map(torch.clone, one) for _ in range(B)]
            rows = lambda t: [t[r:r + 1] for r in range(B)]
            batch = lambda lg: torch.cat(lg)
        else:
            caches = tree_map(lambda a: torch.stack([a] * B), one)
            rows = lambda t: t.view(B, 1, 1)
            batch = lambda lg: lg.reshape(B, -1)
        kept = []

        def run(i, tok):
            """One decode step; the next greedy token (B, 1)."""
            nonlocal caches
            logits, caches = step(caches, i, rows(tok))
            logits = batch(logits)                       # (B, V)
            if keep_logits:
                kept.append(logits)
            return logits

        t0 = time.perf_counter()
        tok = prompts[:, 0:1]
        for i in range(P):
            logits = run(i, tok)
            tok = prompts[:, i + 1:i + 2] if i + 1 < P \
                else torch.argmax(logits, dim=-1).view(B, 1)
        first = tok
        _sync(device)
        ttft = time.perf_counter() - t0
        rest = []
        for i in range(P, P + G - 1):
            tok = torch.argmax(run(i, tok), dim=-1).view(B, 1)
            rest.append(tok)
        _sync(device)
        total = time.perf_counter() - t0
        rest = torch.cat(rest, dim=1) if rest \
            else prompts.new_zeros((B, 0))
        logits = torch.stack(kept, dim=1) if keep_logits else None
        return first.view(B), rest, ttft, total, logits

    # -- continuous batching ------------------------------------------------
    def serve(self, requests: Sequence[Request], *,
              return_logits: bool = False) -> List[dict]:
        """Run a request trace; results come back in request order.
        Requests are grouped by (prompt_len, gen) — mixed tenants share a
        batch — and chunked to ``max_batch``; a batch's times are
        attributed to every request in it.  ``return_logits`` adds each
        request's float32 logits of every step, (P + G - 1, V), read
        from the device when its batch ends."""
        groups: "OrderedDict[Tuple[int, int], list]" = OrderedDict()
        for idx, r in enumerate(requests):
            groups.setdefault((len(r.prompt), r.gen), []).append((idx, r))
        results: List[dict] = [None] * len(requests)
        for (P, G), entries in groups.items():
            for lo in range(0, len(entries), self.max_batch):
                self._serve_batch(G, entries[lo:lo + self.max_batch],
                                  results, return_logits)
        return results

    def _serve_batch(self, G: int, chunk, results, return_logits) -> None:
        B = len(chunk)
        params = [self.params_for(r.tenant) for _, r in chunk]
        device = tree_leaves(params[0])[0].device
        prompts = torch.from_numpy(
            np.array([r.prompt for _, r in chunk], np.int64)).to(device)
        first, rest, ttft, total, logits = self._generate(
            params, prompts, G, return_logits)
        first, rest = first.cpu().numpy(), rest.cpu().numpy()
        if logits is not None:
            logits = logits.cpu().numpy()
        self.metrics.batches += 1
        for row, (idx, r) in enumerate(chunk):
            seq = np.concatenate([np.asarray(r.prompt, np.int32),
                                  first[row:row + 1].astype(np.int32),
                                  rest[row].astype(np.int32)])
            stats = self.metrics.tenant(r.tenant)
            stats.requests += 1
            stats.tokens_generated += G
            stats.ttft_s.append(ttft)
            stats.gen_time_s += total
            results[idx] = {"tenant": str(r.tenant), "tokens": seq,
                            "ttft_s": ttft, "gen_time_s": total,
                            "batch_size": B}
            if logits is not None:
                results[idx]["logits"] = logits[row]
