"""DeltaModelStore: many personalized models resident as compressed
deltas from one shared base — the counterpart of ``repro.serve.store``.

Formulation (1) trains n personalized models x_1..x_n pulled toward
their mean by the penalty lambda/2n sum ||x_i - xbar||^2, so at serving
time they cluster around the mean and the resident layout is

    base (dense, xbar)  +  one codec payload per tenant of x_i - base.

Any :class:`~repro_torch.core.codec.CompressionPlan` gives the delta's
wire format, and ``Payload.nbits`` is the exact bits of what is stored,
so ``models_per_gb()`` is measured from the stored objects.  On the card
the flat and packed plans encode with the pack kernels (``qsgd_pack``,
``natural_pack``) and QSGD tenants decode with ``qsgd_unpack``.
``narrow=True`` repacks a flat-engine QSGD payload (levels <= 7) to
4-bit codes (:func:`~repro_torch.core.flatbuf.narrow_tree_qsgd`), which
decode bit for bit as the int8 codes do.

Persistence rides the checkpoint format (:mod:`repro_torch.checkpoint`):
the payload dataclasses round-trip bit for bit, and a store file of
either package loads in the other.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint.manager import (latest_step, restore_sharded,
                                            step_dir)
from repro_torch.checkpoint.pack import to_device
from repro_torch.checkpoint.resume import FORMAT
from repro_torch.core import flatbuf, prng
from repro_torch.core.aggregation import client_mean
from repro_torch.core.codec import (CompressionPlan, as_plan, decode_payload,
                                    plan_from_spec, plan_spec)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["DeltaModelStore", "plan_spec", "plan_from_spec"]

_BITS_PER_GB = 8.0 * 1024 ** 3


class DeltaModelStore:
    """Base-plus-compressed-delta residency for many personalized models.

    Args:
      base: tree of tensors — the shared global model; its device is the
        store's.
      plan: CompressionPlan (or plain compressor) of the tenant deltas.
      key: key words for stochastic codecs; tenant i is encoded under
        ``fold_in(key, i)`` by insertion index, so ingesting the same
        models in the same order gives the same payloads.
      narrow: repack flat-engine QSGD payloads (levels <= 7) to 4-bit
        codes; decode widens first, bit for bit.
    """

    def __init__(self, base, plan, *, key=None, narrow: bool = False):
        self.base = base
        self.plan = as_plan(plan).bind(base)
        self.narrow = bool(narrow)
        if self.narrow:
            levels = getattr(self.plan.codec, "levels", None)
            if self.plan.transport not in ("flat", "packed") \
                    or levels is None or levels > 7:
                raise ValueError(
                    "narrow=True needs a flat/packed QSGD plan with "
                    f"levels <= 7; got transport={self.plan.transport!r}, "
                    f"levels={levels!r}")
        self._key = prng.PRNGKey(0) if key is None \
            else np.asarray(key, np.uint32)
        self._payloads: Dict[str, Any] = {}
        self._tenant_plans: Dict[str, CompressionPlan] = {}

    # -- ingestion ----------------------------------------------------------
    def add_tenant(self, tenant, params, *, plan=None) -> None:
        """Encode ``params - base`` under the plan and store the payload.

        ``plan`` (optional) overrides the store's plan for THIS tenant —
        the serving face of a heterogeneous fleet (DESIGN.md §13).  An
        overridden tenant stores what its own plan encodes (its
        ``narrow`` flag included); the store's ``narrow`` repack applies
        to default-plan tenants only."""
        tid = str(tenant)
        if tid in self._payloads:
            raise ValueError(f"tenant {tid!r} already stored")
        delta = tree_map(lambda x, b: (x - b).to(torch.float32),
                         params, self.base)
        k = prng.fold_in(self._key, len(self._payloads))
        if plan is not None:
            tplan = as_plan(plan).bind(self.base)
            self._tenant_plans[tid] = tplan
            payload = tplan.encode(k, delta)
        else:
            payload = self.plan.encode(k, delta)
            if self.narrow and not isinstance(payload,
                                              flatbuf.NarrowQSGDPayload):
                payload = flatbuf.narrow_tree_qsgd(payload)
        self._payloads[tid] = payload

    @classmethod
    def from_params(cls, stacked, plan, *, key=None,
                    ids: Optional[List[str]] = None,
                    narrow: bool = False) -> "DeltaModelStore":
        """Ingest client-stacked params (leading client axis): the base is
        the client mean (the reference's ``jnp.mean``,
        :func:`~repro_torch.core.aggregation.client_mean`), tenant i's
        delta ``x_i - mean``.  ``plan`` may be a
        :class:`repro_torch.fl.fleet.FleetPlan`: tenant i is ingested
        under ``fleet.plan_for(i)`` (client 0's cohort plan is the
        store's, the other cohorts ride per-tenant overrides)."""
        n = tree_leaves(stacked)[0].shape[0]
        base = tree_map(client_mean, stacked)
        fleet = plan if hasattr(plan, "cohorts") else None
        if fleet is not None:
            if fleet.n_clients != n:
                raise ValueError(f"fleet covers {fleet.n_clients} clients; "
                                 f"params are stacked for {n}")
            plan = fleet.plan_for(0)
        store = cls(base, plan, key=key, narrow=narrow)
        ids = [str(i) for i in range(n)] if ids is None else list(ids)
        if len(ids) != n:
            raise ValueError(f"{len(ids)} ids for {n} client slices")
        for i, tid in enumerate(ids):
            override = None
            if fleet is not None \
                    and fleet.cohort_of(i) != fleet.cohort_of(0):
                override = fleet.plan_for(i)
            store.add_tenant(tid, tree_map(lambda a: a[i], stacked),
                             plan=override)
        return store

    @classmethod
    def from_checkpoint(cls, path: str, plan=None, *, device=None,
                        **kwargs) -> "DeltaModelStore":
        """Ingest a federated training checkpoint onto ``device``
        (default CUDA), from three sources:

          * a ``checkpoint.save_state`` file of stacked params; ``plan``
            encodes every client as a delta;
          * a :class:`~repro_torch.checkpoint.CheckpointManager` root or
            step directory holding a DENSE rollout snapshot: its stacked
            params are encoded under ``plan``;
          * the same holding a DELTA rollout snapshot: its per-client
            payloads (deltas against the global model already) are
            adopted as they are, the base is the snapshot's cache, and
            ``plan`` may be omitted (the stored plan spec rebuilds it).
        """
        device = resolve_device(device)
        if os.path.isdir(path):
            step = latest_step(path)
            snap_dir = path if step is None else step_dir(path, step)
            tree = restore_sharded(snap_dir, lazy=True)
            if not (isinstance(tree, dict) and tree.get("format") == FORMAT):
                raise ValueError(f"{snap_dir!r} is not a rollout "
                                 "checkpoint directory")
            params_block = tree["state"]["params"]
            if params_block["mode"] == "delta":
                block = params_block["delta"]
                base = to_device(tree["state"]["cache"], device)
                stored = plan_from_spec(block["plan"]) if plan is None \
                    else as_plan(plan)
                store = cls(base, stored, **kwargs)
                for i, payload in enumerate(block["payloads"]):
                    store._payloads[str(i)] = to_device(payload, device)
                return store
            stacked = to_device(params_block["dense"], device)
        else:
            stacked, _extra = checkpoint.restore_state(path, device=device)
        if plan is None:
            raise ValueError("plan= is required to ingest dense "
                             "checkpoint params (only delta rollout "
                             "checkpoints carry their own plan spec)")
        return cls.from_params(stacked, plan, **kwargs)

    # -- read path ----------------------------------------------------------
    @property
    def tenants(self) -> List[str]:
        return list(self._payloads)

    def __contains__(self, tenant) -> bool:
        return str(tenant) in self._payloads

    def __len__(self) -> int:
        return len(self._payloads)

    def payload(self, tenant):
        return self._payloads[str(tenant)]

    def tenant_plan(self, tenant) -> CompressionPlan:
        """The plan the tenant's payload was encoded under: its override,
        else the store's."""
        return self._tenant_plans.get(str(tenant), self.plan)

    def materialize(self, tenant):
        """One tenant's params: base + decode(payload), cast back to the
        base's dtype leaf by leaf.  Deterministic: decode draws nothing."""
        tid = str(tenant)
        delta = decode_payload(self._payloads[tid],
                               self.tenant_plan(tid).codec)
        return tree_map(lambda b, d: (b + d.to(torch.float32)).to(b.dtype),
                        self.base, delta)

    # -- residency accounting (measured, from Payload.nbits) ---------------
    def tenant_bits(self, tenant) -> float:
        return float(self._payloads[str(tenant)].nbits)

    def base_bits(self) -> float:
        return float(sum(a.numel() * a.element_size() * 8
                         for a in tree_leaves(self.base)))

    def total_bits(self) -> float:
        return self.base_bits() + sum(float(p.nbits)
                                      for p in self._payloads.values())

    def models_per_gb(self) -> float:
        """Tenant models resident per GB, the shared base counted once."""
        if not self._payloads:
            return 0.0
        return len(self._payloads) / (self.total_bits() / _BITS_PER_GB)

    def models_per_gb_by_cohort(self) -> Dict[str, float]:
        """:meth:`models_per_gb` by cohort: tenants grouped by their plan's
        :func:`repro_torch.fl.fleet.cohort_label`, each cohort's density
        counting the shared base once in its own total."""
        from repro_torch.fl.fleet import cohort_label
        groups: Dict[str, List[float]] = {}
        for tid, payload in self._payloads.items():
            label = cohort_label(self.tenant_plan(tid))
            groups.setdefault(label, []).append(float(payload.nbits))
        base = self.base_bits()
        return {label: len(bits) / ((base + sum(bits)) / _BITS_PER_GB)
                for label, bits in groups.items()}

    def dense_models_per_gb(self, bits_per_param: float = 16.0) -> float:
        """Models per GB if every tenant were resident dense at
        ``bits_per_param`` (16: bf16, 32: the float32 params here)."""
        d = sum(a.numel() for a in tree_leaves(self.base))
        return _BITS_PER_GB / (bits_per_param * d)

    # -- persistence (rides the checkpoint format) ---------------------------
    def save(self, path: str) -> None:
        checkpoint.save(path, {
            "base": self.base,
            "plan": plan_spec(self.plan),
            "narrow": self.narrow,
            "key": self._key,
            "ids": list(self._payloads),
            "payloads": list(self._payloads.values()),
            # per-tenant plan overrides, as (ids, specs) parallel lists
            "tenant_plan_ids": list(self._tenant_plans),
            "tenant_plan_specs": [plan_spec(p)
                                  for p in self._tenant_plans.values()],
        })

    @classmethod
    def load(cls, path: str, *, device=None) -> "DeltaModelStore":
        """A store saved by either package, onto ``device`` (default
        CUDA)."""
        t = checkpoint.restore(path, lazy=True)
        device = resolve_device(device)
        store = cls(to_device(t["base"], device), plan_from_spec(t["plan"]),
                    key=np.asarray(t["key"], np.uint32),
                    narrow=bool(t["narrow"]))
        store._payloads = {tid: to_device(p, device)
                           for tid, p in zip(t["ids"], t["payloads"])}
        store._tenant_plans = {
            tid: plan_from_spec(spec).bind(store.base)
            for tid, spec in zip(t.get("tenant_plan_ids", ()),
                                 t.get("tenant_plan_specs", ()))}
        return store
