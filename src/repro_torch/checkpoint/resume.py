"""The resumable rollout's snapshot format and :class:`CheckpointPolicy`
— the counterpart of ``repro.checkpoint.resume`` (copied and adapted,
not imported).

A rollout checkpoint holds everything ``run_l2gd`` needs to continue a
chunked run:

    (L2GDState, AsyncAggState?, protocol key, ledger state, realized xi
     trace, loss / eval traces, branch counters, a config signature)

Every random stream of the protocol — xi, compressor noise,
participation masks, fault draws — is keyed by the global step carried
in ``L2GDState.step`` (and the async engine's round clock
``AsyncAggState.rnd``), so chunk boundaries are invisible to the
trajectory: restoring a boundary snapshot and continuing reproduces the
uninterrupted run bit for bit (params, ledger history, losses, xi
trace).  That needs the params stored exactly, so resume takes
``mode="dense"`` snapshots.

``mode="delta"`` stores each client's params as a codec payload of
``x_i - cache`` (the serving layout of :mod:`repro_torch.serve.store`),
encoded by the plan's pack kernels.  Lossy codecs make the restored
params approximate, so a delta snapshot is for storage and serving;
resuming from one is refused unless ``allow_lossy=True``.

The snapshot's scalars (``state.step``, ``state.xi_prev``,
``agg.rnd``) are 0-d int32 arrays and its key the raw uint32 words, as
in the reference's snapshots, so each package continues from the
other's files.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import (DEFAULT_SHARD_BYTES,
                                            CheckpointManager)
from repro_torch.checkpoint.pack import to_device
from repro_torch.core import prng
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["CheckpointPolicy", "RolloutSnapshot", "rollout_signature",
           "pack_snapshot", "unpack_snapshot", "load_rollout_checkpoint",
           "validate_resume", "delta_pack_stacked", "delta_unpack_stacked"]

FORMAT = "l2gd-rollout/v1"
_MODES = ("dense", "delta")


@dataclasses.dataclass
class CheckpointPolicy:
    """When, where and how ``run_l2gd`` snapshots a rollout.

    Args:
      manager: a :class:`CheckpointManager` or a root directory (a
        manager is built on first use from ``max_to_keep`` /
        ``shard_bytes``).
      every_n_chunks: snapshot cadence in chunks; the final chunk
        boundary is always snapshotted.
      mode: ``"dense"`` (bit-exact resume, the default) or ``"delta"``
        (per-client codec payloads against the global model).
      delta_plan: the CompressionPlan or compressor of delta mode.
      wait: block the run until each commit lands (default: only the
        host snapshot blocks).
    """

    manager: Union[CheckpointManager, str]
    every_n_chunks: int = 1
    mode: str = "dense"
    delta_plan: Any = None
    wait: bool = False
    max_to_keep: Optional[int] = None
    shard_bytes: int = DEFAULT_SHARD_BYTES

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown checkpoint mode {self.mode!r}; "
                             f"have {_MODES}")
        if int(self.every_n_chunks) < 1:
            raise ValueError("every_n_chunks must be >= 1, "
                             f"got {self.every_n_chunks}")
        if self.mode == "delta" and self.delta_plan is None:
            raise ValueError("mode='delta' needs delta_plan=")

    def resolve(self) -> CheckpointManager:
        if not isinstance(self.manager, CheckpointManager):
            self.manager = CheckpointManager(
                str(self.manager), max_to_keep=self.max_to_keep,
                shard_bytes=self.shard_bytes)
        return self.manager


@dataclasses.dataclass
class RolloutSnapshot:
    """One unpacked rollout checkpoint (see :func:`pack_snapshot`)."""

    key: np.ndarray          # the run's key words, uint32 (2,)
    done: int                # steps completed at the snapshot
    xi_prev: int             # the host's xi carry at the boundary
    signature: dict          # rollout_signature of the run
    state: Any               # L2GDState on the run's device
    agg: Any                 # AsyncAggState | None (faulty runs)
    ledger_state: dict       # BitsLedger.state_dict()
    losses: List[tuple]
    evals: List[tuple]
    n_local: int
    n_agg_comm: int
    n_agg_cached: int
    xis: np.ndarray          # realized xi trace of steps [0, done)
    fault_stats: Optional[dict]
    mode: str = "dense"


def _key_array(key) -> np.ndarray:
    return np.asarray(key, np.uint32)


def rollout_signature(*, steps: int, n: int, up_bits, down_bits: float,
                      participation: Optional[float], faults) -> dict:
    """The config facts a resumed run must agree on, checked before any
    step runs.  Codecs, hyperparameters and batches are covered
    transitively: a difference there changes params or ledger."""
    if isinstance(up_bits, (int, float)):
        up = float(up_bits)
    else:                              # a fleet's per-client vector
        up = [float(b) for b in np.asarray(up_bits).ravel()]
    return {
        "format": FORMAT,
        "steps": int(steps),
        "n": int(n),
        "up_bits": up,
        "down_bits": float(down_bits),
        "participation": None if participation is None
        else float(participation),
        "engine": "scan" if faults is None else "async",
        "faults": None if faults is None else json.dumps(
            dataclasses.asdict(faults), sort_keys=True),
    }


# -- delta params block -----------------------------------------------------

def delta_pack_stacked(params_stacked, base, plan, key=None) -> dict:
    """Encode client-stacked params as per-client payloads of ``x_i -
    base`` (float32), client i under ``fold_in(key, i)``: the same params
    always give the same payload bytes."""
    from repro_torch.core.codec import as_plan, plan_spec
    bound = as_plan(plan).bind(base)
    key = prng.PRNGKey(0) if key is None else np.asarray(key, np.uint32)
    n = int(tree_leaves(params_stacked)[0].shape[0])
    payloads = []
    for i in range(n):
        delta = tree_map(lambda x, b: (x[i] - b).to(torch.float32),
                         params_stacked, base)
        payloads.append(bound.encode(prng.fold_in(key, i), delta))
    return {"plan": plan_spec(bound), "n": n, "payloads": payloads}


def delta_unpack_stacked(block: dict, base):
    """The stacked params of :func:`delta_pack_stacked` (approximate
    under lossy codecs)."""
    from repro_torch.core.codec import decode_payload, plan_from_spec
    plan = plan_from_spec(block["plan"]).bind(base)
    clients = []
    for payload in block["payloads"]:
        delta = decode_payload(payload, plan.codec)
        clients.append(tree_map(
            lambda b, d: (b + d.to(torch.float32)).to(b.dtype), base, delta))
    return tree_map(lambda *xs: torch.stack(xs), *clients)


# -- snapshot <-> checkpoint tree -------------------------------------------

def pack_snapshot(*, key, done: int, xi_prev: int, state, ledger, run,
                  xis: np.ndarray, signature: dict, agg=None,
                  mode: str = "dense", delta_plan=None) -> dict:
    """The checkpoint tree of one chunk boundary; ``run`` is the
    driver's :class:`~repro_torch.fl.l2gd_driver.L2GDRun` at the
    boundary, ``xis`` the realized xi trace so far."""
    from repro_torch.core.rollout import state_to_tree
    st = state_to_tree(state)
    if mode == "delta":
        params_block = {"mode": "delta",
                        "delta": delta_pack_stacked(st["params"],
                                                    st["cache"], delta_plan)}
    else:
        params_block = {"mode": "dense", "dense": st["params"]}
    agg_tree = None
    if agg is not None:
        from repro_torch.core.async_engine import agg_state_to_tree
        agg_tree = agg_state_to_tree(agg)
    return {
        "format": FORMAT,
        "key": _key_array(key),
        "done": int(done),
        "xi_prev": int(xi_prev),
        "signature": dict(signature),
        "state": {"params": params_block, "cache": st["cache"],
                  "xi_prev": st["xi_prev"], "step": st["step"]},
        "agg": agg_tree,
        "ledger": ledger.state_dict(),
        "run": {
            "loss_steps": np.asarray([s for s, _ in run.losses], np.int64),
            "loss_vals": np.asarray([v for _, v in run.losses], np.float64),
            "eval_steps": np.asarray([s for s, _ in run.evals], np.int64),
            "eval_vals": np.asarray([v for _, v in run.evals], np.float64),
            "n_local": int(run.n_local),
            "n_agg_comm": int(run.n_agg_comm),
            "n_agg_cached": int(run.n_agg_cached),
            "xis": np.asarray(xis, np.int32),
            "fault_stats": None if run.fault_stats is None
            else {k: int(v) for k, v in run.fault_stats.items()},
        },
    }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def unpack_snapshot(tree: dict, *, allow_lossy: bool = False,
                    device=None) -> RolloutSnapshot:
    """A restored checkpoint tree (host views or tensors) as a
    :class:`RolloutSnapshot` whose state lies on ``device`` (default
    CUDA)."""
    from repro_torch.core.rollout import state_from_tree
    device = resolve_device(device)
    if not isinstance(tree, dict) or tree.get("format") != FORMAT:
        got = tree.get("format") if isinstance(tree, dict) else tree
        raise ValueError(f"not a rollout checkpoint (format={got!r})")
    params_block = tree["state"]["params"]
    mode = params_block["mode"]
    cache = to_device(tree["state"]["cache"], device)
    if mode == "dense":
        params = to_device(params_block["dense"], device)
    else:
        if not allow_lossy:
            raise ValueError(
                "checkpoint stores params as LOSSY codec deltas "
                "(mode='delta'); resuming from it is approximate, not "
                "bit-exact — pass allow_lossy=True to proceed anyway")
        params = delta_unpack_stacked(
            to_device(params_block["delta"], device), cache)
    state = state_from_tree({"params": params, "cache": cache,
                             "xi_prev": tree["state"]["xi_prev"],
                             "step": tree["state"]["step"]})
    agg = None
    if tree.get("agg") is not None:
        from repro_torch.core.async_engine import agg_state_from_tree
        agg = agg_state_from_tree(to_device(tree["agg"], device))
    r = tree["run"]
    return RolloutSnapshot(
        key=_host(tree["key"]).astype(np.uint32),
        done=int(tree["done"]), xi_prev=int(tree["xi_prev"]),
        signature=tree["signature"], state=state, agg=agg,
        ledger_state=tree["ledger"],
        losses=[(int(s), float(v)) for s, v in
                zip(_host(r["loss_steps"]), _host(r["loss_vals"]))],
        evals=[(int(s), float(v)) for s, v in
               zip(_host(r["eval_steps"]), _host(r["eval_vals"]))],
        n_local=int(r["n_local"]), n_agg_comm=int(r["n_agg_comm"]),
        n_agg_cached=int(r["n_agg_cached"]),
        xis=_host(r["xis"]).astype(np.int32),
        fault_stats=r["fault_stats"], mode=mode)


def _manager(source) -> CheckpointManager:
    if isinstance(source, CheckpointPolicy):
        return source.resolve()
    if isinstance(source, CheckpointManager):
        return source
    return CheckpointManager(str(source))


def load_rollout_checkpoint(source, step: Optional[int] = None, *,
                            allow_lossy: bool = False,
                            device=None) -> RolloutSnapshot:
    """Load a rollout snapshot from a manager, root path or policy onto
    ``device`` (default CUDA); ``step=None`` takes the newest complete
    step."""
    device = resolve_device(device)
    tree = _manager(source).restore(step, lazy=True)
    return unpack_snapshot(tree, allow_lossy=allow_lossy, device=device)


def validate_resume(snapshot: RolloutSnapshot, signature: dict,
                    key) -> None:
    """Refuse a resume whose config signature or key differs from the
    checkpoint's: continuing would fork the trajectory."""
    mismatches = []
    stored = snapshot.signature
    for field, want in signature.items():
        have = stored.get(field)
        if have != want:
            mismatches.append(f"{field}: checkpoint={have!r} run={want!r}")
    if not np.array_equal(snapshot.key, _key_array(key)):
        mismatches.append("key: checkpoint was written under a different "
                          "PRNG key")
    if mismatches:
        raise ValueError("cannot resume — checkpoint/run config mismatch: "
                         + "; ".join(mismatches))
