"""Durable, sharded, resumable checkpoints — the counterpart of
``repro.checkpoint``.  Both packages read and write the same files.

  * :mod:`.io` — container files (magic + length + CRC-32 header;
    tmp -> fsync -> rename -> directory fsync writes;
    :class:`CheckpointCorruptError`);
  * :mod:`.pack` — trees <-> the MessagePack marker format (arrays,
    scalars, tuples, codec payloads, FlatLayouts and treedefs; escaped
    reserved keys; host views on ``lazy`` restore), through the port's
    own MessagePack codec (:mod:`.mpack`);
  * :mod:`.manager` — :class:`CheckpointManager`: step directories of
    64-byte-aligned shards, one background commit worker, the atomic
    ``latest`` pointer with its fallback scan, pruning;
  * :mod:`.resume` — :class:`CheckpointPolicy` and the rollout snapshot
    ``run_l2gd`` resumes from bit for bit.

The single-file API: :func:`save` / :func:`restore` /
:func:`save_state` / :func:`restore_state`.  ``restore`` gives tensors
on ``device`` (default CUDA) or, with ``lazy=True``, read-only host
views over the file's buffer; headerless files of the format before the
container still load.
"""
from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.io import (CheckpointCorruptError, MAGIC,
                                       header_valid, read_durable,
                                       write_durable)
from repro_torch.checkpoint.manager import (CheckpointManager, all_steps,
                                            latest_step, restore_sharded,
                                            save_sharded, step_dir)
from repro_torch.checkpoint.pack import (pack_bytes, pack_chunks,
                                         register_payload_class,
                                         unpack_bytes)
from repro_torch.checkpoint.resume import (CheckpointPolicy, RolloutSnapshot,
                                           load_rollout_checkpoint)
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["save", "restore", "save_state", "restore_state",
           "register_payload_class",
           "CheckpointCorruptError", "CheckpointManager",
           "CheckpointPolicy", "RolloutSnapshot",
           "save_sharded", "restore_sharded", "latest_step", "all_steps",
           "load_rollout_checkpoint"]


def save(path: str, tree: Any) -> None:
    """Durably write one tree as a single container file."""
    write_durable(path, pack_chunks(tree))


def restore(path: str, *, lazy: bool = False, device=None) -> Any:
    """Read and validate one checkpoint file: tensors on ``device``
    (default CUDA), or with ``lazy=True`` read-only host views over the
    file's buffer.  A truncated or bit-flipped file raises
    :class:`CheckpointCorruptError`."""
    if not lazy:
        device = resolve_device(device)
    return unpack_bytes(read_durable(path), np_views=lazy, device=device)


def save_state(path: str, params, extra: dict | None = None) -> None:
    save(path, {"params": params, "extra": extra or {}})


def restore_state(path: str, *, lazy: bool = False, device=None):
    t = restore(path, lazy=lazy, device=device)
    return t["params"], t["extra"]
