"""Step-tagged, sharded, asynchronous checkpoints — the counterpart of
``repro.checkpoint.manager`` (copied and adapted, not imported).

On-disk layout under one ``root``::

    root/
      latest                    # container: MessagePack {"step": N}
      step_0000000042/
        meta.ckpt               # the skeleton; arrays are __ref__ markers
        shard_00000.ckpt        # leaf bytes at 64-byte-aligned offsets
        shard_00001.ckpt
      .tmp-step_0000000050/     # a commit in flight; readers never look

Commit: every file goes through ``write_durable`` into the staging
directory ``.tmp-step_N``, the staging directory is renamed to
``step_N`` (the commit point), the root is fsynced, and only then is
``latest`` rewritten.  A kill at any instant leaves ``latest`` naming a
complete step, or a newer complete step with a stale pointer:
:func:`latest_step` falls back to a descending scan of the step
directories (checking headers cheaply) when the pointer is missing,
corrupt or dangling.

:class:`CheckpointManager` packs and writes on one background worker,
so commits stay in step order.  ``save`` blocks only for the host
snapshot: every tensor is COPIED to host memory before ``save``
returns — the port's engines write their buffers in place (the params,
the cache, the async engine's ring buffer), a CPU tensor's ``.cpu()`` is
the same storage, and a CUDA tensor's copy to the host must have ended
before the worker reads it.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import mpack
from repro_torch.checkpoint.io import (CheckpointCorruptError, fsync_dir,
                                       header_valid, read_durable,
                                       write_durable)
from repro_torch.checkpoint.pack import (ArraySink, _is_payload, pack_tree,
                                         unpack_tree)
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["CheckpointManager", "save_sharded", "restore_sharded",
           "latest_step", "all_steps", "step_dir"]

_META = "meta.ckpt"
_LATEST = "latest"
_STEP_RE = re.compile(r"^step_(\d{10})$")
#: default shard size bound; small trees land in a single shard
DEFAULT_SHARD_BYTES = 128 << 20
#: shard files written or read at once
_IO_THREADS = 8


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{int(step):010d}")


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.ckpt"


def save_sharded(dirpath: str, tree: Any,
                 shard_bytes: int = DEFAULT_SHARD_BYTES) -> None:
    """Write one tree as meta + shard containers into ``dirpath``: leaf
    bytes packed greedily into shards of at most ``shard_bytes`` (a
    larger leaf gets its own; leaves are never split), the skeleton with
    ``__ref__`` markers in ``meta.ckpt``."""
    sink = ArraySink(shard_bytes)
    skeleton = pack_tree(tree, sink=sink)
    shards = sink.shard_chunks()
    os.makedirs(dirpath, exist_ok=True)
    # the shards go down together (the writes and fsyncs release the
    # interpreter lock), the skeleton after every one of them
    with ThreadPoolExecutor(max_workers=min(len(shards), _IO_THREADS)) \
            as pool:
        for fut in [pool.submit(write_durable,
                                os.path.join(dirpath, _shard_name(i)), c)
                    for i, c in enumerate(shards)]:
            fut.result()
    write_durable(os.path.join(dirpath, _META),
                  mpack.pack_chunks({"skeleton": skeleton,
                                     "nshards": len(shards)}))


def restore_sharded(dirpath: str, *, lazy: bool = False, device=None):
    """Restore a :func:`save_sharded` directory.  ``lazy=True`` returns
    read-only views over the shard buffers (one read a shard, no further
    copy); otherwise tensors on ``device`` (default CUDA)."""
    if not lazy:
        device = resolve_device(device)
    meta_path = os.path.join(dirpath, _META)
    meta = mpack.unpack(read_durable(meta_path, allow_legacy=False))
    nshards = int(meta["nshards"])
    # every shard is read (and CRC-checked) at once, in parallel
    with ThreadPoolExecutor(max_workers=max(1, min(nshards, _IO_THREADS))) \
            as pool:
        cache = dict(enumerate(pool.map(
            lambda i: read_durable(os.path.join(dirpath, _shard_name(i)),
                                   allow_legacy=False), range(nshards))))

    def buffers(i: int):
        if i not in cache:
            raise CheckpointCorruptError(
                meta_path, f"skeleton references shard {i} but meta "
                           f"declares {nshards} shards")
        return cache[i]

    return unpack_tree(meta["skeleton"], buffers=buffers, np_views=lazy,
                       device=device)


def _dir_complete(dirpath: str) -> bool:
    """Cheap completeness probe: the meta header parses and every shard
    it declares is there with a self-consistent header (no CRC pass)."""
    meta_path = os.path.join(dirpath, _META)
    if not header_valid(meta_path):
        return False
    try:
        meta = mpack.unpack(read_durable(meta_path, allow_legacy=False))
        nshards = int(meta["nshards"])
    except (CheckpointCorruptError, ValueError, KeyError, TypeError):
        return False
    return all(header_valid(os.path.join(dirpath, _shard_name(i)))
               for i in range(nshards))


def all_steps(root: str) -> List[int]:
    """Committed steps under ``root``, ascending (complete dirs only)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    steps = []
    for name in names:
        m = _STEP_RE.match(name)
        if m and _dir_complete(os.path.join(root, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """The newest complete step: the ``latest`` pointer when it is valid
    and its target complete, else a scan of the step directories."""
    try:
        payload = read_durable(os.path.join(root, _LATEST),
                               allow_legacy=False)
        step = int(mpack.unpack(payload)["step"])
        if _dir_complete(step_dir(root, step)):
            return step
    except (FileNotFoundError, CheckpointCorruptError, ValueError,
            KeyError, TypeError):
        pass
    steps = all_steps(root)
    return steps[-1] if steps else None


def _host_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` in host memory the caller cannot mutate: every
    tensor copied to a CPU tensor (a CUDA copy has ended on return),
    every numpy array copied; payload dataclasses field by field."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, (np.ndarray, np.generic)):
        return np.array(tree, copy=True)
    if _is_payload(tree):
        changes = {f.name: _host_snapshot(getattr(tree, f.name))
                   for f in dataclasses.fields(tree)
                   if f.name == "leaves" or isinstance(
                       getattr(tree, f.name), (torch.Tensor, np.ndarray))}
        return dataclasses.replace(tree, **changes)
    if isinstance(tree, dict):
        return {k: _host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_host_snapshot(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, list):
        return [_host_snapshot(v) for v in tree]
    return tree


class CheckpointManager:
    """Asynchronous, sharded, step-tagged checkpoints with an atomic
    ``latest`` pointer and optional pruning.

    ``save`` snapshots to the host at once and commits on one background
    worker; ``wait=True`` or :meth:`wait_until_finished` joins it.  A
    failed commit is raised by the next ``save`` or by
    :meth:`wait_until_finished`, never dropped.  ``max_to_keep=N`` prunes
    the oldest committed steps after each commit (``None`` keeps all)."""

    def __init__(self, root: str, *, max_to_keep: Optional[int] = None,
                 shard_bytes: int = DEFAULT_SHARD_BYTES):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.root = os.path.abspath(root)
        self.max_to_keep = max_to_keep
        self.shard_bytes = int(shard_bytes)
        os.makedirs(self.root, exist_ok=True)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    # -- write path ---------------------------------------------------------

    def save(self, step: int, tree: Any, *, wait: bool = False) -> Future:
        """Snapshot ``tree`` now and commit it as ``step`` in the
        background; returns the commit's Future (its result is the step
        directory).  The caller may write its tensors as soon as this
        returns."""
        self._reap_pending()
        snapshot = _host_snapshot(tree)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-commit")
        fut = self._pool.submit(self._commit, int(step), snapshot)
        self._pending.append(fut)
        if wait:
            fut.result()
        return fut

    def _reap_pending(self) -> None:
        """Drop finished commits, raising the first failure among them."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for fut in done:
            exc = fut.exception()
            if exc is not None:
                raise exc

    def _commit(self, step: int, snapshot: Any) -> str:
        final = step_dir(self.root, step)
        staging = os.path.join(self.root, f".tmp-step_{step:010d}")
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        save_sharded(staging, snapshot, self.shard_bytes)
        if os.path.isdir(final):          # a re-commit of the same step
            shutil.rmtree(final)
        os.replace(staging, final)        # the commit point
        fsync_dir(self.root)
        write_durable(os.path.join(self.root, _LATEST),
                      mpack.packb({"step": step}))
        self._prune(keep=step)
        return final

    def _prune(self, keep: int) -> None:
        if self.max_to_keep is None:
            return
        for old in all_steps(self.root)[:-self.max_to_keep]:
            if old != keep:
                shutil.rmtree(step_dir(self.root, old), ignore_errors=True)

    # -- read path ----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return latest_step(self.root)

    def all_steps(self) -> List[int]:
        return all_steps(self.root)

    def restore(self, step: Optional[int] = None, *, lazy: bool = False,
                device=None):
        """Restore ``step`` (default: the newest complete one)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoint under {self.root!r}")
        return restore_sharded(step_dir(self.root, int(step)), lazy=lazy,
                               device=device)

    # -- lifecycle ----------------------------------------------------------

    def wait_until_finished(self) -> None:
        """Join every commit in flight (raising the first failure)."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait_until_finished()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
