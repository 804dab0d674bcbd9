"""Durable container files — the counterpart of ``repro.checkpoint.io``
(copied and adapted, not imported).

Every checkpoint file — a whole-tree file, a shard, the ``meta``
skeleton, the ``latest`` pointer — is a *container*: a 20-byte header
(magic ``RPCKPT01``, u64 payload length, u32 CRC-32 of the payload, all
little-endian) followed by the payload.  :func:`write_durable` writes

    tmp file -> flush -> fsync(file) -> os.replace -> fsync(directory)

so a crash at any point leaves either the previous file or the new one
complete under the final name, never a torn file.  :func:`read_durable`
validates magic, length and CRC and raises
:class:`CheckpointCorruptError` naming the failed check; a file without
the magic (the headerless format that came before the container) is
still returned whole when ``allow_legacy``.

The payload may be given as a list of bytes-like chunks (written one
after the other, the CRC taken over them in order), so a model-sized
shard is written from its host buffers without being joined first.
A read maps the file (``mmap``, read-only) and returns a memoryview of
the mapping: the arrays restored from it are views of the page cache,
with no copy into a buffer of the process.
"""
from __future__ import annotations

import mmap
import os
import struct
import zlib

__all__ = ["CheckpointCorruptError", "MAGIC", "HEADER_BYTES",
           "write_durable", "read_durable", "fsync_dir", "header_valid"]

#: 8-byte container magic; the trailing digit versions the header layout
MAGIC = b"RPCKPT01"
_HEADER = struct.Struct("<8sQI")     # magic, payload nbytes, crc32(payload)
HEADER_BYTES = _HEADER.size


def crc32(chunks) -> int:
    """CRC-32 of the chunks laid end to end."""
    crc = 0
    for c in chunks:
        crc = zlib.crc32(memoryview(c).cast("B"), crc)
    return crc


class CheckpointCorruptError(Exception):
    """A checkpoint file failed validation (bad magic / truncated / CRC
    mismatch / unreadable).  Carries ``path`` and ``reason``."""

    def __init__(self, path: str, reason: str):
        self.path, self.reason = path, reason
        super().__init__(f"corrupt checkpoint {path!r}: {reason}")


def fsync_dir(path: str) -> None:
    """fsync a directory so that a rename into it survives a crash;
    platforms without O_DIRECTORY make this a no-op."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _chunks(payload):
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return [payload]
    return list(payload)


def write_durable(path: str, payload) -> None:
    """Atomically and durably write one container file; ``payload`` is
    bytes-like or a sequence of bytes-like chunks.  A crash leaves at
    worst a ``path + ".tmp"`` orphan, which readers never look at."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    chunks = _chunks(payload)
    crc = crc32(chunks)
    nbytes = sum(memoryview(c).nbytes for c in chunks)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, nbytes, crc))
        for c in chunks:
            f.write(c)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(directory)


def _read_all(path: str) -> memoryview:
    """The file's bytes: a read-only memoryview of its mapping."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return memoryview(b"")
        return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))


def read_durable(path: str, *, allow_legacy: bool = True) -> memoryview:
    """Read and validate one container file; returns the payload as a
    read-only memoryview of the file's mapping.  A missing file raises
    ``FileNotFoundError``; every failed check raises
    :class:`CheckpointCorruptError`."""
    try:
        raw = _read_all(path)
    except FileNotFoundError:
        raise
    except OSError as e:
        raise CheckpointCorruptError(path, f"unreadable: {e}") from e
    if len(raw) == 0:
        raise CheckpointCorruptError(path, "empty file")
    if bytes(raw[:len(MAGIC)]) != MAGIC:
        if allow_legacy:
            return raw
        raise CheckpointCorruptError(path, "bad magic (not a checkpoint "
                                           "container)")
    if len(raw) < HEADER_BYTES:
        raise CheckpointCorruptError(path, "truncated header")
    _, nbytes, crc = _HEADER.unpack_from(raw)
    payload = raw[HEADER_BYTES:]
    if len(payload) != nbytes:
        raise CheckpointCorruptError(
            path, f"truncated payload: header says {nbytes} bytes, "
                  f"file carries {len(payload)}")
    if crc32([payload]) != crc:
        raise CheckpointCorruptError(path, "CRC mismatch")
    return payload


def header_valid(path: str) -> bool:
    """Cheap validity probe: the header parses and the file size matches
    the declared payload length, without reading the payload (the
    ``latest`` fallback scan skips half-written shards with it; the CRC
    still runs on restore)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(HEADER_BYTES)
    except OSError:
        return False
    if len(head) < HEADER_BYTES or not head.startswith(MAGIC):
        return False
    _, nbytes, _ = _HEADER.unpack_from(head)
    return size == HEADER_BYTES + nbytes
