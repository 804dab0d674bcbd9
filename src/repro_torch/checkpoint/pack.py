"""Trees <-> the MessagePack marker format — the counterpart of
``repro.checkpoint.pack`` (copied and adapted, not imported).

Arrays are stored as (dtype name, shape, raw bytes); dicts, lists,
tuples (NamedTuples as tuples), Python scalars and every registered
payload dataclass (:mod:`repro_torch.core.codec`: wire tensors, static
fields, FlatLayouts and treedefs) round-trip bit for bit.  Both packages
write the same bytes for the same tree, and each reads the other's
files:

  * an array leaf is a ``torch.Tensor`` (brought to the host first) or a
    numpy array; its dtype is written under its numpy name, a torch
    ``bfloat16`` as its raw 16-bit words under ``"bfloat16"`` (numpy
    needs no bfloat16 type for that, so none is imported);
  * a treedef is written as the skeleton ``tree_unflatten(treedef,
    range(n_leaves))``, whose dicts carry their keys sorted, as the
    reference's ``jax.tree_util`` skeleton does;
  * a payload's ``dtype`` field and a FlatLayout's dtypes are torch
    dtypes here and numpy names on disk.

Reserved keys: the format marks arrays, scalars and payloads with
sentinel dict keys (``"__arr__"``, ...).  A user dict key that is
reserved, or already starts with the escape prefix ``"__esc__"``, is
written escaped and read back unescaped, so every dict round-trips.

Two modes beside the plain inline one:

  * ``sink=`` (pack): array bytes go to an :class:`ArraySink`, which
    places them at 64-byte-aligned offsets in size-bounded shards, and
    the skeleton carries ``__ref__`` markers (the sharded layout of
    :mod:`repro_torch.checkpoint.manager`);
  * ``np_views=True`` (unpack): array leaves come back as read-only numpy
    views over the files' mappings, with no copy (bfloat16 leaves as CPU
    tensors, numpy having no bfloat16); otherwise as tensors on the
    caller's device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import mpack
from repro_torch.core.tree import tree_flatten, tree_unflatten

__all__ = ["pack_tree", "unpack_tree", "pack_bytes", "pack_chunks",
           "unpack_bytes", "ArraySink", "register_payload_class",
           "RESERVED_KEYS", "dtype_name", "torch_dtype", "to_device"]

_ARR = "__arr__"
_SCALAR = "__scalar__"
_TUPLE = "__tuple__"
_PAYLOAD = "__payload__"
_LAYOUT = "__layout__"
_TREEDEF = "__treedef__"
_REF = "__ref__"
_ESC = "__esc__"

#: every marker key the unpacker dispatches on; user dict keys colliding
#: with these (or starting with the escape prefix) are escaped on pack
RESERVED_KEYS = frozenset({_ARR, _SCALAR, _TUPLE, _PAYLOAD, _LAYOUT,
                           _TREEDEF, _REF, _ESC})

#: alignment of array offsets inside a shard, from the payload's start
_ALIGN = 64

#: torch dtype -> numpy dtype name, the name written on disk
_NAMES = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.uint16: "uint16",
          torch.uint32: "uint32", torch.uint64: "uint64", torch.bool: "bool",
          torch.complex64: "complex64", torch.complex128: "complex128"}
_TORCH = {name: dt for dt, name in _NAMES.items()}

# name -> dataclass; seeded from repro_torch.core.codec on first use
_PAYLOAD_CLASSES: dict = {}


def dtype_name(dt) -> str:
    """The numpy name of a torch or numpy dtype (``"bfloat16"`` for
    torch's bfloat16)."""
    if isinstance(dt, torch.dtype):
        return _NAMES[dt]
    return str(np.dtype(dt))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name."""
    return _TORCH[str(name)]


def register_payload_class(cls) -> type:
    """Register a payload dataclass for checkpoint round-trips (the
    codec's payloads are registered on first use)."""
    _PAYLOAD_CLASSES[cls.__name__] = cls
    return cls


def _payload_classes() -> dict:
    if not _PAYLOAD_CLASSES:
        from repro_torch.core import codec
        for cls in (codec.DensePayload, codec.QSGDPayload,
                    codec.NaturalPayload, codec.TernPayload,
                    codec.SparsePayload, codec.BernoulliPayload,
                    codec.NarrowQSGDPayload, codec.TreePayload):
            _PAYLOAD_CLASSES.setdefault(cls.__name__, cls)
    return _PAYLOAD_CLASSES


def _is_payload(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type) \
        and _payload_classes().get(type(obj).__name__) is type(obj)


def _esc_key(k):
    if isinstance(k, str) and (k in RESERVED_KEYS or k.startswith(_ESC)):
        return _ESC + k
    return k


def _unesc_key(k):
    if isinstance(k, str) and k.startswith(_ESC):
        return k[len(_ESC):]
    return k


# -- shard sink -------------------------------------------------------------

class ArraySink:
    """Greedy size-bounded shard builder for the sharded pack mode.

    Leaf bytes are appended in traversal order; a shard closes when the
    next leaf would push a non-empty shard past ``shard_bytes`` (a leaf
    larger than the bound gets a shard of its own: arrays are never
    split).  Offsets are padded to 64 bytes.  The chunks are the leaves'
    own host buffers, not copies."""

    def __init__(self, shard_bytes: int):
        if int(shard_bytes) <= 0:
            raise ValueError(f"shard_bytes must be > 0, got {shard_bytes}")
        self.shard_bytes = int(shard_bytes)
        self.shards: List[List] = [[]]
        self._sizes: List[int] = [0]

    def add(self, data) -> dict:
        """Place one leaf's bytes; returns its ``{shard, offset, nbytes}``."""
        n = memoryview(data).nbytes
        size = self._sizes[-1]
        pad = (-size) % _ALIGN
        if self.shards[-1] and size + pad + n > self.shard_bytes:
            self.shards.append([])
            self._sizes.append(0)
            size = pad = 0
        if pad:
            self.shards[-1].append(b"\0" * pad)
            size += pad
        self.shards[-1].append(data)
        self._sizes[-1] = size + n
        return {"shard": len(self.shards) - 1, "offset": size, "nbytes": n}

    def shard_chunks(self) -> List[List]:
        """Each shard as its list of chunks (write them in order)."""
        return self.shards


# -- arrays -----------------------------------------------------------------

def _is_array(obj) -> bool:
    return isinstance(obj, (torch.Tensor, np.ndarray, np.generic))


def _array_parts(obj):
    """(dtype name, shape, bytes-like view of the host data)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.asarray(obj)
        if not a.flags.c_contiguous:
            a = a.copy(order="C")
        name = str(a.dtype)
    return name, [int(s) for s in a.shape], \
        memoryview(a.reshape(-1).view(np.uint8))


def _np_carrier(name: str) -> np.dtype:
    """The numpy dtype that holds a leaf's words (uint16 for bfloat16)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _to_tensor(a: np.ndarray, name: str, device) -> torch.Tensor:
    """A tensor of the leaf on ``device`` that owns its memory (a copy:
    the read-only views are never written through)."""
    if not a.flags.aligned:
        a = np.array(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    device = torch.device(device)
    return t.clone() if device.type == "cpu" else t.to(device)


def _leaf(buf, name: str, shape, offset: int, np_views: bool, device):
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    a = np.frombuffer(buf, dtype=_np_carrier(name), count=count,
                      offset=offset).reshape(shape)
    if np_views:
        if name == "bfloat16":
            if not a.flags.aligned or not a.flags.writeable:
                a = np.array(a)
            return torch.from_numpy(a).view(torch.bfloat16)
        a.flags.writeable = False
        return a
    return _to_tensor(a, name, device)


def to_device(obj, device):
    """Move every array leaf of a restored tree (numpy views, tensors,
    payload fields) to tensors on ``device``; other values unchanged."""
    if _is_array(obj):
        if isinstance(obj, torch.Tensor):    # a bfloat16 view: detach it
            return obj.clone() if torch.device(device).type == "cpu" \
                else obj.to(device)
        a = np.asarray(obj)
        return _to_tensor(a, str(a.dtype), device)
    if _is_payload(obj):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "leaves":
                changes[f.name] = tuple(to_device(p, device) for p in v)
            elif _is_array(v):
                changes[f.name] = to_device(v, device)
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        items = [to_device(v, device) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else tuple(items)
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    return obj


# -- treedef <-> int-leaf skeleton (tuples preserved via marker dicts) ------

def _pack_structure(obj: Any):
    if isinstance(obj, dict):
        return {_esc_key(k): _pack_structure(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE: [_pack_structure(v) for v in obj]}
    if isinstance(obj, list):
        return [_pack_structure(v) for v in obj]
    return obj


def _unpack_structure(obj: Any):
    if isinstance(obj, dict):
        if _TUPLE in obj and len(obj) == 1:
            return tuple(_unpack_structure(v) for v in obj[_TUPLE])
        return {_unesc_key(k): _unpack_structure(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack_structure(v) for v in obj]
    return obj


def _n_leaves(treedef) -> int:
    if treedef is None:
        return 1
    return sum(_n_leaves(d) for d in treedef[2])


def _pack_treedef(treedef):
    skeleton = tree_unflatten(treedef, list(range(_n_leaves(treedef))))
    return {_TREEDEF: True, "skeleton": _pack_structure(skeleton)}


def _unpack_treedef(obj):
    return tree_flatten(_unpack_structure(obj["skeleton"]))[1]


def _pack_layout(layout):
    return {_LAYOUT: True,
            "treedef": _pack_treedef(layout.treedef),
            "shapes": [list(s) for s in layout.shapes],
            "dtypes": [dtype_name(dt) for dt in layout.dtypes],
            "offsets": list(layout.offsets),
            "d": int(layout.d), "bucket": int(layout.bucket)}


def _unpack_layout(obj):
    from repro_torch.core.flatbuf import FlatLayout
    return FlatLayout(treedef=_unpack_treedef(obj["treedef"]),
                      shapes=tuple(tuple(s) for s in obj["shapes"]),
                      dtypes=tuple(torch_dtype(dt) for dt in obj["dtypes"]),
                      offsets=tuple(int(o) for o in obj["offsets"]),
                      d=int(obj["d"]), bucket=int(obj["bucket"]))


def _pack_payload(obj, sink):
    from repro_torch.core.flatbuf import FlatLayout
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            fields[f.name] = {_SCALAR: True, "v": None}
        elif isinstance(v, FlatLayout):
            fields[f.name] = _pack_layout(v)
        elif f.name == "treedef":
            fields[f.name] = _pack_treedef(v)
        elif f.name == "shape":
            fields[f.name] = {_TUPLE: [int(s) for s in v]}
        elif f.name == "dtype":
            fields[f.name] = {_SCALAR: True, "v": dtype_name(v)}
        elif f.name == "leaves":           # TreePayload: nested payloads
            fields[f.name] = {_TUPLE: [pack_tree(p, sink=sink) for p in v]}
        else:
            fields[f.name] = pack_tree(v, sink=sink)
    return {_PAYLOAD: type(obj).__name__, "fields": fields}


def _unpack_payload(obj, buffers, np_views, device):
    cls = _payload_classes().get(obj[_PAYLOAD])
    if cls is None:
        raise TypeError(f"unknown payload class {obj[_PAYLOAD]!r} in "
                        "checkpoint; register it via "
                        "repro_torch.checkpoint.register_payload_class")
    fields = {}
    for name, v in obj["fields"].items():
        if isinstance(v, dict) and v.get(_LAYOUT):
            fields[name] = _unpack_layout(v)
        elif isinstance(v, dict) and v.get(_TREEDEF):
            fields[name] = _unpack_treedef(v)
        elif name == "shape" and isinstance(v, dict) and _TUPLE in v:
            fields[name] = tuple(int(s) for s in v[_TUPLE])
        elif name == "dtype":
            fields[name] = None if v["v"] is None else torch_dtype(v["v"])
        elif name == "leaves":
            fields[name] = tuple(
                unpack_tree(p, buffers=buffers, np_views=np_views,
                            device=device) for p in v[_TUPLE])
        else:
            fields[name] = unpack_tree(v, buffers=buffers,
                                       np_views=np_views, device=device)
    return cls(**fields)


# -- the recursive pack/unpack ----------------------------------------------

def pack_tree(obj: Any, sink: Optional[ArraySink] = None):
    """Pack one tree into the marker structure.  With ``sink`` the array
    bytes land in the sink's shards and the skeleton carries ``__ref__``
    markers; without, the bytes are inline (the single-file format)."""
    if _is_payload(obj):
        return _pack_payload(obj, sink)
    if _is_array(obj):
        name, shape, data = _array_parts(obj)
        meta = {"dtype": name, "shape": shape}
        if sink is None:
            return {_ARR: True, "data": data, **meta}
        return {_REF: True, **sink.add(data), **meta}
    if isinstance(obj, dict):
        return {_esc_key(k): pack_tree(v, sink=sink)
                for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE: [pack_tree(v, sink=sink) for v in obj]}
    if isinstance(obj, list):
        return [pack_tree(v, sink=sink) for v in obj]
    if isinstance(obj, (int, float, bool, str, bytes)) or obj is None:
        return {_SCALAR: True, "v": obj}
    raise TypeError(f"cannot checkpoint {type(obj)}")


def unpack_tree(obj: Any, *, buffers: Optional[Callable] = None,
                np_views: bool = False, device="cpu"):
    """Inverse of :func:`pack_tree`.  ``buffers(shard_idx) -> bytes-like``
    resolves ``__ref__`` markers (the sharded format); ``np_views=True``
    returns read-only host views, else tensors on ``device``."""
    if isinstance(obj, dict):
        if obj.get(_ARR):
            return _leaf(obj["data"], obj["dtype"], obj["shape"], 0,
                         np_views, device)
        if obj.get(_REF):
            if buffers is None:
                raise ValueError("checkpoint skeleton carries shard refs "
                                 "but no shard buffers were provided")
            return _leaf(buffers(int(obj["shard"])), obj["dtype"],
                         obj["shape"], int(obj["offset"]), np_views, device)
        if _SCALAR in obj:
            v = obj["v"]
            return bytes(v) if isinstance(v, memoryview) else v
        if _TUPLE in obj and len(obj) == 1:
            return tuple(unpack_tree(v, buffers=buffers, np_views=np_views,
                                     device=device) for v in obj[_TUPLE])
        if _PAYLOAD in obj:
            return _unpack_payload(obj, buffers, np_views, device)
        return {_unesc_key(k): unpack_tree(v, buffers=buffers,
                                           np_views=np_views, device=device)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [unpack_tree(v, buffers=buffers, np_views=np_views,
                            device=device) for v in obj]
    return obj


def pack_chunks(tree: Any) -> list:
    """Whole tree -> the single-file payload, as a list of chunks."""
    return mpack.pack_chunks(pack_tree(tree))


def pack_bytes(tree: Any) -> bytes:
    """Whole tree -> one MessagePack blob (the single-file payload)."""
    return mpack.packb(pack_tree(tree))


def unpack_bytes(payload, *, np_views: bool = False, device="cpu"):
    return unpack_tree(mpack.unpack(payload), np_views=np_views,
                       device=device)
