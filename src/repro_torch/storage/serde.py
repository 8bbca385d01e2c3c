"""Pytree <-> bytes serialization for the storage tiers.

A minimal, dependency-free tensor container: header is JSON (tree structure
with leaf dtype/shape), payload is raw little-endian buffers.  Works for
arbitrary trees (dicts, lists, tuples, NamedTuples, ``None``) of torch
tensors, numpy arrays and python scalars, in the blob format of the
reference package: each package loads the other's blobs.  Tensors are
pulled to the host and load back as numpy arrays, except bf16, which has
no numpy type and loads back as a ``torch.bfloat16`` tensor.

Two warm-path helpers ride along (DESIGN.md §10):

  * :class:`VersionedCodec` memoizes ``dumps`` output per state *version*
    so committing an unchanged state re-uses the encoded bytes instead of
    re-flattening and re-pickling the tree (the lazy serde fast path);
  * :class:`CowState` is a copy-on-write dict handle for imperative steps:
    reads proxy the underlying state, the first write takes a shallow
    copy, and ``collapse()`` returns the *original* object when nothing
    was written — which is exactly the identity the runtime's
    dirty-tracking keys on.
"""

from __future__ import annotations

import importlib
import json
import struct
from collections import OrderedDict
from collections.abc import MutableMapping
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["dumps", "loads", "leaf_bytes", "CowState", "VersionedCodec"]

_MAGIC = b"MRVL1\n"


def _encode_leaf(x: Any) -> Tuple[dict, bytes]:
    if isinstance(x, (bool, int, float, str)) or x is None:
        return {"kind": "py", "value": x}, b""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        # bfloat16 has no numpy name -> round-trip via its uint16 bits.
        if t.dtype == torch.bfloat16:
            payload = t.view(torch.int16).numpy().view(np.uint16).tobytes()
            return {"kind": "bf16", "shape": list(t.shape)}, payload
        arr = t.numpy()
    else:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # an ml_dtypes array
            payload = arr.view(np.uint16).tobytes()
            return {"kind": "bf16", "shape": list(arr.shape)}, payload
    return (
        {"kind": "np", "dtype": arr.dtype.str, "shape": list(arr.shape)},
        arr.tobytes(),
    )


def _decode_leaf(meta: dict, payload: bytes) -> Any:
    kind = meta["kind"]
    if kind == "py":
        return meta["value"]
    if kind == "bf16":
        bits = np.frombuffer(payload, dtype=np.int16).reshape(meta["shape"])
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(payload, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])


def _flatten(x: Any, leaves: List[Any]) -> Any:
    """Append ``x``'s leaves to ``leaves``; return its structure as a
    hashable spec.  Node types and leaf order are the reference's pytree
    rules: dicts by sorted key (an ``OrderedDict`` in insertion order),
    tuples, NamedTuples and lists in order, ``None`` an empty node."""
    if x is None:
        return None
    if isinstance(x, dict):
        keys = list(x) if isinstance(x, OrderedDict) else sorted(x)
        return ("d", tuple(keys), tuple(_flatten(x[k], leaves) for k in keys))
    if isinstance(x, tuple):
        children = tuple(_flatten(v, leaves) for v in x)
        if hasattr(x, "_fields"):
            cls = type(x)
            return ("nt", f"{cls.__module__}:{cls.__qualname__}", children)
        return ("t", children)
    if isinstance(x, list):
        return ("l", tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return len(leaves) - 1


def _jsonify(spec: Any) -> Any:
    """The structure line's JSON for a spec (leaves as their indices)."""
    if spec is None:
        return {"__n": 0}
    if isinstance(spec, int):
        return spec
    if spec[0] == "d":
        return {"__d": {k: _jsonify(c) for k, c in zip(spec[1], spec[2])}}
    if spec[0] == "nt":
        return {"__t": [_jsonify(c) for c in spec[2]], "__nt": spec[1]}
    if spec[0] == "t":
        return {"__t": [_jsonify(c) for c in spec[1]]}
    return {"__l": [_jsonify(c) for c in spec[1]]}


#: per-structure memo of the serialization constants that depend only on
#: the tree *structure*: ``(treedef string, structure-JSON line)``.  Warm
#: invocations re-serialize the same state shape thousands of times a
#: second.  Benign data race under the GIL (worst case: duplicate compute).
_STRUCT_MEMO: dict = {}


def _struct_parts(spec: Any) -> Tuple[str, bytes]:
    parts = _STRUCT_MEMO.get(spec)
    if parts is None:
        line = json.dumps(_jsonify(spec))
        # ``treedef`` is informational (``loads`` never reads it): the
        # reference stores its pytree's repr, the port the structure.
        parts = _STRUCT_MEMO[spec] = (line, line.encode() + b"\n")
    return parts


def dumps(tree: Any) -> bytes:
    """Serialize a tree (device tensors are pulled to the host)."""
    leaves: List[Any] = []
    spec = _flatten(tree, leaves)
    metas: List[dict] = []
    payloads: List[bytes] = [b"", b"", b""]  # magic/len/header placeholders
    for leaf in leaves:
        meta, payload = _encode_leaf(leaf)
        meta["len"] = len(payload)
        metas.append(meta)
        payloads.append(payload)
    treedef_str, structure_line = _struct_parts(spec)
    header = json.dumps({"treedef": treedef_str, "leaves": metas}).encode()
    payloads[0] = _MAGIC
    payloads[1] = struct.pack("<Q", len(header))
    payloads[2] = header + structure_line
    return b"".join(payloads)


def _resolve_namedtuple(path: str) -> Any:
    """The NamedTuple class a blob names.  A class of the reference
    package (``repro.…``) resolves to its counterpart in this package;
    the reference itself is never imported."""
    modname, _, qualname = path.partition(":")
    root = modname.partition(".")[0]
    if root == "repro":
        modname = "repro_torch" + modname[len("repro"):]
    elif root == "jax":
        raise ImportError(f"{modname} is not available to this package")
    obj: Any = importlib.import_module(modname)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _unjsonify(x: Any, leaves: List[Any]) -> Any:
    if isinstance(x, dict):
        if "__n" in x:
            return None
        if "__d" in x:
            return {k: _unjsonify(v, leaves) for k, v in x["__d"].items()}
        if "__t" in x:
            children = [_unjsonify(v, leaves) for v in x["__t"]]
            if "__nt" in x:
                try:
                    return _resolve_namedtuple(x["__nt"])(*children)
                except (ImportError, AttributeError):
                    pass  # class not (yet) in this package: plain tuple
            return tuple(children)
        if "__l" in x:
            return [_unjsonify(v, leaves) for v in x["__l"]]
    return leaves[x]


def loads(data: bytes) -> Any:
    if not data.startswith(_MAGIC):
        raise ValueError("bad magic: not a Marvel blob")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<Q", data, off)
    off += 8
    header = json.loads(data[off : off + hlen])
    off += hlen
    nl = data.index(b"\n", off)
    structure = json.loads(data[off:nl])
    off = nl + 1
    leaves = []
    for meta in header["leaves"]:
        payload = data[off : off + meta["len"]]
        off += meta["len"]
        leaves.append(_decode_leaf(meta, payload))
    return _unjsonify(structure, leaves)


def leaf_bytes(tree: Any) -> int:
    """Total payload bytes of all array leaves (for accounting)."""
    leaves: List[Any] = []
    _flatten(tree, leaves)
    total = 0
    for leaf in leaves:
        if isinstance(leaf, (bool, int, float, str)) or leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        arr = np.asarray(leaf)
        total += arr.size * arr.dtype.itemsize
    return total


class CowState(MutableMapping):
    """Copy-on-write handle over a dict-shaped state tree.

    An imperative step receives the handle, reads for free, and only the
    first mutation pays a shallow ``dict`` copy.  ``collapse()`` returns
    the original base object when the step never wrote — the runtime's
    dirty-tracking treats *object identity* as "unchanged", so a
    read-only invocation through a CowState skips re-serialization and
    the commit entirely.  Writing a key back to the identical value it
    already holds does not count as a mutation.

    Only host-side (``jit=False``) functions may use it, as in the
    reference package.
    """

    __slots__ = ("_base", "_copy")

    def __init__(self, base: dict) -> None:
        self._base = base
        self._copy: Optional[dict] = None

    @property
    def mutated(self) -> bool:
        return self._copy is not None

    def _view(self) -> dict:
        return self._copy if self._copy is not None else self._base

    def __getitem__(self, key: Any) -> Any:
        return self._view()[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        if self._copy is None:
            if key in self._base and self._base[key] is value:
                return  # writing the identical object: not a mutation
            self._copy = dict(self._base)
        self._copy[key] = value

    def __delitem__(self, key: Any) -> None:
        if self._copy is None:
            self._copy = dict(self._base)
        del self._copy[key]

    def __iter__(self) -> Any:
        return iter(self._view())

    def __len__(self) -> int:
        return len(self._view())

    def __contains__(self, key: Any) -> bool:
        return key in self._view()

    def __repr__(self) -> str:
        tag = "mutated" if self.mutated else "clean"
        return f"CowState({self._view()!r}, {tag})"

    def collapse(self) -> Any:
        """The effective state tree: the base object itself when clean
        (identity preserved), the shallow copy once mutated."""
        return self._base if self._copy is None else self._copy


class VersionedCodec:
    """One-slot ``dumps`` memo keyed by a state version stamp.

    The runtime bumps a slot's version stamp only when an invocation
    produces a *different* state object, so ``encode`` for an unchanged
    version returns the cached bytes without touching the pytree.
    ``prime`` seeds the memo from bytes just loaded out of the cache
    (``dumps(loads(b)) == b`` is the serde round-trip contract, so the
    loaded blob *is* the encoding of the loaded state).
    """

    __slots__ = ("_version", "_bytes")

    def __init__(self) -> None:
        self._version: Optional[int] = None
        self._bytes: Optional[bytes] = None

    def encode(self, tree: Any, version: int) -> bytes:
        if version != self._version or self._bytes is None:
            self._bytes = dumps(tree)
            self._version = version
        return self._bytes

    def prime(self, data: bytes, version: int) -> None:
        self._bytes = data
        self._version = version

    def invalidate(self) -> None:
        self._version = None
        self._bytes = None
