"""ShardCtx: the mesh context threaded through model layers, plus the
``constrain`` helper that pins an activation to the intended layout.

The port of ``repro/models/ctx.py``.  The mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` (or None on one
device).  The context also hands out each axis's process group and this
rank's coordinate on it, which the layers that write their collectives
explicitly (every sharded layer of the train step) need, and the train
step's row layout (``row_axes``), which the MoE layers route over, and
the serving steps' cache length (``cache_len``), by which a layer tells
its sequence-sharded cache from a replicated one (:meth:`ShardCtx.tp_block`).

``constrain`` follows the reference's rules; for a ``DTensor`` it
redistributes to the placements they give, and it leaves a plain tensor
as it is (the reference's ``with_sharding_constraint`` steers the
compiler's layout of a global array; a plain tensor here is one rank's
whole value, with no layout to steer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.parallel.collectives import gather_from_tp

__all__ = ["ShardCtx", "constrain", "gather_whole"]


@dataclass(frozen=True)
class ShardCtx:
    """Mesh context threaded to layers that use explicit collectives or
    sharding constraints."""

    mesh: Optional[DeviceMesh] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    #: weights arrive pre-gathered (TP-only layout) — ZeRO-1 step layout;
    #: MoE then skips its FSDP gathers
    zero1: bool = False
    #: None: the layers take whole inputs, the same on every rank (the
    #: expert-parallel paths called on their own block them); else the
    #: sharded train step's layout: each rank's input rows are its own
    #: block of the microbatch over these data axes (() where every data
    #: rank holds the whole microbatch), and its weights arrive gathered
    #: over FSDP
    row_axes: Optional[Tuple[str, ...]] = None
    #: the serving steps on a mesh: the rows of a global layer's whole
    #: decode cache (a windowed layer's ring holds min(window, cache_len)),
    #: whose caches are then laid out by ``cache_pspecs``; None: every
    #: cache is whole on every rank
    cache_len: Optional[int] = None

    def serving_tp(self) -> bool:
        """Whether the layers' caches are the serving steps' blocks over a
        TP axis of more than one rank (``cache_len`` set)."""
        return self.cache_len is not None and self.tp_size() > 1

    def _has(self, axis: str) -> bool:
        return self.mesh is not None and axis in self.mesh.mesh_dim_names

    def axis_size(self, axis: str) -> int:
        """Ranks along ``axis``; 1 without a mesh or without that axis."""
        if not self._has(axis):
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis)

    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.axis_size(a)
        return n

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)

    def local_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def tp_group(self, local: int, whole: int):
        """The TP process group when a weight dim the model sizes ``whole``
        arrives cut to ``local`` (the sharded train step hands the layers
        their TP shards), else None (one card, or whole weights as the
        expert-parallel paths take them when called on their own)."""
        if self.tp_size() == 1 or local == whole:
            return None
        if local * self.tp_size() != whole:
            raise ValueError(f"a dim of {whole} arrived as {local} on TP "
                             f"{self.tp_size()}")
        return self.group(self.tp_axis)

    def tp_block(self, n: int) -> Optional[Tuple[int, int]]:
        """(this rank's first index, its count) of a dim of ``n`` cut over
        TP as ``cache_pspecs`` cuts a decode cache (a KV cache's sequence,
        the SSM conv window's channels): contiguous blocks in TP rank order
        where TP divides ``n``.  None where the dim is whole on every rank:
        TP of one rank, or one that does not divide ``n``."""
        tp = self.tp_size()
        if tp == 1 or n % tp:
            return None
        b = n // tp
        return self.local_rank(self.tp_axis) * b, b


def gather_whole(p: Dict[str, Any], defs: Dict[str, Any], ctx: ShardCtx):
    """``p`` with every leaf that arrived cut over TP (smaller than its
    ``defs`` shape) gathered whole along that dim (``gather_from_tp``:
    every TP rank then repeats the layer on the whole).  A mixer whose
    TP layout does not hold on this mesh runs so."""
    group = ctx.group(ctx.tp_axis)
    out = {}
    for name, t in p.items():
        for d, (n, whole) in enumerate(zip(t.shape, defs[name].shape)):
            if n < whole:
                t = gather_from_tp(t, group, d)
        out[name] = t
    return out


def constrain(x: torch.Tensor, ctx: Optional[ShardCtx], *entries) -> torch.Tensor:
    """Pin ``x`` to a layout given per-dim entries:

      'b'  -> the data axes if the dim divides, else replicated
      'tp' -> the TP axis if the dim divides, else replicated
      None -> replicated

    No-op without a mesh (smoke tests, single device) and for a plain
    tensor; a ``DTensor`` is redistributed to that layout.
    """
    if ctx is None or ctx.mesh is None:
        return x
    # imported here: DTensor's import costs a second per process
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    names = ctx.mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for d, (dim, e) in enumerate(zip(x.shape, entries)):
        if e == "b" and ctx.dp_size() > 1 and dim % ctx.dp_size() == 0:
            axes = [a for a in ctx.dp_axes if a in names]
        elif e == "tp" and ctx.tp_size() > 1 and dim % ctx.tp_size() == 0:
            axes = [ctx.tp_axis]
        else:
            axes = []
        for a in axes:
            placements[names.index(a)] = Shard(d)
    return x.redistribute(ctx.mesh, placements)
