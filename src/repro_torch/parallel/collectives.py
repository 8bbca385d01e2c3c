"""The collectives the sharded paths write out by hand: the counterparts of
``jax.lax.all_gather`` (tiled), ``psum_scatter``, ``psum``/``pmax`` and
``pmean`` over one mesh axis's process group, the axis lookup they start
from, and the autograd Functions of the sharded train step:

* :func:`gather_shard`: an FSDP weight's f32 block cast to the compute
  type and gathered along one dim; backward reduce-scatters (sums) the
  gradient in f32 and returns it in f32.  The cast sits inside the
  Function because autograd hands a Function's input its gradient in the
  input's type: so the reduction runs on f32, not on the compute type.
* the tensor-parallel pair: :func:`copy_to_tp` (identity forward,
  all-reduce backward) on the input of a column-parallel region and
  :func:`reduce_from_tp` (all-reduce forward, identity backward) on the
  output of a row-parallel one.  ``torch.distributed.nn``'s
  ``all_reduce`` all-reduces the gradient in its backward too, which
  counts it once per TP rank when every rank computes the same loss
  downstream: not used here.
* :func:`gather_from_tp`: a TP-sharded tensor gathered whole for a
  computation every TP rank repeats; backward keeps the rank's slice.
* the partial forms, where each rank uses the gathered or summed value
  only in part downstream (its own gate columns, its own heads):
  :func:`gather_partial` (all-gather forward; backward sums the
  gradient over the group, then keeps the rank's slice) and
  :func:`reduce_partial` (all-reduce both ways).  :func:`reduce_from_tp`
  serves any group where every rank's downstream is its own share of one
  loss, as the MoE balance loss's sums over the data axes are.
* :func:`all_to_all`: ``all_to_all_single`` over a group in even splits;
  backward is the same exchange of the gradient, which inverts it.
* :func:`combine_partials`: the exact softmax attention over a sequence
  cut into blocks, one block a rank, from each rank's attention over its
  own block and that block's log-sum-exp (flash-decode's combine: the
  sequence-sharded caches of the serving steps);
  :func:`combine_stacked` is the same arithmetic over blocks stacked on
  one device.

:class:`LeafReducer` sums, maxima and means of per-leaf values (squared
norms, the int8 scale, the quantization error) over the ranks that hold
a leaf's shards, for the optimizer's global norm and the compression.

Every rank of a group must call them in the same order (in the backward
pass too: autograd runs the same graph in the same order on every rank).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["mesh_axis", "all_gather", "all_reduce", "reduce_scatter", "pmean",
           "gather_shard", "copy_to_tp", "reduce_from_tp", "gather_from_tp",
           "gather_partial", "reduce_partial", "all_to_all", "combine_partials",
           "combine_stacked", "LeafReducer"]

# newer torch renames the *_tensor collectives; both work along dim 0
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_from = (getattr(dist, "reduce_scatter_single", None)
                 or dist.reduce_scatter_tensor)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
#: the log-sum-exp of a block with no live entry (the attention kernels'
#: mask value)
EMPTY_LSE = -1e30


def mesh_axis(mesh, name: str):
    """(size, process group, this rank's coordinate) of a ``DeviceMesh`` axis."""
    names = tuple(mesh.mesh_dim_names)
    if name not in names:
        raise ValueError(f"mesh axes {names} have no axis {name!r}")
    return mesh.size(names.index(name)), mesh.get_group(name), mesh.get_local_rank(name)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _gather_into(out, t, group=group)
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The group's tensors reduced by ``op`` ("sum" or "max"), a new
    contiguous tensor (NCCL takes no other)."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors summed, and this rank's block of the sum along
    ``dim`` (blocks in rank order)."""
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _scatter_from(out, t, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group (a new tensor); integers divide exactly when
    the ranks agree."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    if out.is_floating_point():
        return out / n
    return torch.div(out, n, rounding_mode="floor")


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dtype, dim, group, gathered):
        ctx.dim, ctx.group = dim, group
        if gathered is not None:
            return gathered
        return all_gather(shard.to(dtype), group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.float(), ctx.group, ctx.dim), None, None, None, None


def gather_shard(shard: torch.Tensor, dtype: torch.dtype, dim: int, group,
                 gathered: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shard`` (this rank's f32 block of a weight along ``dim``) cast to
    ``dtype`` and gathered over ``group``.  ``gathered``, when given, is
    that result computed once beforehand (ZeRO-1: the weights gathered
    once a step), returned as it is.  Backward: the f32 gradient summed
    over the group, this rank's block of it."""
    return _GatherShard.apply(shard, dtype, dim, group, gathered)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n, ctx.rank = dim, x.shape[dim], dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; backward sums its gradient over the TP ``group``
    (the input of a column-parallel region: each rank's gradient covers
    its own columns only)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the TP ``group`` (the partial outputs of a
    row-parallel product); backward passes the gradient as it is, since
    every rank computes the same loss from the sum.  Over a data axis
    (the MoE balance loss's sums of each rank's rows), the same rule
    holds: each rank's gradient reaches its own rows, and the train step
    sums the weights' gradients over the data ranks."""
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The TP ``group``'s blocks of ``x`` gathered along ``dim``, for a
    computation every TP rank repeats on the whole; backward keeps this
    rank's slice of the (identical) gradient."""
    return _GatherFromTP.apply(x, group, dim)


def gather_partial(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ``group``'s blocks of ``x`` gathered along ``dim`` for a
    computation each rank makes a different part of (its own output
    columns of a product with the whole); backward sums the gradient over
    the group and keeps this rank's slice."""
    return copy_to_tp(gather_from_tp(x, group, dim), group)


def reduce_partial(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` where each rank uses the sum only in part
    downstream (a norm's sum of squares over channels cut over TP):
    backward sums the gradient over the group too."""
    return copy_to_tp(reduce_from_tp(x, group), group)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()  # empty_like keeps a permuted input's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank ``j``'s ``i``-th block of ``x``'s rows to rank ``i``'s ``j``-th
    block (``all_to_all_single`` in even splits).  Backward: the same
    exchange of the gradient, which sends every block back."""
    return _AllToAll.apply(x, group)


def _combine(o: torch.Tensor, lse: torch.Tensor, reduce_max, reduce_sum) -> torch.Tensor:
    m = reduce_max(lse)
    w = torch.where(lse > 0.5 * EMPTY_LSE, torch.exp(lse - m), 0.0)
    both = reduce_sum(torch.cat((o.float() * w[..., None], w[..., None]), dim=-1))
    return (both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-30)).to(o.dtype)


def combine_partials(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The attention over the union of the ``group``'s blocks of one
    sequence, from this rank's attention ``o`` (..., d) over its own block
    and the block's log-sum-exp ``lse`` (...) (f32): an all-reduce max of
    ``lse``, weights ``exp(lse - max)`` (0 for a block with no live entry,
    ``lse`` at ``EMPTY_LSE``), and one all-reduce sum of the weights and the
    weighted ``o`` in f32; the quotient in ``o``'s type.  Two collectives,
    the same on every rank."""
    return _combine(o, lse, lambda t: all_reduce(t, group, "max"),
                    lambda t: all_reduce(t, group))


def combine_stacked(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """:func:`combine_partials`' arithmetic over blocks stacked on dim 0 of
    ``o`` and ``lse`` on one device."""
    return _combine(o, lse, lambda t: t.amax(dim=0), lambda t: t.sum(dim=0))


class LeafReducer:
    """Sums, maxima and means of one value per leaf of a tree of shards,
    each over the mesh axes its leaf is sharded on (``axes``, one tuple of
    axis names per leaf, in leaf order): the value of the whole leaf from
    those of its shards.  Leaves on the same axes share one collective;
    axes of one rank are skipped."""

    def __init__(self, mesh, axes: Sequence[Tuple[str, ...]]):
        self.mesh = mesh
        self.axes = [tuple(a for a in ax if mesh_axis(mesh, a)[0] > 1)
                     for ax in axes]

    def _reduce(self, values: List[torch.Tensor], op: str) -> List[torch.Tensor]:
        if len(values) != len(self.axes):
            raise ValueError(f"{len(values)} values for {len(self.axes)} leaves")
        out = list(values)
        by_axes: dict = {}
        for i, ax in enumerate(self.axes):
            if ax:
                by_axes.setdefault(ax, []).append(i)
        for ax, idx in by_axes.items():
            v = torch.stack([values[i] for i in idx])
            for a in ax:
                v = all_reduce(v, mesh_axis(self.mesh, a)[1],
                               "sum" if op == "mean" else op)
            if op == "mean":
                v = v / self._ranks(ax)
            for j, i in enumerate(idx):
                out[i] = v[j]
        return out

    def _ranks(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= mesh_axis(self.mesh, a)[0]
        return n

    def sum(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(values, "sum")

    def max(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(values, "max")

    def mean(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks: the whole leaf's mean, its shards being
        of one size."""
        return self._reduce(values, "mean")
