"""The collectives the sharded paths write out by hand: the counterparts of
``jax.lax.all_gather`` (tiled) and ``pmean`` over one mesh axis's process
group, and the axis lookup they start from.  Every rank of the group must
call them in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["mesh_axis", "all_gather", "pmean"]

# newer torch renames all_gather_into_tensor; both concatenate along dim 0
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


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


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group (a new tensor); integers divide exactly when
    the ranks agree."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    if out.is_floating_point():
        return out / n
    return torch.div(out, n, rounding_mode="floor")
