"""Concrete sharding rules: inputs, caches, and spec resolution.

The port of ``repro/parallel/sharding.py``.  Everything here maps
*logical* layout decisions (DESIGN.md §4) onto a concrete mesh: batch
over the data axes (``('pod','data')`` multi-pod), heads/ffn/experts over
``model``, FSDP over ``data``.  Dims that don't divide the axis size fall
back to replication (e.g. global_batch=1 in long_500k).

The spec functions are pure: they read only the mesh's axis names and
sizes, so ``mesh`` is a :class:`DeviceMesh` or a plain ``(names, sizes)``
pair, and the specs of a 16×16 pod come out without 256 ranks.  A spec
is a :class:`PartitionSpec`, a tuple with one entry per tensor dim (an
axis name, a tuple of names, or None), the reference's ``PartitionSpec``
entries letter for letter.  :func:`named` turns specs into ``DTensor``
placements over the mesh's dims.  :func:`param_pspecs` is the reference's
``_pspec_tree``: the parameters' specs, FSDP×TP or TP only.

:func:`shard_tree` cuts whole tensors into a rank's blocks and
:func:`unshard_tree` puts the blocks together again: over a
``DeviceMesh`` for this rank (the gather is a collective every rank
calls), over a ``(names, sizes)`` pair for any rank with no process group
(the blocks of every rank given as a list).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.attention import AttnCache
from repro_torch.models.config import BlockSpec, ModelConfig, ShapeConfig
from repro_torch.models.mla import MLACache
from repro_torch.models.param import PartitionSpec, param_specs
from repro_torch.models.quant_cache import QuantAttnCache
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import model_defs
from repro_torch.parallel.collectives import all_gather
from repro_torch.tree import tree_map

__all__ = [
    "PartitionSpec",
    "TensorSpec",
    "mesh_shape",
    "mesh_axes",
    "batch_entry",
    "input_specs",
    "input_shardings",
    "cache_pspecs",
    "named",
    "param_pspecs",
    "spec_axes",
    "spec_leaves",
    "shard_tree",
    "unshard_tree",
]

P = PartitionSpec


class TensorSpec(NamedTuple):
    """Shape and type of a model input: the reference's ShapeDtypeStruct."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    names, sizes = mesh
    return dict(zip(names, sizes))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Optional[str], Optional[str]]:
    """(dp_axes, fsdp_axis, tp_axis) present in this mesh."""
    names = tuple(mesh_shape(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    fsdp = "data" if "data" in names else None
    tp = "model" if "model" in names else None
    return dp, fsdp, tp


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def batch_entry(mesh, batch: int):
    """Spec entry for a batch dim: data axes if divisible, else replicate."""
    dp, _, _ = mesh_axes(mesh)
    if dp and batch % _axes_size(mesh, dp) == 0:
        return dp if len(dp) > 1 else dp[0]
    return None


def _tp_entry(mesh, dim: int):
    _, _, tp = mesh_axes(mesh)
    if tp and dim % mesh_shape(mesh)[tp] == 0:
        return tp
    return None


# -- model inputs ---------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Shape and type of every model input of this cell."""
    B, T = shape.global_batch, shape.seq_len
    kind = shape.kind
    out: Dict[str, TensorSpec] = {}
    if kind == "decode":
        out["tokens"] = TensorSpec((B, 1), torch.int32)
        return out
    if cfg.frontend == "tokens":
        out["tokens"] = TensorSpec((B, T), torch.int32)
    elif cfg.frontend == "frames":
        out["frames"] = TensorSpec((B, T, cfg.frame_dim), torch.bfloat16)
    else:  # tokens+patches
        out["tokens"] = TensorSpec((B, T - cfg.n_patches), torch.int32)
        out["patches"] = TensorSpec((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
    if kind == "train":
        out["labels"] = TensorSpec((B, T), torch.int32)
    return out


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, P]:
    b = batch_entry(mesh, shape.global_batch)
    return {name: P(b, *([None] * (len(spec.shape) - 1)))
            for name, spec in input_specs(cfg, shape).items()}


# -- decode caches ---------------------------------------------------------

def _mixer_cache_pspec(blk: BlockSpec, cfg: ModelConfig, b, mesh,
                       seq_len: int, quant_attn: bool = False):
    if blk.mixer in ("attn", "local"):
        # KV caches shard the *sequence* dim over TP (flash-decode style):
        # partial softmax stats are the only cross-shard traffic.
        S = min(seq_len, blk.window) if blk.window else seq_len
        s_e = _tp_entry(mesh, S)
        spec = P(b, s_e, None, None)
        if quant_attn:
            return QuantAttnCache(k_q=spec, v_q=spec,
                                  k_s=P(b, s_e, None), v_s=P(b, s_e, None))
        return AttnCache(k=spec, v=spec)
    if blk.mixer == "mla":
        s_e = _tp_entry(mesh, seq_len)
        return MLACache(c_kv=P(b, s_e, None), k_pe=P(b, s_e, None))
    if blk.mixer == "ssm":
        s = cfg.ssm
        convdim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
        return SSMCache(
            conv=P(b, None, _tp_entry(mesh, convdim)),
            state=P(b, _tp_entry(mesh, s.n_heads(cfg.d_model)), None, None),
        )
    if blk.mixer == "rglru":
        W = cfg.rglru.lru_width or cfg.d_model
        return RGLRUCache(conv=P(b, None, _tp_entry(mesh, W)),
                          h=P(b, _tp_entry(mesh, W)))
    raise ValueError(blk.mixer)


def _map_specs(fn, tree: Any) -> Any:
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    return type(tree)(_map_specs(fn, v) for v in tree)


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 quant_attn: bool = False):
    """Spec tree matching ``init_cache``'s structure (the body's caches
    carry the leading period axis, replicated)."""
    b = batch_entry(mesh, shape.global_batch)
    S = shape.seq_len
    mk = lambda blk: _mixer_cache_pspec(blk, cfg, b, mesh, S, quant_attn)  # noqa: E731
    return {
        "prelude": [mk(blk) for blk in cfg.prelude],
        "body": [_map_specs(lambda s: P(None, *s), mk(blk)) for blk in cfg.pattern],
        "postlude": [mk(blk) for blk in cfg.postlude],
    }


def named(mesh, spec_tree: Any) -> Any:
    """Each spec of ``spec_tree`` as ``DTensor`` placements, one per mesh
    dim: ``Shard(d)`` where the spec names that mesh axis at tensor dim
    ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard  # a second to import

    names = tuple(mesh_shape(mesh))

    def placements(spec: PartitionSpec):
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    out[names.index(a)] = Shard(d)
        return tuple(out)

    return _map_specs(placements, spec_tree)


# -- parameters ---------------------------------------------------------------

def param_pspecs(cfg: ModelConfig, mesh, fsdp: Any = Ellipsis) -> Any:
    """The spec tree of ``cfg``'s parameters on ``mesh``: FSDP over
    "data" and TP over "model" where the mesh has them and the dims
    divide; ``fsdp`` overrides the FSDP axis (None: the TP-only layout
    ZeRO-1 computes in)."""
    _, fsdp_axis, tp = mesh_axes(mesh)
    if fsdp is not Ellipsis:
        fsdp_axis = fsdp
    return param_specs(model_defs(cfg), tp_axis=tp, fsdp_axis=fsdp_axis,
                       axis_sizes=mesh_shape(mesh))


def spec_leaves(specs: Any) -> List[PartitionSpec]:
    """The specs of a spec tree in the order of its tensors' leaves
    (``tree_leaves`` would split each spec into its entries)."""
    out: List[PartitionSpec] = []
    tree_map(lambda _, spec: out.append(spec), _map_specs(lambda s: 0, specs), specs)
    return out


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """The mesh axes ``spec`` shards a tensor over."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _coords(mesh, rank: Optional[int]) -> Dict[str, int]:
    """Axis name -> coordinate: this rank's on a ``DeviceMesh``, else those
    of ``rank`` (row-major) in a ``(names, sizes)`` mesh."""
    if isinstance(mesh, DeviceMesh):
        return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    shape = mesh_shape(mesh)
    if rank is None or not 0 <= rank < math.prod(shape.values()):
        raise ValueError(f"rank {rank} is not one of the mesh {shape}'s")
    out = {}
    for a, n in reversed(list(shape.items())):
        rank, out[a] = divmod(rank, n)
    return out


def _block_of(t: torch.Tensor, spec: PartitionSpec, shape: Dict[str, int],
              coords: Dict[str, int]) -> torch.Tensor:
    for d, e in enumerate(spec):
        idx, n = 0, 1
        for a in _entry_axes(e):
            idx, n = idx * shape[a] + coords[a], n * shape[a]
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                                 f"over {e} ({n} ranks)")
            b = t.shape[d] // n
            t = t.narrow(d, idx * b, b)
    return t


def shard_tree(tree: Any, specs: Any, mesh, rank: Optional[int] = None) -> Any:
    """Each leaf of ``tree`` (whole tensors) cut to a rank's block by its
    spec in ``specs`` (a tree of the same structure): this rank's on a
    ``DeviceMesh``, ``rank``'s on a ``(names, sizes)`` pair.  The blocks
    are contiguous copies: the whole tensors can be dropped."""
    shape, coords = mesh_shape(mesh), _coords(mesh, rank)
    return tree_map(lambda t, s: _block_of(t, s, shape, coords).clone(
        memory_format=torch.contiguous_format), tree, specs)


def unshard_tree(local: Union[Any, List[Any]], specs: Any, mesh) -> Any:
    """The inverse of :func:`shard_tree`.  On a ``DeviceMesh``, ``local``
    is this rank's tree and every rank gets the whole tensors back (each
    leaf gathered in turn: call it on every rank).  On a ``(names,
    sizes)`` pair, ``local`` is the list of every rank's tree in rank
    order, put together with no collective."""
    if isinstance(mesh, DeviceMesh):
        def gather(t, spec):
            for d, e in enumerate(spec):
                for a in reversed(_entry_axes(e)):
                    t = all_gather(t, mesh.get_group(a), d)
            return t

        return tree_map(gather, local, specs)
    shape = mesh_shape(mesh)
    n_ranks = math.prod(shape.values())
    if len(local) != n_ranks:
        raise ValueError(f"{len(local)} trees for a mesh of {n_ranks} ranks")

    def assemble(*blocks_and_spec):
        *blocks, spec = blocks_and_spec
        size = list(blocks[0].shape)
        for d, e in enumerate(spec):
            for a in _entry_axes(e):
                size[d] *= shape[a]
        whole = blocks[0].new_empty(size)
        for r, b in enumerate(blocks):
            _block_of(whole, spec, shape, _coords(mesh, r)).copy_(b)
        return whole

    return tree_map(assemble, *local, specs)
