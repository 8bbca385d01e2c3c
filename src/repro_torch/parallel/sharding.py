"""Concrete sharding rules: inputs, caches, and spec resolution.

The port of ``repro/parallel/sharding.py``.  Everything here maps
*logical* layout decisions (DESIGN.md §4) onto a concrete mesh: batch
over the data axes (``('pod','data')`` multi-pod), heads/ffn/experts over
``model``, FSDP over ``data``.  Dims that don't divide the axis size fall
back to replication (e.g. global_batch=1 in long_500k).

The functions are pure: they read only the mesh's axis names and sizes,
so ``mesh`` is a :class:`DeviceMesh` or a plain ``(names, sizes)`` pair,
and the specs of a 16×16 pod come out without 256 ranks.  A spec is a
:class:`PartitionSpec`, a tuple with one entry per tensor dim (an axis
name, a tuple of names, or None), the reference's ``PartitionSpec``
entries letter for letter.  :func:`named` turns specs into ``DTensor``
placements over the mesh's dims.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.attention import AttnCache
from repro_torch.models.config import BlockSpec, ModelConfig, ShapeConfig
from repro_torch.models.mla import MLACache
from repro_torch.models.quant_cache import QuantAttnCache
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache

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
]


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


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
