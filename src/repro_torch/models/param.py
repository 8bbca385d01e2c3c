"""Parameter definition trees: one source of truth for shape and init.

A model is described by a tree (dicts and lists) of :class:`ParamDef`
leaves; :func:`init_params` materializes it.  The reference package also
derives sharding specs from the same tree; on one card there is nothing
to shard, so ``spec`` is kept as plain data (the logical axis names
``"tp"``/``"fsdp"``) and ignored.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["ParamDef", "default_device", "init_params", "leaf_dtype",
           "stack_defs", "tree_map_defs"]

#: logical axis names used in ParamDef specs (kept for parity, unused)
TP = "tp"
FSDP = "fsdp"


def default_device(device: Any = None) -> torch.device:
    """``device``, or the card when it is None: the port's entry points
    put their tensors on the GPU unless the caller asks otherwise."""
    return torch.device("cuda" if device is None else device)


@dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical sharding + init."""

    shape: Tuple[int, ...]
    #: logical spec: entries in {"tp", "fsdp", None, ...}; ignored on one card
    spec: Tuple[Any, ...] = ()
    dtype: torch.dtype = torch.bfloat16
    #: stddev of truncated-normal init; 0.0 -> zeros; None -> fan-in default
    init_scale: Optional[float] = None
    #: constant initialization value (overrides init_scale)
    init_value: Optional[float] = None

    def fan_in_scale(self) -> float:
        fan_in = self.shape[-2] if len(self.shape) >= 2 else max(self.shape[-1], 1)
        return 1.0 / math.sqrt(fan_in)


def tree_map_defs(fn: Callable[[ParamDef], Any], tree: Any) -> Any:
    """Apply ``fn`` to every :class:`ParamDef` of a dict/list/tuple tree."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_defs(fn, v) for v in tree)
    raise TypeError(f"not a ParamDef tree node: {type(tree).__name__}")


def leaf_dtype(pd: ParamDef, dtype: Optional[torch.dtype]) -> torch.dtype:
    """The type of leaf ``pd`` when a caller asks for ``dtype`` (None: the
    leaf's own).  Only the weights take it; a leaf the model declares f32
    keeps f32, as the reference does."""
    if dtype is None or pd.dtype == torch.float32:
        return pd.dtype
    return dtype


def init_params(
    defs: Any,
    generator: torch.Generator,
    device: Any = None,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """Materialize tensors from a ParamDef tree on ``device``.

    Draws a truncated normal in [-2, 2] standard deviations (then times the
    leaf's scale) from ``generator``, which must live on ``device``; leaves
    are drawn in the reference's leaf order, one after another.  ``dtype``
    overrides the type of the weight leaves (those of the default bf16); a
    leaf the model declares f32 (the MoE router, RG-LRU's ``lam``,
    Mamba-2's ``A_log``/``Dskip``/``dt_bias``) stays f32, as in the
    reference.  The numbers differ from the
    reference's ``jax.random`` draws: carry a reference tree across with
    :func:`repro_torch.models.convert.from_jax_params` to compare.
    """
    device = torch.device(device) if device is not None else generator.device

    def draw(pd: ParamDef) -> torch.Tensor:
        out_dtype = leaf_dtype(pd, dtype)
        if pd.init_value is not None:
            return torch.full(pd.shape, pd.init_value, dtype=out_dtype,
                              device=device)
        if pd.init_scale == 0.0:
            return torch.zeros(pd.shape, dtype=out_dtype, device=device)
        scale = pd.init_scale if pd.init_scale is not None else pd.fan_in_scale()
        t = torch.empty(pd.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(scale).to(out_dtype)

    def walk(tree: Any) -> Any:
        if isinstance(tree, ParamDef):
            return draw(tree)
        if isinstance(tree, dict):
            drawn = {k: walk(tree[k]) for k in sorted(tree)}
            return {k: drawn[k] for k in tree}
        return type(tree)(walk(v) for v in tree)

    return walk(defs)


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a stacked-layers dim of size ``n`` (the period axis the
    model loops over)."""
    return tree_map_defs(
        lambda pd: ParamDef(
            shape=(n,) + pd.shape,
            spec=(None,) + tuple(pd.spec),
            dtype=pd.dtype,
            init_scale=pd.init_scale,
            init_value=pd.init_value,
        ),
        defs,
    )
