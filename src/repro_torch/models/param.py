"""Parameter definition trees: one source of truth for shape, sharding
and init.

A model is described by a tree (dicts and lists) of :class:`ParamDef`
leaves.  From it come :func:`init_params` (materialized tensors) and
:func:`param_specs` (the :class:`PartitionSpec` of every leaf on a mesh).

Sharding axis conventions (DESIGN.md §4): ``tp`` is the tensor-parallel
mesh axis ('model'), ``fsdp`` the fully-sharded-data-parallel axis
('data').  Specs are written with these *logical* names and resolved
against a concrete mesh's axis names and sizes, so one model def serves
the one-card mesh, the 16×16 pod and the 2×16×16 multi-pod.  Everything
here is pure: no process group is needed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["ParamDef", "PartitionSpec", "default_device", "init_params",
           "leaf_dtype", "param_specs", "resolve_spec", "stack_defs",
           "tree_map_defs"]

#: logical axis names used in ParamDef specs
TP = "tp"
FSDP = "fsdp"


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated): the reference's ``PartitionSpec`` entries letter
    for letter."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def default_device(device: Any = None) -> torch.device:
    """``device``, or the card when it is None: the port's entry points
    put their tensors on the GPU unless the caller asks otherwise."""
    return torch.device("cuda" if device is None else device)


@dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical sharding + init."""

    shape: Tuple[int, ...]
    #: logical spec: tuple with entries in {"tp", "fsdp", None, ("tp","fsdp"), ...}
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


def resolve_spec(
    logical: Tuple[Any, ...],
    tp_axis: Optional[str],
    fsdp_axis: Optional[Any],
) -> PartitionSpec:
    """Map a logical spec to a mesh :class:`PartitionSpec`.

    ``fsdp_axis`` may be a string, a tuple of axes, or None (replicate).
    """

    def resolve_entry(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            parts: list = []
            for sub in e:
                r = resolve_entry(sub)
                if r is None:
                    continue
                if isinstance(r, tuple):
                    parts.extend(r)
                else:
                    parts.append(r)
            return tuple(parts) if parts else None
        if e == TP:
            return tp_axis
        if e == FSDP:
            return fsdp_axis
        raise ValueError(f"unknown logical axis {e!r}")

    return PartitionSpec(*(resolve_entry(e) for e in logical))


def param_specs(
    defs: Any,
    tp_axis: Optional[str] = "model",
    fsdp_axis: Optional[Any] = "data",
    axis_sizes: Optional[Dict[str, int]] = None,
) -> Any:
    """The :class:`PartitionSpec` tree of ``defs`` resolved against
    concrete mesh axis names.

    With ``axis_sizes`` (mesh axis -> size), any entry whose dim does not
    divide the axis product is dropped to replication (e.g. hubert's
    504-entry vocab against TP 16)."""

    def entry_size(e) -> int:
        if e is None or axis_sizes is None:
            return 1
        if isinstance(e, tuple):
            n = 1
            for sub in e:
                n *= entry_size(sub)
            return n
        return axis_sizes.get(e, 1)

    def per_leaf(pd: ParamDef) -> PartitionSpec:
        spec = resolve_spec(pd.spec, tp_axis, fsdp_axis)
        if axis_sizes is None:
            return spec
        entries = list(spec) + [None] * (len(pd.shape) - len(spec))
        return PartitionSpec(*(
            e if e is None or dim % entry_size(e) == 0 else None
            for dim, e in zip(pd.shape, entries)))

    return tree_map_defs(per_leaf, defs)


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a stacked-layers dim of size ``n`` (the period axis the
    model loops over).  The stacked dim is never sharded."""
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
