"""Gradient compression with error feedback.

The port of ``repro/optim/compression.py``: each gradient leaf plus its
residual is quantized to int8 with a per-leaf f32 scale (what would cross
the data-parallel axis), dequantized, and the quantization error is kept
in the residual, so the bias cancels over steps.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so both packages give the same int8
tensors.  On one card nothing crosses an axis: the step runs the
round trip for parity with the reference and its metric.  On a mesh each
rank compresses its shards; ``across`` (a
:class:`~repro_torch.parallel.collectives.LeafReducer`) makes the scale
the leaf's global max |g|, as ``jnp.max`` over a sharded array is in the
reference, and the error the global mean.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["EFState", "ef_init", "compress_decompress"]


class EFState(NamedTuple):
    residual: Any  # f32, a tree like the grads


def ef_init(params: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize(g: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 ``g`` and its f32 scale, from ``g``'s max |g| or ``amax``."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, ef: EFState, across=None
                        ) -> Tuple[Any, EFState, torch.Tensor]:
    """int8 round trip of ``grads + residual``; returns (the dequantized
    grads in the grads' types, the new residuals, the mean over leaves of
    each leaf's mean |error|).  ``across``: the leaves are shards (module
    docstring)."""
    flat_g, flat_r = tree_leaves(grads), tree_leaves(ef.residual)
    amax = [None] * len(flat_g)
    if across is not None:
        amax = across.max([torch.max(torch.abs(g.float() + r))
                           for g, r in zip(flat_g, flat_r)])
    out_g, out_r, errs = [], [], []
    for g, r, m in zip(flat_g, flat_r, amax):
        g32 = g.float() + r
        q, scale = _quantize(g32, m)
        deq = q.float() * scale
        out_g.append(deq.to(g.dtype))
        out_r.append(g32 - deq)
        errs.append(torch.mean(torch.abs(g32 - deq)))
    if across is not None and errs:
        errs = across.mean(errs)
    err = torch.mean(torch.stack(errs)) if errs else torch.zeros(())
    return (tree_unflatten(grads, out_g),
            EFState(residual=tree_unflatten(ef.residual, out_r)), err)
