"""Gradient compression with error feedback.

The port of ``repro/optim/compression.py``: each gradient leaf plus its
residual is quantized to int8 with a per-leaf f32 scale (what would cross
the data-parallel axis), dequantized, and the quantization error is kept
in the residual, so the bias cancels over steps.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so both packages give the same int8
tensors.  On one card nothing crosses an axis: the step runs the
round trip for parity with the reference and its metric.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["EFState", "ef_init", "compress_decompress"]


class EFState(NamedTuple):
    residual: Any  # f32, a tree like the grads


def ef_init(params: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, ef: EFState) -> Tuple[Any, EFState, torch.Tensor]:
    """int8 round trip of ``grads + residual``; returns (the dequantized
    grads in the grads' types, the new residuals, the mean over leaves of
    each leaf's mean |error|)."""
    out_g, out_r, errs = [], [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        g32 = g.float() + r
        q, scale = _quantize(g32)
        deq = q.float() * scale
        out_g.append(deq.to(g.dtype))
        out_r.append(g32 - deq)
        errs.append(torch.mean(torch.abs(g32 - deq)))
    err = torch.mean(torch.stack(errs)) if errs else torch.zeros(())
    return (tree_unflatten(grads, out_g),
            EFState(residual=tree_unflatten(ef.residual, out_r)), err)
