"""Carry a parameter tree of the reference package across to the port.

The port keeps the reference's tree layout and names (``embed``,
``body`` with its stacked leading ``n_periods`` axis, ``mixer``/``wq``,
...), so the conversion is a walk over both trees at once: every leaf
becomes a tensor on ``device`` with the reference's values, bit for bit
(bfloat16 included), and its shape is checked against the port's
:func:`~repro_torch.models.transformer.model_defs`.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamDef, default_device, leaf_dtype

__all__ = ["from_jax_params", "to_tensor"]


def to_tensor(leaf: Any, device=None, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """One array leaf (a tensor, or numpy with ``ml_dtypes`` bfloat16
    included) as a tensor on ``device``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device=device, dtype=dtype or leaf.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: cross as raw bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree: Any, cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The reference's parameter tree (``np.asarray`` leaves, e.g. from
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's, on
    ``device`` (default: the card).  Each leaf keeps its own type unless
    ``dtype`` is given; then the weight leaves take it, and a leaf the
    model declares f32 (the MoE router, RG-LRU's ``lam``, Mamba-2's
    ``A_log``/``Dskip``/``dt_bias``) becomes f32, as ``init_params``
    makes it (:func:`~repro_torch.models.param.leaf_dtype`)."""
    from repro_torch.models.transformer import model_defs

    device = default_device(device)

    def walk(defs: Any, node: Any, path: str) -> Any:
        if isinstance(defs, ParamDef):
            t = to_tensor(node, device,
                          None if dtype is None else leaf_dtype(defs, dtype))
            if tuple(t.shape) != tuple(defs.shape):
                raise ValueError(
                    f"{path}: shape {tuple(t.shape)}, the model wants "
                    f"{tuple(defs.shape)}"
                )
            return t
        if isinstance(defs, dict):
            if not isinstance(node, dict) or set(node) != set(defs):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path}: keys {got}, want {sorted(defs)}")
            return {k: walk(defs[k], node[k], f"{path}/{k}") for k in defs}
        if len(node) != len(defs):
            raise ValueError(f"{path}: {len(node)} entries, want {len(defs)}")
        return [walk(d, n, f"{path}[{i}]") for i, (d, n) in
                enumerate(zip(defs, node))]

    return walk(model_defs(cfg), tree, "params")
