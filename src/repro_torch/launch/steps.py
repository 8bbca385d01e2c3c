"""The train step: f32 masters, bf16 compute, microbatched gradient
accumulation, optional int8 gradient compression, AdamW.

The port of ``repro/launch/steps.py::make_train_step`` for one card.  The
reference builds a jitted, sharded step and casts the whole f32 tree to
bf16 once per step; here the step runs eagerly, and the weights are cast
inside each checkpointed layer period (``models.transformer.forward``'s
``dtype``), so no bf16 copy of the tree stays resident: at qwen2.5-3b's
full width the f32 masters, the two moments and the f32 gradients take
54 GB of the card's 80.  Each microbatch's ``backward()`` accumulates its
gradients into one f32 buffer, which is divided by the number of
microbatches, optionally compressed, and handed to AdamW, which updates
the masters and moments in place.  There is no mesh and no sharding (no
``zero1``).  The reference's prefill and decode step factories serve its
dry-run, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import ModelConfig, ShapeConfig, forward
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.models.param import default_device
from repro_torch.models.transformer import Periods, cast_weights
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update
from repro_torch.optim.compression import EFState, compress_decompress
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "autograd_leaves"]

#: the type the step computes in; the masters stay f32
COMPUTE_DTYPE = torch.bfloat16


def autograd_leaves(params: Dict[str, Any], grads: Dict[str, Any]) -> Dict[str, Any]:
    """The tree the forward pass differentiates: each leaf a detached view
    of its master that requires grad, with ``.grad`` already set to its
    slot of ``grads``, so ``backward()`` adds into ``grads`` in place.  A
    stacked body leaf becomes :class:`Periods`, one view per period: were
    the stacked master indexed under autograd, every period's gradient
    would first be a zero tensor the size of the whole stack."""
    def leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        v = p.detach().requires_grad_()
        v.grad = g
        return v

    def per_period(p: torch.Tensor, g: torch.Tensor) -> Periods:
        return Periods(leaf(p[i], g[i]) for i in range(p.shape[0]))

    return {k: tree_map(per_period if k == "body" else leaf, params[k], grads[k])
            for k in params}


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def make_train_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    aux_coef: float = 0.01,
    compress_grads: bool = False,
    device: Any = None,
) -> Callable:
    """A step ``(params, opt_state, batch[, ef]) -> (params, opt_state,
    metrics[, ef])`` over f32 ``params`` on ``device`` (default: the
    card).  ``batch`` maps ``tokens`` (and ``labels``, -100 ignored) to
    ``(shape.global_batch, T)`` arrays or tensors.  The step updates the
    parameters and moments in place and returns them.  ``metrics``: the
    mean CE loss over the microbatches, ``tokens`` counted, the gradient
    norm before clipping, the new ``step``, and with compression the mean
    quantization error; all 0-dim tensors on the device (reading one
    synchronizes)."""
    device = default_device(device)
    n_mb = shape.microbatches
    B = shape.global_batch
    if B % n_mb:
        raise ValueError(f"global batch {B} does not split into {n_mb} microbatches")

    def train_step(params: Dict[str, Any], opt_state: OptState,
                   batch: Dict[str, Any], ef_state: Optional[EFState] = None):
        grads = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        leaves = autograd_leaves(params, grads)
        mbs = {k: _to_device(v, device).chunk(n_mb) for k, v in batch.items()}
        losses, counts = [], []
        for i in range(n_mb):
            inputs = {k: v[i] for k, v in mbs.items() if k != "labels"}
            h, aux = forward(leaves, cfg, inputs, remat=shape.remat,
                             dtype=COMPUTE_DTYPE)
            loss, n = chunked_ce_loss(
                h, cast_weights(leaves["unembed"], COMPUTE_DTYPE),
                mbs["labels"][i], t_chunk=shape.loss_chunk,
                logit_softcap=cfg.final_softcap)
            (loss + aux_coef * aux).backward()
            losses.append(loss.detach())
            counts.append(n)
            del h, aux, loss
        del leaves
        for g in tree_leaves(grads):
            g.div_(n_mb)
        metrics: Dict[str, torch.Tensor] = {}
        new_ef = ef_state
        if compress_grads and ef_state is not None:
            grads, new_ef, qerr = compress_decompress(grads, ef_state)
            metrics["compression_err"] = qerr
        params, opt_state, gnorm = adamw_update(params, grads, opt_state, opt_cfg)
        metrics.update(loss=torch.stack(losses).mean(),
                       tokens=torch.stack(counts).sum(), grad_norm=gnorm,
                       step=opt_state.step)
        out = (params, opt_state, metrics)
        return out + ((new_ef,) if compress_grads else ())

    return train_step
