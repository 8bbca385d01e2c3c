"""Step factories: the train step (f32 masters, bf16 compute, microbatched
gradient accumulation, optional int8 gradient compression, AdamW), and
the prefill and decode steps.

The port of ``repro/launch/steps.py`` for one card.  The reference's
factories return a ``StepBundle`` (the step, its shardings and argument
stand-ins for the dry-run); here each returns the step itself, a plain
callable on one device, with no shardings.  For the train step the
reference builds a jitted, sharded step and casts the whole f32 tree to
bf16 once per step; here the step runs eagerly, and the weights are cast
inside each checkpointed layer period (``models.transformer.forward``'s
``dtype``), so no bf16 copy of the tree stays resident: at qwen2.5-3b's
full width the f32 masters, the two moments and the f32 gradients take
54 GB of the card's 80.  Each microbatch's ``backward()`` accumulates its
gradients into one f32 buffer, which is divided by the number of
microbatches, optionally compressed, and handed to AdamW, which updates
the masters and moments in place.  There is no mesh and no sharding (no
``zero1``).  ``make_prefill_step`` and ``make_decode_step`` are the
reference's serving steps (the serve launcher's prefill and greedy
decode), and ``make_step`` picks one by ``shape.kind``.  ``make_ctx`` builds the
layers' mesh context; the step factories stay unsharded.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import ModelConfig, ShapeConfig, decode_step, forward, logits_fn
from repro_torch.models.ctx import ShardCtx
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.models.param import default_device
from repro_torch.models.transformer import Periods, cast_weights
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update
from repro_torch.optim.compression import EFState, compress_decompress
from repro_torch.parallel.sharding import mesh_axes
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_step",
           "autograd_leaves", "make_ctx"]

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


def make_ctx(mesh) -> ShardCtx:
    """The layers' mesh context for ``mesh`` (a ``DeviceMesh`` or None): its
    data axes and TP axis, named as the reference names them."""
    if mesh is None:
        return ShardCtx()
    dp, _, tp = mesh_axes(mesh)
    return ShardCtx(mesh=mesh, dp_axes=dp or ("data",), tp_axis=tp or "model")


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


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      cache_len: Optional[int] = None) -> Callable:
    """The prefill step ``(params, batch) -> (logits, caches)``: the
    softcapped f32 logits of each sequence's last token, ``(B, V)``, and
    the cache tree of ``forward(collect_cache=True)``, ``cache_len`` rows
    long (default: the prompt's; more leaves decode headroom).  It runs
    where ``params`` and the batch's ``tokens`` lie, in the weights' own
    type."""

    def prefill_step(params: Dict[str, Any], batch: Dict[str, Any]):
        h, _aux, caches = forward(params, cfg, batch, collect_cache=True,
                                  cache_len=cache_len)
        return logits_fn(params, cfg, h[:, -1]), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """The greedy decode step ``(params, tokens (B, 1), cache, t) ->
    (next tokens (B, 1) int32, cache)``: one ``decode_step`` at position
    ``t`` (the cache's layers are written in place) and the argmax of its
    logits."""

    def serve_step(params: Dict[str, Any], tokens: torch.Tensor,
                   cache: Dict[str, Any], t: int):
        logits, new_cache = decode_step(params, cfg, tokens, cache, t)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], new_cache

    return serve_step


def make_step(cfg: ModelConfig, shape: ShapeConfig, **kw) -> Callable:
    """The step of ``shape.kind``: "train", "prefill", or else decode."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, **kw)
    return make_decode_step(cfg, shape, **kw)
