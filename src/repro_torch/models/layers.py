"""Shared neural layers: norms, RoPE, attention entry points onto the
port's kernels, gated MLPs.

All functions are pure; parameters arrive as dicts built from the
:mod:`repro_torch.models.param` definition trees.  The reference package
computes attention with XLA twins of its Pallas kernels
(``chunked_attention``, ``decode_attention``); here both entry points call
the hand-written kernels through :mod:`repro_torch.kernels.ops`, which take
the plain PyTorch versions only for tensors on the CPU.  Norms, RoPE and
the MLP are plain torch ops, as the reference leaves them to XLA; so is
the training loss, :func:`chunked_ce_loss`.  Given a TP process group,
the MLP runs column-parallel over ``d_ff`` and row-parallel back, and the
loss vocab-parallel over ``unembed``'s TP shard (the sharded train step).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.param import FSDP, TP, ParamDef
from repro_torch.parallel.collectives import (
    all_reduce, copy_to_tp, reduce_from_tp, reduce_partial)

__all__ = [
    "rms_norm",
    "layer_norm",
    "softcap",
    "rope_freqs",
    "apply_rope",
    "chunked_attention",
    "decode_attention",
    "mlp_defs",
    "mlp_apply",
    "chunked_ce_loss",
]


# -- norms ---------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False, tp_group=None) -> torch.Tensor:
    """RMSNorm in fp32; ``plus_one`` uses the gemma ``(1 + scale)`` form.
    With ``tp_group`` the last dim (and ``scale``) is this rank's block of
    channels cut over TP: the mean square is taken over every rank's."""
    xf = x.float()
    if tp_group is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ss = reduce_partial(torch.sum(xf * xf, dim=-1, keepdim=True), tp_group)
        var = ss / (xf.shape[-1] * dist.get_world_size(tp_group))
    normed = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:
        s = 1.0 + s
    return (normed * s).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)``."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# -- rotary embeddings -----------------------------------------------------

@functools.lru_cache(maxsize=64)
def rope_freqs(dh_rot: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, f32 ``(dh_rot / 2,)`` (cached per device: every
    layer of every step asks for the same ones)."""
    exps = torch.arange(0, dh_rot, 2, dtype=torch.float32, device=device) / dh_rot
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,  # (..., T, H, Dh)
    positions: torch.Tensor,  # (..., T) int
    theta: float = 10000.0,
    dh_rot: Optional[int] = None,
) -> torch.Tensor:
    """Rotary embedding on the first ``dh_rot`` head dims (rest pass through)."""
    dh = x.shape[-1]
    dh_rot = dh if dh_rot is None else dh_rot
    freqs = rope_freqs(dh_rot, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., T, dh_rot/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xr = x[..., :dh_rot].float()
    x1, x2 = xr[..., : dh_rot // 2], xr[..., dh_rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., dh_rot:]], dim=-1)


# -- attention ---------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,  # (B, Tq, H, Dh)
    k: torch.Tensor,  # (B, Tk, Kv, Dh)
    v: torch.Tensor,  # (B, Tk, Kv, Dhv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence attention through the flash kernel -> (B, Tq, H, Dhv).

    The reference's ``q_chunk``/``kv_chunk`` tile its XLA twin; the kernel
    picks its own tiles and computes the same function."""
    return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                               softcap=attn_softcap, window=window)


def decode_attention(
    q: torch.Tensor,  # (B, H, Dh): one new token per sequence
    k_cache: torch.Tensor,  # (B, S, Kv, Dh)
    v_cache: torch.Tensor,  # (B, S, Kv, Dh)
    length: torch.Tensor,  # (B,) int32 valid cache entries (incl. current)
    *,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Single-token attention over a KV cache through the decode kernel;
    with ``return_lse`` also each (row, head)'s f32 log-sum-exp.  Raises
    when q and the cache lie on different devices."""
    return ops.decode_attention(q, k_cache, v_cache, length, scale=scale,
                                softcap=attn_softcap, return_lse=return_lse)


# -- MLP ---------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, gated: bool = True) -> Dict[str, ParamDef]:
    if gated:
        return {
            "wi_gate": ParamDef((d_model, d_ff), (FSDP, TP)),
            "wi_up": ParamDef((d_model, d_ff), (FSDP, TP)),
            "wo": ParamDef((d_ff, d_model), (TP, FSDP)),
        }
    return {
        "wi": ParamDef((d_model, d_ff), (FSDP, TP)),
        "wo": ParamDef((d_ff, d_model), (TP, FSDP)),
    }


_ACTS = {
    "silu": F.silu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
}


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str = "silu", tp_group=None) -> torch.Tensor:
    """The MLP; with ``tp_group`` the weights are this rank's TP shards
    over ``d_ff`` (column- then row-parallel, one all-reduce)."""
    act_fn = _ACTS[act]
    if tp_group is not None:
        x = copy_to_tp(x, tp_group)
    if "wi_gate" in p:
        h = act_fn(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = act_fn(x @ p["wi"])
    out = h @ p["wo"]
    return out if tp_group is None else reduce_from_tp(out, tp_group)


# -- loss ---------------------------------------------------------------

def _chunk_ce(xb: torch.Tensor, unembed: torch.Tensor, lb: torch.Tensor,
              logit_softcap: Optional[float], tp_group=None):
    """Summed CE and valid count of one T-chunk.  With ``tp_group``,
    ``unembed`` is this rank's block of the vocab: the max and the sum of
    the exponentials are taken over the group, and the target's logit
    comes from the rank that holds it."""
    logits = softcap((xb @ unembed).float(), logit_softcap)
    valid = lb >= 0
    if tp_group is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, lb.clamp(min=0).long()[..., None],
                                  dim=-1)[..., 0]
        return torch.where(valid, lse - ll, 0.0).sum(), valid.sum()
    Vl = logits.shape[-1]
    local = lb.long() - torch.distributed.get_rank(tp_group) * Vl
    mine = valid & (local >= 0) & (local < Vl)
    m = all_reduce(logits.detach().amax(dim=-1), tp_group, "max")
    lse = m + torch.log(reduce_from_tp(torch.exp(logits - m[..., None]).sum(dim=-1),
                                       tp_group))
    ll = torch.take_along_dim(logits, local.clamp(0, Vl - 1)[..., None],
                              dim=-1)[..., 0]
    ll = reduce_from_tp(torch.where(mine, ll, 0.0), tp_group)
    return torch.where(valid, lse - ll, 0.0).sum(), valid.sum()


def chunked_ce_loss(
    x: torch.Tensor,  # (B, T, D) final hidden states
    unembed: torch.Tensor,  # (D, V), or this rank's (D, V / tp) with tp_group
    labels: torch.Tensor,  # (B, T) int; -100 = ignore
    *,
    t_chunk: int = 512,
    logit_softcap: Optional[float] = None,
    tp_group=None,
    n_total: Optional[torch.Tensor] = None,
):
    """Mean CE over valid tokens, computed in T-chunks so the (.., V)
    logits tensor never exists at full sequence length.  Returns
    ``(loss, n_valid)``.  Under autograd each chunk is checkpointed, so
    the backward pass too holds one chunk's logits at a time (a chunk's
    collectives run again in its recompute, in the same order on every
    rank).  ``tp_group``: vocab-parallel over ``unembed``'s TP shard.
    ``n_total``: divide the sum by this count instead of the valid
    tokens of ``labels`` (a rank's rows of a microbatch whose mean is
    over every rank's)."""
    B, T, _ = x.shape
    t_chunk = min(t_chunk, T)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    grad = torch.is_grad_enabled() and (x.requires_grad or unembed.requires_grad)
    if tp_group is not None:
        x = copy_to_tp(x, tp_group)
    for t0 in range(0, T, t_chunk):
        xb, lb = x[:, t0:t0 + t_chunk], labels[:, t0:t0 + t_chunk]
        if grad:
            s, n = checkpoint(_chunk_ce, xb, unembed, lb, logit_softcap, tp_group,
                              use_reentrant=False)
        else:
            s, n = _chunk_ce(xb, unembed, lb, logit_softcap, tp_group)
        total = total + s
        count = count + n
    n = torch.clamp(count, min=1) if n_total is None else n_total
    return total / n, n
