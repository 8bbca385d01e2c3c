"""Multi-head Latent Attention (DeepSeek-V2): compressed-KV attention.

The port of ``repro/models/mla.py``.  Prefill uses the *expanded* form:
the normed latents ``c_kv`` are decompressed to per-head K (128 "nope"
columns, then the 64 rotary columns of the one shared ``k_pe``) and V
(128), and attention runs through ``layers.chunked_attention``, i.e. the
flash kernel at q/k head dim 192 against v head dim 128 (the reference
calls its XLA twin of the Pallas kernel here).  ``k_pe`` is broadcast to
every head by the concatenation, so K is one contiguous tensor whose
strides TMA takes.

In the sharded train step (``ctx`` with a TP axis of more than one rank
dividing the heads) the block runs tensor-parallel over the heads, as the
parameter specs lay it out: ``wq``, ``wk_b`` and ``wv_b`` this rank's
heads, ``wo`` row-parallel (``reduce_from_tp``), the flash kernel on the
rank's ``H/tp`` heads with ``k_pe`` expanded to those heads only.
``wkv_a`` and ``kv_norm`` stay whole: every rank computes the latents,
and uses them only for its own heads.  The input passes ``copy_to_tp``,
so those two leaves' gradients are partial there (:func:`tp_partial`),
and the train step sums them over TP.  Where TP does not divide the
heads, the cut leaves are gathered whole and every rank runs every head.

Decode uses the *absorbed* form, as torch ops, as the reference computes
it outside any kernel: queries are projected into the latent space, so
attention runs over the ``(B, S, kv_lora_rank + rope_dim)`` cache in f32.
:func:`mla_decode` writes the new latent row at position ``t`` into the
cache it is given, in place.

The serving steps on a mesh cut the latents ``c_kv`` and ``k_pe`` on the
sequence over TP (``cache_pspecs``; whole where TP does not divide the
cache), while the weights are cut on the heads.  Prefill keeps the
rank's block of the latents, which every rank computes whole.  A decode
step gathers the absorbed queries ``q_c`` and ``q_pe`` of every head over
TP (``(B, H, r)`` and ``(B, H, dr)``), scores every head over the rank's
block of latents, combines the blocks' latent contexts through their
log-sum-exps (``combine_partials``, in the ``r``-space), and applies
``wv_b`` and ``wo`` to the rank's own heads (``reduce_from_tp``).  Row
``t`` is written on the rank whose block holds it.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.ctx import ShardCtx, gather_whole
from repro_torch.models.layers import apply_rope, chunked_attention, rms_norm
from repro_torch.models.param import FSDP, TP, ParamDef, default_device
from repro_torch.parallel.collectives import (
    all_gather, combine_partials, copy_to_tp, reduce_from_tp)

__all__ = ["mla_defs", "mla_apply", "mla_decode", "init_mla_cache", "MLACache",
           "tp_partial"]

MASK_VALUE = -1e30


def mla_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamDef((D, H, dq), (FSDP, TP, None)),
        "wkv_a": ParamDef((D, m.kv_lora_rank + m.qk_rope_head_dim), (FSDP, None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init_value=1.0),
        "wk_b": ParamDef((m.kv_lora_rank, H, m.qk_nope_head_dim), (None, TP, None)),
        "wv_b": ParamDef((m.kv_lora_rank, H, m.v_head_dim), (None, TP, None)),
        "wo": ParamDef((H, m.v_head_dim, D), (TP, None, FSDP)),
    }


def tp_partial(cfg: ModelConfig, tp: int) -> Tuple[str, ...]:
    """The leaves replicated over a TP axis of ``tp`` ranks that each rank
    uses only for its own heads: their gradients sum over TP."""
    if tp == 1 or cfg.n_heads % tp:
        return ()
    return ("wkv_a", "kv_norm")


def _scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., r) @ w (r, H, d) -> (..., H, d): one matmul over the
    flattened heads."""
    r, H, d = w.shape
    return (x @ w.reshape(r, H * d)).view(*x.shape[:-1], H, d)


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S, r) compressed latents (normed)
    k_pe: torch.Tensor  # (B, S, dr) roped shared key


def mla_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, D)
    cfg: ModelConfig,
    *,
    collect_cache: bool = False,
    cache_len: Optional[int] = None,
    ctx: Optional[ShardCtx] = None,
):
    """Expanded-form MLA (prefill), through the flash kernel.

    With ``collect_cache`` also returns the compressed ``(c_kv, k_pe)``
    cache the absorbed-form decode reads, ``cache_len`` rows long.  With
    ``ctx`` the weights may arrive as TP shards (module docstring)."""
    m = cfg.mla
    B, T, D = x.shape
    r, dr = m.kv_lora_rank, m.qk_rope_head_dim
    group = None if ctx is None else ctx.tp_group(p["wq"].shape[1], cfg.n_heads)
    if group is None and ctx is not None and ctx.tp_size() > 1:
        p = gather_whole(p, mla_defs(cfg), ctx)
    if group is not None:
        x = copy_to_tp(x, group)
    H = p["wq"].shape[1]  # this rank's heads
    pos = torch.arange(T, device=x.device)[None, :]
    q = _heads(x, p["wq"])  # (B, T, H, dq)
    q_nope, q_pe = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)

    kv_a = x @ p["wkv_a"]  # (B, T, r + dr)
    c_kv = rms_norm(kv_a[..., :r], p["kv_norm"])
    k_pe = apply_rope(kv_a[..., r:][:, :, None, :], pos, cfg.rope_theta)

    k_nope = _heads(c_kv, p["wk_b"])  # (B, T, H, nope)
    v = _heads(c_kv, p["wv_b"])  # (B, T, H, dv)
    k = torch.cat([k_nope, k_pe.expand(B, T, H, dr)], dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    o = chunked_attention(q_full, k, v, causal=cfg.causal, scale=_scale(cfg))
    wo = p["wo"]  # (H, dv, D)
    out = o.reshape(B, T, -1) @ wo.reshape(-1, wo.shape[-1])
    if group is not None:
        out = reduce_from_tp(out, group)
    if not collect_cache:
        return out
    pad = (cache_len or T) - T
    cache = MLACache(c_kv=F.pad(c_kv, (0, 0, 0, pad)),
                     k_pe=F.pad(k_pe[:, :, 0], (0, 0, 0, pad)))
    block = ctx.tp_block(T + pad) if ctx is not None and ctx.serving_tp() else None
    if block is not None:  # this rank's block of the sequence
        cache = MLACache(*(c.narrow(1, *block).clone() for c in cache))
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                   device=None) -> MLACache:
    """Zero latents on ``device`` (default: the card)."""
    device = default_device(device)
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros(batch, seq_len, m.kv_lora_rank, dtype=dtype,
                         device=device),
        k_pe=torch.zeros(batch, seq_len, m.qk_rope_head_dim, dtype=dtype,
                         device=device),
    )


def mla_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, D)
    cache: MLACache,  # written in place
    t: int,  # position of x
    cfg: ModelConfig,
    ctx: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-form decode: attention in the compressed space.  Returns
    (out (B, 1, D), ``cache``) with row ``t`` written in place.  Raises
    when the cache is not on x's device.  With the serving steps' ``ctx``
    on a TP axis of more than one rank (:meth:`ShardCtx.serving_tp`) the
    weights are its TP shards and the cache its block (module
    docstring)."""
    if cache.c_kv.device != x.device or cache.k_pe.device != x.device:
        raise ValueError(
            f"decode on {x.device} but the MLA cache is on {cache.c_kv.device}"
        )
    m = cfg.mla
    B = x.shape[0]
    r = m.kv_lora_rank
    first, rows = 0, cache.c_kv.shape[1]
    block, group = None, None
    if ctx is not None and ctx.serving_tp():
        tp_group = ctx.group(ctx.tp_axis)
        group = ctx.tp_group(p["wq"].shape[1], cfg.n_heads)
        if group is None:
            p = gather_whole(p, mla_defs(cfg), ctx)
        block = ctx.tp_block(ctx.cache_len)
        first, n = block if block is not None else (0, ctx.cache_len)
        if rows != n:
            raise ValueError(f"an MLA cache of {rows} rows where this rank "
                             f"holds {n} of {ctx.cache_len}")
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = _heads(x, p["wq"])[:, 0]  # (B, H, dq): the rank's heads
    q_nope, q_pe = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe[:, None], pos, cfg.rope_theta)[:, 0]

    kv_a = x @ p["wkv_a"]  # (B, 1, r + dr), whole on every rank
    if block is None or first <= t < first + rows:  # the row's owner
        cache.c_kv[:, t - first] = rms_norm(kv_a[..., :r], p["kv_norm"])[:, 0]
        cache.k_pe[:, t - first] = apply_rope(kv_a[..., r:][:, :, None, :], pos,
                                              cfg.rope_theta)[:, 0, 0]

    # Absorb: q_c = q_nope @ wk_b -> (B, H, r); scores over the latents.
    q_c = torch.einsum("bhk,rhk->bhr", q_nope, p["wk_b"])
    if group is not None:  # every head's absorbed query
        q_c, q_pe = (all_gather(y, tp_group, 1) for y in (q_c, q_pe))
    c_kv = cache.c_kv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_c.float(), c_kv)
         + torch.einsum("bhk,bsk->bhs", q_pe.float(), cache.k_pe.float())
         ) * _scale(cfg)
    valid = first + torch.arange(rows, device=x.device) <= t
    s = s.masked_fill(~valid, MASK_VALUE)
    if block is None:
        ctx_c = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c_kv)
    else:  # this block's context and log-sum-exp, combined over TP
        mx = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - mx) * valid
        l = e.sum(dim=-1)
        part = torch.einsum("bhs,bsr->bhr", e, c_kv) / torch.clamp_min(
            l[..., None], 1e-30)
        lse = torch.where(l > 0, mx[..., 0] + torch.log(l), MASK_VALUE)
        ctx_c = combine_partials(part, lse, tp_group)
    if group is not None:  # this rank's heads
        Hl = p["wq"].shape[1]
        ctx_c = ctx_c.narrow(1, ctx.local_rank(ctx.tp_axis) * Hl, Hl)
    o = torch.einsum("bhr,rhv->bhv", ctx_c, p["wv_b"].float())
    out = torch.einsum("bhv,hvd->bd", o.to(x.dtype), p["wo"])[:, None]
    return (out if group is None else reduce_from_tp(out, group)), cache
