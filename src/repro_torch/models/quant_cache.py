"""int8-quantized KV cache: the compression tier for decode state.

The paper's storage argument applied to serving: when the hot tier can't
hold the state, compress it rather than spill it.  The KV pager demotes a
cold conversation's cache to this encoding; a resumed conversation then
decodes straight from it.

Layout: values int8, scales bf16 over the head_dim axis.  Attention runs
chunked over the sequence with an online softmax, dequantizing one
``s_chunk`` panel at a time.  As in the reference package this is plain
tensor code, not a kernel; an int8-dequant variant of the decode kernel is
a later item (ROADMAP.md, queue C).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["QuantAttnCache", "init_quant_cache", "quantize_kv", "quantize_cache",
           "quant_decode_attention"]

MASK_VALUE = -1e30


class QuantAttnCache(NamedTuple):
    k_q: torch.Tensor  # (B, S, Kv, dh) int8
    v_q: torch.Tensor  # (B, S, Kv, dh) int8
    k_s: torch.Tensor  # (B, S, Kv) bf16 scales
    v_s: torch.Tensor  # (B, S, Kv) bf16 scales


def init_quant_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     window: Optional[int] = None,
                     device=None) -> QuantAttnCache:
    S = min(seq_len, window) if window else seq_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return QuantAttnCache(
        k_q=torch.zeros(shape, dtype=torch.int8, device=device),
        v_q=torch.zeros(shape, dtype=torch.int8, device=device),
        k_s=torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
        v_s=torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
    )


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, dh) -> (int8 values, bf16 scale over dh).  Rounds half to even,
    as the reference's ``jnp.round``: the bytes match it."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def quantize_cache(k: torch.Tensor, v: torch.Tensor) -> QuantAttnCache:
    """A layer's K/V cache ``(..., S, Kv, dh)`` in its int8 form (the KV
    pager's demotion of a cold conversation)."""
    (k_q, k_s), (v_q, v_s) = quantize_kv(k), quantize_kv(v)
    return QuantAttnCache(k_q=k_q, v_q=v_q, k_s=k_s, v_s=v_s)


def quant_decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    cache: QuantAttnCache,
    length: torch.Tensor,  # (B,) valid entries
    *,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    s_chunk: int = 2048,
    return_lse: bool = False,
):
    """Single-token attention over the int8 cache, chunk-dequantized.
    Returns bf16 ``(B, H, dh)``; raises when q and the cache lie on
    different devices.  With ``return_lse`` it returns the partial of a
    block of a sequence-sharded cache instead: ``(o, lse)``, o in f32 (the
    whole attention rounds once, after the blocks combine) and lse each
    (row, head)'s f32 log-sum-exp (``MASK_VALUE`` where no row is live)."""
    if {q.device, cache.k_q.device, cache.v_q.device, length.device} != {q.device}:
        raise ValueError(
            f"q on {q.device} but the int8 cache on {cache.k_q.device} "
            f"(lengths on {length.device})"
        )
    B, H, dh = q.shape
    _, S, Kv, _ = cache.k_q.shape
    rep = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qr = q.float().reshape(B, Kv, rep, dh)
    acc = torch.zeros(B, Kv, rep, dh, dtype=torch.float32, device=q.device)
    m = torch.full((B, Kv, rep), MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, Kv, rep, dtype=torch.float32, device=q.device)
    for lo in range(0, S, s_chunk):
        hi = min(S, lo + s_chunk)
        k = cache.k_q[:, lo:hi].float() * cache.k_s[:, lo:hi].float()[..., None]
        s = torch.einsum("bkrd,bskd->bkrs", qr, k) * scale
        if attn_softcap is not None:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        pos = torch.arange(lo, hi, device=q.device)
        valid = (pos[None, :] < length[:, None])[:, None, None, :]  # (B,1,1,C)
        s = s.masked_fill(~valid, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * valid
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        v = cache.v_q[:, lo:hi].float() * cache.v_s[:, lo:hi].float()[..., None]
        acc = acc * corr[..., None] + torch.einsum("bkrs,bskd->bkrd", p, v)
        m = m_new
    o = (acc / torch.clamp_min(l[..., None], 1e-30)).reshape(B, H, dh)
    if not return_lse:
        return o.to(torch.bfloat16)
    lse = torch.where(l > 0, m + torch.log(l), MASK_VALUE)
    return o, lse.reshape(B, H)
