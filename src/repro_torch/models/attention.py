"""GQA/MQA/MHA attention block: defs + prefill apply + decode apply.

The port of ``repro/models/attention.py`` for one card.  The reference
pins layouts for tensor parallelism (``constrain``, ``_head_specs``) and,
in TP-on-heads mode, expands K/V to all heads before attention; on one
card there is nothing to shard, and the flash kernel reads GQA as it
comes, so all of that drops out.  What stays is ``_eff_heads``'s rule:
with ``cfg.pad_heads`` the parameters carry dead heads whose outputs are
zeroed before the out-projection, so the function is the unpadded
model's and the parameter shapes are the reference's.

Decode uses ring-buffer caches for windowed (local) layers: cache memory
is O(window).  The decode step writes its new K/V row into the cache in
place (the reference returns an updated copy); the caller's cache is the
updated one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, chunked_attention, decode_attention
from repro_torch.models.param import FSDP, TP, ParamDef
from repro_torch.models.quant_cache import (
    QuantAttnCache,
    quant_decode_attention,
    quantize_kv,
)

__all__ = ["AttnCache", "attn_defs", "attn_apply", "attn_decode",
           "init_attn_cache", "DEFAULT_TP"]

#: the reference's production TP degree; only ``_eff_heads`` reads it here
DEFAULT_TP = 16


def _eff_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(H_eff, Kv_eff): padded head counts when cfg.pad_heads is set.

    Padding adds *dead* heads: their post-attention outputs are masked to
    zero before the out-projection, so the function space is exactly the
    unpadded model's."""
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    if not cfg.pad_heads or H % DEFAULT_TP == 0:
        return H, Kv
    H_eff = -(-H // DEFAULT_TP) * DEFAULT_TP
    Kv_eff = H_eff if Kv == H else Kv  # MHA pads kv too; GQA/MQA expands
    return H_eff, Kv_eff


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The reference's parameter tree (shapes, names, init); the logical
    sharding specs are kept as data and ignored."""
    D, dh = cfg.d_model, cfg.head_dim
    H, Kv = _eff_heads(cfg)
    defs = {
        "wq": ParamDef((D, H, dh), (FSDP, TP, None)),
        "wk": ParamDef((D, Kv, dh), (FSDP, None, None)),
        "wv": ParamDef((D, Kv, dh), (FSDP, None, None)),
        "wo": ParamDef((H, dh, D), (TP, None, FSDP)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, dh), (TP, None), init_scale=0.0)
        defs["bk"] = ParamDef((Kv, dh), (None, None), init_scale=0.0)
        defs["bv"] = ParamDef((Kv, dh), (None, None), init_scale=0.0)
    return defs


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B, T, D) -> q (B, T, H, dh), k/v (B, T, Kv, dh)."""
    B, T, D = x.shape

    def proj(w):  # (D, n, dh): one matmul over the flattened heads
        return (x @ w.reshape(D, -1)).view(B, T, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _out_proj(p, o: torch.Tensor) -> torch.Tensor:
    """o (..., H, dh) -> (..., D)."""
    wo = p["wo"]
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, S, Kv, dh) — S = min(seq_len, window or seq_len)
    v: torch.Tensor


def attn_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, D)
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    collect_cache: bool = False,
    cache_len: Optional[int] = None,
):
    """Full-sequence attention (prefill), through the flash kernel.

    With ``collect_cache`` also returns the decode cache: full K/V for
    global layers, the last-``window`` ring for local layers (entry for
    position p at slot ``p % window``, matching ``attn_decode``).
    """
    B, T, _ = x.shape
    H_eff, _ = _eff_heads(cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(
        q, k, v,
        causal=cfg.causal,
        window=window,
        attn_softcap=cfg.attn_softcap,
        scale=cfg.query_scale,
    )
    if H_eff != cfg.n_heads:
        # dead padded heads: zero their outputs (exact fn equivalence)
        live = torch.arange(H_eff, device=o.device) < cfg.n_heads
        o = o * live[None, None, :, None].to(o.dtype)
    out = _out_proj(p, o)
    if not collect_cache:
        return out
    L = cache_len or T
    S = min(L, window) if window else L
    n = min(T, S)
    pos = torch.arange(T - n, T, device=x.device)  # last n positions
    slots = pos % S  # ring layout for local layers; identity when S >= T
    ck = torch.zeros((B, S) + k.shape[2:], dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, S) + v.shape[2:], dtype=v.dtype, device=v.device)
    ck[:, slots] = k[:, pos]
    cv[:, slots] = v[:, pos]
    return out, AttnCache(ck, cv)


def init_attn_cache(
    cfg: ModelConfig, batch: int, seq_len: int, window: Optional[int], dtype,
    device=None,
) -> AttnCache:
    S = min(seq_len, window) if window else seq_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def attn_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, D) current token hidden
    cache,  # AttnCache or QuantAttnCache, written in place
    t: int,  # current position (0-based)
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, object]:
    """One decode step; returns (out (B, 1, D), the updated cache).

    Windowed layers use a ring buffer (slot = t mod S): every live entry
    is inside the window by construction, so only warmup masking is
    needed.  Raises when the cache is not on x's device.
    """
    B = x.shape[0]
    quant = isinstance(cache, QuantAttnCache)
    held = cache.k_q if quant else cache.k
    if held.device != x.device:
        raise ValueError(
            f"decode on {x.device} but the KV cache is on {held.device}"
        )
    S = held.shape[1]
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)  # (B, 1, H/Kv, dh)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = t % S  # ring slot; global layers have S == seq_len so slot == t
    # Valid entries: slots <= t (warmup) or everything once t >= S.
    lengths = torch.full((B,), min(t + 1, S), dtype=torch.int32, device=x.device)
    if quant:
        kq, ks = quantize_kv(k[:, 0])
        vq, vs = quantize_kv(v[:, 0])
        cache.k_q[:, slot] = kq
        cache.v_q[:, slot] = vq
        cache.k_s[:, slot] = ks.to(cache.k_s.dtype)
        cache.v_s[:, slot] = vs.to(cache.v_s.dtype)
        o = quant_decode_attention(
            q[:, 0], cache, lengths,
            attn_softcap=cfg.attn_softcap, scale=cfg.query_scale,
        ).to(x.dtype)
        return _out_proj(p, o)[:, None, :], cache
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    # the kernel masks by `lengths` over the slot axis; ring order does not
    # matter for the softmax since all live entries are in-window.
    o = decode_attention(
        q[:, 0], cache.k, cache.v, lengths,
        attn_softcap=cfg.attn_softcap, scale=cfg.query_scale,
    )
    return _out_proj(p, o)[:, None, :], cache
