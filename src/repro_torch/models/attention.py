"""GQA/MQA/MHA attention block: defs + prefill/train apply + decode apply.

The port of ``repro/models/attention.py``.  Sharding rule (DESIGN.md
§4), the reference's ``_head_specs``: the tensor-parallel axis goes on
the *heads* dim when the production TP degree (16) divides it, otherwise
on head_dim; in TP-on-heads mode with fewer kv heads than that, the kv
projections are replicated over TP.  With ``cfg.pad_heads`` the
parameters carry dead heads whose outputs are zeroed before the
out-projection, so the function is the unpadded model's and the
parameter shapes are the reference's.

On one card, or with whole weights, ``attn_apply`` is one flash call
over every head (the kernel reads GQA as it comes).  In the sharded
train step the weights arrive as this rank's TP shards
(:meth:`ShardCtx.tp_group` tells them from whole ones by their shape):

* heads over TP: q and its bias column-parallel, the flash kernel on the
  rank's own heads, ``wo`` row-parallel with the all-reduce of the TP
  pair (``copy_to_tp`` on the input, ``reduce_from_tp`` on the output).
  Replicated kv projections give each rank the kv heads its q heads read
  (every q head its own kv head where they split a kv group unevenly);
  each rank then uses them only in part, so the train step sums their
  gradients over TP (:func:`tp_partial`).
* head_dim over TP: the weights are gathered whole over TP
  (``gather_from_tp``, whose backward keeps the rank's slice) and the
  attention runs replicated, as the reference's GSPMD layout of that
  mode reads whole heads for every score.

Decode uses ring-buffer caches for windowed (local) layers: cache memory
is O(window).  The decode step writes its new K/V row into the cache in
place (the reference returns an updated copy); the caller's cache is the
updated one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ctx import ShardCtx, gather_whole
from repro_torch.models.layers import apply_rope, chunked_attention, decode_attention
from repro_torch.models.param import FSDP, TP, ParamDef
from repro_torch.models.quant_cache import (
    QuantAttnCache,
    quant_decode_attention,
    quantize_kv,
)
from repro_torch.parallel.collectives import copy_to_tp, reduce_from_tp

__all__ = ["AttnCache", "attn_defs", "attn_apply", "attn_decode",
           "init_attn_cache", "tp_partial", "DEFAULT_TP"]

#: the reference's production TP degree: it picks the sharded dim
DEFAULT_TP = 16


def _head_specs(n_heads: int, head_dim: int):
    """(spec for (D, H, dh) proj, spec for (H, dh, D) out-proj)."""
    if n_heads % DEFAULT_TP == 0:
        return (FSDP, TP, None), (TP, None, FSDP)
    if head_dim % DEFAULT_TP == 0:
        return (FSDP, None, TP), (None, TP, FSDP)
    return (FSDP, None, None), (None, None, FSDP)


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


def _expand_kv(cfg: ModelConfig) -> bool:
    """TP-on-heads mode with Kv < TP: the (small) kv projections are
    replicated over TP."""
    H, Kv = _eff_heads(cfg)
    return H % DEFAULT_TP == 0 and Kv % DEFAULT_TP != 0


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, dh = cfg.d_model, cfg.head_dim
    H, Kv = _eff_heads(cfg)
    q_spec, o_spec = _head_specs(H, dh)
    if _expand_kv(cfg):
        kv_spec = (FSDP, None, None)  # replicated heads
    else:
        kv_spec, _ = _head_specs(Kv, dh)
    defs = {
        "wq": ParamDef((D, H, dh), q_spec),
        "wk": ParamDef((D, Kv, dh), kv_spec),
        "wv": ParamDef((D, Kv, dh), kv_spec),
        "wo": ParamDef((H, dh, D), o_spec),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, dh), (q_spec[1], q_spec[2]), init_scale=0.0)
        defs["bk"] = ParamDef((Kv, dh), (kv_spec[1], kv_spec[2]), init_scale=0.0)
        defs["bv"] = ParamDef((Kv, dh), (kv_spec[1], kv_spec[2]), init_scale=0.0)
    return defs


def tp_partial(cfg: ModelConfig, tp: int) -> Tuple[str, ...]:
    """The leaves replicated over a TP axis of ``tp`` ranks that each rank
    uses only in part (the kv projections of TP-on-heads mode, where the
    kv heads do not split over TP): their gradients sum over TP."""
    H, Kv = _eff_heads(cfg)
    if tp == 1 or H % DEFAULT_TP or H % tp or not (_expand_kv(cfg) or Kv % tp):
        return ()
    return ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")


def _project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """x (B, T, D) @ w (D, n, dh) (+ b (n, dh)) -> (B, T, n, dh): one
    matmul over the flattened heads."""
    B, T, D = x.shape
    y = (x @ w.reshape(D, -1)).view(B, T, w.shape[1], w.shape[2])
    return y if b is None else y + b


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B, T, D) -> q (B, T, H, dh), k/v (B, T, Kv, dh)."""
    return tuple(_project(x, p[w], p.get(b) if cfg.qkv_bias else None)
                 for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))


def _heads_tp(p, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx, group):
    """q, k, v of this rank's q heads, TP over heads (see the module
    docstring), and the first of those heads."""
    H, Kv = _eff_heads(cfg)
    Hl = p["wq"].shape[1]
    h0 = ctx.local_rank(ctx.tp_axis) * Hl
    x = copy_to_tp(x, group)
    bias = (lambda b: p[b]) if cfg.qkv_bias else (lambda b: None)
    q = _project(x, p["wq"], bias("bq"))
    if p["wk"].shape[1] < Kv:  # kv heads split over TP too: the GQA ratio holds
        return q, _project(x, p["wk"], bias("bk")), _project(x, p["wv"], bias("bv")), h0
    G = H // Kv
    first, last = h0 // G, (h0 + Hl - 1) // G
    n = last - first + 1

    def kv(w, b):
        y = _project(x, p[w].narrow(1, first, n),
                     None if b is None else b.narrow(0, first, n))
        if n > 1 and (h0 % G or Hl % G):  # q heads split a kv group unevenly
            idx = torch.arange(h0, h0 + Hl, device=y.device) // G - first
            y = y.index_select(2, idx)
        return y

    return q, kv("wk", bias("bk")), kv("wv", bias("bv")), h0


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
    ctx: Optional[ShardCtx] = None,
):
    """Full-sequence attention (training / prefill), through the flash
    kernel.

    With ``collect_cache`` also returns the decode cache: full K/V for
    global layers, the last-``window`` ring for local layers (entry for
    position p at slot ``p % window``, matching ``attn_decode``).  With
    ``ctx`` the weights may arrive as TP shards (module docstring).
    """
    B, T, _ = x.shape
    H_eff, _ = _eff_heads(cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    group = None if ctx is None else ctx.tp_group(p["wq"].shape[1], H_eff)
    h0 = 0
    if group is not None:
        q, k, v, h0 = _heads_tp(p, x, cfg, ctx, group)
    else:
        if ctx is not None and ctx.tp_size() > 1:
            p = gather_whole(p, attn_defs(cfg), ctx)
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
        live = torch.arange(h0, h0 + o.shape[2], device=o.device) < cfg.n_heads
        o = o * live[None, None, :, None].to(o.dtype)
    out = _out_proj(p, o)
    if group is not None:
        out = reduce_from_tp(out, group)
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
