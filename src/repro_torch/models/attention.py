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

The serving steps on a mesh lay the caches out as the reference's
``cache_pspecs`` does: the sequence (the ring's slots) cut over TP in
contiguous blocks, every kv head on every rank (``ShardCtx.tp_block``),
or whole where TP does not divide it.  Prefill turns the K and V each
rank computed for its kv heads into sequence blocks of every head with
one ``all_to_all`` (where the kv heads are cut over TP), or takes its
block of K and V computed whole (the kv projections replicated, or
gathered in head_dim mode).  A decode step gathers the new token's q over
TP (and its k and v where the kv heads are cut), writes the k/v row on the
rank that owns its slot, runs the decode kernel for every q head over the
rank's block with the block's own lengths, and combines the blocks'
partial outputs through their log-sum-exps (``combine_partials``); each
rank then applies its own heads' out-projection (``reduce_from_tp``), as
the train path does.  Only q, the new k/v row and the partial outputs
cross the ranks: no rank holds another's block of the cache.
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
from repro_torch.parallel.collectives import (
    all_gather, all_to_all, combine_partials, copy_to_tp, reduce_from_tp)

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
    if ctx is not None and ctx.serving_tp():
        return out, _tp_cache(p, x, k, v, cfg, ctx, group, S, positions)
    return out, AttnCache(*(_ring(t, S) for t in (k, v)))


def _ring(t: torch.Tensor, S: int) -> torch.Tensor:
    """(B, T, n, dh) -> the (B, S, n, dh) cache of its last min(T, S)
    positions, position p at slot ``p % S`` (the ring of local layers;
    the identity layout when S >= T)."""
    B, T = t.shape[:2]
    n = min(T, S)
    pos = torch.arange(T - n, T, device=t.device)  # last n positions
    c = torch.zeros((B, S) + t.shape[2:], dtype=t.dtype, device=t.device)
    c[:, pos % S] = t[:, pos]
    return c


def _tp_cache(p, x, k, v, cfg: ModelConfig, ctx: ShardCtx, group, S: int,
              positions) -> AttnCache:
    """Prefill's cache on a TP axis of more than one rank, laid out as
    ``cache_pspecs`` says (module docstring): every kv head, this rank's
    block of the ``S`` slots (or all of them where TP does not divide S).
    ``k``/``v`` are the attention's own (post-RoPE): every kv head in
    head_dim mode, the rank's kv heads where they are cut over TP, else
    (replicated kv projections, narrowed to the rank's q heads) they are
    computed again whole."""
    _, Kv = _eff_heads(cfg)
    tp_group = ctx.group(ctx.tp_axis)
    block = ctx.tp_block(S)
    if group is not None and p["wk"].shape[1] == Kv:
        bias = (lambda b: p[b]) if cfg.qkv_bias else (lambda b: None)
        k = apply_rope(_project(x, p["wk"], bias("bk")), positions, cfg.rope_theta)
        v = _project(x, p["wv"], bias("bv"))
    out = []
    for t in (k, v):
        c = _ring(t, S)
        if c.shape[2] == Kv:  # every head here: keep this rank's block
            if block is not None:
                c = c.narrow(1, *block).clone()
        elif block is None:  # the kv heads cut over TP, the cache whole
            c = all_gather(c, tp_group, 2).contiguous()
        else:  # rank j's heads of block i to rank i: heads of one block
            tp = ctx.tp_size()
            B, _, Kl, dh = c.shape
            send = c.view(B, tp, S // tp, Kl, dh).movedim(1, 0)
            c = all_to_all(send, tp_group).permute(1, 2, 0, 3, 4).reshape(
                B, S // tp, tp * Kl, dh)
        out.append(c)
    return AttnCache(*out)


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
    *,
    window: Optional[int] = None,
    ctx: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, object]:
    """One decode step; returns (out (B, 1, D), the updated cache).

    Windowed layers use a ring buffer (slot = t mod S): every live entry
    is inside the window by construction, so only warmup masking is
    needed.  Raises when the cache is not on x's device.  With the serving
    steps' ``ctx`` on a TP axis of more than one rank
    (:meth:`ShardCtx.serving_tp`), the weights are this rank's TP shards
    and the cache its block (module docstring); ``window`` then sizes the
    whole ring.  Otherwise the cache is whole and no collective runs.
    """
    B = x.shape[0]
    quant = isinstance(cache, QuantAttnCache)
    held = cache.k_q if quant else cache.k
    if held.device != x.device:
        raise ValueError(
            f"decode on {x.device} but the KV cache is on {held.device}"
        )
    S = rows = held.shape[1]
    first, block, group = 0, None, None
    if ctx is not None and ctx.serving_tp():
        H_eff, Kv = _eff_heads(cfg)
        tp_group = ctx.group(ctx.tp_axis)
        group = ctx.tp_group(p["wq"].shape[1], H_eff)
        if group is None:  # head_dim mode, or heads TP does not split
            p = gather_whole(p, attn_defs(cfg), ctx)
        S = min(ctx.cache_len, window) if window else ctx.cache_len
        block = ctx.tp_block(S)
        first, n = block if block is not None else (0, S)
        if rows != n:
            raise ValueError(f"a cache of {rows} rows where this rank holds "
                             f"{n} of {S}")
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)  # (B, 1, H/Kv, dh): the rank's heads
    if group is not None:  # every q head, every kv head of the new token
        q = all_gather(q, tp_group, 2)
        if k.shape[2] < Kv:
            k, v = (all_gather(y, tp_group, 2) for y in (k, v))
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    # ring slot (global layers have S == seq_len so slot == t), written by
    # the rank whose block holds it
    slot = t % S - first
    if 0 <= slot < rows:
        _write_row(cache, slot, k[:, 0], v[:, 0])
    # Valid entries: slots <= t (warmup) or everything once t >= S, as
    # many as fall in this rank's block.  The kernel masks by `lengths`
    # over the slot axis; ring order does not matter for the softmax since
    # all live entries are in-window.
    live = min(max(min(t + 1, S) - first, 0), rows)
    lengths = torch.full((B,), live, dtype=torch.int32, device=x.device)
    kw = dict(attn_softcap=cfg.attn_softcap, scale=cfg.query_scale,
              return_lse=block is not None)
    if quant:
        o = quant_decode_attention(q[:, 0], cache, lengths, **kw)
    else:
        o = decode_attention(q[:, 0], cache.k, cache.v, lengths, **kw)
    if block is not None:
        o = combine_partials(*o, tp_group)
    if quant:  # the whole attention rounds once, after the blocks combine
        o = o.to(torch.bfloat16)
    o = o.to(x.dtype)
    if group is None:
        return _out_proj(p, o)[:, None, :], cache
    Hl = p["wq"].shape[1]
    h0 = ctx.local_rank(ctx.tp_axis) * Hl
    out = _out_proj(p, o[:, h0:h0 + Hl])[:, None, :]
    return reduce_from_tp(out, group), cache


def _write_row(cache, slot: int, k: torch.Tensor, v: torch.Tensor):
    """Write one token's k/v (B, Kv, dh) at ``slot`` of ``cache`` (int8
    with its scales for a :class:`QuantAttnCache`)."""
    if isinstance(cache, QuantAttnCache):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache.k_q[:, slot] = kq
        cache.v_q[:, slot] = vq
        cache.k_s[:, slot] = ks.to(cache.k_s.dtype)
        cache.v_s[:, slot] = vs.to(cache.v_s.dtype)
    else:
        cache.k[:, slot] = k
        cache.v[:, slot] = v

