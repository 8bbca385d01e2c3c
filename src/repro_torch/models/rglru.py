"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of ``repro/models/rglru.py``.  Linear recurrence with input and
recurrence gates:

    r_t = sigmoid(x_t @ W_a)          (recurrence gate)
    i_t = sigmoid(x_t @ W_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as a log-depth inclusive scan over T of f32
torch ops (:func:`_linear_scan`) in the order of operations of the
reference's ``jax.lax.associative_scan``, so that the two packages round
alike.  Decode is the O(1) update, which writes the new conv window and
state into the cache it is given (the period views of the stacked body
cache), as the port's other mixers do.
The conv1d front and the gated-GeLU output (the tanh approximation, which
is ``jax.nn.gelu``'s default) mirror Griffin's recurrent block.

In the sharded train step (``ctx`` with a TP axis of more than one rank)
the block runs tensor-parallel over the LRU width ``W``, as the
parameter specs lay it out: ``wx_in`` and ``wg_in`` column-parallel,
``conv_w``, ``conv_b`` and ``lam`` this rank's channels, ``wo``
row-parallel (``reduce_from_tp``).  The gates ``wa`` and ``wi`` are cut
over their output columns, each of which reads the whole post-conv
``xb``: it is gathered over TP with ``gather_partial``, whose backward
sums the rank's partial gradient over TP.  The scan runs on the rank's
``W/tp`` channels in the same order as on one card.  No leaf is
replicated over TP, so none needs its gradient summed there.  The decode
cache's conv window and state are cut over the same channels
(``cache_pspecs``), so on a mesh prefill keeps, and decode updates, the
rank's own channels; a decode step gathers only the new post-conv row
for the gates.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.ctx import ShardCtx, gather_whole
from repro_torch.models.param import FSDP, TP, ParamDef, default_device
from repro_torch.parallel.collectives import (
    all_gather, copy_to_tp, gather_partial, reduce_from_tp)

__all__ = ["rglru_defs", "rglru_apply", "rglru_decode", "init_rglru_cache",
           "RGLRUCache"]

#: the sharpening constant c of the recurrence gate (Griffin; the
#: reference fixes it at 8 whatever ``RGLRUConfig.c`` says)
C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D = cfg.d_model
    W = _width(cfg)
    K = cfg.rglru.d_conv
    return {
        "wx_in": ParamDef((D, W), (FSDP, TP)),  # x branch
        "wg_in": ParamDef((D, W), (FSDP, TP)),  # gelu gate branch
        "conv_w": ParamDef((K, W), (None, TP)),
        "conv_b": ParamDef((W,), (TP,), init_scale=0.0),
        "wa": ParamDef((W, W), (FSDP, TP)),  # recurrence gate
        "wi": ParamDef((W, W), (FSDP, TP)),  # input gate
        "lam": ParamDef((W,), (TP,), dtype=torch.float32, init_value=0.7),
        "wo": ParamDef((W, D), (TP, FSDP)),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in f32, cast back to u's type (no
    activation).  u: (B, T, W); w: (K, W)."""
    K, T = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(K):  # K is tiny (4); unrolled taps
        out = out + up[:, i : i + T].float() * w[i].float()
    return (out + b.float()).to(u.dtype)


def _gates(p, xb: torch.Tensor, xb_all: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (f32), gated input (f32). xb: (B, T, W) post-conv; under TP
    ``xb`` is the rank's channels and ``xb_all`` every rank's, which the
    gates' column blocks read."""
    xg = xb if xb_all is None else xb_all
    r = torch.sigmoid((xg @ p["wa"]).float())
    i = torch.sigmoid((xg @ p["wi"]).float())
    a = torch.exp(-C * F.softplus(p["lam"]) * r)  # (B, T, W)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.float())
    return a, gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1.

    The reference's order of operations (``jax.lax.associative_scan``'s
    odd/even recursion) over the pairs (a, b), which compose as ``(a_l,
    b_l) then (a_r, b_r) = (a_l a_r, a_r b_l + b_r)``: compose neighbours
    (0, 1), (2, 3), ..., scan those pairs, then extend each odd prefix by
    one element to the next even position.  ``2 ceil(log2 T)`` levels of a
    few elementwise launches, O(T) work in all.  Each level builds new
    tensors and writes nothing in place: autograd keeps views of them for
    the backward pass."""
    return _odd_even(a, b)[1]


def _odd_even(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    T = a.shape[1]
    if T < 2:
        return a, b
    a_l, b_l, a_r, b_r = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _odd_even(a_l * a_r, a_r * b_l + b_r)  # prefixes 1, 3, 5, ..
    a_e, b_e = a[:, 2::2], b[:, 2::2]
    n = a_e.shape[1]  # even positions past 0: prefix 2i-1, then element 2i
    even_a = torch.cat((a[:, :1], odd_a[:, :n] * a_e), 1)
    even_b = torch.cat((b[:, :1], a_e * odd_b[:, :n] + b_e), 1)

    def interleave(even, odd):
        m = odd.shape[1]
        out = torch.stack((even[:, :m], odd), 2).flatten(1, 2)
        return torch.cat((out, even[:, m:]), 1) if even.shape[1] > m else out

    return interleave(even_a, odd_a), interleave(even_b, odd_b)


class RGLRUCache(NamedTuple):
    conv: torch.Tensor  # (B, K-1, W) last conv inputs
    h: torch.Tensor  # (B, W) f32 recurrent state


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> RGLRUCache:
    """A zero conv window and f32 state on ``device`` (default: the card)."""
    device = default_device(device)
    W = _width(cfg)
    return RGLRUCache(
        conv=torch.zeros(batch, cfg.rglru.d_conv - 1, W, dtype=dtype,
                         device=device),
        h=torch.zeros(batch, W, dtype=torch.float32, device=device),
    )


def rglru_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                collect_cache: bool = False, ctx: Optional[ShardCtx] = None):
    """Full-sequence RG-LRU (prefill) through the log-depth scan.
    x: (B, T, D).  With ``ctx`` the weights may arrive as TP shards
    (module docstring)."""
    group = None if ctx is None else ctx.tp_group(p["lam"].shape[0], _width(cfg))
    if group is None and ctx is not None and ctx.tp_size() > 1:
        p = gather_whole(p, rglru_defs(cfg), ctx)
    if group is not None:
        x = copy_to_tp(x, group)
    xb_pre = x @ p["wx_in"]
    gate = x @ p["wg_in"]
    xb = _causal_conv(xb_pre, p["conv_w"], p["conv_b"])
    a, gated = _gates(p, xb, None if group is None else gather_partial(xb, group, -1))
    h = _linear_scan(a, gated)
    y = (h * _gelu(gate.float())).to(x.dtype)
    out = y @ p["wo"]
    if group is not None:
        out = reduce_from_tp(out, group)
    if not collect_cache:
        return out
    # the reference's slice: for a prompt shorter than K-1 its start is
    # negative and counts from the end, as in the reference.  Copies, so
    # the cache holds no view of the prefill's (B, T, W) tensors.
    K = cfg.rglru.d_conv
    return out, RGLRUCache(conv=xb_pre[:, x.shape[1] - (K - 1):].clone(),
                           h=h[:, -1].clone())


def rglru_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, D)
    cache: RGLRUCache,  # written in place
    cfg: ModelConfig,
    ctx: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, RGLRUCache]:
    """One recurrent step.  Returns (out (B, 1, D), ``cache``), its conv
    window and state updated in place.  Raises when the cache is not on
    x's device.  With ``ctx`` the weights and the cache may be the rank's
    channels (module docstring)."""
    if cache.h.device != x.device or cache.conv.device != x.device:
        raise ValueError(
            f"decode on {x.device} but the RG-LRU cache is on {cache.h.device}"
        )
    group = None if ctx is None else ctx.tp_group(p["lam"].shape[0], _width(cfg))
    if group is None and ctx is not None and ctx.tp_size() > 1:
        p = gather_whole(p, rglru_defs(cfg), ctx)
    xb = x @ p["wx_in"]  # (B, 1, W)
    gate = x @ p["wg_in"]
    # hist is a new tensor, so shifting it into the cache below reads
    # nothing the copy overwrites
    hist = torch.cat([cache.conv, xb], dim=1)  # (B, K, W)
    conv = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xb1 = conv[:, None, :].to(x.dtype)  # (B, 1, W)
    a, gated = _gates(p, xb1, None if group is None else all_gather(xb1, group, 2))
    h = a[:, 0] * cache.h + gated[:, 0]  # (B, W)
    y = (h[:, None, :] * _gelu(gate.float())).to(x.dtype)
    cache.conv.copy_(hist[:, 1:])
    cache.h.copy_(h)
    out = y @ p["wo"]
    return (out if group is None else reduce_from_tp(out, group)), cache
