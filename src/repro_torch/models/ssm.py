"""Mamba-2 SSD (state-space duality) block: chunked parallel form for
prefill, O(1) recurrent form for decode.

The port of ``repro/models/ssm.py``.  Within-chunk work (the quadratic,
attention-like term and each chunk's state) runs on the SSD kernel through
:func:`repro_torch.kernels.ops.ssd_chunk`; the inter-chunk recurrence is a
Python loop over the chunks (the reference's ``lax.scan``) and the
off-diagonal term a torch einsum, as the reference leaves both outside its
Pallas kernel.  B and C go to the kernel by group, and the single group
reaches it as an ``expand`` view over the heads, not the reference's
broadcast copy.  Under autograd the chunk step differentiates through its
backward kernel (``kernels/ssd_scan_bwd.py``), which sums each group's
gradient over its heads; ``dA_cs = cumsum(dt * A)`` and the inter-chunk
recurrence stay torch ops, which autograd differentiates.

In the sharded train step (``ctx`` with a TP axis of more than one rank
and the heads cut over it) the block runs tensor-parallel over the SSM
heads, as the parameter specs lay it out: ``wz``, ``wx`` and ``wdt``
column-parallel, ``A_log``, ``Dskip``, ``dt_bias`` and ``norm`` this
rank's heads or channels, ``wo`` row-parallel (``reduce_from_tp``).
``wB``, ``wC``, ``conv_w`` and ``conv_b`` stay whole: each rank convolves
its own ``x`` channels (its columns of ``conv_w``'s first ``d_inner``) and
all of B and C, which reach its heads by group.  The chunk kernels run on
the rank's ``H/tp`` heads.  The gated RMSNorm's mean square sums over
every rank's channels (``layers.rms_norm(tp_group=)``).  The input passes
``copy_to_tp``, so every leaf each rank uses only for its own heads has a
partial gradient there: ``wB``, ``wC``, ``conv_w`` and ``conv_b``
(:func:`tp_partial`), which the train step sums over TP.  Where TP does
not divide the heads, the cut leaves are gathered whole and the block
runs on every head on every rank.

Decode state is ``(B, H, P, N)`` f32, constant in sequence length.
:func:`ssm_decode` writes the new conv window and state into the cache it
is given (the period views of the stacked body cache), so a decode step
updates the cache in place, as attention decode does.

The serving steps on a mesh lay the cache out as the reference's
``cache_pspecs`` does: the state by heads over TP, which are the rank's
heads, and the conv window ``(B, d_conv - 1, convdim)`` in contiguous
blocks of ``convdim = d_inner + 2·G·N`` channels over TP, which are not
the channels the rank convolves (its own x channels and all of B and C).
So prefill gathers the tail's x channels over TP and keeps the rank's
block of the whole tail, and a decode step gathers the window (a few KB)
and the new row's x channels, convolves its own channels, and writes back
its block of the shifted window.  Either part is whole where TP does not
divide it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan_bwd import head_view
from repro_torch.models.config import ModelConfig
from repro_torch.models.ctx import ShardCtx, gather_whole
from repro_torch.models.layers import rms_norm
from repro_torch.models.param import FSDP, TP, ParamDef, default_device
from repro_torch.parallel.collectives import all_gather, copy_to_tp, reduce_from_tp

__all__ = ["ssm_defs", "ssm_apply", "ssm_decode", "init_ssm_cache", "SSMCache",
           "tp_partial"]


def ssm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    H = s.n_heads(D)
    G, N = s.n_groups, s.d_state
    convdim = di + 2 * G * N
    return {
        "wz": ParamDef((D, di), (FSDP, TP)),
        "wx": ParamDef((D, di), (FSDP, TP)),
        "wB": ParamDef((D, G * N), (FSDP, None)),
        "wC": ParamDef((D, G * N), (FSDP, None)),
        "wdt": ParamDef((D, H), (FSDP, TP)),
        "conv_w": ParamDef((s.d_conv, convdim), (None, None)),
        "conv_b": ParamDef((convdim,), (None,), init_scale=0.0),
        "A_log": ParamDef((H,), (TP,), dtype=torch.float32, init_value=0.0),
        "Dskip": ParamDef((H,), (TP,), dtype=torch.float32, init_value=1.0),
        "dt_bias": ParamDef((H,), (TP,), dtype=torch.float32, init_value=0.0),
        "norm": ParamDef((di,), (TP,), init_value=1.0),
        "wo": ParamDef((di, D), (TP, FSDP)),
    }


def tp_partial(cfg: ModelConfig, tp: int) -> Tuple[str, ...]:
    """The leaves replicated over a TP axis of ``tp`` ranks that each rank
    uses only for its own heads (module docstring): their gradients sum
    over TP."""
    if tp == 1 or cfg.ssm.n_heads(cfg.d_model) % tp:
        return ()
    return ("wB", "wC", "conv_w", "conv_b")


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in f32, cast back to u's type.
    u: (B, T, C); w: (K, C)."""
    K, T = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(K):  # K is tiny (4); unrolled taps
        out = out + up[:, i : i + T].float() * w[i].float()
    return F.silu(out + b.float()).to(u.dtype)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` zero rows after the sequence axis (1).  B and C are padded
    by group, before ``ops.ssd_chunk`` makes their head view, so a single
    group still reaches the kernel through a head stride of 0."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32, post-softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, L, G, N) by group, G dividing H (G = H: per head)
    Cm: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, L, H, P), final state (B, H, P, N))."""
    B_, L, H, P = x.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    Q = min(chunk, L)
    L_orig = L
    pad = (-L) % Q
    if pad:
        # Zero-dt padding is a no-op in the recurrence (decay exp(0) = 1,
        # state contribution 0); padded outputs are sliced off below.
        x, dt, Bm, Cm = (_pad_seq(t, pad) for t in (x, dt, Bm, Cm))
        L = L + pad
    nc = L // Q
    xc = x.reshape(B_ * nc, Q, H, P)
    dtc = dt.reshape(B_ * nc, Q, H)
    Bc = Bm.reshape(B_ * nc, Q, G, N)
    Cc = Cm.reshape(B_ * nc, Q, G, N)

    dA_cs = torch.cumsum(dtc * A, dim=1)  # within-chunk cumulative, negative
    y_diag, S = ops.ssd_chunk(xc, dtc, dA_cs, Bc, Cc)
    y_diag = y_diag.reshape(B_, nc, Q, H, P)
    S = S.reshape(B_, nc, H, P, N)
    dA_cs = dA_cs.reshape(B_, nc, Q, H)
    seg = dA_cs[:, :, -1]  # (B, nc, H) total decay per chunk

    # Inter-chunk recurrence: h_c = exp(seg_c) h_{c-1} + S_c, keeping the
    # state *entering* each chunk.
    h = (h0.float() if h0 is not None
         else torch.zeros(B_, H, P, N, dtype=torch.float32, device=x.device))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = torch.exp(seg[:, c])[:, :, None, None] * h + S[:, c]
    h_enter = torch.stack(h_enter, dim=1)  # (B, nc, H, P, N)

    # Off-diagonal term: y_off[i] = C_i . (exp(dA_cs[i]) h_enter)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                         head_view(Cc, H).reshape(B_, nc, Q, H, N), h_enter,
                         torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(B_, L, H, P)[:, :L_orig]
    return y, h


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, convdim) last conv inputs
    state: torch.Tensor  # (B, H, P, N) fp32 SSM state


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> SSMCache:
    """A zero conv window and f32 state on ``device`` (default: the card)."""
    device = default_device(device)
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    H = s.n_heads(D)
    convdim = di + 2 * s.n_groups * s.d_state
    return SSMCache(
        conv=torch.zeros(batch, s.d_conv - 1, convdim, dtype=dtype,
                         device=device),
        state=torch.zeros(batch, H, s.head_dim, s.d_state,
                          dtype=torch.float32, device=device),
    )


def _project(p, x, cfg):
    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt_raw = (x @ p["wdt"]).float()
    u = torch.cat([xs, Bp, Cp], dim=-1)  # conv input channels
    return z, u, dt_raw


def _split_conv(u, cfg, di: Optional[int] = None):
    """(x, B, C) of the conv channels; ``di`` x channels (default: all)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model) if di is None else di
    GN = s.n_groups * s.d_state
    return u[..., :di], u[..., di : di + GN], u[..., di + GN :]


def _group_heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., G*N) → (..., H, N) f32, each group read by its H/G heads
    through a stride-0 view (a copy only when G > 1)."""
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    G, N = s.n_groups, s.d_state
    lead = t.shape[:-1]
    t = t.float().reshape(*lead, G, 1, N).expand(*lead, G, H // G, N)
    return t.reshape(*lead, H, N)


def _rank_heads(p, cfg: ModelConfig, ctx: Optional[ShardCtx]):
    """(p, TP group or None, this rank's first head, its number of heads):
    the heads cut over TP, or every head (the cut leaves gathered whole
    where the heads do not split)."""
    H = cfg.ssm.n_heads(cfg.d_model)
    group = None if ctx is None else ctx.tp_group(p["wdt"].shape[-1], H)
    if group is None:
        if ctx is not None and ctx.tp_size() > 1:
            p = gather_whole(p, ssm_defs(cfg), ctx)
        return p, None, 0, H
    Hl = p["wdt"].shape[-1]
    return p, group, ctx.local_rank(ctx.tp_axis) * Hl, Hl


def ssm_apply(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    collect_cache: bool = False, ctx: Optional[ShardCtx] = None,
):
    """Full-sequence SSD (prefill). x: (B, T, D).  With ``ctx`` the
    weights may arrive as TP shards (module docstring)."""
    s = cfg.ssm
    B_, T, D = x.shape
    H = s.n_heads(D)
    P = s.head_dim
    G, N = s.n_groups, s.d_state
    p, group, h0, Hl = _rank_heads(p, cfg, ctx)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if group is not None:
        x = copy_to_tp(x, group)
        cols = _rank_cols(cfg, h0, Hl)
        conv_w, conv_b = cols(conv_w), cols(conv_b)
    z, u_pre, dt_raw = _project(p, x, cfg)
    u = _causal_conv(u_pre, conv_w, conv_b)
    xs, Bp, Cp = _split_conv(u, cfg, Hl * P)
    xh = xs.reshape(B_, T, Hl, P)
    Bm = Bp.float().reshape(B_, T, G, N)
    Cm = Cp.float().reshape(B_, T, G, N)
    hpg = H // G  # heads per group
    Gl = max(1, Hl // hpg)
    if Gl < G:  # the groups this rank's heads read
        Bm, Cm = (t.narrow(2, h0 // hpg, Gl) for t in (Bm, Cm))
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_final = _ssd_chunked(xh.float(), dt, A, Bm, Cm, s.chunk)
    y = y + p["Dskip"][None, None, :, None] * xh.float()
    y = y.reshape(B_, T, Hl * P).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], tp_group=group)
    out = y @ p["wo"]
    if group is not None:
        out = reduce_from_tp(out, group)
    if not collect_cache:
        return out
    # conv state = raw (pre-conv) inputs of the last K-1 positions
    conv_tail = u_pre[:, T - (s.d_conv - 1):]
    if ctx is not None and ctx.serving_tp():
        conv_tail = _conv_block(_whole_cols(conv_tail, Hl * P, group), cfg, ctx)
    return out, SSMCache(conv=conv_tail, state=h_final)


def _rank_cols(cfg: ModelConfig, h0: int, Hl: int):
    """A function from the conv channels' last dim (``convdim``) to the
    rank's own: the x channels of heads ``h0 .. h0 + Hl``, then all B/C."""
    P, di = cfg.ssm.head_dim, cfg.ssm.d_inner(cfg.d_model)
    return lambda t: torch.cat((t[..., h0 * P:(h0 + Hl) * P], t[..., di:]), dim=-1)


def _whole_cols(u: torch.Tensor, n_x: int, group) -> torch.Tensor:
    """Conv channels in the rank's layout (its ``n_x`` x channels, then
    B/C) -> every channel, the x channels gathered over the TP ``group``
    (None: ``u`` holds them all already)."""
    if group is None:
        return u
    xs = all_gather(u[..., :n_x], group, u.dim() - 1)
    return torch.cat((xs, u[..., n_x:]), dim=-1)


def _conv_block(window: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    """The rank's block of a whole conv window, as ``cache_pspecs`` cuts
    its channels (whole where TP does not divide them), a new tensor."""
    block = ctx.tp_block(window.shape[-1])
    if block is None:
        return window.clone(memory_format=torch.contiguous_format)
    return window.narrow(-1, *block).clone(memory_format=torch.contiguous_format)


def ssm_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, D)
    cache: SSMCache,  # written in place
    cfg: ModelConfig,
    ctx: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, SSMCache]:
    """One recurrent step: h' = exp(dt·A) h + dt·(B ⊗ x); y = C·h' + D·x.
    Returns (out (B, 1, D), ``cache``), its conv window and state updated
    in place.  Raises when the cache is not on x's device.  With the
    serving steps' ``ctx`` on a TP axis of more than one rank
    (:meth:`ShardCtx.serving_tp`) the weights are its TP shards and the
    cache its blocks (module docstring)."""
    if cache.state.device != x.device or cache.conv.device != x.device:
        raise ValueError(
            f"decode on {x.device} but the SSM cache is on {cache.state.device}"
        )
    s = cfg.ssm
    B_ = x.shape[0]
    P = s.head_dim
    p, group, h0, Hl = _rank_heads(p, cfg, ctx)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    window, block = cache.conv, None
    if ctx is not None and ctx.serving_tp():
        block = ctx.tp_block(s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state)
        if block is not None:  # the whole (B, K-1, convdim) window
            window = all_gather(window, ctx.group(ctx.tp_axis), 2)
    z, u, dt_raw = _project(p, x, cfg)  # u: (B, 1, the rank's conv channels)
    # conv over (cached last K-1 inputs, current); hist is a new tensor, so
    # shifting it into the cache below reads nothing the copy overwrites
    hist = torch.cat([window, _whole_cols(u, Hl * P, group)], dim=1)  # (B, K, convdim)
    mine = hist
    if group is not None:
        cols = _rank_cols(cfg, h0, Hl)
        mine, conv_w, conv_b = cols(hist), cols(conv_w), cols(conv_b)
    conv_out = torch.einsum("bkc,kc->bc", mine.float(), conv_w.float()) + conv_b.float()
    uc = F.silu(conv_out)[:, None, :].to(x.dtype)
    xs, Bp, Cp = _split_conv(uc, cfg, Hl * P)
    xh = xs.reshape(B_, Hl, P).float()
    Bm, Cm = (_group_heads(t[:, 0], cfg).narrow(1, h0, Hl) for t in (Bp, Cp))
    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"])  # (B, Hl)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)  # (B, Hl)
    h = dA[:, :, None, None] * cache.state + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, Bm, xh
    )
    y = torch.einsum("bhn,bhpn->bhp", Cm, h) + p["Dskip"][None, :, None] * xh
    y = y.reshape(B_, 1, Hl * P).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], tp_group=group)
    cache.conv.copy_(hist[:, 1:] if block is None else hist[:, 1:].narrow(-1, *block))
    cache.state.copy_(h)
    out = y @ p["wo"]
    return (out if group is None else reduce_from_tp(out, group)), cache
