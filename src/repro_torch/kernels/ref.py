"""Plain oracles for the port's kernels, written independently of them.

``bucket_histogram_ref`` counts the way the TPU kernel does, as the column
sums of a one-hot ``(N, n_buckets)`` panel, so it is for test sizes only.
The attention and SSD oracles are the reference package's
``kernels/ref.py`` contracts, in its layouts (heads flattened for
attention, ``(BC, Q, H, ·)`` for SSD) and in f32: the same math with no
tiling (``decode_attention_ref`` gives the mean of V where
``lengths[b] == 0``, as the reference's oracle does).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "bucket_histogram_ref",
    "flash_attention_ref",
    "decode_attention_ref",
    "ssd_chunk_ref",
]


def bucket_histogram_ref(
    keys: torch.Tensor, n_buckets: int, dtype: torch.dtype = torch.int32
) -> torch.Tensor:
    cols = torch.arange(n_buckets, dtype=keys.dtype, device=keys.device)
    onehot = keys.reshape(-1, 1) == cols  # negative and >= n_buckets: no hit
    return onehot.sum(dim=0).to(dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (BH, Tq, dh)
    k: torch.Tensor,  # (BH, Tk, dh)
    v: torch.Tensor,  # (BH, Tk, dv): -> (BH, Tq, dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    Tq, dh = q.shape[1], q.shape[2]
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        mask = torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :]
        s = s.masked_fill(~mask.to(s.device)[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, dh)
    k_cache: torch.Tensor,  # (B, S, dh)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    dh = q.shape[2]
    S = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhd,bsd->bhs", q.float(), k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.arange(S, device=s.device)[None, None, :] < lengths[:, None, None]
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsd->bhd", p, v_cache.float()).to(q.dtype)


def ssd_chunk_ref(x, dt, dA_cs, Bm, Cm):
    """(BC,Q,H,P),(BC,Q,H),(BC,Q,H),(BC,Q,H,N)x2 -> (y_diag, states).

    The decay is taken for every (q, j) and masked after ``exp``, as the
    reference's oracle does: entries above the diagonal may overflow to
    ``inf`` and are then replaced by 0."""
    xf, dtf, da, Bf, Cf = (t.float() for t in (x, dt, dA_cs, Bm, Cm))
    Q = x.shape[1]
    decay = torch.exp(da[:, :, None, :] - da[:, None, :, :])  # (BC,Qi,Qj,H)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay = torch.where(tril[None, :, :, None], decay, torch.zeros_like(decay))
    cb = torch.einsum("bqhn,bjhn->bqjh", Cf, Bf)
    y = torch.einsum("bqjh,bjh,bjhp->bqhp", cb * decay, dtf, xf)
    seg = da[:, -1]  # (BC, H)
    sdecay = torch.exp(seg[:, None, :] - da) * dtf  # (BC, Q, H)
    S = torch.einsum("bjh,bjhn,bjhp->bhpn", sdecay, Bf, xf)
    return y, S
