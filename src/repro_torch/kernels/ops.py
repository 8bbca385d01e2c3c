"""Public wrappers for the port's CUDA kernels.

The wrappers run the kernel for tensors on the card and the plain
version for tensors on the CPU (see each kernel's module).  Every
Pallas kernel of the reference package has its counterpart here: the
shuffle histogram, both attention kernels and the SSD chunk.  Unlike the
reference's wrappers, the attention entry points take GQA as it comes
(k/v with ``Kv`` heads) and read the caches in place, and the SSD entry
point reads B/C through their strides (a head stride of 0 for a shared
group): no repeated, transposed or broadcast copy.  It has no
``head_block``: that is a TPU tiling choice.  Flash attention and the SSD
chunk have backward kernels and differentiate under autograd; decode and
the histogram raise there (``_build.forward_only``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import forward_only
from repro_torch.kernels.bucket_histogram import bucket_histogram
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention_bwd import FlashAttention
from repro_torch.kernels.ssd_scan import ssd_chunk_fwd
from repro_torch.kernels.ssd_scan_bwd import SSDChunk, head_view

__all__ = [
    "flash_attention",
    "decode_attention",
    "ssd_chunk",
    "shuffle_histogram",
    "partition_counts",
]


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, dh)
    k: torch.Tensor,  # (B, Tk, Kv, dh)
    v: torch.Tensor,  # (B, Tk, Kv, dv)
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Batched GQA flash attention -> (B, Tq, H, dv); differentiable
    through the backward kernel when an input requires grad."""
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, softcap, window)
    return _flash(q, k, v, causal=causal, scale=scale, softcap=softcap,
                  window=window)


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k_cache: torch.Tensor,  # (B, S, Kv, dh)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    return_lse: bool = False,
):
    """Single-token GQA attention over a KV cache -> (B, H, dh); with
    ``return_lse`` also each (row, head)'s f32 log-sum-exp, (B, H)."""
    forward_only("decode_attention", q, k_cache, v_cache)
    return _decode(q, k_cache, v_cache, lengths, scale=scale, softcap=softcap,
                   return_lse=return_lse)


def ssd_chunk(
    x: torch.Tensor,  # (BC, Q, H, P)
    dt: torch.Tensor,  # (BC, Q, H)
    dA_cs: torch.Tensor,  # (BC, Q, H)
    Bm: torch.Tensor,  # (BC, Q, G, N), G dividing H; G = H is per head
    Cm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD within-chunk output and chunk states -> (y_diag (BC, Q, H, P),
    states (BC, H, P, N)), f32.  B and C come by group (head ``h`` reads
    group ``h // (H // G)``); differentiable through the backward kernel
    when an input requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, dA_cs, Bm, Cm)):
        return SSDChunk.apply(x, dt, dA_cs, Bm, Cm)
    if x.dim() != 4:
        raise ValueError(f"want x (BC, Q, H, P), got {tuple(x.shape)}")
    H = x.shape[2]
    return ssd_chunk_fwd(x, dt, dA_cs, head_view(Bm, H), head_view(Cm, H))


def shuffle_histogram(
    keys: torch.Tensor, n_buckets: int, out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    return bucket_histogram(keys, n_buckets, out_dtype=out_dtype)


def partition_counts(
    dest: torch.Tensor,  # (N,) int32 partition ids; negative = padding
    n_parts: int,
) -> torch.Tensor:
    """Per-partition pair counts for the shuffle planner: the dataflow
    engine's entry point onto :func:`bucket_histogram`.  ``n_parts`` is
    the engine's reducer count (usually 4); empty input yields zero
    counts.  (The reference pads the buckets to 128 TPU lanes; the counts
    are the same without it.)"""
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    return bucket_histogram(dest, n_parts)
