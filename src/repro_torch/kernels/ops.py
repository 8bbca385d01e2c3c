"""Public wrappers for the port's CUDA kernels.

The wrappers run the kernel for tensors on the card and the plain
version for tensors on the CPU (see each kernel's module).  The shuffle
histogram and both attention kernels are ported; the SSD kernel of the
reference package waits for a later slice (ROADMAP.md, queue B).  Unlike
the reference's wrappers, the attention entry points take GQA as it comes
(k/v with ``Kv`` heads) and read the caches in place: no repeated or
transposed copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bucket_histogram import bucket_histogram
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash

__all__ = [
    "flash_attention",
    "decode_attention",
    "shuffle_histogram",
    "partition_counts",
]


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, dh)
    k: torch.Tensor,  # (B, Tk, Kv, dh)
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Batched GQA flash attention -> (B, Tq, H, dh)."""
    return _flash(q, k, v, causal=causal, scale=scale, softcap=softcap,
                  window=window)


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k_cache: torch.Tensor,  # (B, S, Kv, dh)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token GQA attention over a KV cache -> (B, H, dh)."""
    return _decode(q, k_cache, v_cache, lengths, scale=scale, softcap=softcap)


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
