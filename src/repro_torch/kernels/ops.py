"""Public wrappers for the port's CUDA kernels.

The wrappers run the kernel for tensors on the card and the plain
version for tensors on the CPU (see each kernel's module).  Only the
shuffle histogram is ported so far; the attention and SSD kernels of the
reference package wait for later slices (ROADMAP.md, queue B).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bucket_histogram import bucket_histogram

__all__ = ["shuffle_histogram", "partition_counts"]


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
