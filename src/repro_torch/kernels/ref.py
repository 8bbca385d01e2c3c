"""Plain oracles for the port's kernels, written independently of them.

``bucket_histogram_ref`` counts the way the TPU kernel does, as the column
sums of a one-hot ``(N, n_buckets)`` panel, so it is for test sizes only.
"""

from __future__ import annotations

import torch

__all__ = ["bucket_histogram_ref"]


def bucket_histogram_ref(
    keys: torch.Tensor, n_buckets: int, dtype: torch.dtype = torch.int32
) -> torch.Tensor:
    cols = torch.arange(n_buckets, dtype=keys.dtype, device=keys.device)
    onehot = keys.reshape(-1, 1) == cols  # negative and >= n_buckets: no hit
    return onehot.sum(dim=0).to(dtype)
