"""Shuffle-partition histogram: a CUDA kernel for Hopper.

The MapReduce shuffle planner (core/device_shuffle.py) needs per-bucket
counts of a key block to size its capacity buffers: the partition step of
the paper's hot phase.  This replaces the Pallas TPU kernel
``repro/kernels/bucket_histogram.py::bucket_histogram``.  The TPU kernel
sums a one-hot panel on the MXU for want of a scatter-add; the CUDA kernel
(``csrc/bucket_histogram.cu``) counts with shared-memory atomics in a
per-block histogram and flushes the non-zero bins with global atomics.

What bounds it: it reads the keys once, 4·N bytes (plus 4·n_buckets
written), with one compare and one add per key, so the memory rate is
the bound.

Contract (the reference's): negative keys are padding, keys ≥
``n_buckets`` are dropped, ``N == 0`` gives zeros, counts are exact int32.
:func:`bucket_histogram` launches the kernel for a CUDA tensor and takes
the plain version, :func:`bucket_histogram_torch`, only for a CPU tensor.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

__all__ = ["bucket_histogram", "bucket_histogram_torch", "launches"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
_count_lock = threading.Lock()
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("bucket_histogram")
        fn = lib.bucket_histogram_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        err = lib.bucket_histogram_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


def bucket_histogram_torch(
    keys: torch.Tensor, n_buckets: int, out_dtype: torch.dtype = torch.int32
) -> torch.Tensor:
    """The plain version: a masked scatter-add in int64, then a cast."""
    valid = (keys >= 0) & (keys < n_buckets)
    idx = keys[valid].long()
    counts = torch.zeros(n_buckets, dtype=torch.int64, device=keys.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts.to(out_dtype)


def bucket_histogram(
    keys: torch.Tensor,  # (N,) int32; negative = padding
    n_buckets: int,
    *,
    out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Counts per bucket, ``(n_buckets,)`` in ``out_dtype``."""
    global launches
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"N = {n} keys would overflow the int32 counts")
    if keys.device.type == "cpu":
        return bucket_histogram_torch(keys, n_buckets, out_dtype)
    if keys.device.type != "cuda":
        raise ValueError(f"keys on unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    out = torch.zeros(n_buckets, dtype=torch.int32, device=keys.device)
    if n:
        fn, err_str = _launcher()
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            err = fn(keys.data_ptr(), n, n_buckets, out.data_ptr(), stream)
        if err:
            raise RuntimeError(
                f"bucket_histogram launch failed: {err_str(err).decode()}"
            )
        with _count_lock:
            launches += 1
    return out if out_dtype == torch.int32 else out.to(out_dtype)
