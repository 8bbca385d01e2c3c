"""Flash-decode: a CUDA kernel for Hopper.

Every decode step attends one new query token per sequence to the KV
cache.  This replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_fwd`` (the JAX models
call its XLA twin, ``layers.decode_attention``).  The reference wrapper
(``repro/kernels/ops.py::decode_attention``) transposes the whole cache to
``(B·Kv, S, dh)`` on every step; the CUDA kernel
(``csrc/decode_attention.cu``) reads the ``(B, S, Kv, dh)`` cache in place
through its strides.  At serving shapes ``B·Kv`` is 2 per conversation, so
the sequence is split across blocks: each block writes a partial softmax
(max, sum, unnormalised accumulator) of its slice, and a second kernel
combines the partials in split order.  No float atomics: the same inputs
give the same bytes every time.

What bounds it: one read of q and of the first ``lengths[b]`` cache rows,
one write of the output, so the memory rate; at serving shapes (about a
megabyte per layer) launch latency dominates.

Contract: ``lengths[b]`` is the number of valid cache rows of sequence
``b``; rows at or past it never count.  ``lengths[b] == 0`` gives zeros,
as the TPU kernel does (``ref.py::decode_attention_ref`` gives the mean of
V there instead); serving never asks for it.  :func:`decode_attention`
launches the kernel for CUDA tensors and takes the plain version,
:func:`decode_attention_torch`, only for CPU tensors.  ``launches`` counts
the kernel's launches (one per call: the split and combine kernels
together).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS, MASK_VALUE

__all__ = ["decode_attention", "decode_attention_torch", "launches"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
_count_lock = threading.Lock()
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 10
            + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        splits = lib.decode_attention_splits
        splits.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        splits.restype = ctypes.c_int
        err = lib.decode_attention_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, splits, err)
    return _entry


def decode_attention_torch(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """The plain version: one masked softmax in f32 (zeros where
    ``lengths[b] == 0``, as the kernel)."""
    B, H, dh = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.float().reshape(B, Kv, H // Kv, dh)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    live = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    s = s.masked_fill(~live, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * live
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, dh).to(q.dtype)


def _check(q, k_cache, v_cache, lengths) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q (B, H, dh) and k/v caches (B, S, Kv, dh), got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, H, dh = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != dh:
        raise ValueError(
            f"cache {tuple(k_cache.shape)} does not fit q {tuple(q.shape)}"
        )
    if k_cache.shape[1] < 1 or k_cache.shape[2] < 1 or H % k_cache.shape[2]:
        raise ValueError(
            f"need S >= 1 and H % Kv == 0, got cache {tuple(k_cache.shape)}"
        )
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(
            f"lengths must be ({B},) int32, got {tuple(lengths.shape)} "
            f"{lengths.dtype}"
        )
    devices = {q.device, k_cache.device, v_cache.device, lengths.device}
    if len(devices) != 1:
        raise ValueError(
            f"q, caches and lengths on different devices: {sorted(map(str, devices))}"
        )
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(
            f"q and the caches must share one of {list(DTYPE_CODES)}, got "
            f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )


def decode_attention(
    q: torch.Tensor,  # (B, H, dh): one token per sequence
    k_cache: torch.Tensor,  # (B, S, Kv, dh)
    v_cache: torch.Tensor,  # (B, S, Kv, dh)
    lengths: torch.Tensor,  # (B,) int32 valid cache rows
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a KV cache, ``(B, H, dh)`` in q's type.
    Query head ``h`` reads kv head ``h // (H // Kv)``."""
    global launches
    _check(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_torch(q, k_cache, v_cache, lengths,
                                      scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attention on unsupported device {q.device}")
    B, H, dh = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's {HEAD_DIMS}")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("the head dim of q and the caches must be contiguous")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    out = torch.empty(B, H, dh, dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    fn, splits, err_str = _launcher()
    split_len = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        n_splits = splits(B, S, Kv, ctypes.byref(split_len))
        if n_splits < 1:
            raise RuntimeError("decode_attention: cannot query the device")
        rows = n_splits * B * H
        scratch = torch.empty(rows * (dh + 2), dtype=torch.float32,
                              device=q.device)
        scale = scale if scale is not None else 1.0 / math.sqrt(dh)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + 4 * rows * dh,
            scratch.data_ptr() + 4 * rows * (dh + 1),
            q.stride(0), q.stride(1), *k_cache.stride()[:3],
            *v_cache.stride()[:3], out.stride(0), out.stride(1),
            B, S, H, Kv, dh, n_splits, split_len.value,
            scale, softcap if softcap is not None else 0.0, stream,
        )
    if err:
        raise RuntimeError(
            f"decode_attention launch failed: {err_str(err).decode()}"
        )
    with _count_lock:
        launches += 1
    return out
