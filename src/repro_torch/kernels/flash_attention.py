"""Flash attention forward: a CUDA kernel for Hopper.

Prefill and full-sequence forward passes attend every query token to the
keys before it.  This replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd`` (the JAX models
call its XLA twin, ``layers.chunked_attention``).  The TPU kernel takes
heads flattened to ``(B·H, T, dh)`` with GQA expanded upstream by a
``jnp.repeat`` copy of K/V; the CUDA kernel (``csrc/flash_attention.cu``)
reads q as ``(B, Tq, H, dh)`` and k/v as ``(B, Tk, Kv, dh)`` through their
strides and maps query head ``h`` to kv head ``h // (H // Kv)``, so no
copy is made.  One block owns one (batch, head, q tile) and loops over
the kv tiles with an f32 online softmax; causal blocks skip the tiles
above the diagonal.

What bounds it: ``4·Tq·Tk·dh·H`` operations (half when causal) against
one read of q, k, v and one write of o, so at prefill shapes the
operations are the bound.  This first version runs them on CUDA cores,
not on the tensor cores (PERF.md has its time beside the bound).

:func:`flash_attention` launches the kernel for CUDA tensors and takes the
plain version, :func:`flash_attention_torch`, only for CPU tensors.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_torch", "launches", "HEAD_DIMS"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
#: head dims the kernel is compiled for (the dense configs' 64, 128, 256).
HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MASK_VALUE = -1e30
_count_lock = threading.Lock()
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
            + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = lib.flash_attention_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain version: one einsum softmax in f32 over the GQA layout."""
    B, Tq, H, dh = q.shape
    Tk, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.float().reshape(B, Tq, Kv, rep, dh)
    s = torch.einsum("bqkrd,bckd->bkrqc", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        live &= q_pos >= k_pos
    if window is not None:
        live &= q_pos - k_pos < window
    p = torch.softmax(s.masked_fill(~live, MASK_VALUE), dim=-1)
    o = torch.einsum("bkrqc,bckd->bqkrd", p, v.float())
    return o.reshape(B, Tq, H, dh).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"want q (B, Tq, H, dh) and k/v (B, Tk, Kv, dh), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Tq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}"
        )
    if k.shape[1] < 1 or k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"need Tk >= 1 and H % Kv == 0, got k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(
            f"q, k, v must share one of {list(DTYPE_CODES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, dh)
    k: torch.Tensor,  # (B, Tk, Kv, dh)
    v: torch.Tensor,  # (B, Tk, Kv, dh)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention forward, ``(B, Tq, H, dh)`` in q's type.  Query position
    ``i`` sees key ``j`` when ``j <= i`` (causal) and ``i - j < window``
    (when a window is given); scores are ``softcap·tanh(q·k·scale /
    softcap)`` with ``scale`` defaulting to ``1/sqrt(dh)``."""
    global launches
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    kwargs = dict(causal=causal, scale=scale, softcap=softcap, window=window)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, **kwargs)
    if q.device.type != "cuda":
        raise ValueError(f"attention on unsupported device {q.device}")
    B, Tq, H, dh = q.shape
    Tk, Kv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    out = torch.empty(B, Tq, H, dh, dtype=q.dtype, device=q.device)
    if B == 0 or Tq == 0:
        return out
    fn, err_str = _launcher()
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], B, Tq, Tk, H, Kv, dh,
            scale, softcap if softcap is not None else 0.0, int(causal),
            window if window is not None else 0, stream,
        )
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {err_str(err).decode()}"
        )
    with _count_lock:
        launches += 1
    return out
