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

:func:`_plan` routes by dtype alone:

* ``"wgmma"`` for bf16 and f16: a tensor-core kernel.  Consumer
  warpgroups of 64 query rows each (two a block for dh 64 and 128, one
  for dh 256) run ``wgmma`` for ``Q·Kᵀ`` and, with P rounded to the input
  type and kept in registers, for ``P·V``; a producer warpgroup streams
  64-key K/V tiles into a two-stage shared-memory ring with TMA.  TMA
  binds the layout: each base 16-byte aligned, the batch, token and head
  strides multiples of 16 bytes, the head dim contiguous; anything else
  raises ``ValueError`` (the path's q, k and v are contiguous projections
  and always qualify).
* ``"f32"`` for float32: the same algorithm on CUDA cores (``wgmma`` has
  no f32 inputs; TF32 would not hold the f32 tolerance).

What bounds it: ``4·Tq·Tk·dh·H`` operations (about half when causal)
against one read of q, k, v and one write of o, so at prefill shapes the
tensor cores' rate is the bound; the kernel sits above it by the latency
of one warpgroup's chain of key tiles (PERF.md has its time beside the
bound).  The wrapper's host time counts in every call, so its checks,
plan and argument list are prepared once per signature (shapes, strides,
types, devices, options) and reused.

:func:`flash_attention` launches the kernel for CUDA tensors and takes the
plain version, :func:`flash_attention_torch`, only for CPU tensors.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import _raw_stream

__all__ = ["flash_attention", "flash_attention_torch", "launches", "HEAD_DIMS"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
#: head dims the kernel is compiled for (the dense configs' 64, 128, 256).
HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MASK_VALUE = -1e30
#: query rows per block of the tensor-core route (64 per consumer
#: warpgroup), by head dim: dh 256 holds 128 f32 output accumulators a
#: thread and takes one warpgroup.
BLOCK_Q = {64: 128, 128: 128, 256: 64}
BLOCK_K = 64  #: keys per kv tile of the tensor-core route
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and strides
_count_lock = threading.Lock()
_entry = None


class _Params(ctypes.Structure):
    """One call's sizes, strides and options: ``Params`` in
    ``csrc/flash_attention.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh",
            "v_sb", "v_st", "v_sh", "o_sb", "o_st", "o_sh")]
        + [(n, ctypes.c_int32) for n in (
            "dtype", "B", "Tq", "Tk", "H", "Kv", "dh", "causal", "window",
            "block_q", "block_k")]
        + [("scale", ctypes.c_float), ("softcap", ctypes.c_float),
           ("device", ctypes.c_int32)]
    )


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 6
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


class Plan(NamedTuple):
    """How one call runs: the route, its tiles and its grid."""

    route: str  # "wgmma" (bf16/f16, tensor cores) or "f32" (CUDA cores)
    block_q: int  # query rows per block
    block_k: int  # keys per kv tile
    grid: Tuple[int, ...]  # blocks (the kernel derives the same from Tq)


def _plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The route, tiles and grid for q ``(B, Tq, H, dh)``, k/v ``(B, Tk,
    Kv, dh)``, by dtype alone; raises ``ValueError`` on a layout the
    route's kernel does not take.  Reads only shapes, strides, the dtype
    and the base addresses."""
    B, Tq, H, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's {HEAD_DIMS}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.dtype == torch.float32:
        bq = 32 if dh == 256 else 64
        return Plan("f32", bq, 32, (-(-Tq // bq), B * H))
    # TMA: 16-byte aligned bases and strides (8 elements of 2 bytes; one
    # OR tests them all, since 8 is a power of two)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % TMA_ALIGN:
        raise ValueError(
            f"q, k and v need {TMA_ALIGN}-byte aligned base addresses (TMA)")
    if (qs[0] | qs[1] | qs[2] | ks[0] | ks[1] | ks[2] | vs[0] | vs[1]
            | vs[2]) * q.element_size() % TMA_ALIGN:
        raise ValueError(
            f"the strides of q {qs}, k {ks} and v {vs} must be multiples of "
            f"{TMA_ALIGN} bytes (TMA)")
    bq = BLOCK_Q[dh]
    return Plan("wgmma", bq, BLOCK_K, (-(-Tq // bq) * B * H,))


class _Call(NamedTuple):
    """What a CUDA call of one signature (shapes, strides, types, devices,
    options) needs besides the four data pointers and the stream."""

    plan: Plan
    out_shape: Tuple[int, ...]
    params: _Params  # kept alive: the kernel reads it through `address`
    address: int


#: prepared calls by signature: the checks, the plan and the argument
#: list run once per signature, not once per call (the wrapper's host
#: time is part of every prefill layer's).  Cleared when it fills.
#: Invoker threads share it without a lock, which is safe under the GIL:
#: a lookup, an insert and a clear are each atomic; two threads that miss
#: together each prepare an equal call, and the later insert wins; a call
#: taken from the dict keeps its parameter struct alive while the thread
#: holding it launches, even if another thread clears the dict meanwhile.
_calls: Dict[tuple, _Call] = {}
_CALLS_MAX = 256


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
    if q.is_cuda:
        # everything before the launch counts in the call's latency: one
        # dict lookup on the signature, then the pointers
        key = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
               q.dtype, k.dtype, v.dtype, q.get_device(), k.get_device(),
               v.get_device(), causal, scale, softcap, window)
        call = _calls.get(key)
        if call is None:
            call = _prepare(q, k, v, causal, scale, softcap, window)
            if len(_calls) >= _CALLS_MAX:
                _calls.clear()
            _calls[key] = call
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        if call.plan.route == "wgmma" and (ptrs[0] | ptrs[1] | ptrs[2]) % TMA_ALIGN:
            _plan(q, k, v)  # raises on the misaligned base
        return _launch(q, ptrs, call)
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type != "cpu":
        raise ValueError(f"attention on unsupported device {q.device}")
    return flash_attention_torch(q, k, v, causal=causal, scale=scale,
                                 softcap=softcap, window=window)


def _prepare(q, k, v, causal: bool, scale: Optional[float],
             softcap: Optional[float], window: Optional[int]) -> _Call:
    """Check CUDA tensors, plan the call and build its argument list."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    plan = _plan(q, k, v)
    B, Tq, H, dh = q.shape
    params = _Params(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        Tq * H * dh, H * dh, dh,  # a fresh contiguous output
        DTYPE_CODES[q.dtype], B, Tq, k.shape[1], H, k.shape[2], dh,
        int(causal), window if window is not None else 0, plan.block_q,
        plan.block_k, scale if scale is not None else 1.0 / math.sqrt(dh),
        softcap if softcap is not None else 0.0, q.get_device(),
    )
    return _Call(plan, (B, Tq, H, dh), params, ctypes.addressof(params))


def _launch(q, ptrs, call: _Call) -> torch.Tensor:
    """Launch the kernel of a prepared call on q, k, v at ``ptrs``."""
    global launches
    out = q.new_empty(call.out_shape)
    if out.numel() == 0:
        return out
    fn, err_str = _entry or _launcher()
    index = q.get_device()
    if index == torch.cuda.current_device():
        err = fn(call.address, *ptrs, out.data_ptr(), _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(call.address, *ptrs, out.data_ptr(), _raw_stream(index))
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {err_str(err).decode()}"
        )
    with _count_lock:
        launches += 1
    return out
