"""Flash attention backward: a CUDA kernel for Hopper, and the autograd
Function that puts the forward and backward kernels under ``backward()``.

The reference trains through XLA: ``jax.value_and_grad`` differentiates
the XLA twin of its Pallas forward (``repro/models/layers.py::
chunked_attention``); no Pallas kernel has a backward.  Here the forward
is the hand-written kernel (``flash_attention.py``), which writes each
row's log-sum-exp on request, and :func:`flash_attention_bwd` computes
``dq, dk, dv`` from ``q, k, v``, the output ``o``, its gradient ``do`` and
that lse (``csrc/flash_attention_bwd.cu``): P and dS are recomputed from
the lse, never stored.  It takes the forward's options (causal or full,
``window``, ``softcap``, ``scale``) and GQA through the strides (query
head ``h`` reads kv head ``h // (H // Kv)``; dk and dv sum over the
group), head dims (q/k, v) in :data:`HEAD_DIM_PAIRS`: the square 64, 128
and 256 and MLA's (192, 128); bf16, f16 and f32, any Tq.  Anything else
raises.

:func:`_plan` picks the route, in pure Python:

* ``"wgmma"`` for bf16 and f16 at every pair of head dims: the
  products on the tensor cores, fed by TMA (at 256 the head dim is split
  between a block's two consumer warpgroups, and Pᵀ and dSᵀ pass through
  shared memory in the input type).  TMA binds the layout of q, k, v, o
  and do: each base 16-byte aligned, the batch, token and head strides
  multiples of 16 bytes, the head dim contiguous; anything else raises
  ``ValueError``.
* ``"tf32x3"`` for f32: the same algorithm in 3xTF32 on ``mma.sync``
  m16n8k8, as the forward's f32 route: each product three TF32 products
  (``lo·hi + hi·lo + hi·hi``) summed in f32.  dk/dv blocks of 64 keys
  take keys as the M dimension (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO,
  dK += dSᵀ·Q), dq blocks of 64 rows (S, dP, dQ += dS·K); Pᵀ, dSᵀ and dS
  pass from the accumulators to the next product as A fragments in key
  order, and no tile is transposed (``wgmma`` takes TF32 only with both
  operands K-major in shared memory).  Any layout with the head dim
  contiguous.

Either route is four launches a call (``rowsum(do·o)``; dk and dv per
kv tile and query head; dq per q tile; the sum over each kv head's query
heads) and deterministic (no atomics, every sum in a fixed order), so a
training run resumed from a checkpoint replays the same losses.
``launches`` counts calls that launched it (one a call).

:func:`flash_attention_bwd_torch` is the plain version, the explicit
formulas in f32: the CPU path and the yardstick on the card.
:class:`FlashAttention` saves ``q, k, v, o, lse`` in the forward; on CPU
tensors both of its directions are the plain versions.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, _report
from repro_torch.kernels._build import _raw_stream
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES,
    HEAD_DIM_PAIRS,
    TMA_ALIGN,
    flash_attention,
    live_mask,
)

__all__ = ["FlashAttention", "flash_attention_bwd", "flash_attention_bwd_torch",
           "launches"]

#: calls that launched the kernel so far (the plain CPU version does not count).
launches = 0
ROUTE_CODES = {"tf32x3": 0, "wgmma": 1}
ROW_PAD = 128  #: the kernel's per-row scratch (rowsum(do·o), lse) is padded to it
_count_lock = threading.Lock()
_entry = None


class _Params(ctypes.Structure):
    """``Params`` in ``csrc/flash_attention_bwd.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh", "v_sb", "v_st",
            "v_sh", "o_sb", "o_st", "o_sh", "g_sb", "g_st", "g_sh")]
        + [(n, ctypes.c_int32) for n in (
            "dtype", "B", "Tq", "Tk", "H", "Kv", "D", "Dv", "causal",
            "window", "route")]
        + [("scale", ctypes.c_float), ("softcap", ctypes.c_float),
           ("device", ctypes.c_int32)]
    )


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("flash_attention_bwd")
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 15
        fn.restype = ctypes.c_int
        err = lib.flash_attention_bwd_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


def flash_attention_bwd_torch(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Kv, D)
    v: torch.Tensor,  # (B, Tk, Kv, D)
    o: torch.Tensor,  # (B, Tq, H, D): the forward's output
    do: torch.Tensor,  # (B, Tq, H, D): its gradient
    lse: torch.Tensor,  # (B, H, Tq) f32: the forward's log-sum-exp
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version, in f32: ``P = exp(y - lse)`` with ``y`` the
    (softcapped) scaled scores, ``dV = Pᵀ dO``, ``dP = dO Vᵀ``, ``dY = P ∘
    (dP - D)`` with ``D = rowsum(dO ∘ O)``, times ``1 - tanh²`` under a
    softcap, ``dQ = dY K · scale``, ``dK = dYᵀ Q · scale``; dK and dV
    summed over each kv head's query heads.  Returns ``(dq, dk, dv)`` in
    the inputs' types."""
    B, Tq, H, D = q.shape
    Tk, Kv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    rep = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Tq, Kv, rep, D)
    gf = do.float().reshape(B, Tq, Kv, rep, dv_)
    kf, vf = k.float(), v.float()
    y = torch.einsum("bqkrd,bckd->bkrqc", qf, kf) * scale
    if softcap is not None:
        t = torch.tanh(y / softcap)
        y = softcap * t
    live = live_mask(Tq, Tk, causal, window, q.device)
    p = torch.exp(y - lse.float().reshape(B, Kv, rep, Tq, 1))
    p = torch.where(live, p, torch.zeros((), device=q.device))
    dv = torch.einsum("bkrqc,bqkrd->bckd", p, gf)
    dp = torch.einsum("bqkrd,bckd->bkrqc", gf, vf)
    delta = (gf * o.float().reshape(B, Tq, Kv, rep, dv_)).sum(-1)  # (B, Tq, Kv, rep)
    dy = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap is not None:
        dy = dy * (1.0 - t * t)
    dq = torch.einsum("bkrqc,bckd->bqkrd", dy, kf) * scale
    dk = torch.einsum("bkrqc,bqkrd->bckd", dy, qf) * scale
    return (dq.reshape(B, Tq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _check(q, k, v, o, do, lse) -> None:
    B, Tq, H, D = q.shape
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]
            or k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1
            or H % k.shape[2] or o.shape != (B, Tq, H, v.shape[3])
            or do.shape != o.shape):
        raise ValueError(
            f"want q (B, Tq, H, D), k (B, Tk, Kv, D), v (B, Tk, Kv, Dv) and "
            f"o, do (B, Tq, H, Dv), got q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, do "
            f"{tuple(do.shape)}")
    if tuple(lse.shape) != (B, H, Tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(B, H, Tq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    tensors = (q, k, v, o, do, lse)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v, o, do and lse must share one device")
    if len({t.dtype for t in tensors[:5]}) != 1 or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q, k, v, o and do must share one of "
                        f"{list(DTYPE_CODES)}, got {[t.dtype for t in tensors[:5]]}")
    if any(t.stride(3) != 1 for t in tensors[:5]):
        raise ValueError("the head dim of q, k, v, o and do must be contiguous")


def _plan(q, k, v, o, do) -> str:
    """The route of a call: ``"wgmma"`` for bf16 and f16 (at every pair of
    head dims the kernel is built for, :data:`HEAD_DIM_PAIRS`),
    ``"tf32x3"`` for f32; raises ``ValueError`` on bases or strides the
    ``wgmma`` route's TMA loads refuse.  Reads only strides, the dtype
    and the base addresses."""
    if q.dtype == torch.float32:
        return "tf32x3"
    tensors = (q, k, v, o, do)  # head dims contiguous: `_check`
    # 16-byte aligned bases and strides (8 elements of 2 bytes; one OR
    # tests them all, since 8 is a power of two)
    bases = 0
    strides = 0
    for t in tensors:
        bases |= t.data_ptr()
        for st in t.stride()[:3]:
            strides |= st
    if bases % TMA_ALIGN:
        raise ValueError(f"q, k, v, o and do need {TMA_ALIGN}-byte aligned base "
                         "addresses (TMA)")
    if strides * q.element_size() % TMA_ALIGN:
        raise ValueError(
            f"the strides of q, k, v, o and do "
            f"{[t.stride() for t in tensors]} must be multiples of "
            f"{TMA_ALIGN} bytes (TMA)")
    return "wgmma"


class _Call(NamedTuple):
    route: str
    params: _Params  # kept alive: the kernel reads it through `address`
    address: int


#: prepared calls by signature (shapes, strides, type, device, options).
_calls: Dict[tuple, _Call] = {}
_CALLS_MAX = 256


def _check_kernel(q, v) -> None:
    """The head dims the kernel is built for: :data:`HEAD_DIM_PAIRS`."""
    if (q.shape[3], v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(
            f"head dims (q/k, v) {(q.shape[3], v.shape[3])}: the backward "
            f"kernel takes {HEAD_DIM_PAIRS}")


def _prepare(q, k, v, o, do, lse, causal, scale, softcap, window) -> _Call:
    _check(q, k, v, o, do, lse)
    _check_kernel(q, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    route = _plan(q, k, v, o, do)
    B, Tq, H, D = q.shape
    params = _Params(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], DTYPE_CODES[q.dtype], B, Tq, k.shape[1], H,
        k.shape[2], D, v.shape[3], int(causal), window if window is not None else 0,
        ROUTE_CODES[route], scale if scale is not None else 1.0 / math.sqrt(D),
        softcap if softcap is not None else 0.0, q.get_device())
    return _Call(route, params, ctypes.addressof(params))


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`~repro_torch.kernels.flash_attention.
    flash_attention` in the inputs' type: the kernel for CUDA tensors, the
    plain version for CPU tensors, and for a ``FakeTensor`` q (a dry run's
    trace) outputs of the kernel's shapes, types and device, no launch."""
    global launches
    if _report.fake(q):
        return _fake(q, k, v, o, do, lse, causal, window)
    if not q.is_cuda:
        _check(q, k, v, o, do, lse)
        if q.device.type != "cpu":
            raise ValueError(f"attention on unsupported device {q.device}")
        with _report.plain("flash_attention_bwd", q, k, v, o, do, lse,
                           causal=causal, window=window):
            return flash_attention_bwd_torch(q, k, v, o, do, lse, causal=causal,
                                             scale=scale, softcap=softcap,
                                             window=window)
    key = (q.shape, k.shape, q.stride(), k.stride(), v.stride(), o.stride(),
           do.stride(), q.dtype, k.dtype, v.dtype, o.dtype, do.dtype,
           lse.dtype, lse.shape, lse.stride(), q.get_device(), k.get_device(),
           v.get_device(), o.get_device(), do.get_device(), lse.get_device(),
           causal, scale, softcap, window)
    call = _calls.get(key)
    if call is None:
        call = _prepare(q, k, v, o, do, lse, causal, scale, softcap, window)
        if len(_calls) >= _CALLS_MAX:
            _calls.clear()
        _calls[key] = call
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr())
    if call.route == "wgmma" and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]
                                  | ptrs[4]) % TMA_ALIGN:
        _plan(q, k, v, o, do)  # raises on the misaligned base
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dq, dk, dv = _outputs(q, k, v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = torch.empty((2, B, H, -(-Tq // ROW_PAD) * ROW_PAD), **f32)  # delta, lse2
    dk_part = torch.empty((B, H, Tk, D), **f32)
    dv_part = torch.empty((B, H, Tk, v.shape[3]), **f32)
    fn, err_str = _entry or _launcher()
    index = q.get_device()
    args = (call.address, *ptrs, lse.data_ptr(), rows[0].data_ptr(),
            rows[1].data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: {err_str(err).decode()}")
    with _count_lock:
        launches += 1
    if _report.counters:
        _report.report("flash_attention_bwd", q, k, v, o, do, lse, causal=causal,
                       window=window)
    return dq, dk, dv


def _outputs(q, k, v):
    """``(dq, dk, dv)`` uninitialised, as the kernel writes them."""
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty(k.shape, dtype=k.dtype, device=k.device),
            torch.empty(v.shape, dtype=v.dtype, device=v.device))


def _fake(q, k, v, o, do, lse, causal: bool, window: Optional[int]):
    """The kernel's outputs for fake inputs, reported as a call where the
    kernel would launch: no pointer, plan or launcher is touched."""
    _check(q, k, v, o, do, lse)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dq, dk, dv = _outputs(q, k, v)
    if dq.numel() and dk.numel():
        _report.report("flash_attention_bwd", q, k, v, o, do, lse, causal=causal,
                       window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a backward: the forward kernel with its lse, the
    backward kernel (both plain versions on CPU tensors).  Saves ``q, k,
    v, o, lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, scale: Optional[float] = None,
                softcap: Optional[float] = None, window: Optional[int] = None):
        if q.is_cuda:  # refuse before the forward what the backward cannot take
            _check_kernel(q, v)
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                 softcap=softcap, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.options = dict(causal=causal, scale=scale, softcap=softcap,
                           window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, **ctx.options)
        return dq, dk, dv, None, None, None, None
