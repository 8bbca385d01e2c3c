"""Flash-decode: a CUDA kernel for Hopper.

Every decode step attends one new query token per sequence to the KV
cache.  This replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_fwd`` (the JAX models
call its XLA twin, ``layers.decode_attention``).  The reference wrapper
(``repro/kernels/ops.py::decode_attention``) transposes the whole cache to
``(B·Kv, S, dh)`` on every step; the CUDA kernel
(``csrc/decode_attention.cu``) reads the ``(B, S, Kv, dh)`` cache in place
through its strides.  At serving shapes ``B·Kv`` is 2 per conversation, so
the sequence is split across the blocks of a thread-block cluster (at
most 16): each block runs the online softmax over its slice, and the
cluster combines the partials through distributed shared memory in split
order, in the same launch.  No scratch in device memory and no float
atomics: the same inputs give the same bytes every time.  bf16 and f16
run both products on tensor cores (``mma.sync``, the GQA group of query
heads as the n = 8 side, P rounded to the input type before P·V, as the
flash kernel does); f32 runs on CUDA cores.

What bounds it: one read of q and of the first ``lengths[b]`` cache rows,
one write of the output, so the memory rate; at serving shapes (about a
megabyte per layer) the launch and a few memory round trips.  The
wrapper's host time counts in every decode step, so the checks, the plan
(:func:`_plan`, pure Python) and the packed parameter struct are prepared
once per call signature and reused, and a call allocates only its output
and queries nothing: it can be captured in a CUDA graph.

Contract: ``lengths[b]`` is the number of valid cache rows of sequence
``b``; rows at or past it never count.  ``lengths[b] == 0`` gives zeros,
as the TPU kernel does (``ref.py::decode_attention_ref`` gives the mean of
V there instead); serving never asks for it.  Any ``H % Kv == 0``, dh in
{64, 128, 256}, strided caches with the head dim contiguous; bf16/f16
need 16-byte aligned bases and strides (``ValueError`` otherwise).
:func:`decode_attention` launches the kernel for CUDA tensors and takes
the plain version, :func:`decode_attention_torch`, only for CPU tensors.
``launches`` counts the kernel's launches (one per call).

With ``return_lse`` a call also returns each (row, head)'s f32
log-sum-exp of its scores, ``(B, H)`` in natural log (``m + log l``;
``MASK_VALUE`` where ``lengths[b] == 0``), written by the same launch
where the cluster combines its partials: with it, attentions over blocks
of one sequence (a sequence-sharded cache, one block per rank) combine
into the attention over the whole (``parallel.collectives.combine_partials``).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, _report
from repro_torch.kernels._build import _raw_stream
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS, MASK_VALUE

__all__ = ["decode_attention", "decode_attention_torch", "launches"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
MAX_SPLITS = 16  #: the largest cluster (non-portable size) of one row
ALIGN = 16  # bytes: the 16-byte cp.async loads of the tensor-core route
_count_lock = threading.Lock()
_entry = None


class _Params(ctypes.Structure):
    """One call's sizes, strides, plan and options: ``Params`` in
    ``csrc/decode_attention.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "q_sb", "q_sh", "k_sb", "k_ss", "k_sh", "v_sb", "v_ss", "v_sh",
            "o_sb", "o_sh")]
        + [(n, ctypes.c_int32) for n in (
            "dtype", "device", "B", "S", "H", "Kv", "dh", "n_splits",
            "split_len", "heads", "groups")]
        + [("scale", ctypes.c_float), ("softcap", ctypes.c_float),
           ("pad_", ctypes.c_int32)]
    )


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        err = lib.decode_attention_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


def decode_attention_torch(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    return_lse: bool = False,
):
    """The plain version: one masked softmax in f32 (zeros where
    ``lengths[b] == 0``, as the kernel).  With ``return_lse`` also each
    (row, head)'s log-sum-exp, f32 ``(B, H)`` (``MASK_VALUE`` where
    ``lengths[b] == 0``)."""
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
    # normalised before the product, as the reference's softmax is
    p = torch.softmax(s, dim=-1) * live
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
    o = o.reshape(B, H, dh).to(q.dtype)
    if not return_lse:
        return o
    empty = (lengths.to(q.device) <= 0)[:, None]
    lse = torch.logsumexp(s, dim=-1).reshape(B, H).masked_fill(empty, MASK_VALUE)
    return o, lse


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


class Plan(NamedTuple):
    """How one call runs: the route, the split of the cache and the head
    groups.  The grid is ``(n_splits, B·Kv·groups)``, one cluster of
    ``n_splits`` blocks per row."""

    route: str  # "mma" (bf16/f16, tensor cores) or "f32" (CUDA cores)
    n_splits: int  # blocks of a row's cluster, 1..MAX_SPLITS
    split_len: int  # cache rows per split
    heads: int  # query heads per block (8 or 16 on "mma"; rep on "f32")
    groups: int  # head groups per kv head
    grid: Tuple[int, int]


def _plan(B: int, S: int, H: int, Kv: int, dtype: torch.dtype,
          sms: int) -> Plan:
    """Split each row's cache so that the blocks fill one wave of the
    card's ``sms`` SMs, within a cluster of at most 16, each split a whole
    number of the kernel's row steps (16 rows for mma, 32 for f32)."""
    rep = H // Kv
    if dtype == torch.float32:
        route, heads, unit = "f32", rep, 32
    else:  # the n = 8 side of the mma: one n tile, or two
        route, heads, unit = "mma", 8 if rep <= 8 else 16, 16
    groups = -(-rep // heads)
    rows = B * Kv * groups
    want = max(1, min(MAX_SPLITS, -(-sms // rows), -(-S // unit)))
    split_len = -(-S // want)
    split_len = -(-split_len // unit) * unit
    n_splits = -(-S // split_len)
    return Plan(route, n_splits, split_len, heads, groups, (n_splits, rows))


_sms: Dict[int, int] = {}


def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once per device)."""
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


class _Call(NamedTuple):
    """What a CUDA call of one signature needs besides the pointers."""

    plan: Plan
    out_shape: Tuple[int, ...]
    lse_shape: Optional[Tuple[int, ...]]  # (B, H) when asked for, else None
    params: _Params  # kept alive: the kernel reads it through `address`
    address: int


#: prepared calls by signature (shapes, strides, types, devices, options):
#: the checks, the plan and the parameter struct run once per signature,
#: not once per decode step.  Cleared when it fills.
#: Invoker threads share it without a lock, which is safe under the GIL:
#: a lookup, an insert and a clear are each atomic; two threads that miss
#: together each prepare an equal call, and the later insert wins; a call
#: taken from the dict keeps its parameter struct alive while the thread
#: holding it launches, even if another thread clears the dict meanwhile.
_calls: Dict[tuple, _Call] = {}
_CALLS_MAX = 256


def _prepare(q, k_cache, v_cache, lengths, scale: Optional[float],
             softcap: Optional[float], sms: int, return_lse: bool = False) -> _Call:
    """Check CUDA tensors, plan the call and build its parameter struct."""
    _check(q, k_cache, v_cache, lengths)
    B, H, dh = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's {HEAD_DIMS}")
    qs, ks, vs = q.stride(), k_cache.stride(), v_cache.stride()
    if qs[2] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("the head dim of q and the caches must be contiguous")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    plan = _plan(B, S, H, Kv, q.dtype, sms)
    if plan.route == "mma" and (qs[0] | qs[1] | ks[0] | ks[1] | ks[2] | vs[0]
                                | vs[1] | vs[2]) * q.element_size() % ALIGN:
        raise ValueError(
            f"the strides of q {qs} and the caches {ks}, {vs} must be "
            f"multiples of {ALIGN} bytes")
    params = _Params(
        qs[0], qs[1], *ks[:3], *vs[:3], H * dh, dh,  # a fresh contiguous output
        DTYPE_CODES[q.dtype], q.get_device() if q.is_cuda else 0, B, S, H, Kv,
        dh, plan.n_splits, plan.split_len, plan.heads, plan.groups,
        scale if scale is not None else 1.0 / math.sqrt(dh),
        softcap if softcap is not None else 0.0, 0,
    )
    return _Call(plan, (B, H, dh), (B, H) if return_lse else None, params,
                 ctypes.addressof(params))


def decode_attention(
    q: torch.Tensor,  # (B, H, dh): one token per sequence
    k_cache: torch.Tensor,  # (B, S, Kv, dh)
    v_cache: torch.Tensor,  # (B, S, Kv, dh)
    lengths: torch.Tensor,  # (B,) int32 valid cache rows
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    return_lse: bool = False,
):
    """Single-token attention over a KV cache, ``(B, H, dh)`` in q's type.
    Query head ``h`` reads kv head ``h // (H // Kv)``.  With
    ``return_lse``, ``(o, lse)``: lse each (row, head)'s f32 log-sum-exp,
    ``(B, H)`` (module docstring).  A ``FakeTensor`` q (a dry run's trace)
    gets outputs of these shapes, types and device and no launch."""
    if _report.fake(q):
        return _fake(q, k_cache, v_cache, lengths, return_lse)
    if q.is_cuda:
        # everything before the launch counts in every decode step: one
        # dict lookup on the signature, then the pointers
        key = (q.shape, k_cache.shape, v_cache.shape, lengths.shape,
               q.stride(), k_cache.stride(), v_cache.stride(), lengths.stride(),
               q.dtype, k_cache.dtype, v_cache.dtype, lengths.dtype,
               q.get_device(), k_cache.get_device(), v_cache.get_device(),
               lengths.get_device(), scale, softcap, return_lse)
        call = _calls.get(key)
        if call is None:
            call = _prepare(q, k_cache, v_cache, lengths, scale, softcap,
                            _sm_count(q.get_device()), return_lse)
            if len(_calls) >= _CALLS_MAX:
                _calls.clear()
            _calls[key] = call
        ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
        if call.plan.route == "mma" and (ptrs[0] | ptrs[1] | ptrs[2]) % ALIGN:
            raise ValueError(
                f"q and the caches need {ALIGN}-byte aligned base addresses")
        res = _launch(q, ptrs, lengths.data_ptr(), call)
        if _report.counters and math.prod(call.out_shape):
            _report.report("decode_attention", q, k_cache, v_cache, lengths)
        return res
    _check(q, k_cache, v_cache, lengths)
    if q.device.type != "cpu":
        raise ValueError(f"attention on unsupported device {q.device}")
    with _report.plain("decode_attention", q, k_cache, v_cache, lengths):
        return decode_attention_torch(q, k_cache, v_cache, lengths,
                                      scale=scale, softcap=softcap,
                                      return_lse=return_lse)


def _fake(q, k_cache, v_cache, lengths, return_lse: bool):
    """The kernel's outputs for fake inputs, reported as a call where the
    kernel would launch: no pointer, plan or launcher is touched."""
    _check(q, k_cache, v_cache, lengths)
    out = q.new_empty(q.shape)
    if out.numel():
        _report.report("decode_attention", q, k_cache, v_cache, lengths)
    if not return_lse:
        return out
    return out, torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)


def _launch(q, ptrs, lengths_ptr: int, call: _Call):
    """Launch the kernel of a prepared call: one launch, no other work on
    the device."""
    global launches
    out = q.new_empty(call.out_shape)
    lse = None
    if call.lse_shape is not None:
        lse = torch.empty(call.lse_shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out if lse is None else (out, lse)
    fn, err_str = _entry or _launcher()
    index = q.get_device()
    lse_ptr = None if lse is None else lse.data_ptr()
    if index == torch.cuda.current_device():
        err = fn(call.address, *ptrs, lengths_ptr, out.data_ptr(), lse_ptr,
                 _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(call.address, *ptrs, lengths_ptr, out.data_ptr(), lse_ptr,
                     _raw_stream(index))
    if err:
        raise RuntimeError(
            f"decode_attention launch failed: {err_str(err).decode()}"
        )
    with _count_lock:
        launches += 1
    return out if lse is None else (out, lse)
