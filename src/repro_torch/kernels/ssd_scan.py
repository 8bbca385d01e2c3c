"""Mamba-2 SSD within-chunk step: a CUDA kernel for Hopper.

Every Mamba-2 prefill runs it once per layer.  For one chunk of ``Q``
positions and one head it computes

    y_diag[q] = sum_{j<=q} (C_q . B_j) exp(dA_cs[q] - dA_cs[j]) dt_j x_j
    S[p, n]   = sum_j exp(dA_cs[Q-1] - dA_cs[j]) dt_j x_j[p] B_j[n]

the quadratic, attention-like part of SSD and the chunk's contribution to
the recurrent state.  This replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_chunk_fwd``; the inter-chunk recurrence
stays in torch ops (``models/ssm.py``), as it stays in ``lax.scan`` there.
The kernel (``csrc/ssd_scan.cu``) reads every input through its strides,
so the single B/C group of the model is read with a head stride of 0 (an
``expand`` view) instead of the reference's 80-fold broadcast copy.

What bounds it: at the prefill's shape (BC=4, Q=256, H=80, P=64, N=128,
f32) about 2.7 GFLOP of causal products once C·Bᵀ is shared across the
80 heads of the single B/C group, against some 54 MB of traffic, so the
memory rate.  The kernel shares C·Bᵀ across the heads that read the same
B and C (head stride 0), runs every product on the tensor cores in
3xTF32 (f32 operands split into TF32 high and low parts, three products
summed in f32): C·Bᵀ on ``mma.sync``, the y and state products on
``wgmma``, one warpgroup a head.  The wrapper's host time counts in
every prefill layer, so its checks, plan (:func:`_plan`, pure Python)
and packed parameter struct are prepared once per call signature.

Contract: f32 inputs ``x (BC, Q, H, P)``, ``dt`` and ``dA_cs (BC, Q, H)``,
``Bm`` and ``Cm (BC, Q, H, N)``; outputs f32 ``y_diag (BC, Q, H, P)`` and
``states (BC, H, P, N)``.  The kernel takes any ``Q`` from 1 to 256, any
``H``, and ``P``, ``N`` in {16, 32, 64, 128}, with 16-byte aligned bases
and strides and the last dim of x, B and C contiguous; it raises
``ValueError`` on anything else.  Entries above the diagonal are never exponentiated.  The
sums run in a fixed order with no float atomics, so the same inputs give
the same bytes every time.  :func:`ssd_chunk_fwd` launches the kernel for
CUDA tensors and takes the plain version, :func:`ssd_chunk_torch`, only
for CPU tensors.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, _report
from repro_torch.kernels._build import _raw_stream

__all__ = ["ssd_chunk_fwd", "ssd_chunk_torch", "launches"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
#: the longest chunk the kernel takes, and the head and state widths.
MAX_Q = 256
WIDTHS = (16, 32, 64, 128)
TILE = 64  #: rows of a q tile
#: heads of a y block and of a state block that share one B/C (head
#: stride 0); with per-head B/C every block takes one head.
Y_HEADS, S_HEADS = 8, 4
ALIGN = 16  # bytes: the kernel's 16-byte cp.async loads
_count_lock = threading.Lock()
_entry = None


class _Params(ctypes.Structure):
    """One call's sizes, strides and plan: ``Params`` in
    ``csrc/ssd_scan.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "x_sb", "x_sq", "x_sh", "dt_sb", "dt_sq", "dt_sh",
            "da_sb", "da_sq", "da_sh", "b_sb", "b_sq", "b_sh",
            "c_sb", "c_sq", "c_sh")]
        + [(n, ctypes.c_int32) for n in (
            "device", "BC", "Q", "H", "P", "N", "y_heads", "s_heads",
            "blocks", "pad_")]
    )


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_chunk_launch
        fn.argtypes = [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
        err = lib.ssd_chunk_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


class Plan(NamedTuple):
    """How one call runs: heads per y block and per state block, and the
    grid (one dimension: y blocks for each 64-row q tile, state blocks)."""

    shared: bool  # B and C both have head stride 0: C·Bᵀ computed once a set
    y_heads: int
    s_heads: int
    blocks: int


def _plan(BC: int, Q: int, H: int, P: int, shared: bool) -> Plan:
    """Heads per block and the grid for a ``(BC, Q, H, P)`` call: per
    chunk and 64 columns of P, one y block per 64-row q tile and head set,
    one state block per head set."""
    y_heads, s_heads = (Y_HEADS, S_HEADS) if shared else (1, 1)
    n_qt = -(-Q // TILE)
    blocks = (BC * (P // min(P, TILE))
              * (n_qt * -(-H // y_heads) + -(-H // s_heads)))
    return Plan(shared, y_heads, s_heads, blocks)


def ssd_chunk_torch(
    x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in f32: the decay's exponent is masked to
    ``-inf`` above the diagonal before ``exp``, then two batched products
    per head."""
    x, dt, da, Bf, Cf = (t.float() for t in (x, dt, dA_cs, Bm, Cm))
    Q = x.shape[1]
    above = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    diff = (da[:, :, None, :] - da[:, None, :, :]).permute(0, 3, 1, 2)
    decay = torch.exp(diff.masked_fill(above, float("-inf")))  # (BC,H,Qi,Qj)
    cb = torch.einsum("bqhn,bjhn->bhqj", Cf, Bf)
    w = cb * decay * dt.permute(0, 2, 1)[:, :, None, :]
    y = torch.einsum("bhqj,bjhp->bqhp", w, x)
    sdecay = torch.exp(da[:, -1:, :] - da) * dt  # (BC, Q, H)
    S = torch.einsum("bjhp,bjhn->bhpn", x * sdecay[..., None], Bf)
    return y, S


def _check(x, dt, dA_cs, Bm, Cm) -> None:
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4:
        raise ValueError(
            f"want x (BC, Q, H, P), dt/dA_cs (BC, Q, H), B/C (BC, Q, H, N); "
            f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(Bm.shape)}"
        )
    BC, Q, H, _ = x.shape
    N = Bm.shape[-1]
    if dt.shape != (BC, Q, H) or dA_cs.shape != (BC, Q, H):
        raise ValueError(
            f"dt {tuple(dt.shape)} and dA_cs {tuple(dA_cs.shape)} do not fit "
            f"x {tuple(x.shape)}"
        )
    if Bm.shape != (BC, Q, H, N) or Cm.shape != (BC, Q, H, N):
        raise ValueError(
            f"B {tuple(Bm.shape)} and C {tuple(Cm.shape)} do not fit "
            f"x {tuple(x.shape)}"
        )
    devices = {t.device for t in (x, dt, dA_cs, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(
            f"SSD inputs on different devices: {sorted(map(str, devices))}"
        )


class _Call(NamedTuple):
    """What a CUDA call of one signature needs besides the pointers."""

    plan: Plan
    y_shape: Tuple[int, ...]
    s_shape: Tuple[int, ...]
    params: _Params  # kept alive: the kernel reads it through `address`
    address: int


#: prepared calls by signature (shapes, strides, types, devices).
_calls: Dict[tuple, _Call] = {}
_CALLS_MAX = 256


def _prepare(x, dt, dA_cs, Bm, Cm) -> _Call:
    """Check CUDA tensors, plan the call and build its parameter struct."""
    _check(x, dt, dA_cs, Bm, Cm)
    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    if (not 1 <= Q <= MAX_Q or P not in WIDTHS or N not in WIDTHS
            or BC > 65535 or H > 65535):
        raise ValueError(
            f"the SSD kernel takes 1 <= Q <= {MAX_Q}, P and N in {WIDTHS}, "
            f"BC and H up to 65535; got BC={BC}, Q={Q}, H={H}, P={P}, N={N}"
        )
    if any(t.dtype != torch.float32 for t in (x, dt, dA_cs, Bm, Cm)):
        raise TypeError(
            "the SSD kernel takes f32 inputs, got "
            f"{[str(t.dtype) for t in (x, dt, dA_cs, Bm, Cm)]}"
        )
    if x.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1:
        raise ValueError("the last dim of x, B and C must be contiguous")
    strides = [*x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3]]
    if any(s_ * 4 % ALIGN for s_ in strides):
        raise ValueError(
            f"the strides of x, B and C {strides} must be multiples of "
            f"{ALIGN} bytes")
    plan = _plan(BC, Q, H, P, Bm.stride(2) == 0 and Cm.stride(2) == 0)
    params = _Params(
        *x.stride()[:3], *dt.stride(), *dA_cs.stride(), *Bm.stride()[:3],
        *Cm.stride()[:3], x.get_device() if x.is_cuda else 0, BC, Q, H, P, N,
        plan.y_heads,
        plan.s_heads, plan.blocks, 0,
    )
    return _Call(plan, (BC, Q, H, P), (BC, H, P, N), params,
                 ctypes.addressof(params))


def ssd_chunk_fwd(
    x: torch.Tensor,  # (BC, Q, H, P) chunked inputs (batch*chunks flattened)
    dt: torch.Tensor,  # (BC, Q, H) post-softplus
    dA_cs: torch.Tensor,  # (BC, Q, H) within-chunk cumsum of dt*A
    Bm: torch.Tensor,  # (BC, Q, H, N), a head stride of 0 allowed
    Cm: torch.Tensor,  # (BC, Q, H, N), a head stride of 0 allowed
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y_diag (BC, Q, H, P), chunk states (BC, H, P, N)), f32.  A
    ``FakeTensor`` x (a dry run's trace) gets outputs of these shapes, no
    launch."""
    global launches
    if _report.fake(x):
        return _fake(x, dt, dA_cs, Bm, Cm)
    if not x.is_cuda:
        _check(x, dt, dA_cs, Bm, Cm)
        if x.device.type != "cpu":
            raise ValueError(f"SSD on unsupported device {x.device}")
        with _report.plain("ssd_chunk", x, dt, dA_cs, Bm, Cm):
            return ssd_chunk_torch(x, dt, dA_cs, Bm, Cm)
    args = (x, dt, dA_cs, Bm, Cm)
    key = tuple((t.shape, t.stride(), t.dtype, t.get_device()) for t in args)
    call = _calls.get(key)
    if call is None:
        call = _prepare(*args)
        if len(_calls) >= _CALLS_MAX:
            _calls.clear()
        _calls[key] = call
    ptrs = [t.data_ptr() for t in args]
    if (ptrs[0] | ptrs[3] | ptrs[4]) % ALIGN:
        raise ValueError(
            f"x, B and C need {ALIGN}-byte aligned base addresses")
    y = x.new_empty(call.y_shape)
    S = x.new_empty(call.s_shape)
    if y.numel() == 0 or S.numel() == 0:
        return y, S
    fn, err_str = _entry or _launcher()
    index = x.get_device()
    if index == torch.cuda.current_device():
        err = fn(call.address, *ptrs, y.data_ptr(), S.data_ptr(),
                 _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(call.address, *ptrs, y.data_ptr(), S.data_ptr(),
                     _raw_stream(index))
    if err:
        raise RuntimeError(f"ssd_chunk launch failed: {err_str(err).decode()}")
    with _count_lock:
        launches += 1
    if _report.counters:
        _report.report("ssd_chunk", x, dt, dA_cs, Bm, Cm)
    return y, S


def _fake(x, dt, dA_cs, Bm, Cm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's outputs for fake inputs, reported as a call where the
    kernel would launch: no pointer, plan or launcher is touched."""
    _check(x, dt, dA_cs, Bm, Cm)
    BC, Q, H, P = x.shape
    y = x.new_empty((BC, Q, H, P))
    S = x.new_empty((BC, H, P, Bm.shape[-1]))
    if y.numel() and S.numel():
        _report.report("ssd_chunk", x, dt, dA_cs, Bm, Cm)
    return y, S
