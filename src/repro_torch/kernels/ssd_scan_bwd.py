"""Mamba-2 SSD within-chunk step, backward: a CUDA kernel for Hopper, and
the autograd Function that puts the forward and backward kernels under
``backward()``.

The reference trains Mamba-2 through XLA: ``jax.value_and_grad``
differentiates the einsums of ``repro/models/ssm.py::_ssd_chunked``; its
Pallas SSD kernel has no backward and sits on no model path.  Here the
forward is the hand-written kernel (``ssd_scan.py``) and
:func:`ssd_chunk_bwd` computes ``dx, ddt, ddA_cs, dB, dC`` from the
forward's inputs and the gradients ``dy`` of ``y_diag`` and ``dS`` of the
chunk states (``csrc/ssd_scan_bwd.cu``; its header note gives the
formulas).  ``dA_cs = cumsum(dt * A)`` stays a torch op in the model, so
autograd carries ``ddA_cs`` on to ``dt`` and ``A_log``.

B and C come by group, ``(BC, Q, G, N)`` with G dividing H (head ``h``
reads group ``h // (H // G)``; G = H is per head): :class:`SSDChunk` makes
the forward's head view itself (for mamba2-2.7b's single group an
``expand`` view with head stride 0) and returns per-group ``dB`` and
``dC``, summed over each group's heads inside the kernel.

The decay's exponent is taken only on and below the diagonal, in the
kernel and in the plain version alike: the reference exponentiates the
whole chunk and masks afterwards (``repro/models/ssm.py:99-103``), which
overflows above the diagonal at a long chunk and a strong decay and makes
its ``ddA_cs`` non-finite.

The kernel runs every product on the tensor cores in 3xTF32, as the
forward does, and keeps dG on chip: one launch sums dG over each group's
heads in head order beside C·Bᵀ (and, per head, M = dW∘W and dW∘G∘L
summed over each tile's rows and keys), one computes the per-head dx,
ddt and ddA_cs, and one dB and dC, whose state term Σ_h (e_h∘x_h)·dS_h
runs as one product over the group's heads.  Its scratch is C·Bᵀ and dG,
``(BC, G, Qp, Qp)`` each (Qp = Q rounded up to 64), and those sums, 3 ×
64 floats per (chunk, head, tile pair).

Contract: f32 ``x (BC, Q, H, P)``, ``dt`` and ``dA_cs (BC, Q, H)``, ``B``
and ``C (BC, Q, G, N)``, ``dy (BC, Q, H, P)``, ``dS (BC, H, P, N)``, the
last dim of x, B, C, dy and dS contiguous, their bases and strides
16-byte aligned; the outputs take the inputs' shapes, contiguous.  The
kernel takes Q from 1 to 256 and P, N in {16, 32, 64, 128}, as the
forward does, and raises ``ValueError`` on anything else.  Three launches
a call, no float atomics, every sum in a fixed order: the same inputs
give the same bytes.  :func:`ssd_chunk_bwd`
launches the kernel for CUDA tensors and takes the plain version,
:func:`ssd_chunk_bwd_torch` (the formulas written out, not autograd of the
forward), only for CPU tensors.  ``launches`` counts calls that launched
it (one a call).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, _report
from repro_torch.kernels._build import _raw_stream
from repro_torch.kernels.ssd_scan import ALIGN, MAX_Q, WIDTHS, ssd_chunk_fwd

__all__ = ["SSDChunk", "head_view", "ssd_chunk_bwd", "ssd_chunk_bwd_torch",
           "launches"]

#: calls that launched the kernel so far (the plain CPU version does not count).
launches = 0
TILE = 64  #: rows of the kernel's q and key tiles; its scratch pads Q to it
N_BLOCK = 64  #: most columns of N one dB or dC block of the kernel takes
_count_lock = threading.Lock()
_entry = None


class _Params(ctypes.Structure):
    """One call's sizes, strides and grids: ``Params`` in
    ``csrc/ssd_scan_bwd.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in (
            "x_sb", "x_sq", "x_sh", "dt_sb", "dt_sq", "dt_sh",
            "da_sb", "da_sq", "da_sh", "b_sb", "b_sq", "b_sg",
            "c_sb", "c_sq", "c_sg", "dy_sb", "dy_sq", "dy_sh",
            "ds_sb", "ds_sh", "ds_sp")]
        + [(n, ctypes.c_int32) for n in (
            "device", "BC", "Q", "H", "G", "P", "N", "qp",
            "pair_blocks", "head_blocks", "group_blocks", "pad_")]
    )


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("ssd_scan_bwd")
        fn = lib.ssd_chunk_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 17
        fn.restype = ctypes.c_int
        err = lib.ssd_chunk_bwd_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


def head_view(t: torch.Tensor, H: int) -> torch.Tensor:
    """``(BC, Q, G, N)`` B or C by group → ``(BC, Q, H, N)`` per head, head
    ``h`` reading group ``h // (H // G)``: the tensor itself when G = H, an
    ``expand`` view with head stride 0 when G = 1, else a copy (as it is
    when G does not divide H: the kernels' checks refuse it)."""
    G = t.shape[2]
    if G == H or H % G:
        return t
    if G == 1:
        return t.expand(-1, -1, H, -1)
    BC, Q, _, N = t.shape
    return t[:, :, :, None].expand(BC, Q, G, H // G, N).reshape(BC, Q, H, N)


def ssd_chunk_bwd_torch(
    x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, dS: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """The plain version, in f32: the backward's formulas written out
    (``csrc/ssd_scan_bwd.cu``), the decay's exponent masked to ``-inf``
    above the diagonal before ``exp``.  B and C by group; returns ``(dx,
    ddt, ddA_cs, dB, dC)``, dB and dC per group."""
    x, dt, da, Bf, Cf, Y, Sg = (t.float() for t in (x, dt, dA_cs, Bm, Cm, dy, dS))
    BC, Q, H, P = x.shape
    G, N = Bf.shape[2], Bf.shape[3]
    rep = H // G
    above = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    diff = (da[:, :, None, :] - da[:, None, :, :]).permute(0, 3, 1, 2)
    L = torch.exp(diff.masked_fill(above, float("-inf")))  # (BC, H, Qq, Qj)
    Gm = torch.einsum("bqgn,bjgn->bgqj", Cf, Bf).repeat_interleave(rep, 1)
    dtj = dt.permute(0, 2, 1)[:, :, None, :]  # (BC, H, 1, Qj)
    GL = Gm * L
    W = GL * dtj
    dW = torch.einsum("bqhp,bjhp->bhqj", Y, x).masked_fill(above, 0.0)
    M = dW * W
    ex = torch.exp(da[:, -1:, :] - da)  # (BC, Q, H): exp(s - a_j)
    e = ex * dt
    Bh = Bf.repeat_interleave(rep, 2)  # (BC, Q, H, N)
    u = torch.einsum("bjhn,bhpn->bjhp", Bh, Sg)  # B . dS^T
    dx = torch.einsum("bhqj,bqhp->bjhp", W, Y) + e[..., None] * u
    f = (x * u).sum(-1)  # (BC, Q, H)
    ddt = (dW * GL).sum(2).permute(0, 2, 1) + f * ex
    fe = f * e
    dda = M.sum(3).permute(0, 2, 1) - M.sum(2).permute(0, 2, 1) - fe
    dda[:, -1] += fe.sum(1)
    dG = (dW * L * dtj).reshape(BC, G, rep, Q, Q).sum(2)  # (BC, G, Qq, Qj)
    dC = torch.einsum("bgqj,bjgn->bqgn", dG, Bf)
    v = torch.einsum("bjhp,bhpn->bjhn", x * e[..., None], Sg)  # e o (x . dS)
    dB = torch.einsum("bgqj,bqgn->bjgn", dG, Cf) + v.reshape(BC, Q, G, rep, N).sum(3)
    return dx, ddt, dda, dB, dC


def _check_inputs(x, dt, dA_cs, Bm, Cm) -> None:
    """Shapes and devices of the forward's inputs, B and C by group."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4:
        raise ValueError(
            f"want x (BC, Q, H, P), dt/dA_cs (BC, Q, H), B/C (BC, Q, G, N); "
            f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(Bm.shape)}")
    BC, Q, H, P = x.shape
    G = Bm.shape[2]
    if dt.shape != (BC, Q, H) or dA_cs.shape != (BC, Q, H):
        raise ValueError(f"dt {tuple(dt.shape)} and dA_cs {tuple(dA_cs.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if (Bm.shape[:2] != (BC, Q) or G < 1 or H % G or Cm.shape != Bm.shape):
        raise ValueError(f"B {tuple(Bm.shape)} and C {tuple(Cm.shape)} must be "
                         f"(BC, Q, G, N) with G dividing H = {H}")
    tensors = (x, dt, dA_cs, Bm, Cm)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the SSD inputs must share one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")


def _check_kernel(x, dt, dA_cs, Bm, Cm) -> None:
    """What the kernel takes beyond the shapes: Q, P, N, f32, contiguous
    last dims."""
    BC, Q, H, P = x.shape
    N = Bm.shape[3]
    if (not 1 <= Q <= MAX_Q or P not in WIDTHS or N not in WIDTHS
            or BC * H >= 2 ** 31):
        raise ValueError(
            f"the SSD backward kernel takes 1 <= Q <= {MAX_Q}, P and N in "
            f"{WIDTHS}, BC * H below 2^31; got BC={BC}, Q={Q}, H={H}, P={P}, "
            f"N={N}")
    tensors = (x, dt, dA_cs, Bm, Cm)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the SSD backward kernel takes f32 inputs, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("the last dim of x, B, C, dy and dS must be contiguous")


def _check(x, dt, dA_cs, Bm, Cm, dy, dS) -> None:
    _check_inputs(x, dt, dA_cs, Bm, Cm)
    BC, Q, H, P = x.shape
    N = Bm.shape[3]
    if dy.shape != x.shape or dS.shape != (BC, H, P, N):
        raise ValueError(f"dy {tuple(dy.shape)} and dS {tuple(dS.shape)} do not "
                         f"fit x {tuple(x.shape)} and N = {N}")
    if dy.device != x.device or dS.device != x.device:
        raise ValueError("the SSD backward's inputs must share one device")


class _Call(NamedTuple):
    """What a CUDA call of one signature needs besides the pointers."""

    params: _Params  # kept alive: the kernel reads it through `address`
    address: int
    scratch: Tuple[int, ...]  # the shape of gs and of dg, (BC, G, Qp, Qp)
    sums: Tuple[int, ...]  # of ms, (BC, H, tile pairs, 3, 64)


#: prepared calls by signature (shapes, strides, types, devices).
_calls: Dict[tuple, _Call] = {}
_CALLS_MAX = 256


def _prepare(x, dt, dA_cs, Bm, Cm, dy, dS) -> _Call:
    """Check CUDA tensors against the kernel's contract and build its
    parameter struct."""
    _check(x, dt, dA_cs, Bm, Cm, dy, dS)
    _check_kernel(x, dt, dA_cs, Bm, Cm)
    if dy.dtype != torch.float32 or dS.dtype != torch.float32:
        raise TypeError(f"dy and dS must be f32, got {dy.dtype}, {dS.dtype}")
    if dy.stride(-1) != 1 or dS.stride(-1) != 1:
        raise ValueError("the last dim of x, B, C, dy and dS must be contiguous")
    strides = [*x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3],
               *dy.stride()[:3], *dS.stride()[:3]]
    if any(s_ * 4 % ALIGN for s_ in strides):
        raise ValueError(f"the strides of x, B, C, dy and dS {strides} must be "
                         f"multiples of {ALIGN} bytes")
    BC, Q, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nt = -(-Q // TILE)
    qp = nt * TILE
    n_chunks = max(1, N // N_BLOCK)
    params = _Params(
        *x.stride()[:3], *dt.stride(), *dA_cs.stride(), *Bm.stride()[:3],
        *Cm.stride()[:3], *dy.stride()[:3], *dS.stride()[:3],
        x.get_device() if x.is_cuda else 0, BC, Q, H, G, P, N, qp,
        BC * G * nt * (nt + 1) // 2, BC * H, 2 * BC * G * nt * n_chunks, 0)
    return _Call(params, ctypes.addressof(params), (BC, G, qp, qp),
                 (BC, H, nt * (nt + 1) // 2, 3, TILE))


def ssd_chunk_bwd(
    x: torch.Tensor,  # (BC, Q, H, P)
    dt: torch.Tensor,  # (BC, Q, H)
    dA_cs: torch.Tensor,  # (BC, Q, H)
    Bm: torch.Tensor,  # (BC, Q, G, N), by group
    Cm: torch.Tensor,  # (BC, Q, G, N)
    dy: torch.Tensor,  # (BC, Q, H, P): the gradient of y_diag
    dS: torch.Tensor,  # (BC, H, P, N): the gradient of the chunk states
) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, ddA_cs, dB, dC)`` of :func:`~repro_torch.kernels.ssd_scan.
    ssd_chunk_fwd` with B and C by group, f32: the kernel for CUDA tensors,
    the plain version for CPU tensors, and for a ``FakeTensor`` x (a dry
    run's trace) outputs of the kernel's shapes, no launch."""
    global launches
    args = (x, dt, dA_cs, Bm, Cm, dy, dS)
    if _report.fake(x):
        _check(*args)
        outs = _outputs(x, dt, dA_cs, Bm, Cm)
        if x.numel() and Bm.numel():
            _report.report("ssd_chunk_bwd", *args)
        return outs
    if not x.is_cuda:
        _check(*args)
        if x.device.type != "cpu":
            raise ValueError(f"SSD backward on unsupported device {x.device}")
        with _report.plain("ssd_chunk_bwd", *args):
            return ssd_chunk_bwd_torch(*args)
    key = tuple((t.shape, t.stride(), t.dtype, t.get_device()) for t in args)
    call = _calls.get(key)
    if call is None:
        call = _prepare(*args)
        if len(_calls) >= _CALLS_MAX:
            _calls.clear()
        _calls[key] = call
    outs = _outputs(x, dt, dA_cs, Bm, Cm)
    if x.numel() == 0 or Bm.numel() == 0:
        return tuple(o.zero_() for o in outs)
    ptrs = [t.data_ptr() for t in args]
    if (ptrs[0] | ptrs[3] | ptrs[4] | ptrs[5] | ptrs[6]) % ALIGN:
        raise ValueError(
            f"x, B, C, dy and dS need {ALIGN}-byte aligned base addresses")
    gs, dg = (torch.empty(call.scratch, dtype=torch.float32, device=x.device)
              for _ in range(2))
    ms = torch.empty(call.sums, dtype=torch.float32, device=x.device)
    fn, err_str = _entry or _launcher()
    index = x.get_device()
    ptrs += [t.data_ptr() for t in (*outs, gs, dg, ms)]
    if index == torch.cuda.current_device():
        err = fn(call.address, *ptrs, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(call.address, *ptrs, _raw_stream(index))
    if err:
        raise RuntimeError(f"ssd_chunk_bwd launch failed: {err_str(err).decode()}")
    with _count_lock:
        launches += 1
    if _report.counters:
        _report.report("ssd_chunk_bwd", *args)
    return tuple(outs)


def _outputs(*inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One uninitialised f32 gradient of each input's shape."""
    return tuple(torch.empty(t.shape, dtype=torch.float32, device=t.device)
                 for t in inputs)


class SSDChunk(torch.autograd.Function):
    """The SSD chunk step with a backward: the forward kernel over the head
    view of B and C by group, the backward kernel (both plain versions on
    CPU tensors).  Saves ``x, dt, dA_cs, B, C``."""

    @staticmethod
    def forward(ctx, x, dt, dA_cs, Bm, Cm):
        _check_inputs(x, dt, dA_cs, Bm, Cm)
        H = x.shape[2]
        if x.device.type != "cpu":  # refuse what the backward kernel cannot take
            _check_kernel(x, dt, dA_cs, Bm, Cm)
        y, S = ssd_chunk_fwd(x, dt, dA_cs, head_view(Bm, H), head_view(Cm, H))
        ctx.save_for_backward(x, dt, dA_cs, Bm, Cm)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, dA_cs, Bm, Cm = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dS.stride(-1) != 1:
            dS = dS.contiguous()
        return ssd_chunk_bwd(x, dt, dA_cs, Bm, Cm, dy, dS)
