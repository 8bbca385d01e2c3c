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
f32) about 5 GFLOP of causal products against some 54 MB of traffic, so
the memory rate (see the source's note for how far this simple design is
from it).

Contract: f32 inputs ``x (BC, Q, H, P)``, ``dt`` and ``dA_cs (BC, Q, H)``,
``Bm`` and ``Cm (BC, Q, H, N)``; outputs f32 ``y_diag (BC, Q, H, P)`` and
``states (BC, H, P, N)``.  The kernel takes any ``Q`` from 1 to 256, any
``H``, and ``P``, ``N`` in {16, 32, 64, 128}; it raises ``ValueError`` on
anything else.  Entries above the diagonal are never exponentiated.  The
sums run in a fixed order with no float atomics, so the same inputs give
the same bytes every time.  :func:`ssd_chunk_fwd` launches the kernel for
CUDA tensors and takes the plain version, :func:`ssd_chunk_torch`, only
for CPU tensors.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_chunk_fwd", "ssd_chunk_torch", "launches"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
#: the longest chunk the kernel takes, and the head and state widths.
MAX_Q = 256
WIDTHS = (16, 32, 64, 128)
_count_lock = threading.Lock()
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_chunk_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 15
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = lib.ssd_chunk_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = (fn, err)
    return _entry


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


def ssd_chunk_fwd(
    x: torch.Tensor,  # (BC, Q, H, P) chunked inputs (batch*chunks flattened)
    dt: torch.Tensor,  # (BC, Q, H) post-softplus
    dA_cs: torch.Tensor,  # (BC, Q, H) within-chunk cumsum of dt*A
    Bm: torch.Tensor,  # (BC, Q, H, N), a head stride of 0 allowed
    Cm: torch.Tensor,  # (BC, Q, H, N), a head stride of 0 allowed
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y_diag (BC, Q, H, P), chunk states (BC, H, P, N)), f32."""
    global launches
    _check(x, dt, dA_cs, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_chunk_torch(x, dt, dA_cs, Bm, Cm)
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
    if x.device.type != "cuda":
        raise ValueError(f"SSD on unsupported device {x.device}")
    y = torch.empty(BC, Q, H, P, dtype=torch.float32, device=x.device)
    S = torch.empty(BC, H, P, N, dtype=torch.float32, device=x.device)
    if BC == 0 or H == 0:
        return y, S
    fn, err_str = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), dt.data_ptr(), dA_cs.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), S.data_ptr(),
            *x.stride()[:3], *dt.stride(), *dA_cs.stride(),
            *Bm.stride()[:3], *Cm.stride()[:3],
            BC, Q, H, P, N, stream,
        )
    if err:
        raise RuntimeError(f"ssd_chunk launch failed: {err_str(err).decode()}")
    with _count_lock:
        launches += 1
    return y, S
