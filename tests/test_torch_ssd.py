"""The port's SSD chunk kernel against the reference package, on the CPU.

On the CPU the wrapper takes the kernel's plain version
(``ssd_chunk_torch``); these tests hold it against the reference's Pallas
kernel run in interpret mode and against both packages' ``kernels/ref.py``
oracles, on the same inputs made with numpy: the reference's sweep
(``tests/test_kernels.py``) plus a one-row chunk, a ragged chunk and a
head count that is no multiple of 8.  Tolerance 2e-3, the reference's
kernel test's (the same math summed in another order).  The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan
from repro_torch.models.ssm import _ssd_chunked

TOL = 2e-3


def _inputs(rng, BC, Q, H, P, N, decay=0.1):
    """x, dt, dA_cs, B, C as numpy f32, as the reference's sweep draws
    them (dA_cs a decreasing cumulative sum within the chunk)."""
    x = rng.standard_normal((BC, Q, H, P)).astype(np.float32)
    dt = rng.random((BC, Q, H)).astype(np.float32)
    dA = -np.cumsum(rng.random((BC, Q, H)).astype(np.float32) * decay, axis=1)
    Bm = rng.standard_normal((BC, Q, H, N)).astype(np.float32)
    Cm = rng.standard_normal((BC, Q, H, N)).astype(np.float32)
    return x, dt, dA, Bm, Cm


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("Q,H,P,N,hb", [
    (64, 16, 32, 16, 8),   # the reference's sweep
    (32, 8, 64, 32, 8),
    (128, 4, 16, 8, 4),
    (1, 8, 16, 16, 8),     # a one-row chunk
    (37, 8, 32, 16, 8),    # a ragged chunk (Q = min(chunk, L) for short prompts)
    (48, 6, 16, 16, 6),    # H = 6: no multiple of the TPU's head block
])
def test_plain_matches_reference_kernel_and_both_oracles(rng, Q, H, P, N, hb):
    arrays = _inputs(rng, 2, Q, H, P, N)
    y, S = ops.ssd_chunk(*(torch.from_numpy(a) for a in arrays))
    assert y.shape == (2, Q, H, P) and S.shape == (2, H, P, N)
    assert y.dtype == S.dtype == torch.float32
    jy, jS = jops.ssd_chunk(*(jnp.asarray(a) for a in arrays), head_block=hb,
                            interpret=True)
    ry, rS = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in arrays))
    oy, oS = ref.ssd_chunk_ref(*(torch.from_numpy(a) for a in arrays))
    for want_y, want_S in ((jy, jS), (ry, rS), (oy, oS)):
        _close(y, want_y)
        _close(S, want_S)


def test_strongly_negative_decay_stays_finite(rng):
    """dA_cs falling by up to 100 a row: exp of the upper triangle's
    differences overflows, which the plain version never takes."""
    arrays = _inputs(rng, 2, 64, 4, 16, 16, decay=100.0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(arrays[2][:, :, None, :] - arrays[2][:, None, :, :])).any()
    y, S = ops.ssd_chunk(*(torch.from_numpy(a) for a in arrays))
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    ry, rS = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in arrays))
    _close(y, ry)
    _close(S, rS)


def test_a_head_broadcast_view_gives_the_copy_s_result(rng):
    """The model hands B and C over as expand views (head stride 0)."""
    x, dt, dA, Bm, Cm = _inputs(rng, 2, 32, 6, 16, 16)
    Bg, Cg = (torch.from_numpy(a[:, :, :1]) for a in (Bm, Cm))
    view = [Bg.expand(-1, -1, 6, -1), Cg.expand(-1, -1, 6, -1)]
    assert view[0].stride(2) == 0
    args = (torch.from_numpy(x), torch.from_numpy(dt), torch.from_numpy(dA))
    y, S = ops.ssd_chunk(*args, *view)
    y2, S2 = ops.ssd_chunk(*args, *(v.contiguous() for v in view))
    assert torch.equal(y, y2) and torch.equal(S, S2)


@pytest.mark.parametrize("L,Q", [(128, 32), (37, 32)])
def test_chunked_scan_matches_reference(rng, L, Q):
    """The model layer's chunked scan, kernel step included, against the
    reference's: an even L and a ragged one, whose zero-dt padding must be
    a no-op."""
    B, H, P, N = 1, 8, 16, 8
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = rng.random((B, L, H)).astype(np.float32)
    A = -rng.random((H,)).astype(np.float32)
    Bm = rng.standard_normal((B, L, H, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, H, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jy, jh = j_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), Q,
                           h0=jnp.asarray(h0))
    y, h = _ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), Q,
                        h0=torch.from_numpy(h0))
    assert y.shape == (B, L, H, P) and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    before = ssd_scan.launches
    ops.ssd_chunk(*(torch.from_numpy(a) for a in _inputs(rng, 1, 8, 2, 16, 16)))
    assert ssd_scan.launches == before


def _meta(a):
    return torch.empty(a.shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("bad", ["P=8", "N=256", "Q=257", "bf16", "x_stride",
                                 "meta_device", "mixed_devices", "dt_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, bad):
    """A meta tensor stands in for the card: every case raises, none falls
    back to the plain version."""
    shape = {"P=8": (1, 8, 2, 8, 16), "N=256": (1, 8, 2, 16, 256),
             "Q=257": (1, 257, 2, 16, 16)}.get(bad, (1, 8, 2, 16, 16))
    arrays = [_meta(a) for a in _inputs(rng, *shape)]
    if bad == "bf16":
        arrays[0] = arrays[0].bfloat16()
    elif bad == "x_stride":
        arrays[0] = arrays[0].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "mixed_devices":
        arrays[1] = torch.zeros(arrays[1].shape)
    elif bad == "dt_shape":
        arrays[1] = arrays[1][:, :-1]
    before = ssd_scan.launches
    with pytest.raises((ValueError, TypeError)) as err:
        ops.ssd_chunk(*arrays)
    if bad == "meta_device":
        assert "unsupported device" in str(err.value)
    assert ssd_scan.launches == before


# -- the kernel's plan, its prepared call and its 3xTF32 arithmetic ------------

@pytest.mark.parametrize("BC,Q,H,P,shared,plan", [
    (4, 256, 80, 64, True, (8, 4, 240)),    # the mamba2-2.7b prefill: 4 x (4 x 10 + 20)
    (4, 256, 80, 64, False, (1, 1, 1600)),  # per-head B/C: one head a block
    (2, 37, 6, 16, True, (8, 4, 6)),        # H below a block's heads
    (2, 1, 20, 64, True, (8, 4, 2 * (3 + 5))),    # H no multiple of 8 or 4
    (2, 200, 5, 128, True, (8, 4, 2 * 2 * (4 + 2))),  # P 128: two column blocks
])
def test_plan_shares_C_B_across_the_heads_of_one_group(BC, Q, H, P, shared,
                                                       plan):
    got = ssd_scan._plan(BC, Q, H, P, shared)
    assert (got.y_heads, got.s_heads, got.blocks) == plan


def test_prepared_call_fills_the_kernels_parameter_struct(rng):
    import ctypes

    x, dt, dA, Bm, Cm = (torch.from_numpy(a) for a in _inputs(rng, 2, 40, 6, 16, 32))
    Bv, Cv = (t[:, :, :1].expand(-1, -1, 6, -1) for t in (Bm, Cm))
    call = ssd_scan._prepare(x, dt, dA, Bv, Cv)
    p = call.params
    assert (p.x_sb, p.x_sq, p.x_sh) == x.stride()[:3]
    assert (p.dt_sb, p.dt_sq, p.dt_sh) == dt.stride()
    assert (p.da_sb, p.da_sq, p.da_sh) == dA.stride()
    assert (p.b_sb, p.b_sq, p.b_sh) == (40 * 6 * 32, 6 * 32, 0)
    assert (p.c_sb, p.c_sq, p.c_sh) == Cv.stride()[:3]
    assert (p.device, p.BC, p.Q, p.H, p.P, p.N) == (0, 2, 40, 6, 16, 32)
    assert (p.y_heads, p.s_heads, p.blocks) == (8, 4, 2 * (1 + 2))
    assert call.y_shape == (2, 40, 6, 16) and call.s_shape == (2, 6, 16, 32)
    assert call.address == ctypes.addressof(p) and ctypes.sizeof(p) == 160
    per_head = ssd_scan._prepare(x, dt, dA, Bm, Cm)
    assert (per_head.params.y_heads, per_head.params.s_heads) == (1, 1)


def _tf32(x):
    """Cut f32 to TF32's 10 mantissa bits (the low 13 bits cleared), as the
    kernel splits its operands."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b in 3xTF32: each operand split into a TF32 high part and the
    rest cut to TF32; hi·hi and lo·hi + hi·lo summed in f32 apart, then
    added (as the kernel's two accumulators)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def _ssd_shared_cb_3xtf32(x, dt, dA, Bg, Cg):
    """The kernel's arithmetic for one B/C group (``Bg``, ``Cg`` (BC, Q,
    N)): C·Bᵀ once per chunk, then per head the decay and dt on and below
    the diagonal and the products with x, every product in 3xTF32."""
    BC, Q, H, P = x.shape
    cb = _mm3(Cg, Bg.transpose(1, 2))  # (BC, Q, Q), shared by every head
    below = torch.ones(Q, Q, dtype=torch.bool).tril()
    y = torch.empty(BC, Q, H, P)
    S = torch.empty(BC, H, P, Bg.shape[-1])
    for h in range(H):
        diff = dA[:, :, None, h] - dA[:, None, :, h]
        w = cb * torch.exp(diff.masked_fill(~below, -np.inf)) * dt[:, None, :, h]
        y[:, :, h] = _mm3(w, x[:, :, h])
        wj = torch.exp(dA[:, -1:, h] - dA[:, :, h]) * dt[:, :, h]
        S[:, h] = _mm3((x[:, :, h] * wj[..., None]).transpose(1, 2), Bg)
    return y, S


def test_shared_cb_in_3xtf32_stays_within_tolerance_of_reference_kernel(rng):
    """The tensor-core design (C·Bᵀ shared by the heads of the single
    B/C group, products in 3xTF32), emulated in torch at the prefill's
    widths (P 64, N 128, Q 256) with a few heads, against the reference's
    Pallas kernel in interpret mode and the plain version."""
    x, dt, dA, Bm, Cm = _inputs(rng, 2, 256, 3, 64, 128)
    Bg, Cg = Bm[:, :, 0], Cm[:, :, 0]
    y, S = _ssd_shared_cb_3xtf32(*(torch.from_numpy(a) for a in (x, dt, dA, Bg, Cg)))
    Bb, Cb = (np.ascontiguousarray(np.broadcast_to(a[:, :, None], Bm.shape))
              for a in (Bg, Cg))
    jy, jS = jops.ssd_chunk(*(jnp.asarray(a) for a in (x, dt, dA, Bb, Cb)),
                            head_block=3, interpret=True)
    _close(y, jy)
    _close(S, jS)
    view = [torch.from_numpy(a[:, :, None]).expand(-1, -1, 3, -1) for a in (Bg, Cg)]
    py, pS = ssd_scan.ssd_chunk_torch(*(torch.from_numpy(a) for a in (x, dt, dA)),
                                      *view)
    _close(y, py)
    _close(S, pS)
    # the split loses little: 3xTF32 is far inside the tolerance
    assert float((y - py).abs().max()) < 1e-3
