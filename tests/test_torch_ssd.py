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
