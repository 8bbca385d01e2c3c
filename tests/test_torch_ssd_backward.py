"""The SSD chunk's backward against the reference package, on the CPU.

The reference has no Pallas backward: ``jax.value_and_grad`` differentiates
the einsums of its chunked SSD, so the oracle is ``jax.vjp`` of
``repro.kernels.ref.ssd_chunk_ref`` (and of ``repro.models.ssm.
_ssd_chunked`` for the model layer).  On the CPU the wrapper takes the
kernel's plain version, ``ssd_chunk_bwd_torch``, which writes out the
backward's formulas; it is held here against that oracle and against torch
autograd of the forward's plain version, on the same seeded numpy inputs,
to relative L2 1e-5 per gradient (f32, the same sums in other orders).
The CUDA kernel (``csrc/ssd_scan_bwd.cu``) is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ops, ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd_scan_bwd import SSDChunk, ssd_chunk_bwd_torch
from repro_torch.models.ssm import _ssd_chunked

TOL = 1e-5
NAMES = ("dx", "ddt", "ddA_cs", "dB", "dC")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _inputs(seed, BC, Q, H, P, N, G, dt_scale=1.0, A=None):
    """x, dt, dA_cs, B and C by group (BC, Q, G, N), dy, dS as numpy f32;
    dA_cs the within-chunk cumulative sum of dt * A, A < 0 per head."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, Q, H, P)).astype(np.float32)
    dt = (rng.random((BC, Q, H)) * dt_scale).astype(np.float32)
    A = -rng.uniform(0.05, 0.5, H) if A is None else np.full(H, A)
    dA = np.cumsum(dt * A.astype(np.float32), axis=1).astype(np.float32)
    Bm = rng.standard_normal((BC, Q, G, N)).astype(np.float32)
    Cm = rng.standard_normal((BC, Q, G, N)).astype(np.float32)
    dy = rng.standard_normal((BC, Q, H, P)).astype(np.float32)
    dS = rng.standard_normal((BC, H, P, N)).astype(np.float32)
    return x, dt, dA, Bm, Cm, dy, dS


def _per_head(a, H):
    """B or C by group -> the per-head copy the reference takes."""
    return np.ascontiguousarray(np.repeat(a, H // a.shape[2], axis=2))


def _jax_grads(x, dt, dA, Bm, Cm, dy, dS):
    """jax.vjp of the reference's oracle over per-head copies of B and C,
    dB and dC summed back over each group's heads."""
    H, G = x.shape[2], Bm.shape[2]
    ins = [jnp.asarray(a) for a in (x, dt, dA, _per_head(Bm, H), _per_head(Cm, H))]
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *ins)
    gx, gdt, gda, gB, gC = (np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dS))))
    BC, Q, _, N = Bm.shape
    fold = lambda g: g.reshape(BC, Q, G, H // G, N).sum(3)  # noqa: E731
    return gx, gdt, gda, fold(gB), fold(gC)


def _autograd_grads(x, dt, dA, Bm, Cm, dy, dS):
    """torch autograd of the forward's plain version over the head view."""
    t = [torch.from_numpy(a).requires_grad_() for a in (x, dt, dA, Bm, Cm)]
    H = x.shape[2]
    y, S = ssd_scan.ssd_chunk_torch(*t[:3], ssd_scan_bwd.head_view(t[3], H),
                                    ssd_scan_bwd.head_view(t[4], H))
    torch.autograd.backward((y, S), (torch.from_numpy(dy), torch.from_numpy(dS)))
    return [a.grad for a in t]


@pytest.mark.parametrize("BC,Q,H,P,N,G", [
    (2, 64, 4, 16, 16, 1),     # one B/C group read by every head
    (2, 64, 4, 16, 16, 4),     # per-head B/C
    (1, 100, 6, 32, 16, 1),    # a ragged Q (no multiple of the kernel's 64)
    (2, 37, 4, 16, 32, 2),     # two groups of two heads
    (1, 1, 3, 16, 16, 1),      # a one-row chunk
    (1, 128, 2, 64, 128, 1),   # the training widths P 64, N 128
])
def test_plain_backward_matches_jax_vjp_and_autograd(BC, Q, H, P, N, G):
    arrays = _inputs(BC * 1000 + Q, BC, Q, H, P, N, G)
    got = ssd_chunk_bwd_torch(*(torch.from_numpy(a) for a in arrays))
    for want in (_jax_grads(*arrays), _autograd_grads(*arrays)):
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == tuple(w.shape) and g.dtype == torch.float32, name
            assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


def test_group_gradient_is_the_head_sum_of_a_broadcast_copy():
    """dB and dC of one group read by every head equal the sums over heads
    of the per-head gradients of the group's broadcast copy."""
    x, dt, dA, Bm, Cm, dy, dS = _inputs(7, 2, 48, 5, 16, 32, 1)
    H = x.shape[2]
    head = [torch.from_numpy(a) for a in (x, dt, dA)]
    by_group = [torch.from_numpy(a).requires_grad_() for a in (Bm, Cm)]
    copy = [torch.from_numpy(_per_head(a, H)).requires_grad_() for a in (Bm, Cm)]
    outs = (torch.from_numpy(dy), torch.from_numpy(dS))
    gB, gC = torch.autograd.grad(SSDChunk.apply(*head, *by_group), by_group, outs)
    hB, hC = torch.autograd.grad(SSDChunk.apply(*head, *copy), copy, outs)
    for g, h in ((gB, hB), (gC, hC)):
        assert g.shape == (2, 48, 1, 32) and h.shape == (2, 48, H, 32)
        assert _rel(g.numpy(), h.sum(2, keepdim=True).numpy()) <= TOL


def test_strong_decay_gradients_stay_finite_where_the_reference_s_do_not():
    """Q = 256, dt = 0.7, A = -1 (mamba2-2.7b's initial dt and A): above
    the diagonal dA_cs[q] - dA_cs[j] reaches 178, past f32's exp range.
    The reference exponentiates the whole chunk and masks after exp
    (``src/repro/models/ssm.py:99-103``; ``repro/kernels/ref.py``), so
    ``jax.vjp`` multiplies a masked zero by exp's inf there: its ddA_cs is
    non-finite.  The port masks the exponent before exp: every gradient
    finite, and equal to autograd of the forward's plain version."""
    x, dt, dA, Bm, Cm, dy, dS = _inputs(3, 1, 256, 2, 16, 16, 1, A=-1.0)
    dt[:] = 0.7
    dA = np.cumsum(dt * -1.0, axis=1).astype(np.float32)
    arrays = (x, dt, dA, Bm, Cm, dy, dS)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(dA[:, :, None] - dA[:, None])).any()
    jg = _jax_grads(*arrays)
    assert not np.isfinite(jg[2]).all()  # the reference's ddA_cs
    assert all(np.isfinite(g).all() for i, g in enumerate(jg) if i != 2)
    got = ssd_chunk_bwd_torch(*(torch.from_numpy(a) for a in arrays))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for name, g, w in zip(NAMES, got, _autograd_grads(*arrays)):
        assert _rel(g.numpy(), w) <= TOL, name
    for name, g, w in zip(NAMES, got, jg):
        if name != "ddA_cs":
            assert _rel(g.numpy(), w) <= TOL, name


def test_ops_ssd_chunk_under_autograd_takes_the_function_without_a_launch():
    arrays = _inputs(5, 2, 32, 4, 16, 16, 1)
    x = torch.from_numpy(arrays[0]).requires_grad_()
    rest = [torch.from_numpy(a) for a in arrays[1:5]]
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, S = ops.ssd_chunk(x, *rest)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward"
    torch.autograd.backward((y, S), (torch.from_numpy(arrays[5]),
                                     torch.from_numpy(arrays[6])))
    want = ssd_chunk_bwd_torch(*(torch.from_numpy(a) for a in arrays))[0]
    assert _rel(x.grad.numpy(), want.numpy()) <= 1e-6  # CPU einsums may round apart
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == before
    with torch.no_grad():  # serving: the forward alone, as before
        y2, S2 = ops.ssd_chunk(x, *rest)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


@pytest.mark.parametrize("L,Q,G", [(128, 32, 1), (37, 32, 1), (40, 16, 4)])
def test_chunked_scan_gradients_match_jax_vjp(L, Q, G):
    """The model layer's chunked scan (zero-dt padding, the chunk step,
    the inter-chunk recurrence, the off-diagonal term) under backward()
    against jax.vjp of the reference's, B and C by group; 1e-4 relative
    L2, as the layer's forward parity."""
    rng = np.random.default_rng(L + G)
    B, H, P, N = 1, 4, 16, 8
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = rng.random((B, L, H)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    gy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def jfn(x, dt, A, Bg, Cg, h0):
        rep = lambda t: jnp.repeat(t, H // G, axis=2)  # noqa: E731
        return j_ssd_chunked(x, dt, A, rep(Bg), rep(Cg), Q, h0=h0)

    ins = (x, dt, A, Bm, Cm, h0)
    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    t = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = _ssd_chunked(*t[:5], Q, h0=t[5])
    torch.autograd.backward((y, h), (torch.from_numpy(gy), torch.from_numpy(gh)))
    for a, w in zip(t, want):
        assert _rel(a.grad.numpy(), w) <= 1e-4


def _meta(a):
    return torch.empty(a.shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("bad", ["P=8", "N=256", "Q=257", "bf16", "x_stride",
                                 "G=3", "dy_shape", "mixed_devices", "dS_stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """Every case raises before a launch, in the prepared call and under
    autograd on a non-CPU tensor (a meta tensor stands in for the card):
    nothing falls back to the plain version."""
    shape = {"P=8": (1, 8, 2, 8, 16, 1), "N=256": (1, 8, 2, 16, 256, 1),
             "Q=257": (1, 257, 2, 16, 16, 1), "G=3": (1, 8, 4, 16, 16, 3)
             }.get(bad, (1, 8, 2, 16, 16, 1))
    arrays = [torch.from_numpy(a) for a in _inputs(0, *shape)]
    if bad == "bf16":
        arrays[0] = arrays[0].bfloat16()
    elif bad == "x_stride":
        arrays[0] = arrays[0].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "dy_shape":
        arrays[5] = arrays[5][:, :-1]
    elif bad == "mixed_devices":
        arrays[6] = _meta(arrays[6])
    elif bad == "dS_stride":  # rows of dS 17 floats apart: no 16-byte cp.async
        dS = arrays[6]
        arrays[6] = torch.zeros(*dS.shape[:3], dS.shape[3] + 1)[..., :-1]
    before = ssd_scan_bwd.launches
    with pytest.raises((ValueError, TypeError)):
        ssd_scan_bwd._prepare(*arrays)
    if bad not in ("dy_shape", "mixed_devices", "dS_stride"):
        meta = [_meta(a).to(a.dtype) for a in arrays[:5]]
        meta[0].requires_grad_()
        with pytest.raises((ValueError, TypeError)):
            ops.ssd_chunk(*meta)
    assert ssd_scan_bwd.launches == before


def test_prepared_call_fills_the_kernels_parameter_struct():
    x, dt, dA, Bm, Cm, dy, dS = (torch.from_numpy(a)
                                 for a in _inputs(1, 2, 100, 6, 16, 32, 1))
    Cv = Cm.transpose(0, 1).contiguous().transpose(0, 1)  # another batch stride
    call = ssd_scan_bwd._prepare(x, dt, dA, Bm, Cv, dy, dS)
    p = call.params
    assert (p.x_sb, p.x_sq, p.x_sh) == x.stride()[:3]
    assert (p.dt_sb, p.dt_sq, p.dt_sh) == dt.stride()
    assert (p.da_sb, p.da_sq, p.da_sh) == dA.stride()
    assert (p.b_sb, p.b_sq, p.b_sg) == (100 * 32, 32, 32)
    assert (p.c_sb, p.c_sq, p.c_sg) == (32, 2 * 32, 32) == Cv.stride()[:3]
    assert (p.dy_sb, p.dy_sq, p.dy_sh) == dy.stride()[:3]
    assert (p.ds_sb, p.ds_sh, p.ds_sp) == dS.stride()[:3]
    assert (p.device, p.BC, p.Q, p.H, p.G, p.P, p.N, p.qp) == (0, 2, 100, 6, 1, 16, 32, 128)
    # a block per tile pair on and below the diagonal (3 of 2 x 2), per
    # (chunk, head), and dC and dB blocks per (chunk, group, 64-row tile,
    # 64 columns of N)
    assert (p.pair_blocks, p.head_blocks, p.group_blocks) == (2 * 3, 2 * 6, 2 * 2 * 2)
    # the scratch: C.B^T and dG per group (no per-head dG), and each head's
    # 3 x 64 sums of M and dW G L per tile pair
    assert call.scratch == (2, 1, 128, 128)
    assert call.sums == (2, 6, 3, 3, 64)
    assert call.address == ctypes.addressof(p) and ctypes.sizeof(p) == 216
    # the offsets the CUDA source's static_assert holds
    assert (type(p).device.offset, type(p).pair_blocks.offset) == (168, 200)
    # N 128 at the training widths: two 64-column dB and dC blocks a tile
    wide = ssd_scan_bwd._prepare(*(torch.from_numpy(a)
                                   for a in _inputs(2, 16, 256, 80, 64, 128, 1)))
    assert (wide.params.pair_blocks, wide.params.head_blocks,
            wide.params.group_blocks) == (16 * 10, 16 * 80, 2 * 16 * 4 * 2)
    assert wide.scratch == (16, 1, 256, 256) and wide.sums == (16, 80, 10, 3, 64)


def _tf32(x):
    """Cut f32 to TF32's 10 mantissa bits (the low 13 bits cleared), as the
    kernel splits its operands."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b in 3xTF32: each operand split into a TF32 high part and the
    rest cut to TF32, lo·hi + hi·lo + hi·hi summed in f32 (lo·lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _ssd_bwd_3xtf32(x, dt, dA, Bg, Cg, dy, dS):
    """The kernel's arithmetic for one B/C group (``Bg``, ``Cg`` (BC, Q,
    N)), every product in 3xTF32: C·Bᵀ once; per head dWᵀ = x·Yᵀ, Wᵀ·Y
    and B·dSᵀ; dG summed over the heads in order; dC = dG·B and dB =
    dGᵀ·C plus the state term as one product of depth H·P."""
    BC, Q, H, P = x.shape
    G = _mm3(Cg, Bg.transpose(1, 2))  # (BC, Q, Q)
    below = torch.ones(Q, Q, dtype=torch.bool).tril()
    ex = torch.exp(dA[:, -1:] - dA)  # (BC, Q, H)
    e = ex * dt
    dx, ddt, dda = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(dt)
    dG = torch.zeros(BC, Q, Q)
    for h in range(H):
        a = dA[:, :, h]
        L = torch.exp((a[:, :, None] - a[:, None, :]).masked_fill(~below, -np.inf))
        dW = _mm3(x[:, :, h], dy[:, :, h].transpose(1, 2)).transpose(1, 2)
        dW = dW.masked_fill(~below, 0.0)  # (BC, Qq, Qj)
        GL = G * L
        W = GL * dt[:, None, :, h]
        M = dW * W
        u = _mm3(Bg, dS[:, h].transpose(1, 2))  # (BC, Q, P)
        dx[:, :, h] = _mm3(W.transpose(1, 2), dy[:, :, h]) + e[:, :, h, None] * u
        f = (x[:, :, h] * u).sum(-1)
        ddt[:, :, h] = (dW * GL).sum(1) + f * ex[:, :, h]
        fe = f * e[:, :, h]
        dda[:, :, h] = M.sum(2) - M.sum(1) - fe
        dda[:, -1, h] += fe.sum(1)
        dG += dW * L * dt[:, None, :, h]
    dC = _mm3(dG, Bg)
    xe = (x * e[..., None]).reshape(BC, Q, H * P)
    dB = _mm3(dG.transpose(1, 2), Cg) + _mm3(xe, dS.reshape(BC, H * P, -1))
    return dx, ddt, dda, dB[:, :, None], dC[:, :, None]


def test_tensor_core_backward_in_3xtf32_holds_the_chip_tolerance():
    """The kernel's design (every product in 3xTF32, dG summed over the
    heads, dB's state term one product of depth H·P), emulated in torch at
    the training widths (Q 256, P 64, N 128, one B/C group) with a few
    heads, within ``chip_smoke.py``'s SSD_BWD_TOL = 1e-4 (relative L2 per
    gradient) of the f32 plain version."""
    arrays = [torch.from_numpy(a) for a in _inputs(23, 2, 256, 3, 64, 128, 1)]
    x, dt, dA, Bm, Cm, dy, dS = arrays
    got = _ssd_bwd_3xtf32(x, dt, dA, Bm[:, :, 0], Cm[:, :, 0], dy, dS)
    want = ssd_chunk_bwd_torch(*arrays)
    for name, g, w in zip(NAMES, got, want):
        err = _rel(g.numpy(), w.numpy())
        assert err <= 1e-4, (name, err)
        assert err > 0, name  # the split is really there
