"""The flash attention backward of the port against the reference, on the
CPU.

The reference differentiates its XLA attention twin
(``repro.models.layers.chunked_attention``) with ``jax.vjp``; the port has
a plain PyTorch version of its backward kernel
(``flash_attention_bwd_torch``, the explicit formulas from the forward's
log-sum-exp) and the autograd Function ``ops.flash_attention`` takes
under grad.  Both must give the reference's dq, dk and dv on the same
seeded f32 inputs: relative L2 error <= 1e-4 per gradient (f32 sums in
another order); MLA's q/k head dim 192 against v head dim 128 among
them.  The autograd guards of the kernels without a backward,
and the backward's route plan and TMA layout rules, are checked on
``meta`` tensors, which stand in for the card.  The tensor-core route's
rounding (Pᵀ and dSᵀ to bf16 before their products) is emulated on the
CPU and held to ``chip_smoke.py``'s bf16 limit, 2e-2 (it reads 2.4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as jchunked
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb

TOL = 1e-4  # relative L2, f32

# (B, T, H, Kv, dh, causal, softcap, window, Tk[, dv]): dv, v's head dim,
# is dh where the tuple stops at Tk
CASES = {
    "causal_rep2": (2, 40, 4, 2, 64, True, None, None, None),
    "full_rep1": (1, 33, 4, 4, 64, False, None, None, None),
    "causal_rep8": (1, 48, 8, 1, 128, True, None, None, None),
    "softcap": (1, 40, 4, 2, 64, True, 5.0, None, None),
    "window": (1, 70, 4, 2, 64, True, None, 16, None),
    "softcap_window_full": (1, 37, 2, 1, 64, False, 3.0, 9, None),
    "dh128": (1, 32, 2, 1, 128, True, None, None, None),
    "dh256": (1, 24, 2, 2, 256, True, None, None, None),
    "ragged": (1, 67, 4, 2, 64, True, None, None, None),
    "tq_lt_tk_full": (1, 20, 4, 2, 64, False, None, None, 29),
}
#: each case's seed: its place among the cases above, then MLA's
SEEDS = {case: i for i, case in enumerate(sorted(CASES))}
# MLA (deepseek-v2): q/k head dim 192 (128 "nope" + 64 rotary) against v's 128
CASES["mla"] = (1, 40, 4, 4, 192, True, None, None, None, 128)
SEEDS["mla"] = len(SEEDS)


def _inputs(case):
    B, T, H, Kv, dh, causal, cap, window, Tk, *dv = CASES[case]
    Tk = Tk or T
    dv = dv[0] if dv else dh
    rng = np.random.default_rng(SEEDS[case])
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = draw(B, T, H, dh), draw(B, Tk, Kv, dh), draw(B, Tk, Kv, dv), \
        draw(B, T, H, dv)
    return (q, k, v, do), dict(causal=causal, softcap=cap, window=window)


def _reference(q, k, v, do, kw):
    fn = lambda q_, k_, v_: jchunked(  # noqa: E731
        q_, k_, v_, causal=kw["causal"], window=kw["window"],
        attn_softcap=kw["softcap"], q_chunk=32, kv_chunk=32)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case):
    (q, k, v, do), kw = _inputs(case)
    out_ref, grads_ref = _reference(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_torch(tq, tk, tv, return_lse=True, **kw)
    assert _rel(o, out_ref) <= TOL
    grads = fb.flash_attention_bwd(tq, tk, tv, o, tdo, lse, **kw)
    for name, g, r in zip("qkv", grads, grads_ref):
        assert _rel(g, r) <= TOL, (name, _rel(g, r))


@pytest.mark.parametrize("case", ["causal_rep2", "softcap_window_full", "ragged",
                                  "mla"])
def test_autograd_function_matches_jax_vjp(case):
    (q, k, v, do), kw = _inputs(case)
    _, grads_ref = _reference(q, k, v, do, kw)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, kw["causal"], None, kw["softcap"],
                              kw["window"])
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    for name, t, r in zip("qkv", (tq, tk, tv), grads_ref):
        assert _rel(t.grad, r) <= TOL, (name, _rel(t.grad, r))


def test_lse_is_the_row_logsumexp():
    (q, k, v, _), kw = _inputs("softcap_window_full")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = fa.flash_attention_torch(tq, tk, tv, return_lse=True, **kw)
    s = np.einsum("bqhd,bchd->bhqc", q, np.repeat(k, 2, axis=2)) / np.sqrt(64)
    s = kw["softcap"] * np.tanh(s / kw["softcap"])
    pos = np.arange(q.shape[1])
    live = pos[:, None] - pos[None, :] < kw["window"]  # not causal: window only
    s = np.where(live, s, -np.inf)
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_no_grad_path_is_the_plain_kernel_call():
    (q, k, v, _), kw = _inputs("causal_rep2")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = ops.flash_attention(tq, tk, tv, True)
    assert out.grad_fn is None
    out = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), True)
    assert out.grad_fn is None


def test_backward_kernel_takes_square_head_dims_only():
    """The kernel's head dims (q/k, v): the square 64, 128 and 256 and
    MLA's (192, 128); any other pair raises."""
    for d in (64, 128, 256):
        fb._check_kernel(torch.empty(1, 4, 2, d), torch.empty(1, 4, 2, d))
    fb._check_kernel(torch.empty(1, 4, 2, 192), torch.empty(1, 4, 2, 128))
    for dqk, dv in ((128, 64), (192, 192), (32, 32)):
        with pytest.raises(ValueError, match="backward kernel takes"):
            fb._check_kernel(torch.empty(1, 4, 2, dqk), torch.empty(1, 4, 2, dv))


def _meta(*shape, grad=True):
    return torch.empty(*shape, device="meta").requires_grad_(grad)


def _bwd_meta(dtype, D, B=1, T=64, H=8, Kv=2, Dv=None):
    """q, k, v, o, do, lse of one backward call, on ``meta``; v, o and do
    of head dim ``Dv`` (default ``D``)."""
    Dv = Dv or D

    def t(*shape):
        return torch.empty(*shape, device="meta", dtype=dtype)
    return (t(B, T, H, D), t(B, T, Kv, D), t(B, T, Kv, Dv), t(B, T, H, Dv),
            t(B, T, H, Dv), torch.empty(B, H, T, device="meta"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256, 192])
def test_backward_route_plan(dtype, D):
    """bf16 and f16 take the tensor cores at head dims 64, 128 and 256 and
    MLA's (192, 128) (D 192 here: v's head dim 128); f32 the 3xTF32
    route.  The plan is pure Python: it reads shapes, strides, the dtype
    and base addresses only."""
    q, k, v, o, do, lse = _bwd_meta(dtype, D, Dv=128 if D == 192 else None)
    want = "wgmma" if dtype != torch.float32 else "tf32x3"
    assert fb._plan(q, k, v, o, do) == want
    assert fb._prepare(q, k, v, o, do, lse, True, None, None, None).route == want


def _misaligned_base(t):
    """``t``'s shape and strides, one element past an aligned base."""
    flat = torch.empty(t.numel() + 1, device="meta", dtype=t.dtype)
    return flat[1:].as_strided(t.shape, t.stride())


def _misaligned_token_stride(t):
    """``t``'s shape, its token rows 4 elements (8 bytes) apart too far."""
    B, T, H, D = t.shape
    big = torch.empty(B, T, H * D + 4, device="meta", dtype=t.dtype)
    return big.as_strided(t.shape, (T * (H * D + 4), H * D + 4, D, 1))


@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("fault", ["base", "stride"])
def test_backward_tma_layout_rules(which, fault):
    """Each of q, k, v, o and do must have a 16-byte aligned base and
    strides (TMA): the wgmma route raises, the tf32x3 route (f32, cp.async
    copies of 4 bytes where 16 do not fit) takes the same layout."""
    bad = _misaligned_base if fault == "base" else _misaligned_token_stride
    for dtype, raises in ((torch.bfloat16, True), (torch.float32, False)):
        args = list(_bwd_meta(dtype, 128))
        args[which] = bad(args[which])
        if raises:
            with pytest.raises(ValueError, match="TMA"):
                fb._prepare(*args, True, None, None, None)
        else:
            assert fb._prepare(*args, True, None, None, None).route == "tf32x3"


def test_backward_refuses_non_square_head_dims_on_the_card():
    """On the card (``meta`` here) a call is prepared for MLA's (192, 128)
    on the tensor cores, and refused for any other pair that is not
    square at 64, 128 or 256."""
    args = _bwd_meta(torch.bfloat16, 192, Dv=128)
    assert fb._prepare(*args, True, None, None, None).route == "wgmma"
    for D, Dv in ((128, 64), (192, 192), (32, 32)):
        args = _bwd_meta(torch.bfloat16, D, Dv=Dv)
        with pytest.raises(ValueError, match="backward kernel takes"):
            fb._prepare(*args, True, None, None, None)


def _tensor_core_backward(q, k, v, o, do, lse, causal):
    """The tensor-core route's arithmetic on the CPU: f32 products of the
    bf16 inputs, with Pᵀ and dSᵀ rounded to bf16 before the products that
    take them as A fragments (dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K), and the
    outputs rounded to bf16.  At q/k wider than v (MLA's (192, 128)) the
    dk/dv kernel keeps P packed in bf16 and makes dSᵀ from it, so P is
    rounded before dS there too (the dq kernel makes its dS from f32 P)."""
    B, T, H, D = q.shape
    Kv, Dv = k.shape[2], v.shape[3]
    rep = H // Kv
    scale = 1.0 / np.sqrt(D)
    qf = q.float().reshape(B, T, Kv, rep, D)
    gf = do.float().reshape(B, T, Kv, rep, Dv)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkrd,bckd->bkrqc", qf, kf) * scale
    live = fa.live_mask(T, k.shape[1], causal, None, q.device)
    p = torch.where(live, torch.exp(s - lse.reshape(B, Kv, rep, T, 1)), 0.0)
    dp = torch.einsum("bqkrd,bckd->bkrqc", gf, vf)
    delta = (gf * o.float().reshape(B, T, Kv, rep, Dv)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    # dk's dS from the packed P, where the dk/dv kernel keeps P so
    dsk16 = ((p16 * (dp - delta[..., None])).to(torch.bfloat16).float()
             if Dv < D else ds16)
    dv = torch.einsum("bkrqc,bqkrd->bckd", p16, gf)
    dk = torch.einsum("bkrqc,bqkrd->bckd", dsk16, qf) * scale
    dq = torch.einsum("bkrqc,bckd->bqkrd", ds16, kf) * scale
    return tuple(x.to(torch.bfloat16) for x in (dq.reshape(B, T, H, D), dk, dv))


@pytest.mark.parametrize("D", [128, 256, 192])
def test_tensor_core_rounding_holds_the_chip_tolerance(D):
    """Rounding Pᵀ and dSᵀ to bf16, as the tensor-core route does (from
    registers at dh 128 and at MLA's (192, 128), through shared memory at
    dh 256), keeps dq, dk and dv within ``chip_smoke.py``'s
    BWD_TOL[bfloat16] = 2e-2 (relative L2) of the f32 plain version at
    T=256, GQA rep 8 (D 192: v's head dim 128, rep 1, as MLA has)."""
    rng = np.random.default_rng(21)
    B, T, H, Kv = 1, 256, 8, 8 if D == 192 else 1
    Dv = 128 if D == 192 else D
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(torch.bfloat16)
                   for s in ((B, T, H, D), (B, T, Kv, D), (B, T, Kv, Dv), (B, T, H, Dv)))
    o, lse = fa.flash_attention_torch(q.float(), k.float(), v.float(),
                                      return_lse=True)
    o = o.to(torch.bfloat16)
    got = _tensor_core_backward(q, k, v, o, do, lse, True)
    want = fb.flash_attention_bwd_torch(q.float(), k.float(), v.float(), o.float(),
                                        do.float(), lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = _rel(g.float().numpy(), w.numpy())
        assert err <= 2e-2, (name, err)
        assert err > 0, name  # the rounding is really there


def test_kernels_without_backward_refuse_grad_on_the_card():
    q, kc, vc = _meta(1, 4, 16), _meta(1, 8, 2, 16), _meta(1, 8, 2, 16)
    lengths = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kc, vc, lengths)
    # the SSD chunk has a backward kernel now: under autograd it takes its
    # Function, which refuses a device it has no kernel for
    x, dt = _meta(1, 4, 2, 16), _meta(1, 4, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_chunk(x, dt, dt, _meta(1, 4, 1, 16), _meta(1, 4, 1, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.shuffle_histogram(_meta(8), 4)
    # the guard itself: only grad mode, requires_grad and a non-CPU device
    # together raise
    with torch.no_grad():
        _build.forward_only("x", _meta(2))
    _build.forward_only("x", _meta(2, grad=False))
    _build.forward_only("x", torch.zeros(2, requires_grad=True))
