"""The flash attention backward of the port against the reference, on the
CPU.

The reference differentiates its XLA attention twin
(``repro.models.layers.chunked_attention``) with ``jax.vjp``; the port has
a plain PyTorch version of its backward kernel
(``flash_attention_bwd_torch``, the explicit formulas from the forward's
log-sum-exp) and the autograd Function ``ops.flash_attention`` takes
under grad.  Both must give the reference's dq, dk and dv on the same
seeded f32 inputs: relative L2 error <= 1e-4 per gradient (f32 sums in
another order).  The autograd guards of the kernels without a backward
are checked on ``meta`` tensors, which stand in for the card.
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

# (B, T, H, Kv, dh, causal, softcap, window, Tk)
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


def _inputs(case):
    B, T, H, Kv, dh, causal, cap, window, Tk = CASES[case]
    Tk = Tk or T
    rng = np.random.default_rng(sorted(CASES).index(case))
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = draw(B, T, H, dh), draw(B, Tk, Kv, dh), draw(B, Tk, Kv, dh), \
        draw(B, T, H, dh)
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


@pytest.mark.parametrize("case", ["causal_rep2", "softcap_window_full", "ragged"])
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
    q = torch.empty(1, 4, 2, 192)
    with pytest.raises(ValueError, match="square"):
        fb._check_kernel(q, torch.empty(1, 4, 2, 128))
    with pytest.raises(ValueError, match="square"):
        fb._check_kernel(torch.empty(1, 4, 2, 32), torch.empty(1, 4, 2, 32))
    fb._check_kernel(torch.empty(1, 4, 2, 128), torch.empty(1, 4, 2, 128))


def _meta(*shape, grad=True):
    return torch.empty(*shape, device="meta").requires_grad_(grad)


def test_kernels_without_backward_refuse_grad_on_the_card():
    q, kc, vc = _meta(1, 4, 16), _meta(1, 8, 2, 16), _meta(1, 8, 2, 16)
    lengths = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kc, vc, lengths)
    x, dt = _meta(1, 4, 2, 8), _meta(1, 4, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_chunk(x, dt, dt, _meta(1, 4, 2, 8), _meta(1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.shuffle_histogram(_meta(8), 4)
    # the guard itself: only grad mode, requires_grad and a non-CPU device
    # together raise
    with torch.no_grad():
        _build.forward_only("x", _meta(2))
    _build.forward_only("x", _meta(2, grad=False))
    _build.forward_only("x", torch.zeros(2, requires_grad=True))
