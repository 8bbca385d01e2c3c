"""The port's RG-LRU block against the reference package, on the CPU.

Parameters are drawn by the reference (``init_params`` under a JAX key),
cast to f32 and carried across; inputs come from numpy.  The port's
prefill scan runs the order of ``jax.lax.associative_scan`` (and matches
it bit for bit), but the gates' exp, sigmoid and tanh round apart in the
last bits between the two frameworks, so outputs and caches are held to
1e-4 (relative and absolute, f32), as the port's other parity tests are.
Decode is held step by step, its cache written in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import model_defs as jmodel_defs
from repro.models import reduced_for_smoke as jreduced
from repro.models import rglru as jrglru
from repro_torch.configs import get_config
from repro_torch.models import (
    RGLRUCache,
    from_jax_params,
    init_params,
    model_defs,
    reduced_for_smoke,
    rglru,
)
from repro_torch.models.convert import to_tensor

ARCH = "recurrentgemma-9b"
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_for_smoke(get_config(ARCH))
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jinit_params(jrglru.rglru_defs(jcfg), jax.random.PRNGKey(1)))
    # a conv bias and spread-out decay rates, so every term of the layer
    # is exercised (the init gives a zero bias and one lam for all)
    rng = np.random.default_rng(5)
    jp["conv_b"] = jnp.asarray(rng.standard_normal(jp["conv_b"].shape), jnp.float32)
    jp["lam"] = jnp.asarray(rng.uniform(-2, 3, jp["lam"].shape), jnp.float32)
    p = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("T", [1, 2, 3, 16, 37])
def test_rglru_apply_and_cache_match_reference(layer, T):
    """Prefill output and cache, prompts shorter than d_conv - 1 included
    (the conv window then keeps what the reference's slice keeps)."""
    jcfg, cfg, jp, p = layer
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jout, jc = jrglru.rglru_apply(jp, jnp.asarray(x), jcfg, collect_cache=True)
    out, c = rglru.rglru_apply(p, torch.from_numpy(x), cfg, collect_cache=True)
    _close(out, jout)
    assert isinstance(c, RGLRUCache)
    assert tuple(c.conv.shape) == jc.conv.shape and tuple(c.h.shape) == jc.h.shape
    assert c.h.dtype == torch.float32
    _close(c.conv, jc.conv)
    _close(c.h, jc.h)
    assert torch.equal(rglru.rglru_apply(p, torch.from_numpy(x), cfg), out)


def test_rglru_decode_steps_match_reference_in_place(layer):
    """Prefill 16 tokens, then recurrent steps that write the conv window
    and state into the cache they are given."""
    jcfg, cfg, jp, p = layer
    x = np.random.default_rng(0).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    _, jc = jrglru.rglru_apply(jp, jnp.asarray(x[:, :16]), jcfg, collect_cache=True)
    _, c = rglru.rglru_apply(p, torch.from_numpy(x[:, :16]), cfg, collect_cache=True)
    for t in range(16, 21):
        jo, jc = jrglru.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        conv, h = c
        o, c = rglru.rglru_decode(p, torch.from_numpy(x[:, t:t + 1]), c, cfg)
        assert c.conv is conv and c.h is h
        _close(o, jo)
        _close(c.conv, jc.conv)
        _close(c.h, jc.h)


@pytest.mark.parametrize("T", [1, 2, 5, 8, 33, 64])
def test_linear_scan_is_the_recurrence(T):
    """The log-depth scan gives every h_t of the sequential recurrence."""
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0, 1, (2, T, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, T, 3)).astype(np.float32))
    a0, b0 = a.clone(), b.clone()
    h = rglru._linear_scan(a, b)
    assert torch.equal(a, a0) and torch.equal(b, b0)  # inputs untouched
    want, acc = [], torch.zeros(2, 3)
    for t in range(T):
        acc = a[:, t] * acc + b[:, t]
        want.append(acc)
    np.testing.assert_allclose(h.numpy(), torch.stack(want, 1).numpy(),
                               atol=1e-6, rtol=1e-5)


def test_decode_refuses_a_cache_on_another_device(layer):
    _, cfg, _, p = layer
    cache = rglru.init_rglru_cache(cfg, 1, torch.float32, device="cpu")
    x = torch.empty((1, 1, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="RG-LRU cache is on cpu"):
        rglru.rglru_decode(p, x, cache, cfg)


def test_lam_stays_f32_under_a_weight_dtype(layer):
    """``lam`` is an f32 leaf (init 0.7) in both packages; asking for bf16
    weights casts the weights, not it."""
    jcfg, cfg, _, _ = layer
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                     dtype=torch.bfloat16)
    mixer = tp["body"][0]["mixer"]
    assert mixer["lam"].dtype == torch.float32 and bool((mixer["lam"] == 0.7).all())
    assert mixer["wa"].dtype == torch.bfloat16
    jp = jax.tree_util.tree_map(np.asarray, jinit_params(jmodel_defs(jcfg),
                                                         jax.random.PRNGKey(0)))
    assert jp["body"][0]["mixer"]["lam"].dtype == np.float32
    conv = from_jax_params(jp, cfg, "cpu", dtype=torch.float16)
    assert conv["body"][0]["mixer"]["lam"].dtype == torch.float32
    assert conv["body"][0]["mixer"]["wa"].dtype == torch.float16
    assert conv["body"][0]["mixer"]["lam"].numpy().tobytes() == \
        jp["body"][0]["mixer"]["lam"].tobytes()


def _jax_scan(a, b):
    """The reference's prefill scan (``repro/models/rglru.py::rglru_apply``):
    ``jax.lax.associative_scan`` over the pairs (a, b)."""
    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, a_r * b_l + b_r

    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("T", [1, 2, 7, 8, 64, 100])
def test_linear_scan_rounds_as_the_reference(T):
    """The port's scan runs the reference's odd/even order of f32 products
    and sums, so it gives the reference's associative scan (run op by op)
    bit for bit."""
    rng = np.random.default_rng(T + 1)
    a = rng.uniform(0, 1, (2, T, 5)).astype(np.float32)
    b = rng.standard_normal((2, T, 5)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(_jax_scan(jnp.asarray(a), jnp.asarray(b)))
    got = rglru._linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("T", [1, 2, 7, 64, 100])
def test_linear_scan_gradients_match_jax_vjp(T):
    """``backward()`` through the scan against ``jax.vjp`` of the
    reference's associative scan, on the same seeded a, b and cotangent.
    f32; the two scans sum in different orders: relative L2 <= 1e-5."""
    rng = np.random.default_rng(100 + T)
    a = rng.uniform(0.5, 1.0, (2, T, 6)).astype(np.float32)
    b = rng.standard_normal((2, T, 6)).astype(np.float32)
    g = rng.standard_normal((2, T, 6)).astype(np.float32)
    ta, tb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    h = rglru._linear_scan(ta, tb)
    h.backward(torch.from_numpy(g))
    jh, vjp = jax.vjp(_jax_scan, jnp.asarray(a), jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(g))
    if T == 1:  # h = b: a takes no part, and its gradient is 0
        assert ta.grad is None and not np.asarray(ja).any()
        ta.grad = torch.zeros_like(ta)
    for got, want in ((h.detach(), jh), (ta.grad, ja), (tb.grad, jb)):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-5, err


def test_rglru_apply_gradients_match_jax_vjp(layer):
    """The whole layer under ``backward()`` (the scan, gates, conv and
    projections) against ``jax.vjp`` of the reference's ``rglru_apply``:
    the input's and every weight's gradient within 1e-4 relative L2."""
    jcfg, cfg, jp, p = layer
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    tp = {k: v.clone().requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    rglru.rglru_apply(tp, tx, cfg).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda q, v: jrglru.rglru_apply(q, v, jcfg), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    pairs = [(tx.grad, jgx)] + [(tp[k].grad, jgp[k]) for k in jp]
    for got, want in pairs:
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= TOL, err
