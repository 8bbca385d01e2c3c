"""The port's mixture-of-experts FFN against the reference package, on the
CPU, at ``reduced_for_smoke`` widths of deepseek-v2-lite-16b (8 experts
top-2 and a shared expert) and dbrx-132b (8 experts top-2, none shared).

Routing must be exact: the same expert ids in the same order, and the
capacity pack must keep and drop the same (token, slot) entries as the
reference.  Weights, outputs and the aux loss are held to 1e-4 in f32 (the
combine sums a token's contributions in another order than the
reference's scatter-add).  Parameters are drawn by the reference, cast to
f32 and carried across; inputs come from numpy.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import reduced_for_smoke as jreduced
from repro_torch.configs import get_config
from repro_torch.models import moe, reduced_for_smoke
from repro_torch.models.convert import to_tensor

ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b"]
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(arch, capacity_factor=None):
    jcfg, cfg = jreduced(jget_config(arch)), reduced_for_smoke(get_config(arch))
    if capacity_factor is not None:
        jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=capacity_factor))
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _params(jcfg, seed=1):
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed)))
    return jp, jax.tree_util.tree_map(lambda a: to_tensor(np.asarray(a)), jp)


def _x(cfg, seed, B=2, T=24):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_gives_the_reference_experts_exactly(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(jcfg)
    xf = _x(cfg, 0).reshape(-1, cfg.d_model)
    jw, jidx, jaux = jmoe._route(jnp.asarray(xf), jp["router"], jcfg.moe)
    w, idx, aux = moe._route(torch.from_numpy(xf), p["router"], cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    _close(aux, jaux)


def test_route_ranks_equal_probabilities_by_expert_id():
    """A zero router gives every expert the same probability: both
    packages take the lowest ids first (``jax.lax.top_k``'s order)."""
    jcfg, cfg = _cfgs("dbrx-132b")
    router = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    xf = _x(cfg, 1).reshape(-1, cfg.d_model)
    _, jidx, _ = jmoe._route(jnp.asarray(xf), jnp.asarray(router), jcfg.moe)
    w, idx, _ = moe._route(torch.from_numpy(xf), torch.from_numpy(router), cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == np.arange(cfg.moe.top_k)).all()


@pytest.mark.parametrize("capacity", [1, 3, 50])
def test_pack_by_group_is_exact(capacity):
    """Order, sorted ids, positions and kept entries, with entries of no
    group (a sentinel above n_groups) and runs longer than the capacity."""
    groups = np.random.default_rng(capacity).integers(0, 7, 200).astype(np.int32)
    groups[::11] = 9  # no group
    want = jmoe._pack_by_group(jnp.asarray(groups), 6, capacity)
    got = moe._pack_by_group(torch.from_numpy(groups).long(), 6, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,T", [(1.25, 24), (0.5, 24), (8.0, 1),
                                               (1.25, 1)])
def test_moe_apply_dense_matches_reference(arch, capacity_factor, T):
    """Output and aux loss, at the configs' factor (where a skewed router
    overfills some experts), a factor of 0.5 (many drops), and decode's
    one token."""
    jcfg, cfg = _cfgs(arch, capacity_factor)
    jp, p = _params(jcfg)
    x = _x(cfg, 2, T=T)
    jout, jaux = jmoe.moe_apply_dense(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(out, jout)
    _close(aux, jaux)
    out2, _ = moe.moe_apply_dense(p, torch.from_numpy(x), cfg)
    assert torch.equal(out, out2)  # the combine has a fixed order
    if capacity_factor == 0.5:  # the case drops entries, in both packages
        m = cfg.moe
        M = x.shape[0] * T * m.top_k
        _, idx, _ = moe._route(torch.from_numpy(x).reshape(-1, cfg.d_model),
                               p["router"], m)
        cap = max(1, int(math.ceil(M / m.n_experts * m.capacity_factor)))
        keep = moe._pack_by_group(idx.reshape(M), m.n_experts, cap)[3]
        jkeep = jmoe._pack_by_group(jnp.asarray(idx.reshape(M).numpy()),
                                    m.n_experts, cap)[3]
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        assert not keep.all()


def test_router_stays_f32_under_a_weight_dtype():
    from repro_torch.models import init_params, model_defs

    _, cfg = _cfgs("deepseek-v2-lite-16b")
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                     dtype=torch.bfloat16)
    ffn = tp["body"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == ffn["shared"]["wi_gate"].dtype == torch.bfloat16
    assert ffn["w_gate"].shape == (cfg.n_periods, cfg.moe.n_experts,
                                   cfg.d_model, cfg.moe.d_expert)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_gradients_match_jax_vjp(arch, capacity_factor):
    """The dense path's gradients (input, router, experts, shared expert)
    against ``jax.vjp`` of the reference's, with drops at a factor of
    0.5, under ``torch.use_deterministic_algorithms(True)``: the row moves
    accumulate into no repeated index.  The cotangent is a seeded
    ``(B, T, D)`` array and 0.3 for the aux loss.  Measured (f32): at most
    5.7e-6 absolute, 3.7e-7 of the largest entry; held to 1e-4 absolute
    and relative, as the forward."""
    jcfg, cfg = _cfgs(arch, capacity_factor)
    jp, p = _params(jcfg)
    x = _x(cfg, 3)
    ct = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    (jout, jaux), vjp = jax.vjp(lambda q, y: jmoe.moe_apply_dense(q, y, jcfg),
                                jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(ct), jnp.float32(0.3)))
    leaves = jax.tree_util.tree_map(lambda a: a.clone().requires_grad_(), p)
    xt = torch.from_numpy(x).requires_grad_()
    torch.use_deterministic_algorithms(True)
    try:
        out, aux = moe.moe_apply_dense(leaves, xt, cfg)
        (out * torch.from_numpy(ct)).sum().add(0.3 * aux).backward()
    finally:
        torch.use_deterministic_algorithms(False)
    _close(out.detach(), jout)
    _close(xt.grad, jgx)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.grad, leaves))
    want = jax.tree_util.tree_leaves(jgp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    if capacity_factor == 0.5:
        M = x.shape[0] * x.shape[1] * cfg.moe.top_k
        _, idx, _ = moe._route(torch.from_numpy(x).reshape(-1, cfg.d_model),
                               p["router"], cfg.moe)
        cap = max(1, int(math.ceil(M / cfg.moe.n_experts * capacity_factor)))
        assert not moe._pack_by_group(idx.reshape(M), cfg.moe.n_experts, cap)[3].all()
