"""The port's multi-head latent attention against the reference package,
on the CPU, at ``reduced_for_smoke`` widths of deepseek-v2-lite-16b.

The expanded prefill runs through the flash kernel's entry point with q/k
of one head dim and v of another; on the CPU that is the kernel's plain
version, held here against the reference's XLA twin of its Pallas kernel
(``repro.models.layers.chunked_attention``; the Pallas kernel itself takes
only square head dims) at deepseek's full 192/128 head dims.  The prefill
output and its latent cache, and absorbed-form decode steps (the new row
written into the cache in place), are held to 1e-4 in f32; the attention
at 2e-5 in f32 and 2e-2 in bf16, the tolerances of the port's other
attention tests.  Parameters are drawn by the reference, cast to f32 and
carried across; inputs come from numpy.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import mla as jmla
from repro.models import reduced_for_smoke as jreduced
from repro.models.layers import chunked_attention as jchunked
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import MLACache, mla, reduced_for_smoke
from repro_torch.models.convert import to_tensor

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_for_smoke(get_config(ARCH))
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jinit_params(jmla.mla_defs(jcfg), jax.random.PRNGKey(1)))
    p = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(cfg, seed, T):
    return np.random.default_rng(seed).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("T,cache_len", [(13, 13), (13, 20), (1, 4)])
def test_mla_apply_and_cache_match_reference(layer, T, cache_len):
    jcfg, cfg, jp, p = layer
    x = _x(cfg, T, T)
    jout, jc = jmla.mla_apply(jp, jnp.asarray(x), jcfg, q_chunk=4, kv_chunk=4,
                              collect_cache=True, cache_len=cache_len)
    out, c = mla.mla_apply(p, torch.from_numpy(x), cfg, collect_cache=True,
                           cache_len=cache_len)
    _close(out, jout)
    assert isinstance(c, MLACache)
    assert tuple(c.c_kv.shape) == jc.c_kv.shape == (2, cache_len,
                                                     cfg.mla.kv_lora_rank)
    assert tuple(c.k_pe.shape) == jc.k_pe.shape
    _close(c.c_kv, jc.c_kv)
    _close(c.k_pe, jc.k_pe)
    assert torch.equal(mla.mla_apply(p, torch.from_numpy(x), cfg), out)


def test_mla_decode_steps_match_reference_in_place(layer):
    jcfg, cfg, jp, p = layer
    x = _x(cfg, 0, 16)
    _, jc = jmla.mla_apply(jp, jnp.asarray(x[:, :11]), jcfg, q_chunk=4,
                           kv_chunk=4, collect_cache=True, cache_len=16)
    _, c = mla.mla_apply(p, torch.from_numpy(x[:, :11]), cfg,
                         collect_cache=True, cache_len=16)
    for t in range(11, 16):
        jo, jc = jmla.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                 jnp.int32(t), jcfg)
        c_kv, k_pe = c
        o, c = mla.mla_decode(p, torch.from_numpy(x[:, t:t + 1]), c, t, cfg)
        assert c.c_kv is c_kv and c.k_pe is k_pe
        _close(o, jo)
        _close(c.c_kv, jc.c_kv)
        _close(c.k_pe, jc.k_pe)


def test_decode_refuses_a_cache_on_another_device(layer):
    _, cfg, _, p = layer
    cache = mla.init_mla_cache(cfg, 1, 4, torch.float32, device="cpu")
    x = torch.empty((1, 1, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="MLA cache is on cpu"):
        mla.mla_decode(p, x, cache, 0, cfg)


# -- the flash entry point at q/k 192 against v 128 ---------------------------

def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("T,Tk,H,Kv,causal", [
    (40, 40, 4, 4, True),      # MLA's MHA, causal
    (37, 37, 4, 4, True),      # ragged T
    (1, 1, 4, 4, True),        # T = 1
    (20, 33, 4, 2, False),     # GQA, Tq < Tk, full attention
])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_flash_plain_at_192_128_matches_reference_twin(rng, T, Tk, H, Kv, causal,
                                                       dtype, tol):
    jq, tq = _pair(rng, (2, T, H, 192), dtype)
    jk, tk = _pair(rng, (2, Tk, Kv, 192), dtype)
    jv, tv = _pair(rng, (2, Tk, Kv, 128), dtype)
    scale = 1.0 / np.sqrt(192)
    got = ops.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    assert got.shape == (2, T, H, 128) and got.dtype == tq.dtype
    want = jchunked(jq, jk, jv, causal=causal, scale=scale, q_chunk=16,
                    kv_chunk=16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_plan_takes_192_128_and_refuses_other_pairs():
    q = torch.zeros(1, 1024, 16, 192, dtype=torch.bfloat16)
    k = torch.zeros(1, 1024, 16, 192, dtype=torch.bfloat16)
    v = torch.zeros(1, 1024, 16, 128, dtype=torch.bfloat16)
    assert fa._plan(q, k, v) == fa.Plan("wgmma", 128, 64, (8 * 16,))
    assert fa._plan(q.float(), k.float(), v.float()).route == "tf32x3"
    call = fa._prepare(q, k, v, True, 1 / np.sqrt(192), None, None)
    p = call.params
    assert call.out_shape == (1, 1024, 16, 128)
    assert (p.dh, p.dv) == (192, 128)
    assert (p.o_sb, p.o_st, p.o_sh) == (1024 * 16 * 128, 16 * 128, 128)
    assert (p.v_sb, p.v_st, p.v_sh) == v.stride()[:3]
    assert call.address == ctypes.addressof(p)
    for dqk, dv in ((192, 64), (128, 192), (96, 96)):
        with pytest.raises(ValueError, match="head dims"):
            fa._plan(q[..., :dqk] if dqk <= 192 else q, k[..., :dqk],
                     torch.zeros(1, 1024, 16, dv, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="do not fit"):  # k's dh is q's
        ops.flash_attention(q[:, :4], k[:, :4, :, :128], v[:, :4])
