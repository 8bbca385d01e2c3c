"""The port's attention kernels against the reference package, on the CPU.

On the CPU the wrappers take the kernels' plain versions
(``flash_attention_torch``, ``decode_attention_torch``); these tests hold
them against the reference's Pallas kernels run in interpret mode and
against both packages' ``kernels/ref.py`` oracles, on the same inputs made
with numpy.  Tolerances: 2e-5 in f32, 2e-2 in bf16 (the reference's
flash tests'; its decode tests allow 3e-2 in bf16).  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _flat_heads(x, rep):
    """(B, T, n, dh) -> (B*n*rep, T, dh) with each head repeated ``rep``
    times: the reference oracle's heads-flattened layout."""
    x = np.repeat(np.asarray(x, np.float32), rep, axis=2)
    B, T, n, dh = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * n, T, dh)


# -- flash attention -----------------------------------------------------------

@pytest.mark.parametrize("T,H,Kv,dh,causal,softcap", [
    (64, 4, 4, 32, True, None),     # MHA, rep 1
    (37, 4, 2, 32, True, 30.0),     # ragged T, rep 2, softcap
    (48, 8, 2, 64, False, None),    # rep 4, full attention
    (1, 4, 1, 32, True, None),      # T = 1, MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_kernel(rng, T, H, Kv, dh, causal,
                                              softcap, dtype):
    B = 2
    jq, tq = _pair(rng, (B, T, H, dh), dtype)
    jk, tk = _pair(rng, (B, T, Kv, dh), dtype)
    jv, tv = _pair(rng, (B, T, Kv, dh), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == (B, T, H, dh)
    want = jops.flash_attention(jq, jk, jv, causal=causal, softcap=softcap,
                                interpret=True)
    _close(got, want, TOL[dtype])
    rep = H // Kv
    oracle = jref.flash_attention_ref(
        jnp.asarray(_flat_heads(jq, 1)), jnp.asarray(_flat_heads(jk, rep)),
        jnp.asarray(_flat_heads(jv, rep)), causal=causal, softcap=softcap,
    )
    flat = _np(got).transpose(0, 2, 1, 3).reshape(B * H, T, dh)
    _close(flat, oracle, TOL[dtype])


def test_flash_window_matches_reference_twin(rng):
    """A sliding window (the local layers), against the reference's XLA twin."""
    from repro.models.layers import chunked_attention

    jq, tq = _pair(rng, (1, 50, 4, 32), "float32")
    jk, tk = _pair(rng, (1, 50, 2, 32), "float32")
    jv, tv = _pair(rng, (1, 50, 2, 32), "float32")
    got = ops.flash_attention(tq, tk, tv, window=7)
    want = chunked_attention(jq, jk, jv, window=7, q_chunk=16, kv_chunk=16)
    _close(got, want, 2e-5)


def test_port_flash_oracle_matches_reference_oracle(rng):
    jq, tq = _pair(rng, (6, 33, 32), "float32")
    jk, tk = _pair(rng, (6, 33, 32), "float32")
    jv, tv = _pair(rng, (6, 33, 32), "float32")
    for causal, cap in ((True, None), (False, 20.0)):
        _close(ref.flash_attention_ref(tq, tk, tv, causal=causal, softcap=cap),
               jref.flash_attention_ref(jq, jk, jv, causal=causal, softcap=cap),
               2e-5)


# -- decode attention ------------------------------------------------------

@pytest.mark.parametrize("S,H,Kv,dh,lengths,softcap", [
    (64, 4, 4, 32, (1, 64), None),       # rep 1, a one-row cache
    (100, 4, 2, 32, (37, 99), 30.0),     # rep 2, ragged, softcap
    (80, 8, 2, 64, (80, 3), None),       # rep 4
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference_kernel(rng, S, H, Kv, dh, lengths,
                                               softcap, dtype):
    B = 2
    jq, tq = _pair(rng, (B, H, dh), dtype)
    jk, tk = _pair(rng, (B, S, Kv, dh), dtype)
    jv, tv = _pair(rng, (B, S, Kv, dh), dtype)
    lens = np.asarray(lengths, np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                               softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == (B, H, dh)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                 softcap=softcap, interpret=True)
    tol = TOL[dtype]
    _close(got, want, tol)
    # the oracle's layout: one row per (b, kv head) holding rep query heads
    rep = H // Kv
    qg = np.asarray(jq, np.float32).reshape(B * Kv, rep, dh)
    kf = np.asarray(jk, np.float32).transpose(0, 2, 1, 3).reshape(B * Kv, S, dh)
    vf = np.asarray(jv, np.float32).transpose(0, 2, 1, 3).reshape(B * Kv, S, dh)
    oracle = jref.decode_attention_ref(
        jnp.asarray(qg), jnp.asarray(kf), jnp.asarray(vf),
        jnp.asarray(np.repeat(lens, Kv)), softcap=softcap,
    )
    _close(_np(got).reshape(B * Kv, rep, dh), oracle, tol)


def test_decode_zero_length_gives_zeros_as_the_tpu_kernel(rng):
    jq, tq = _pair(rng, (2, 4, 32), "float32")
    jk, tk = _pair(rng, (2, 16, 2, 32), "float32")
    jv, tv = _pair(rng, (2, 16, 2, 32), "float32")
    lens = np.asarray([0, 16], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), interpret=True)
    assert not got[0].any()
    _close(got, want, 2e-5)
    # the oracle (both packages) defines it as the mean of V instead
    mean = ref.decode_attention_ref(tq[:1, :2], tk[:1, :, 0], tv[:1, :, 0],
                                    torch.zeros(1, dtype=torch.int32))
    _close(mean[0, 0], tv[0, :, 0].mean(0), 2e-5)


def test_port_decode_oracle_matches_reference_oracle(rng):
    jq, tq = _pair(rng, (3, 4, 32), "float32")
    jk, tk = _pair(rng, (3, 20, 32), "float32")
    jv, tv = _pair(rng, (3, 20, 32), "float32")
    lens = np.asarray([0, 7, 20], np.int32)
    _close(ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens),
                                    softcap=10.0),
           jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens),
                                     softcap=10.0), 2e-5)


# -- the wrappers ----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    _, q = _pair(rng, (1, 8, 4, 32), "float32")
    _, k = _pair(rng, (1, 8, 2, 32), "float32")
    before = (fa.launches, da.launches)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0], k, k, torch.tensor([8], dtype=torch.int32))
    assert (fa.launches, da.launches) == before


def _meta_like(x):
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


@pytest.mark.parametrize("entry", ["chunked_attention", "decode_attention"])
def test_entry_points_refuse_q_and_cache_on_different_devices(rng, entry):
    """A meta tensor stands in for the card: q there, the cache on the CPU."""
    _, q = _pair(rng, (1, 8, 4, 32), "float32")
    _, k = _pair(rng, (1, 8, 2, 32), "float32")
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        if entry == "chunked_attention":
            layers.chunked_attention(_meta_like(q), k, k)
        else:
            layers.decode_attention(_meta_like(q[:, 0]), k, k, lengths)
    with pytest.raises(ValueError, match="unsupported device"):  # all on meta
        if entry == "chunked_attention":
            layers.chunked_attention(_meta_like(q), _meta_like(k), _meta_like(k))
        else:
            layers.decode_attention(_meta_like(q[:, 0]), _meta_like(k),
                                    _meta_like(k), _meta_like(lengths))


@pytest.mark.parametrize("bad", ["dtype_mix", "heads", "lengths_dtype", "dh"])
def test_wrappers_reject_what_the_kernels_do_not_take(rng, bad):
    _, q = _pair(rng, (1, 8, 4, 32), "float32")
    _, k = _pair(rng, (1, 8, 2, 32), "float32")
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        if bad == "dtype_mix":
            ops.flash_attention(q, k.bfloat16(), k)
        elif bad == "heads":  # H not a multiple of Kv
            ops.decode_attention(q[:, 0, :3], k, k, lengths)
        elif bad == "lengths_dtype":
            ops.decode_attention(q[:, 0], k, k, lengths.long())
        else:
            ops.flash_attention(q, k[..., :16], k[..., :16])


# -- the flash kernel's plan (route, tiles, grid) and P's rounding ------------

def _qkv(B, T, H, Kv, dh, dtype, Tk=None):
    Tk = T if Tk is None else Tk
    return (torch.zeros(B, T, H, dh, dtype=dtype),
            torch.zeros(B, Tk, Kv, dh, dtype=dtype),
            torch.zeros(B, Tk, Kv, dh, dtype=dtype))


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_flash_plan_routes_by_dtype(dtype, route, dh):
    plan = fa._plan(*_qkv(1, 100, 8, 2, dh, dtype))
    assert plan.route == route
    if route == "wgmma":  # 64 query rows per consumer warpgroup
        assert plan.block_q == (64 if dh == 256 else 128) and plan.block_k == 64
    else:  # 64 rows, 16 a warp; 64-key tiles, 32 at dh 256
        assert plan.block_q == 64 and plan.block_k == (32 if dh == 256 else 64)


@pytest.mark.parametrize("B,T,H,Kv,dh,grid", [
    (1, 1, 16, 2, 128, (16,)),           # T = 1: one block per head
    (2, 475, 16, 2, 128, (4 * 32,)),     # ragged T: ceil(475 / 128)
    (1, 1024, 16, 2, 128, (8 * 16,)),    # the qwen2.5-3b prefill
    (2, 200, 8, 2, 64, (2 * 16,)),       # dh 64: 128-row blocks too
    (1, 515, 8, 1, 256, (9 * 8,)),       # dh 256: 64-row blocks
])
def test_flash_plan_grid(B, T, H, Kv, dh, grid):
    plan = fa._plan(*_qkv(B, T, H, Kv, dh, torch.bfloat16))
    assert plan.grid == grid


def test_flash_plan_f32_grid_is_the_tf32x3_kernels():
    plan = fa._plan(*_qkv(2, 475, 16, 2, 256, torch.float32))
    assert plan == fa.Plan("tf32x3", 64, 32, (8 * 32,))  # ceil(475 / 64) x B*H


@pytest.mark.parametrize("bad", ["stride", "base", "head_dim", "batch_stride"])
def test_flash_plan_raises_on_what_tma_does_not_take(bad):
    q, k, v = _qkv(1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        if bad == "stride":  # heads 68 elements (136 bytes) apart
            wide = torch.zeros(1, 64, 4, 68, dtype=torch.bfloat16)
            fa._plan(wide[..., :64], k, v)
        elif bad == "base":  # one element (2 bytes) past an aligned base
            flat = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)
            fa._plan(q, flat[1:].view(k.shape), v)
        elif bad == "head_dim":
            fa._plan(q, k, v.transpose(1, 3).contiguous().transpose(1, 3))
        else:  # a batch stride of 4 elements (8 bytes)
            fa._plan(q, k.as_strided(k.shape, (4, *k.stride()[1:])), v)


def _flash_p_rounded(q, k, v, *, causal, softcap, dtype):
    """The plain version with P rounded to ``dtype`` before P·V and the row
    sum taken over the rounded P, as the tensor-core kernel does (there
    per kv tile, against the running max)."""
    B, Tq, H, dh = q.shape
    Tk, Kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Tq, Kv, H // Kv, dh)
    s = torch.einsum("bqkrd,bckd->bkrqc", qf, k.float()) / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        live = torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :]
        s = s.masked_fill(~live, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(dtype).float()
    o = torch.einsum("bkrqc,bckd->bqkrd", p, v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Tq, H, dh)


@pytest.mark.parametrize("T,H,Kv,dh,causal,softcap", [
    (96, 4, 2, 64, True, None),
    (50, 4, 1, 64, True, 30.0),
    (40, 2, 2, 128, False, None),
])
def test_flash_with_p_in_bf16_stays_within_tolerance_of_reference(
        rng, T, H, Kv, dh, causal, softcap):
    """Rounding P to bf16 before P·V (the tensor-core kernel's choice; the
    reference keeps P in f32) stays within the bf16 tolerance of the
    reference's Pallas kernel."""
    jq, tq = _pair(rng, (2, T, H, dh), "bfloat16")
    jk, tk = _pair(rng, (2, T, Kv, dh), "bfloat16")
    jv, tv = _pair(rng, (2, T, Kv, dh), "bfloat16")
    got = _flash_p_rounded(tq, tk, tv, causal=causal, softcap=softcap,
                           dtype=torch.bfloat16)
    want = jops.flash_attention(jq, jk, jv, causal=causal, softcap=softcap,
                                interpret=True)
    _close(got, want, TOL["bfloat16"])


def test_flash_prepared_call_fills_the_kernels_parameter_struct():
    """A CUDA call's sizes, strides and options go to the kernel as one
    struct built once per signature; its fields follow the tensors."""
    q, k, v = _qkv(2, 100, 8, 2, 128, torch.bfloat16, Tk=120)
    call = fa._prepare(q, k, v, False, 0.25, 30.0, 7)
    p = call.params
    assert call.out_shape == (2, 100, 8, 128)
    assert (p.q_sb, p.q_st, p.q_sh) == q.stride()[:3]
    assert (p.k_sb, p.k_st, p.k_sh) == k.stride()[:3]
    assert (p.o_sb, p.o_st, p.o_sh) == (100 * 8 * 128, 8 * 128, 128)
    assert (p.dtype, p.B, p.Tq, p.Tk, p.H, p.Kv, p.dh, p.dv) == \
        (1, 2, 100, 120, 8, 2, 128, 128)
    assert (p.causal, p.window, p.block_q, p.block_k) == (0, 7, 128, 64)
    assert (p.scale, p.softcap) == (0.25, 30.0)
    assert call.address == ctypes.addressof(p) and ctypes.sizeof(p) == 160


# -- the decode kernel's plan, its prepared call and P's rounding -------------

@pytest.mark.parametrize("B,S,H,Kv,plan", [
    (1, 1088, 16, 2, (14, 80, 8, 1, (14, 2))),   # the qwen2.5-3b decode path
    (8, 1088, 16, 2, (9, 128, 8, 1, (9, 16))),   # a batch of 8: one wave
    (1, 1, 16, 2, (1, 16, 8, 1, (1, 2))),        # S = 1: one split
    (1, 1088, 40, 40, (4, 272, 8, 1, (4, 40))),  # rep 1 (qwen1.5-32b, MHA)
    (1, 1088, 16, 8, (14, 80, 8, 1, (14, 8))),   # rep 2 (gemma2-9b)
    (1, 1088, 10, 2, (14, 80, 8, 1, (14, 2))),   # rep 5: padded to 8
    (1, 1088, 32, 2, (14, 80, 16, 1, (14, 2))),  # rep 16: two n tiles
    (1, 1088, 80, 2, (14, 80, 16, 3, (14, 6))),  # rep 40: three groups
])
def test_decode_plan_splits_the_cache_into_one_cluster_per_row(B, S, H, Kv,
                                                               plan):
    got = da._plan(B, S, H, Kv, torch.bfloat16, 132)
    assert got.route == "mma" and tuple(got)[1:] == plan
    n, length, heads, groups = plan[:4]
    assert 1 <= n <= da.MAX_SPLITS and length % 16 == 0
    assert (n - 1) * length < S <= n * length  # no split past the cache
    assert heads * groups >= H // Kv > heads * (groups - 1)


def test_decode_plan_f32_takes_every_head_on_cuda_cores():
    assert da._plan(2, 1088, 16, 2, torch.float32, 132) == da.Plan(
        "f32", 12, 96, 8, 1, (12, 4))


def test_decode_prepared_call_fills_the_kernels_parameter_struct():
    """A CUDA call's sizes, strides, plan and options go to the kernel as
    one struct built once per signature; its fields follow the tensors (a
    strided cache view included)."""
    q = torch.zeros(2, 16, 128, dtype=torch.bfloat16)
    kc = torch.zeros(2, 300, 4, 128, dtype=torch.bfloat16)[:, :, 1:3]
    vc = torch.zeros(2, 300, 2, 128, dtype=torch.bfloat16)
    lengths = torch.ones(2, dtype=torch.int32)
    call = da._prepare(q, kc, vc, lengths, 0.25, 30.0, 132)
    p = call.params
    assert call.out_shape == (2, 16, 128)
    assert (p.q_sb, p.q_sh) == q.stride()[:2]
    assert (p.k_sb, p.k_ss, p.k_sh) == kc.stride()[:3] == (300 * 512, 512, 128)
    assert (p.v_sb, p.v_ss, p.v_sh) == vc.stride()[:3]
    assert (p.o_sb, p.o_sh) == (16 * 128, 128)
    assert (p.dtype, p.device, p.B, p.S, p.H, p.Kv, p.dh) == (1, 0, 2, 300, 16, 2, 128)
    assert (p.n_splits, p.split_len, p.heads, p.groups) == tuple(call.plan)[1:5]
    assert (p.scale, p.softcap) == (0.25, 30.0)
    assert call.address == ctypes.addressof(p) and ctypes.sizeof(p) == 136


def test_decode_prepared_call_refuses_strides_the_loads_cannot_take():
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    wide = torch.zeros(1, 40, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        da._prepare(q, wide, wide, torch.ones(1, dtype=torch.int32), None,
                    None, 132)


def _decode_p_rounded(q, k, v, lengths, *, softcap, dtype):
    """The plain version with P rounded to ``dtype`` before P·V and the row
    sum taken over the rounded P, as the tensor-core kernel does (there
    per 16-row chunk, against each warp's running max)."""
    B, H, dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Kv, H // Kv, dh)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k.float()) / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    live = (torch.arange(S)[None, :] < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~live, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(dtype).float()
    o = torch.einsum("bkrs,bskd->bkrd", p, v.float()) / p.sum(-1, keepdim=True)
    return o.reshape(B, H, dh)


@pytest.mark.parametrize("S,H,Kv,dh,lengths,softcap", [
    (160, 16, 2, 64, (37, 160), None),    # rep 8, the path's grouping
    (96, 4, 4, 64, (1, 96), None),        # rep 1, a one-row cache
    (130, 10, 2, 128, (129, 64), 30.0),   # rep 5, softcap
])
def test_decode_with_p_in_bf16_stays_within_tolerance_of_reference(
        rng, S, H, Kv, dh, lengths, softcap):
    """Rounding P to bf16 before P·V (the tensor-core kernel's choice; the
    reference keeps P in f32) stays within the bf16 tolerance of the
    reference's Pallas decode kernel."""
    jq, tq = _pair(rng, (2, H, dh), "bfloat16")
    jk, tk = _pair(rng, (2, S, Kv, dh), "bfloat16")
    jv, tv = _pair(rng, (2, S, Kv, dh), "bfloat16")
    lens = np.asarray(lengths, np.int32)
    got = _decode_p_rounded(tq, tk, tv, torch.from_numpy(lens),
                            softcap=softcap, dtype=torch.bfloat16)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                 softcap=softcap, interpret=True)
    _close(got, want, TOL["bfloat16"])
