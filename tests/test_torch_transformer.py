"""The port's model stack against the reference package, on the CPU.

Parameters are drawn once by the reference (``init_params`` under a JAX
key) and carried across with ``from_jax_params``; token ids come from
numpy.  Prefill (``forward`` with the cache) and teacher-forced
``decode_step`` logits must match the reference's: 1e-4 with f32 weights
in both packages, 5e-2 with bf16 weights (the two frameworks round bf16
at different places).  The int8 cache encoding must match byte for byte.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import (
    ShapeConfig,
    init_params as jinit_params,
    model_defs as jmodel_defs,
    reduced_for_smoke as jreduced,
)
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import logits_fn as jlogits_fn
from repro.models import quant_cache as jquant
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step,
    forward,
    from_jax_params,
    init_cache,
    init_params,
    logits_fn,
    model_defs,
    reduced_for_smoke,
)
from repro_torch.models import attention, quant_cache

ARCH = "qwen2.5-3b"
PROMPT, TOTAL = 8, 12


def _cfgs(arch=ARCH):
    return jreduced(jget_config(arch)), reduced_for_smoke(get_config(arch))


def _params(jcfg, cfg, dtype):
    jp = jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")


def _run_both(jcfg, cfg, jp, tp, tokens, quant=False):
    """Prefill PROMPT tokens, then decode the rest teacher-forced; the
    logits of every position from both packages."""
    shape = ShapeConfig(name="t", kind="prefill", seq_len=PROMPT,
                        global_batch=tokens.shape[0], q_chunk=4, kv_chunk=4,
                        remat="none")
    jprefill = jax.jit(lambda p, tok: jforward(
        p, jcfg, {"tokens": tok}, shape, collect_cache=True, cache_len=TOTAL))
    jh, _, jc = jprefill(jp, jnp.asarray(tokens[:, :PROMPT]))
    th, _, tc = forward(tp, cfg, {"tokens": torch.from_numpy(tokens[:, :PROMPT])},
                        collect_cache=True, cache_len=TOTAL)
    jl, tl = [np.asarray(jlogits_fn(jp, jcfg, jh))], [logits_fn(tp, cfg, th)]
    if quant:  # decode from int8 caches, as a demoted session does
        jc = jinit_cache(jcfg, tokens.shape[0], TOTAL, quant_attn=True)
        tc = init_cache(cfg, tokens.shape[0], TOTAL, quant_attn=True, device="cpu")
    jstep = jax.jit(lambda p, tok, c, t: jdecode_step(p, jcfg, tok, c, t))
    for t in range(PROMPT if not quant else 0, TOTAL):
        jlo, jc = jstep(jp, jnp.asarray(tokens[:, t:t + 1]), jc, jnp.int32(t))
        tlo, tc = decode_step(tp, cfg, torch.from_numpy(tokens[:, t:t + 1]), tc, t)
        jl.append(np.asarray(jlo)[:, None])
        tl.append(tlo[:, None])
    return jl, tl, jc, tc


def _windowed(cfg, window):
    """``cfg`` with every local layer's window cut to ``window``, so that
    a short decode wraps the ring cache."""
    return replace(cfg, pattern=tuple(
        replace(b, window=window) if b.window else b for b in cfg.pattern))


@pytest.mark.parametrize("arch,window,dtype,tol", [
    pytest.param(ARCH, None, "float32", 1e-4, id="float32-0.0001"),
    pytest.param(ARCH, None, "bfloat16", 5e-2, id="bfloat16-0.05"),
    # the other dense decode paths: (1 + scale) norms, embedding scale,
    # MQA (gemma-2b), MHA with QKV bias (qwen1.5-32b), softcaps and a
    # local window cut so that the ring cache wraps (gemma2-9b)
    pytest.param("gemma-2b", None, "float32", 1e-4, id="gemma-2b"),
    pytest.param("qwen1.5-32b", None, "float32", 1e-4, id="qwen1.5-32b"),
    pytest.param("gemma2-9b", 3, "float32", 1e-4, id="gemma2-9b-window3"),
    pytest.param("gemma2-9b", 5, "float32", 1e-4, id="gemma2-9b-window5"),
])
def test_prefill_and_decode_logits_match_reference(arch, window, dtype, tol):
    jcfg, cfg = _cfgs(arch)
    if window is not None:
        jcfg, cfg = _windowed(jcfg, window), _windowed(cfg, window)
    jp, tp = _params(jcfg, cfg, dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, TOTAL)).astype(np.int32)
    jl, tl, jc, tc = _run_both(jcfg, cfg, jp, tp, tokens)
    assert tl[0].dtype == torch.float32
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), j, atol=tol, rtol=tol)
    # the caches keep the reference's layout: (n_periods, B, S, Kv, dh),
    # S the window for a local layer
    jk, tk = jc["body"][0].k, tc["body"][0].k
    S = min(TOTAL, window) if window is not None else TOTAL
    assert tuple(tk.shape) == jk.shape == (cfg.n_periods, 2, S, cfg.n_kv_heads,
                                           cfg.head_dim)
    np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk, np.float32),
                               atol=tol, rtol=tol)


def test_int8_cache_decode_matches_reference():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, cfg, "float32")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (1, TOTAL)).astype(np.int32)
    jl, tl, jc, tc = _run_both(jcfg, cfg, jp, tp, tokens, quant=True)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=1e-4)
    cache = tc["body"][0]
    assert isinstance(cache, quant_cache.QuantAttnCache)
    for name in ("k_q", "v_q"):
        np.testing.assert_array_equal(getattr(cache, name).numpy(),
                                      np.asarray(getattr(jc["body"][0], name)))


def test_quantize_kv_is_byte_identical(rng):
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16) - 7.5  # a row whose values fall on .5 ties
    x[0, 0, 0, 0] = 127.0  # scale exactly 1: round(-6.5) etc. tie to even
    x[1, 1, 1] = 0.0  # an all-zero row: the 1e-8 scale floor
    for dtype in (np.float32, "bfloat16"):
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(torch.float32 if dtype is np.float32
                                    else torch.bfloat16)
        jq, js = jquant.quantize_kv(jx)
        tq, ts = quant_cache.quantize_kv(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
        assert ts.view(torch.int16).numpy().tobytes() == \
            np.asarray(js).view(np.int16).tobytes()


def test_quant_decode_attention_matches_reference(rng):
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 20, 2, 16)).astype(np.float32)
    lengths = np.asarray([20, 9], np.int32)
    jk, jks = jquant.quantize_kv(jnp.asarray(kv[0]))
    jv, jvs = jquant.quantize_kv(jnp.asarray(kv[1]))
    tk, tks = quant_cache.quantize_kv(torch.from_numpy(kv[0]))
    tv, tvs = quant_cache.quantize_kv(torch.from_numpy(kv[1]))
    want = jquant.quant_decode_attention(
        jnp.asarray(q), jquant.QuantAttnCache(jk, jv, jks, jvs),
        jnp.asarray(lengths), attn_softcap=20.0, s_chunk=8)
    got = quant_cache.quant_decode_attention(
        torch.from_numpy(q), quant_cache.QuantAttnCache(tk, tv, tks, tvs),
        torch.from_numpy(lengths), attn_softcap=20.0, s_chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_decode_refuses_a_cache_on_another_device():
    """A meta tensor stands in for the card: x there, the cache on the CPU."""
    _, cfg = _cfgs()
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    p = {k: v[0] for k, v in tp["body"][0]["mixer"].items()}
    x = torch.empty((1, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    for quant in (False, True):
        cache = init_cache(cfg, 1, 4, quant_attn=quant, device="cpu")["body"][0]
        cache = type(cache)(*(f[0] for f in cache))
        with pytest.raises(ValueError, match="KV cache is on cpu"):
            attention.attn_decode(p, x, cache, 0, cfg)
    q = torch.empty((1, cfg.n_heads, cfg.head_dim), device="meta")
    with pytest.raises(ValueError, match="int8 cache on cpu"):
        quant_cache.quant_decode_attention(q, cache, torch.ones(1, dtype=torch.int32))


def test_init_params_follows_the_defs():
    _, cfg = _cfgs()
    defs = model_defs(cfg)
    a = init_params(defs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(defs, torch.Generator().manual_seed(3), "cpu")
    f32 = init_params(defs, torch.Generator().manual_seed(3), "cpu",
                      dtype=torch.float32)
    body = a["body"][0]
    assert body["mixer"]["wq"].shape == (cfg.n_periods, cfg.d_model,
                                         cfg.n_heads, cfg.head_dim)
    assert body["mixer"]["wq"].dtype == torch.bfloat16
    assert f32["body"][0]["mixer"]["wq"].dtype == torch.float32
    assert not body["mixer"]["bq"].any()  # QKV bias starts at zero
    assert bool((body["norm1"]["scale"] == 1).all())
    assert torch.equal(a["embed"], b["embed"])  # same generator seed, same draw
    w = f32["body"][0]["ffn"]["wo"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_ff) + 1e-6  # truncated
    # the reference's tree layout, leaf for leaf
    jcfg, _ = _cfgs()
    jdefs = jmodel_defs(jcfg)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
        jinit_params(jdefs, jax.random.PRNGKey(0)))) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, a))


def test_from_jax_params_checks_shapes():
    jcfg, cfg = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray, jinit_params(jmodel_defs(jcfg),
                                                          jax.random.PRNGKey(0)))
    tp = from_jax_params(jp, cfg, "cpu")
    assert tp["embed"].dtype == torch.bfloat16  # bf16 crosses bit for bit
    assert tp["embed"].view(torch.int16).numpy().tobytes() == \
        np.asarray(jp["embed"]).view(np.int16).tobytes()
    jp["unembed"] = jp["unembed"][:, :-1]
    with pytest.raises(ValueError, match="unembed"):
        from_jax_params(jp, cfg, "cpu")


def _cache_leaves(tree):
    """A port cache tree's tensors in the reference's pytree order (dict
    keys sorted, NamedTuple fields in order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _cache_leaves(tree[k])]
    return [t for v in tree for t in _cache_leaves(v)]


@pytest.mark.parametrize("arch,window", [
    # RG-LRU blocks beside local attention whose window is cut so that the
    # ring cache wraps, as gemma2-9b's cases do
    pytest.param("recurrentgemma-9b", 3, id="recurrentgemma-9b-window3"),
    pytest.param("recurrentgemma-9b", 5, id="recurrentgemma-9b-window5"),
    # MLA with a dense first layer, then MoE layers with a shared expert
    pytest.param("deepseek-v2-lite-16b", None, id="deepseek-v2-lite-16b"),
    # GQA attention with MoE layers
    pytest.param("dbrx-132b", None, id="dbrx-132b"),
])
def test_remaining_mixers_match_reference(arch, window):
    """Prefill and teacher-forced decode logits, the MoE aux loss and every
    cache leaf against the reference, 1e-4 with f32 weights."""
    jcfg, cfg = _cfgs(arch)
    if window is not None:
        jcfg, cfg = _windowed(jcfg, window), _windowed(cfg, window)
    jp, tp = _params(jcfg, cfg, "float32")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, TOTAL)).astype(np.int32)
    jl, tl, jc, tc = _run_both(jcfg, cfg, jp, tp, tokens)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=1e-4)
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), _cache_leaves(tc)
    assert len(tleaves) == len(jleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   atol=1e-4, rtol=1e-4)
    shape = ShapeConfig(name="t", kind="prefill", seq_len=TOTAL, global_batch=2,
                        q_chunk=4, kv_chunk=4, remat="none")
    _, jaux = jforward(jp, jcfg, {"tokens": jnp.asarray(tokens)}, shape)
    _, aux = forward(tp, cfg, {"tokens": torch.from_numpy(tokens)})
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-4, rtol=1e-4)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v2-lite-16b",
                                  "dbrx-132b"])
def test_decode_matches_teacher_forced_forward(arch):
    """The port alone: decode from an empty cache gives the logits of one
    forward pass over the same tokens (the recurrent and absorbed forms
    against the scan and the expanded form), 1e-4 in f32.  MoE runs at
    capacity factor 8, as the reference's own test does: a 16-token
    forward drops entries that a one-token step keeps."""
    _, cfg = _cfgs(arch)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(1), "cpu",
                     dtype=torch.float32)
    T = 16
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    h, _ = forward(tp, cfg, {"tokens": tokens})
    full = logits_fn(tp, cfg, h)
    cache = init_cache(cfg, 2, T, dtype=torch.float32, device="cpu")
    for t in range(T):
        lg, cache = decode_step(tp, cfg, tokens[:, t:t + 1], cache, t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b", "hubert-xlarge",
                                  "internvl2-26b"])
def test_other_dense_configs_match_reference(arch):
    """Softcaps, (1 + scale) norms, embedding scale, local windows, layer
    norm, the encoder's full attention and the vision-language model's
    patch embeddings ahead of the tokens, through the same kernels."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg, cfg, "float32")
    rng = np.random.default_rng(2)
    shape = ShapeConfig(name="t", kind="prefill", seq_len=PROMPT, global_batch=1,
                        q_chunk=4, kv_chunk=4, remat="none")
    if cfg.frontend == "frames":
        x = rng.standard_normal((1, PROMPT, cfg.frame_dim)).astype(np.float32)
        jin, tin = {"frames": jnp.asarray(x)}, {"frames": torch.from_numpy(x)}
    else:
        x = rng.integers(0, cfg.vocab, (1, PROMPT)).astype(np.int32)
        jin, tin = {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
    if cfg.frontend == "tokens+patches":
        patches = rng.standard_normal((1, cfg.n_patches, cfg.d_model)).astype(np.float32)
        jin["patches"] = jnp.asarray(patches)
        tin["patches"] = torch.from_numpy(patches)
    jh, _ = jforward(jp, jcfg, jin, shape)
    th, _ = forward(tp, cfg, tin)
    np.testing.assert_allclose(logits_fn(tp, cfg, th).numpy(),
                               np.asarray(jlogits_fn(jp, jcfg, jh)),
                               atol=1e-4, rtol=1e-4)
