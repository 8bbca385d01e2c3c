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


@pytest.mark.parametrize("window", [3, 5])
def test_local_attention_ring_decode_matches_reference(window):
    """One local-attention layer of recurrentgemma-9b: a prefill longer
    than its window, then decode across two wraps of the ring, against
    the reference's ``attn_apply``/``attn_decode`` on the same inputs.
    Every step's output and both ring caches (slot ``t % window`` holds
    position t) within 1e-5, on inputs drawn at unit scale."""
    from repro.models import attention as jattn
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    rng = np.random.default_rng(7)
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {"wq": (D, H, dh), "wk": (D, Kv, dh), "wv": (D, Kv, dh), "wo": (H, dh, D)}
    jp = {k: (rng.standard_normal(shp) / np.sqrt(shp[0] * (shp[1] if k == "wo" else 1)))
          .astype(np.float32) for k, shp in w.items()}
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    prompt, total = window + 2, 3 * window + 1  # two wraps past the prefill
    x = rng.standard_normal((2, total, D)).astype(np.float32)
    jo, jc = jattn.attn_apply(jp, jnp.asarray(x[:, :prompt]), jcfg, window=window,
                              q_chunk=4, kv_chunk=4, collect_cache=True,
                              cache_len=total)
    to, tc = attention.attn_apply(tp, torch.from_numpy(x[:, :prompt]), cfg,
                                  window=window, collect_cache=True, cache_len=total)
    assert tuple(tc.k.shape) == jc.k.shape == (2, window, Kv, dh)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for t in range(prompt, total):
        jo, jc = jattn.attn_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t),
                                   jcfg, window=window)
        to, tc = attention.attn_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, t, cfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
        for j, got in zip(jc, tc):
            np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
        # the new position's key sits in its ring slot in both caches
        k_t = np.asarray(jc.k)[:, t % window]
        np.testing.assert_allclose(tc.k[:, t % window].numpy(), k_t, atol=1e-5,
                                   rtol=1e-5)


def _scaled_gap(want, got) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


def test_recurrentgemma_window5_blocks_depart_only_in_rounding():
    """The window-5 case of ``test_remaining_mixers_match_reference``
    block by block: each of the port's blocks (the (R, R, L) periods and
    the postlude) is given the reference's input to that block, and at
    decode t = 8..11 also the reference's cache, so that no departure
    upstream reaches it.  Every block's output and cache lies within 1e-5
    of its scale from the reference's, at prefill and at every decode step
    across the ring's wrap: no block computes anything else than the
    reference's block, whatever the whole model's logits do."""
    from repro.models import ShardCtx, transformer as jt
    from repro_torch.models import transformer as tt
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    jcfg, cfg = _windowed(jcfg, 5), _windowed(cfg, 5)
    jp, tp = _params(jcfg, cfg, "float32")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, TOTAL)).astype(np.int32)
    shape = ShapeConfig(name="t", kind="prefill", seq_len=PROMPT, global_batch=2,
                        q_chunk=4, kv_chunk=4, remat="none")
    blocks = [(jax.tree_util.tree_map(lambda a, i=i: a[i], jp["body"][j]),
               tt._period(tp["body"][j], i), jcfg.pattern[j], blk)
              for i in range(cfg.n_periods) for j, blk in enumerate(cfg.pattern)]
    blocks += [(jp["postlude"][k], tp["postlude"][k], jcfg.postlude[k], blk)
               for k, blk in enumerate(cfg.postlude)]
    torch_of = lambda a: torch.from_numpy(np.array(a))

    x = jt._frontend(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    caches = []
    for jb, tb, jblk, blk in blocks:
        jx, _, jc = jax.jit(lambda p, x_, b=jblk: jt._block_apply(
            p, x_, b, jcfg, shape, ShardCtx(), True, TOTAL))(jb, x)
        tx, _, tc = tt._block_apply(tb, torch_of(x), blk, cfg, True, TOTAL)
        assert _scaled_gap(jx, tx) < 1e-5, (blk.mixer, "prefill")
        for j, t in zip(jc, tc):
            assert _scaled_gap(j, t) < 1e-5, (blk.mixer, "prefill cache")
        x = jx
        caches.append(jc)
    for t in range(PROMPT, TOTAL):
        x = jt._frontend(jp, jcfg, {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        for n, (jb, tb, jblk, blk) in enumerate(blocks):
            jx, jc = jax.jit(lambda p, x_, c, s, b=jblk: jt._block_decode(
                p, x_, c, s, b, jcfg, ShardCtx()))(jb, x, caches[n], jnp.int32(t))
            tc = type(caches[n])(*(torch_of(a) for a in caches[n]))
            tx, tc = tt._block_decode(tb, torch_of(x), tc, t, blk, cfg)
            assert _scaled_gap(jx, tx) < 1e-5, (blk.mixer, t)
            for j, got in zip(jc, tc):
                assert _scaled_gap(j, got) < 1e-5, (blk.mixer, t, "cache")
            x, caches[n] = jx, jc


def test_recurrentgemma_decode_blocks_depart_only_in_rounding():
    """``test_decode_matches_teacher_forced_forward[recurrentgemma-9b]``
    block by block, on that test's own draw (the port alone, f32).  Each
    block (the (R, R, L) periods and the postlude), given the forward's
    input to it at every step, decodes the forward's output within 1e-5 of
    its scale; and each block's forward over the decode's own inputs gives
    the decode's outputs as closely.  So no block computes another
    function: the whole model's departure at t = 2 is rounding (the
    RG-LRU step against the scan's odd/even order, a few 1e-7 of scale)
    that the first local-attention block amplifies most at that step."""
    from repro_torch.models import transformer as tt
    _, cfg = _cfgs("recurrentgemma-9b")
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(1), "cpu",
                     dtype=torch.float32)
    T = 16
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    blocks = [(tt._period(tp["body"][j], i), blk)
              for i in range(cfg.n_periods) for j, blk in enumerate(cfg.pattern)]
    blocks += list(zip(tp["postlude"], cfg.postlude))
    assert not cfg.prelude

    def fresh_caches():
        c = init_cache(cfg, 2, T, dtype=torch.float32, device="cpu")
        return [tt._period(c["body"][j], i) for i in range(cfg.n_periods)
                for j in range(len(cfg.pattern))] + c["postlude"]

    def gap(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    with torch.no_grad():
        # the forward, block by block
        x = tt._frontend(tp, cfg, {"tokens": tokens})
        f_in, f_out = [], []
        for p, blk in blocks:
            f_in.append(x)
            x, _, _ = tt._block_apply(p, x, blk, cfg)
            f_out.append(x)
        # each block decoding the forward's own inputs
        caches = fresh_caches()
        for t in range(T):
            for n, (p, blk) in enumerate(blocks):
                y, caches[n] = tt._block_decode(p, f_in[n][:, t:t + 1], caches[n], t,
                                                blk, cfg)
                assert gap(y[:, 0], f_out[n][:, t]) < 1e-5, (n, blk.mixer, t)
        # the decode chain, and each block's forward over its inputs
        caches = fresh_caches()
        d_in = [[] for _ in blocks]
        d_out = [[] for _ in blocks]
        for t in range(T):
            x = tt._frontend(tp, cfg, {"tokens": tokens[:, t:t + 1]})
            for n, (p, blk) in enumerate(blocks):
                d_in[n].append(x)
                x, caches[n] = tt._block_decode(p, x, caches[n], t, blk, cfg)
                d_out[n].append(x)
        d_in = [torch.cat(v, 1) for v in d_in]
        d_out = [torch.cat(v, 1) for v in d_out]
        for n, (p, blk) in enumerate(blocks):
            y, _, _ = tt._block_apply(p, d_in[n], blk, cfg)
            assert gap(y, d_out[n]) < 1e-5, (n, blk.mixer)
    # where it departs at t = 2: the gain of each block along the chain
    t = 2
    gains = [gap(d_out[n][:, t], f_out[n][:, t])
             / max(gap(d_in[n][:, t], f_in[n][:, t]), 1e-30)
             for n in range(1, len(blocks))]
    first_local = [blk.mixer for _, blk in blocks].index("local")
    assert gap(d_in[first_local][:, t], f_in[first_local][:, t]) < 1e-6
    assert 1 + int(np.argmax(gains)) == first_local and max(gains) > 5, gains


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
