"""The port's Mamba-2 slice against the reference package, on the CPU.

Parameters are drawn once by the reference (``init_params`` under a JAX
key) and carried across with ``from_jax_params``; token ids and inputs
come from numpy.  The SSD layer (prefill with its cache, then recurrent
decode steps), a ``reduced_for_smoke`` mamba2-2.7b (prefill and
teacher-forced decode logits, the cache tree's conv windows and states)
and the serving pool through ``MarvelClient.serving`` must match the
reference: 1e-4 with f32 weights (the same math summed in another order),
the same tokens, byte-identical paging.  The flattened cache tree keeps
its ``SSMCache`` nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.configs import get_config as jget_config
from repro.models import ShapeConfig
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import logits_fn as jlogits_fn
from repro.models import model_defs as jmodel_defs
from repro.models import reduced_for_smoke as jreduced
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import (
    SSMCache,
    decode_step,
    forward,
    from_jax_params,
    init_cache,
    logits_fn,
    reduced_for_smoke,
    ssm,
)
from repro_torch.models.convert import to_tensor
from repro_torch.serving import flatten_cache, unflatten_cache

ARCH = "mamba2-2.7b"
PROMPT, MAX_TOKENS = 21, 6  # a ragged prompt: chunk 16, so padding runs
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_for_smoke(get_config(ARCH))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0)))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n)).astype(np.int32)


# -- the layer -----------------------------------------------------------------

def test_ssm_apply_and_decode_match_reference(model):
    """One SSD layer: prefill with its cache, then recurrent steps that
    write the conv window and state into the cache they are given."""
    jcfg, cfg, _, _ = model
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jinit_params(jssm.ssm_defs(jcfg), jax.random.PRNGKey(1)))
    p = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    assert p["A_log"].dtype == torch.float32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    jout, jc = jssm.ssm_apply(jp, jnp.asarray(x[:, :16]), jcfg, collect_cache=True)
    out, c = ssm.ssm_apply(p, torch.from_numpy(x[:, :16]), cfg, collect_cache=True)
    _close(out, jout)
    assert isinstance(c, SSMCache)
    _close(c.conv, jc.conv)
    _close(c.state, jc.state)
    c = SSMCache(c.conv.clone(), c.state.clone())  # decode writes in place
    for t in range(16, 19):
        jo, jc = jssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        conv, state = c
        o, c = ssm.ssm_decode(p, torch.from_numpy(x[:, t:t + 1]), c, cfg)
        assert c.conv is conv and c.state is state
        _close(o, jo)
        _close(c.conv, jc.conv)
        _close(c.state, jc.state)


def test_defs_keep_the_reference_f32_leaves_bit_for_bit(model):
    jcfg, cfg, _, _ = model
    jp = jax.tree_util.tree_map(np.asarray, jinit_params(jmodel_defs(jcfg),
                                                         jax.random.PRNGKey(2)))
    tp = from_jax_params(jp, cfg, "cpu")
    for name in ("A_log", "Dskip", "dt_bias", "wx", "conv_w"):
        want = jp["body"][0]["mixer"][name]
        got = tp["body"][0]["mixer"][name]
        assert tuple(got.shape) == want.shape
        bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert bits.numpy().tobytes() == np.asarray(want).tobytes()
    assert tp["body"][0]["mixer"]["A_log"].dtype == torch.float32
    assert tp["body"][0]["mixer"]["wx"].dtype == torch.bfloat16


# -- the model -----------------------------------------------------------------

def test_prefill_and_decode_logits_and_caches_match_reference(model):
    jcfg, cfg, jp, tp = model
    tokens = np.concatenate([_tokens(cfg, 3, PROMPT + MAX_TOKENS),
                             _tokens(cfg, 4, PROMPT + MAX_TOKENS)])
    shape = ShapeConfig(name="t", kind="prefill", seq_len=PROMPT, global_batch=2,
                        q_chunk=4, kv_chunk=4, remat="none")
    jh, _, jc = jforward(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :PROMPT])},
                         shape, collect_cache=True, cache_len=PROMPT + MAX_TOKENS)
    th, _, tc = forward(tp, cfg, {"tokens": torch.from_numpy(tokens[:, :PROMPT])},
                        collect_cache=True, cache_len=PROMPT + MAX_TOKENS)
    _close(logits_fn(tp, cfg, th), jlogits_fn(jp, jcfg, jh))
    jstep = jax.jit(lambda p, tok, c, t: jdecode_step(p, jcfg, tok, c, t))
    for t in range(PROMPT, PROMPT + MAX_TOKENS):
        jl, jc = jstep(jp, jnp.asarray(tokens[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = decode_step(tp, cfg, torch.from_numpy(tokens[:, t:t + 1]), tc, t)
        _close(tl, jl)
    # the reference's cache layout: (n_periods, B, d_conv-1, convdim), (n_periods, B, H, P, N)
    body, jbody = tc["body"][0], jc["body"][0]
    assert isinstance(body, SSMCache)
    assert tuple(body.state.shape) == jbody.state.shape == (
        cfg.n_periods, 2, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
        cfg.ssm.d_state)
    assert body.state.dtype == torch.float32
    _close(body.conv, jbody.conv)
    _close(body.state, jbody.state)


def test_flatten_cache_keeps_ssm_cache_and_its_field_order(model):
    _, cfg, _, _ = model
    cache = init_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
    cache["body"][0].state.normal_()
    layers, treedef = flatten_cache(cache)
    body = cache["body"][0]
    assert len(layers) == 2
    assert layers[0] is body.conv and layers[1] is body.state  # field order
    back = unflatten_cache(treedef, layers)
    assert type(back["body"][0]) is SSMCache
    assert back["body"][0].state is body.state
    assert back["prelude"] == [] and back["postlude"] == []
    mixed = {"a": (torch.zeros(1), [SSMCache(torch.ones(1), torch.ones(2))])}
    layers, treedef = flatten_cache(mixed)
    back = unflatten_cache(treedef, layers)
    assert type(back["a"]) is tuple and type(back["a"][1][0]) is SSMCache


# -- serving -------------------------------------------------------------------

def _cluster(api, root, *, warm_pool):
    return api.ClusterConfig(
        name="serve-ssm",
        tiers=(api.TierSpec("dram"), api.TierSpec("pmem", path=str(root / "pmem"))),
        invokers=1, warm_pool=warm_pool, commit_every=1,
        journal="pmem", journal_path=str(root / "journal"),
        serving=api.ServingConfig(block_tokens=4, lossless=True),
    )


def _serve(api, client, model):
    jcfg, cfg, jp, tp = model
    if api is japi:
        return client.serving(jp, jcfg, prompt_len=PROMPT, max_tokens=MAX_TOKENS)
    return client.serving(tp, cfg, prompt_len=PROMPT, max_tokens=MAX_TOKENS,
                          device="cpu")


def _tok(fut):
    return int(np.asarray(fut.result()).reshape(-1)[0])


def _blobs(pool, conversation):
    prefix = pool.pager.session_prefix(pool._scoped(conversation))
    return {k[len(prefix):]: pool.pager.store.get(k)
            for k in sorted(pool.pager.store.keys(prefix))}


def test_pool_decodes_the_reference_tokens(tmp_path, model):
    """Three conversations over a warm pool of two, steps interleaved, so
    each eviction pushes a recurrent state to PMEM and the next step
    resumes it: both packages give the same tokens."""
    streams, stats = {}, {}
    for name, api in (("jax", japi), ("torch", tapi)):
        with api.MarvelClient(_cluster(api, tmp_path / name, warm_pool=2)) as client:
            pool = _serve(api, client, model)
            convs = ["c0", "c1", "c2"]
            out = {c: [_tok(pool.start(c, _tokens(model[1], i, PROMPT)))]
                   for i, c in enumerate(convs)}
            for _ in range(3):
                for c in convs:
                    out[c].append(_tok(pool.step(c)))
            streams[name], stats[name] = out, pool.stats()
    assert streams["torch"] == streams["jax"]
    assert stats["torch"]["demotions"] == stats["jax"]["demotions"] > 0
    assert stats["torch"]["resumes"] == stats["jax"]["resumes"]


def test_suspend_resume_is_lossless_and_a_restart_readopts(tmp_path, model):
    """'b' is suspended to PMEM and resumed midway, 'a' never is: the same
    tokens and byte-identical blobs.  Then a fresh client over the same
    PMEM path re-adopts both and decodes on as the uninterrupted run."""
    _, cfg, _, _ = model
    prompt = _tokens(cfg, 7, PROMPT)
    root = tmp_path / "serve"
    with tapi.MarvelClient(_cluster(tapi, root, warm_pool=4)) as client:
        pool = _serve(tapi, client, model)
        stream = {c: [_tok(pool.start(c, prompt))] for c in ("a", "b", "c")}
        for c in ("a", "b"):
            stream[c] += [_tok(pool.step(c)) for _ in range(2)]
        assert pool.suspend("b") and not pool.is_resident("b")
        assert pool.resume("b")
        for c in ("a", "b"):
            stream[c] += [_tok(pool.step(c)) for _ in range(2)]
        stream["c"] += [_tok(pool.step("c")) for _ in range(MAX_TOKENS - 1)]
        assert stream["a"] == stream["b"] == stream["c"][:5]
        blobs_a, blobs_b = _blobs(pool, "a"), _blobs(pool, "b")
        assert blobs_a.keys() == blobs_b.keys() and blobs_a == blobs_b
        assert len(blobs_a) == 3  # meta, conv window, state
        client.runtime.commit_all()
        pool.pager.sync()
    with tapi.MarvelClient(_cluster(tapi, root, warm_pool=4)) as client:
        pool = _serve(tapi, client, model)
        assert pool.pager.recover() == 3
        layers, _ = pool.pager.load(pool._scoped("a"))
        assert [l.dtype for l in layers] == [torch.float32, torch.float32]
        assert _tok(pool.step("a")) == stream["c"][5]

