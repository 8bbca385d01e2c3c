"""Marvel-Serve over the remaining mixers, on the CPU: a
``reduced_for_smoke`` recurrentgemma-9b (RG-LRU states and conv windows,
and local-attention ring caches) and deepseek-v2-lite-16b (MLA latent
caches, MoE FFNs) through ``MarvelClient.serving(..., device="cpu")``.

The pool must decode the reference's tokens with evictions that push
each conversation's cache to PMEM and resume it; a conversation
suspended and resumed must give the same tokens and byte-identical block
blobs as one never suspended; and a restart must re-adopt every session
and decode on as the uninterrupted run.  The recurrent and latent caches
are opaque leaves the pager stores whole (their ``RGLRUCache`` and
``MLACache`` nodes survive the flatten).  Parameters are drawn by the
reference, cast to f32 and carried across; prompts come from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import model_defs as jmodel_defs
from repro.models import reduced_for_smoke as jreduced
from repro_torch.configs import get_config
from repro_torch.models import (
    MLACache,
    RGLRUCache,
    from_jax_params,
    init_cache,
    reduced_for_smoke,
)
from repro_torch.models.attention import AttnCache
from repro_torch.serving import flatten_cache, unflatten_cache

ARCHS = ["recurrentgemma-9b", "deepseek-v2-lite-16b"]
PROMPT, MAX_TOKENS = 9, 6


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = jreduced(jget_config(arch)), reduced_for_smoke(get_config(arch))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0)))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, seed, n=PROMPT):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n)).astype(np.int32)


def _cluster(api, root, *, warm_pool):
    return api.ClusterConfig(
        name="serve-mixers",
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


def test_flatten_cache_keeps_the_mixer_cache_nodes(model):
    _, cfg, _, _ = model
    cache = init_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
    layers, treedef = flatten_cache(cache)
    back = unflatten_cache(treedef, layers)
    kinds = {type(c) for part in back.values() for c in part}
    want = {RGLRUCache, AttnCache} if cfg.rglru else {MLACache}
    assert kinds == want
    assert all(isinstance(l, (torch.Tensor, AttnCache)) for l in layers)
    again, _ = flatten_cache(back)
    assert len(again) == len(layers)
    assert all(a is b for a, b in zip(again, layers))


def test_pool_decodes_the_reference_tokens(tmp_path, model):
    """Three conversations over a warm pool of two, steps interleaved, so
    each eviction pushes a cache to PMEM and the next step resumes it:
    both packages give the same tokens."""
    streams, stats = {}, {}
    for name, api in (("jax", japi), ("torch", tapi)):
        with api.MarvelClient(_cluster(api, tmp_path / name, warm_pool=2)) as client:
            pool = _serve(api, client, model)
            convs = ["c0", "c1", "c2"]
            out = {c: [_tok(pool.start(c, _tokens(model[1], i)))]
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
    PMEM path re-adopts all three and decodes on as the uninterrupted run."""
    _, cfg, _, _ = model
    prompt = _tokens(cfg, 7)
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
        assert blobs_a and blobs_a.keys() == blobs_b.keys() and blobs_a == blobs_b
        client.runtime.commit_all()
        pool.pager.sync()
    with tapi.MarvelClient(_cluster(tapi, root, warm_pool=4)) as client:
        pool = _serve(tapi, client, model)
        assert pool.pager.recover() == 3
        layers, _ = pool.pager.load(pool._scoped("a"))
        want = flatten_cache(init_cache(cfg, 1, PROMPT + MAX_TOKENS,
                                        dtype=torch.float32, device="cpu"))[0]
        assert [type(l) for l in layers] == [type(w) for w in want]
        assert _tok(pool.step("a")) == stream["c"][5]
