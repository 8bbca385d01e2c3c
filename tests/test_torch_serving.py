"""The port's Marvel-Serve slice against the reference package, on the CPU.

The KV pager's placement transitions (create / per-step write-back /
demote / resume / crash-recover) on a hand-built tier stack; the block
blobs both packages write for the same layers; a session paged by the
reference, re-adopted by the port after a restart over the same PMEM
path, continuing with the reference's logits and tokens; and the whole
serving pool through ``MarvelClient.serving`` decoding the reference's
tokens, int8 demotion included.  Parameters are drawn by the reference
and carried across with ``from_jax_params``; prompts come from numpy.
"""

import shutil

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
from repro.models.attention import AttnCache as JAttnCache
from repro.serving import KVPager as JKVPager
from repro.serving import unflatten_cache as junflatten
from repro.storage import DramTier as JDramTier
from repro.storage import PlacementPolicy as JPlacementPolicy
from repro.storage import StateCache as JStateCache
from repro.storage import TieredStore as JTieredStore
from repro.storage import TierLevel as JTierLevel
from repro_torch.configs import get_config
from repro_torch.models import decode_step, from_jax_params, reduced_for_smoke
from repro_torch.models.attention import AttnCache
from repro_torch.models.quant_cache import QuantAttnCache
from repro_torch.serving import KVPager, unflatten_cache
from repro_torch.storage import (
    DramTier,
    PlacementPolicy,
    StateCache,
    TieredStore,
    TierLevel,
    serde,
)

PROMPT, MAX_TOKENS = 8, 8


class _DurableDram(DramTier):
    """In-memory PMEM stand-in: survives `crash()`."""

    name = "fakepmem"
    persistent = True


class _JDurableDram(JDramTier):
    name = "fakepmem"
    persistent = True


def _store(pkg="torch"):
    """Two-level stack: capped DRAM over an unbounded durable home."""
    if pkg == "torch":
        dram, home, level, policy, cache, tiered = (
            DramTier, _DurableDram, TierLevel, PlacementPolicy, StateCache,
            TieredStore)
    else:
        dram, home, level, policy, cache, tiered = (
            JDramTier, _JDurableDram, JTierLevel, JPlacementPolicy,
            JStateCache, JTieredStore)
    return tiered(
        [level("dram", dram(), 1 << 20), level("pmem", home())],
        policy=policy(write_back=False, promote_after=1, flush_interval=0.002),
        journal=cache(memory=home()),
        name=f"serve-test-{pkg}",
    )


def _arrays(rng, n=2, B=1, S=8, Kv=2, dh=16):
    return [(rng.standard_normal((B, S, Kv, dh)).astype(np.float32),
             rng.standard_normal((B, S, Kv, dh)).astype(np.float32))
            for _ in range(n)]


def _layers(arrays):
    return [AttnCache(torch.from_numpy(k), torch.from_numpy(v)) for k, v in arrays]


def _assert_layers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        for gf, wf in zip(g, w):
            assert gf.dtype == wf.dtype and torch.equal(gf, wf)


# -- the pager's placement transitions ----------------------------------------

def test_create_write_load_and_per_step_write_back(rng):
    pager = KVPager(_store(), device="cpu", block_tokens=4, lossless=True)
    layers = _layers(_arrays(rng))
    pager.create("s0", layers, t=3)
    got, t = pager.load("s0")
    assert t == 3
    _assert_layers_equal(got, layers)
    assert sorted(pager.store.keys("kv/s0/")) == [
        "kv/s0/L000/B00000", "kv/s0/L000/B00001",
        "kv/s0/L001/B00000", "kv/s0/L001/B00001", "kv/s0/meta",
    ]
    before = pager.stats.blocks_written
    new_layers = _layers(_arrays(rng))
    pager.write("s0", new_layers, t=4)
    assert pager.stats.blocks_written == before + 2  # one dirty block a layer


def test_lossless_demote_resume_is_byte_identical(rng):
    store = _store()
    pager = KVPager(store, device="cpu", block_tokens=4, lossless=True)
    layers = _layers(_arrays(rng))
    pager.create("s0", layers, t=5)
    blobs = {k: store.get(k) for k in store.keys("kv/s0/")}
    assert pager.demote("s0")
    assert all(store.level_of(k) == "pmem" for k in store.keys("kv/s0/"))
    assert {k: store.get(k) for k in store.keys("kv/s0/")} == blobs
    got, t = pager.load("s0")  # demand-fault resume
    assert t == 5 and pager.stats.demand_faults == 1 and pager.is_hot("s0")
    _assert_layers_equal(got, layers)


def test_int8_demotion_matches_the_reference_pager(rng):
    """The same layers demoted by both packages' pagers: the int8 blocks
    hold the same bytes, and both resume as int8 caches."""
    arrays = _arrays(rng)
    tpager = KVPager(_store(), device="cpu", block_tokens=4)
    jpager = JKVPager(_store("jax"), block_tokens=4)
    tpager.create("s0", _layers(arrays), t=6)
    jpager.create("s0", [JAttnCache(jnp.asarray(k), jnp.asarray(v))
                         for k, v in arrays], t=6)
    assert tpager.demote("s0") and jpager.demote("s0")
    keys = sorted(tpager.store.keys("kv/s0/"))
    assert keys == sorted(jpager.store.keys("kv/s0/"))
    for key in keys:
        if key.endswith("meta"):
            assert tpager.store.get(key) == jpager.store.get(key)
            continue
        mine = serde.loads(tpager.store.get(key))
        theirs = serde.loads(jpager.store.get(key))
        assert mine.keys() == theirs.keys() == {"k_q", "v_q", "k_s", "v_s"}
        for name in mine:
            a, b = (torch.from_numpy(np.array(x)) if not isinstance(x, torch.Tensor)
                    else x for x in (mine[name], theirs[name]))
            assert a.dtype == b.dtype and torch.equal(a, b), (key, name)
    got, _ = tpager.load("s0")
    assert all(isinstance(layer, QuantAttnCache) for layer in got)


def test_resumed_layers_land_on_the_pager_device(rng):
    """A meta device stands in for the card: blocks come back from the
    tiers as host arrays and must be placed on the decoder's device."""
    store = _store()
    pager = KVPager(store, device="meta", block_tokens=4, lossless=True)
    pager.create("s0", _layers(_arrays(rng)), t=2)
    pager.demote("s0")
    got, _ = pager.load("s0")
    assert all(f.device.type == "meta" for layer in got for f in layer)


def test_crash_recover_adopts_sessions(rng):
    store = _store()
    pager = KVPager(store, device="cpu", block_tokens=4, lossless=True)
    layers = _layers(_arrays(rng))
    pager.create("s0", layers, t=7)
    pager.create("s1", _layers(_arrays(rng)), t=1)
    pager.sync()
    pager.crash()
    store.crash()
    store.recover()
    assert pager.sessions == []
    assert pager.recover() == 2
    assert pager.paged_sessions == 2  # adopted cold
    got, t = pager.load("s0")
    assert t == 7
    _assert_layers_equal(got, layers)


# -- the serving pool through the façade ----------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("qwen2.5-3b"))
    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0)))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _prompt(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (1, PROMPT)).astype(np.int32)


def _cluster(api, root, *, lossless=True, warm_pool=4):
    return api.ClusterConfig(
        name="serve-test",
        tiers=(api.TierSpec("dram", capacity_bytes=8 << 20),
               api.TierSpec("pmem", path=str(root / "pmem"))),
        invokers=1, warm_pool=warm_pool, commit_every=1,
        journal="pmem", journal_path=str(root / "journal"),
        serving=api.ServingConfig(block_tokens=4, lossless=lossless),
    )


def _serve(api, client, model):
    jcfg, cfg, jp, tp = model
    if api is japi:
        return client.serving(jp, jcfg, prompt_len=PROMPT, max_tokens=MAX_TOKENS)
    return client.serving(tp, cfg, prompt_len=PROMPT, max_tokens=MAX_TOKENS,
                          device="cpu")


def _tok(fut):
    return int(np.asarray(fut.result()).reshape(-1)[0])


@pytest.mark.parametrize("lossless", [True, False])
def test_pool_decodes_the_reference_tokens(tmp_path, model, lossless):
    """Three conversations over a warm pool of two, steps interleaved so
    evictions demote (to int8 unless lossless) and resumes decode from
    the demoted cache: both packages give the same tokens."""
    streams, stats = {}, {}
    for name, api in (("jax", japi), ("torch", tapi)):
        cfg = _cluster(api, tmp_path / name, lossless=lossless, warm_pool=2)
        with api.MarvelClient(cfg) as client:
            pool = _serve(api, client, model)
            convs = ["c0", "c1", "c2"]
            out = {c: [_tok(pool.start(c, _prompt(model[1], i)))]
                   for i, c in enumerate(convs)}
            for _ in range(3):
                for c in convs:
                    out[c].append(_tok(pool.step(c)))
            streams[name], stats[name] = out, pool.stats()
    assert streams["torch"] == streams["jax"]
    assert stats["torch"]["demotions"] == stats["jax"]["demotions"] > 0
    assert stats["torch"]["quantized_blocks"] == stats["jax"]["quantized_blocks"]
    assert (stats["torch"]["quantized_blocks"] > 0) == (not lossless)


def test_port_readopts_a_session_the_reference_paged(tmp_path, model):
    """The reference serves a conversation and stops; the port restarts
    over a copy of the same PMEM tier and journal, re-adopts the session
    and continues it exactly as the reference does."""
    jcfg, cfg, jp, tp = model
    with japi.MarvelClient(_cluster(japi, tmp_path / "orig")) as client:
        pool = _serve(japi, client, model)
        toks = [_tok(pool.start("c0", _prompt(cfg, 0)))]
        toks += [_tok(pool.step("c0")) for _ in range(2)]
        client.runtime.commit_all()
        pool.pager.sync()
    shutil.copytree(tmp_path / "orig", tmp_path / "jax")
    shutil.copytree(tmp_path / "orig", tmp_path / "torch")
    nxt, logits = {}, {}
    for name, api in (("jax", japi), ("torch", tapi)):
        with api.MarvelClient(_cluster(api, tmp_path / name)) as client:
            pool = _serve(api, client, model)
            assert pool.pager.recover() == 1
            sid = pool._scoped("c0")
            layers, t = pool.pager.load(sid)
            assert t == PROMPT + 2  # the prefill's step and two more
            tok = np.asarray([[toks[-1]]], np.int32)
            if api is japi:
                cache = junflatten(pool.decoder._treedef, layers)
                lg, _ = pool.decoder._decode(jp, jnp.asarray(tok), cache,
                                             jnp.int32(t + 1))
                logits[name] = np.asarray(lg)
            else:
                copies = [AttnCache(l.k.clone(), l.v.clone()) for l in layers]
                cache = unflatten_cache(pool.decoder._treedef, copies)
                lg, _ = decode_step(tp, cfg, torch.from_numpy(tok), cache, t + 1)
                logits[name] = lg.numpy()
            nxt[name] = [_tok(pool.step("c0")) for _ in range(3)]
    np.testing.assert_allclose(logits["torch"], logits["jax"], atol=1e-4, rtol=1e-4)
    assert nxt["torch"] == nxt["jax"]


def test_serving_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch, model):
    _, cfg, _, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tapi.MarvelClient(tapi.ClusterConfig()) as client:
        with pytest.raises(tapi.ConfigError, match="device='cpu'"):
            client.serving(tp, cfg, prompt_len=PROMPT, max_tokens=MAX_TOKENS)
        pool = client.serving(tp, cfg, prompt_len=PROMPT, max_tokens=MAX_TOKENS,
                              device="cpu")
        assert pool.pager.device == torch.device("cpu")


def test_serving_rejects_sharded_client(model):
    _, cfg, _, tp = model
    with tapi.MarvelClient(tapi.ClusterConfig(name="x", sharded=True,
                                              nodes=2)) as client:
        with pytest.raises(tapi.ConfigError):
            client.serving(tp, cfg, prompt_len=4, max_tokens=2, device="cpu")


def test_suspend_resume_and_load_snapshot(tmp_path, model):
    _, cfg, _, _ = model
    with tapi.MarvelClient(_cluster(tapi, tmp_path, warm_pool=3)) as client:
        pool = _serve(tapi, client, model)
        convs = [f"c{i}" for i in range(5)]
        for i, c in enumerate(convs):
            pool.start(c, _prompt(cfg, i)).result()
        assert pool.stats()["demotions"] > 0  # warm_pool=3 < 5 conversations
        snap = client.gateway.load_snapshot()
        assert snap.resident_sessions + snap.paged_sessions == 5
        pool.step("c0").result()
        assert pool.is_resident("c0")
        assert pool.suspend("c0") and not pool.is_resident("c0")
        assert pool.resume("c0")
        assert pool.step("c0").result().shape == (1, 1)
