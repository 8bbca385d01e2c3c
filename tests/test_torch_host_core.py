"""The port's host core against the reference: both packages run the same
sequence on the same inputs, and every compared value is equal.

The modules held here are the paper's own contribution, stateful
functions over a PMEM-backed tier stack: ``core/cluster.py``,
``core/dag.py``, ``core/dataflow.py``, ``core/scheduler.py``,
``core/journal.py``, ``core/gateway.py``, ``storage/hierarchy.py``,
``storage/faults.py``, ``storage/blockstore.py`` and
``storage/kvcache.py``.  The cases:

(a) a 4-node cluster WordCount (replication 2, blocks of 2048 B) with a
    node killed after 2 maps, as ``tests/test_cluster_faults.py`` runs it:
    the output bytes, the live nodes, ``under_replicated()`` and the
    report's integer fields;
(b) ``nodes=1`` sharded against the single stack, in each package: the
    output bytes and the report's counts;
(c) one sequence of puts, gets, demotions and promotions on a stack of
    DRAM over PMEM over modeled S3: every level's stats (wall seconds
    aside), the modeled seconds, placements and hit rates;
(d) a dataflow loop halted mid-run and resumed from its journal, and one
    crashed mid-superstep: the resumed iterations and the result bytes;
(e) a gateway session sequence through a warm pool smaller than the
    sessions: every result, the invoker each ran on, cold/warm flags,
    evictions and the warm set;
(f) a seeded fault-injecting tier under a write-through state cache: which
    operations failed, the torn batches' prefixes, what survived a crash.
"""

import dataclasses
import types

import numpy as np
import pytest

import repro.api as japi
import repro.core as jcore
import repro.core.mapreduce as jmapreduce
import repro.core.workloads as jworkloads
import repro.storage as jstorage
import repro_torch.api as tapi
import repro_torch.core as tcore
import repro_torch.core.mapreduce as tmapreduce
import repro_torch.core.workloads as tworkloads
import repro_torch.storage as tstorage

PKGS = {
    "jax": types.SimpleNamespace(api=japi, core=jcore, mr=jmapreduce, wl=jworkloads,
                                 storage=jstorage),
    "torch": types.SimpleNamespace(api=tapi, core=tcore, mr=tmapreduce, wl=tworkloads,
                                   storage=tstorage),
}


def _both(fn, *args) -> dict:
    return {name: fn(pkg, *args) for name, pkg in PKGS.items()}


def _corpus(n: int = 300) -> bytes:
    return b"\n".join(
        b"alpha beta gamma delta epsilon zeta word%d tail" % (i % 11)
        for i in range(n)
    )


def _read_parts(client, path: str, n: int) -> bytes:
    return b"".join(client.store.read(f"{path}/part_{p:04d}") for p in range(n))


def _ints(report) -> dict:
    """A report's integer (and bool) fields."""
    return {f.name: getattr(report, f.name) for f in dataclasses.fields(report)
            if isinstance(getattr(report, f.name), (int, bool))}


# -- (a) node loss mid-shuffle ------------------------------------------------------

def _cluster_kill(pkg, after: int, victim: str) -> dict:
    with pkg.api.MarvelClient(pkg.api.ClusterConfig(
            name="k", nodes=4, sharded=True, replication=2, block_size=2048)) as client:
        client.store.write("/in", _corpus(), record_delim=b"\n")
        killed = []

        def on_map_done(count):
            if count == after and not killed:
                killed.append(True)
                client.cluster.fail_node(victim)

        raw = client.cluster.run_mapreduce(pkg.mr.wordcount_job(4), "/in", "/out",
                                           on_map_done=on_map_done)
        return {"killed": killed, "out": _read_parts(client, "/out", 4),
                "live": sorted(n.node_id for n in client.cluster.live_nodes()),
                "under_replicated": client.store.under_replicated(),
                "mode": raw.mode, "report": _ints(raw)}


@pytest.mark.parametrize("after,victim", [(2, "n1"), (4, "n3")])
def test_cluster_node_loss_mid_shuffle_matches_reference(after, victim):
    got = _both(_cluster_kill, after, victim)
    assert got["torch"] == got["jax"]
    assert got["torch"]["killed"] and got["torch"]["out"]
    assert len(got["torch"]["live"]) == 3 and victim not in got["torch"]["live"]
    assert got["torch"]["under_replicated"] == []


# -- (b) nodes=1 sharded == single stack ------------------------------------------

def _nodes1(pkg, sharded: bool) -> dict:
    with pkg.api.MarvelClient(pkg.api.ClusterConfig(
            name="g", nodes=1, replication=1, sharded=sharded,
            block_size=2048)) as client:
        client.store.write("/in", _corpus(), record_delim=b"\n")
        handle = client.mapreduce(pkg.mr.wordcount_job(4), "/in", "/out")
        rep = handle.report
        return {"out": _read_parts(client, "/out", 4),
                "report": {f: getattr(rep, f) for f in ("tasks", "resumed_tasks",
                                                        "iterations", "kind")},
                "mode": rep.extra.get("mode"), "tiers": sorted(rep.tiers)}


def test_nodes1_sharded_is_the_single_stack_in_both_packages():
    runs = {s: _both(_nodes1, s) for s in (False, True)}
    for name in PKGS:
        assert runs[True][name] == runs[False][name]
    assert runs[True]["torch"] == runs[True]["jax"]
    assert runs[True]["torch"]["out"]


# -- (c) the tier hierarchy --------------------------------------------------------

def _io(stats) -> tuple:
    """A ``TierStats``'s fields, wall seconds aside (each package has its
    own dataclass)."""
    return dataclasses.astuple(dataclasses.replace(stats, wall_seconds=0.0))


def _hierarchy(pkg, root, eviction: str, promote_after: int) -> dict:
    s = pkg.storage
    store = s.TieredStore(
        [s.TierLevel("dram", s.DramTier(), 6000),
         s.TierLevel("pmem", s.PmemTier(str(root / pkg.api.__name__)), 20000),
         s.TierLevel("s3", s.SimulatedTier(s.S3_SPEC))],
        policy=s.PlacementPolicy(eviction=eviction, promote_after=promote_after),
        name="hc")
    rng = np.random.default_rng(11)
    blobs = {f"k{i:02d}": rng.bytes(int(rng.integers(400, 3000))) for i in range(14)}
    events = []
    for k, v in blobs.items():
        store.put(k, v)
    store.pin("k00")
    for i in rng.integers(0, 14, 60):
        k = f"k{i:02d}"
        events.append(("get", k, store.get(k) == blobs[k], store.level_of(k)))
    for k in ("k03", "k00", "k07", "k07"):
        events.append(("demote", k, store.demote(k), store.level_of(k)))
    blobs["k05"] = rng.bytes(2500)
    store.put("k05", blobs["k05"])
    store.delete("k09")
    events.append(("get", "k07", store.get("k07") == blobs["k07"], store.level_of("k07")))
    store.unpin("k00")
    out = {
        "events": events,
        "levels": {k: store.level_of(k) for k in blobs},
        "keys": sorted(store.keys()),
        "stats": {name: _io(st) for name, st in store.stats_by_level().items()},
        "physical": _io(store.physical_stats()),
        "logical": _io(store.stats),
        "hit_rates": store.hit_rates(),
        "moves": (store.promotions, store.demotions),
    }
    store.close()
    return out


@pytest.mark.parametrize("eviction,promote_after", [("lru", 2), ("lru", 1), ("cost", 2)])
def test_hierarchy_sequence_matches_reference(tmp_path, eviction, promote_after):
    got = _both(_hierarchy, tmp_path, eviction, promote_after)
    assert got["torch"] == got["jax"]
    assert got["torch"]["moves"][0] > 0 and got["torch"]["moves"][1] > 0
    assert got["torch"]["stats"]["s3"][4] > 0  # modeled seconds on the home


# -- (d) dataflow resume -----------------------------------------------------------

def _sched(pkg):
    return pkg.core.Scheduler(["w0", "w1", "w2", "w3"], speculation_factor=None)


def _pagerank_resume(pkg) -> dict:
    wl, s = pkg.wl, pkg.storage
    src, dst = wl.pagerank_graph(120, 700, seed=5)
    golden = wl.pagerank_loop("pr", s.DramTier(), src, dst, 120, n_parts=3, tol=0.0,
                              max_iterations=7, scheduler=_sched(pkg))
    state, journal = s.DramTier(), s.StateCache()
    first = wl.pagerank_loop("pr", state, src, dst, 120, n_parts=3, tol=0.0,
                             max_iterations=7, journal=journal, halt_after=4,
                             scheduler=_sched(pkg))
    second = wl.pagerank_loop("pr", state, src, dst, 120, n_parts=3, tol=0.0,
                              max_iterations=7, journal=journal, scheduler=_sched(pkg))
    return {"first": (first.report.iterations, first.report.converged),
            "resumed": second.report.resumed_iterations,
            "last": second.report.last_iteration,
            "bytes": second.rank_bytes, "golden": golden.rank_bytes}


def _hash_loop_crash(pkg) -> dict:
    """The loop halted after 3 supersteps, partial blobs of superstep 3
    left behind (a crash mid-superstep), then resumed."""
    import hashlib

    core, s = pkg.core, pkg.storage
    state, journal = s.DramTier(), s.StateCache()

    def init(ctx):
        ctx.write("x", b"seed")

    def superstep(ctx):
        def run(_tc):
            prev = ctx.read("x")
            ctx.write("x", hashlib.blake2b(prev + str(ctx.iteration).encode(),
                                           digest_size=16).digest())

        return [core.Stage("s", [core.StageTask("t", run)])]

    kw = dict(state=state, journal=journal, max_iterations=5, pin_state=False)
    core.run_loop("hash", init, superstep, lambda ctx: False, scheduler=_sched(pkg),
                  halt_after=3, **kw)
    state.put("df/hash/state/it00003/x", b"partial-garbage")
    state.put("df/hash/state/it00003/orphan", b"never-rewritten")
    res = core.run_loop("hash", init, superstep, lambda ctx: False,
                        scheduler=_sched(pkg), **kw)
    return {"resumed": res.resumed_iterations, "last": res.last_iteration,
            "orphan": state.contains("df/hash/state/it00003/orphan"),
            "x": state.get("df/hash/state/it00005/x")}


def test_dataflow_loop_resume_matches_reference():
    got = _both(_pagerank_resume)
    assert got["torch"] == got["jax"]
    assert got["torch"]["resumed"] == got["torch"]["first"][0] == 4
    assert got["torch"]["bytes"] == got["torch"]["golden"]


def test_dataflow_crash_mid_superstep_matches_reference():
    got = _both(_hash_loop_crash)
    assert got["torch"] == got["jax"]
    assert got["torch"]["resumed"] == 3 and not got["torch"]["orphan"]


# -- (e) the gateway's warm pool ---------------------------------------------------

def _gateway(pkg, invokers: int, warm_pool: int) -> dict:
    core, s = pkg.core, pkg.storage
    rt = core.FunctionRuntime(cache=s.StateCache(), commit_every=1)
    rt.register(core.StatefulFunction("counter", lambda st, x: (st + x, st + x),
                                      init=lambda: 0, jit=False))
    gw = core.Gateway(rt, invokers=invokers, warm_pool=warm_pool)
    try:
        order = [f"s{i}" for i in (0, 1, 2, 0, 3, 3, 1, 4, 5, 0, 2, 5, 5, 1)]
        results = [gw.invoke("counter", session=sess, x=i + 1)
                   for i, sess in enumerate(order)]
        results += [gw.invoke("counter", session=f"s{i}", x=0) for i in range(6)]
        st = gw.stats()
        return {"results": results,
                "records": [(r.session, r.seq, r.cold, r.warm, r.invoker) for r in rt.log],
                "warm": sorted(gw.warm_contexts()),
                "stats": (st.submitted, st.completed, st.rejected, st.evictions,
                          st.warm_hits, st.cold_starts),
                "states": [rt.peek_state("counter", f"s{i}") for i in range(6)]}
    finally:
        gw.close()


@pytest.mark.parametrize("invokers,warm_pool", [(1, 2), (2, 2), (3, 4)])
def test_gateway_warm_pool_eviction_matches_reference(invokers, warm_pool):
    got = _both(_gateway, invokers, warm_pool)
    assert got["torch"] == got["jax"]
    assert got["torch"]["stats"][3] > 0  # evictions
    assert len(got["torch"]["warm"]) <= warm_pool


# -- (f) injected faults under a write-through state cache ------------------------

def _faults(pkg, root) -> dict:
    s = pkg.storage
    faulty = s.FaultInjectingTier(s.PmemTier(str(root / pkg.api.__name__)), seed=3,
                                  put_error_rate=0.2, get_error_rate=0.2,
                                  torn_put_many_rate=0.5, schedule=[("put", 1)])
    cache = s.StateCache(write_through=faulty)
    rng = np.random.default_rng(4)
    events = []
    for i in range(30):
        key = f"app/s{i % 7}"
        try:
            if i % 5 == 4:
                cache.put_many({f"app/batch{i}/b{j}": rng.bytes(64) for j in range(4)})
            else:
                cache.put(key, rng.bytes(int(rng.integers(16, 256))))
            events.append(("ok", i))
        except s.TornWriteError as e:
            events.append(("torn", i, e.landed, e.total))
        except s.InjectedIOError as e:
            events.append(("io", i, str(e)))
    faulty.heal()
    cache.crash()
    survived = {}
    for k in sorted(faulty.keys("app/")):
        survived[k] = cache.get(k)
    return {"events": events, "injected": dict(faulty.injected),
            "survived": survived}


def test_fault_injection_under_the_state_cache_matches_reference(tmp_path):
    got = _both(_faults, tmp_path)
    assert got["torch"] == got["jax"]
    kinds = {e[0] for e in got["torch"]["events"]}
    assert {"ok", "torn", "io"} <= kinds and got["torch"]["survived"]
