"""The port's autoscaler against the reference, and on a real port client.

``PolicyController.decide`` must give the reference's targets over any
snapshot stream; the reference's fluid-queue step script must give the
same pool-size sequence in both packages (``before=1, after=20``
included, where the reference's own convergence property fails: this
asserts equality with the reference, not convergence); ``Autoscaler``
action logs over scripted fake gateways must be equal.  Then the
reference's real-client cases run on the port, a sharded port client's
autoscaler is checked for its node actuators, and a CPU ``ServingPool``
replays a short trace under the autoscaler with several invokers and
must decode the tokens of a sequential pass.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import repro.core.autoscale as jas
import repro.core.gateway as jgateway
import repro_torch.core.autoscale as tas
import repro_torch.core.gateway as tgateway
from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
from repro_torch.configs import get_config
from repro_torch.core.loadgen import (
    BurstSpec,
    OpSpec,
    TraceSpec,
    generate_trace,
    replay,
)
from repro_torch.core.stateful import StatefulFunction
from repro_torch.models import init_params, model_defs, reduced_for_smoke
from tests.hypothesis_compat import given, nightly_examples, settings, st

PACKAGES = {"jax": (jas, jgateway), "torch": (tas, tgateway)}


def _snap(gateway, queue=0, inflight=0, invokers=1):
    return gateway.LoadSnapshot(
        queue_depth=queue, queue_per_stripe=[queue], inflight=inflight,
        invokers=invokers, warm_hits=0, cold_starts=0, rejected=0,
        wait_p99_ms=0.0,
    )


class FakeGateway:
    """Just enough surface for the Autoscaler: snapshot + actuators, the
    snapshot of the package under test."""

    def __init__(self, gateway, invokers=1, queue=0, inflight=0):
        self.gateway = gateway
        self.invokers = invokers
        self.queue = queue
        self.inflight = inflight
        self.warm_pool = 64
        self.scale_calls = []

    def load_snapshot(self):
        return _snap(self.gateway, self.queue, self.inflight, self.invokers)

    def scale_to(self, n: int) -> None:
        self.scale_calls.append(n)
        self.invokers = n


# -- the pure decision rule ------------------------------------------------------

SPEC_KNOBS = st.tuples(
    st.integers(min_value=1, max_value=3),  # min_invokers
    st.integers(min_value=0, max_value=8),  # max_invokers - min_invokers
    st.integers(min_value=1, max_value=6),  # target_per_invoker
    st.sampled_from([0.0, 0.5, 2.0]),  # up_cooldown_s
    st.sampled_from([0.0, 1.0, 3.0]),  # down_cooldown_s
)


def _policy(autoscale, knobs):
    lo, span, target, up, down = knobs
    return autoscale.PolicySpec(min_invokers=lo, max_invokers=lo + span,
                                target_per_invoker=target, up_cooldown_s=up,
                                down_cooldown_s=down)


@settings(max_examples=nightly_examples(40), deadline=None)
@given(
    SPEC_KNOBS,
    st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=80),  # queue depth
            st.integers(min_value=0, max_value=40),  # inflight
            st.integers(min_value=1, max_value=12),  # invokers
            st.sampled_from([0.0, 0.25, 1.0, 2.5]),  # time step
        ),
        min_size=1,
        max_size=40,
    ),
)
def test_decide_equals_reference_over_snapshot_streams(knobs, stream):
    targets = {}
    for name, (autoscale, gateway) in PACKAGES.items():
        ctl = autoscale.PolicyController(_policy(autoscale, knobs))
        now, out = 0.0, []
        for queue, inflight, invokers, dt in stream:
            now += dt
            target = ctl.decide(_snap(gateway, queue, inflight, invokers),
                                invokers, now)
            if target != invokers:
                ctl.note_action(now, scaled_up=target > invokers)
            out.append(target)
        targets[name] = out
    assert targets["torch"] == targets["jax"]


def test_spec_clamp_and_spec_with_equal_reference():
    for autoscale in (jas, tas):
        spec = autoscale.PolicySpec(min_invokers=2, max_invokers=5)
        assert [spec.clamp(n) for n in range(8)] == [2, 2, 2, 3, 4, 5, 5, 5]
    assert tas._spec_with(None) == tas.PolicySpec()
    assert (tas._spec_with(tas.PolicySpec(max_invokers=3), min_invokers=2)
            == tas.PolicySpec(min_invokers=2, max_invokers=3))


# -- the reference's fluid-queue step script ----------------------------------------

def _step_sizes(autoscale, gateway, before: int, after: int):
    """The reference's step-load script: each tick serves ``invokers *
    target_per_invoker`` requests, the backlog carries over."""
    spec = autoscale.PolicySpec(min_invokers=1, max_invokers=50,
                                target_per_invoker=4, down_cooldown_s=2.0)
    gw = FakeGateway(gateway, invokers=1)
    auto = autoscale.Autoscaler({"n0": gw}, spec, interval_s=1.0)
    queue, sizes, queues = 0, [], []
    for t in range(40):
        arrivals = before if t < 2 else after
        capacity = gw.invokers * spec.target_per_invoker
        served = min(queue + arrivals, capacity)
        queue = queue + arrivals - served
        gw.queue, gw.inflight = queue, served
        auto.tick(float(t))
        sizes.append(gw.invokers)
        queues.append(queue)
    return sizes, queues, auto.actions


def test_step_load_sequence_equals_reference_at_its_failing_example():
    """``before=1, after=20`` is the input on which the reference's
    convergence property fails; the port gives the same sequence."""
    got = _step_sizes(tas, tgateway, 1, 20)
    assert got == _step_sizes(jas, jgateway, 1, 20)
    sizes, queues, _ = got
    # the pool settles at 5 invokers (capacity 20 = the arrivals), so the
    # backlog of 16 never drains: the property's `queue == 0` fails
    assert set(sizes[2:]) == {5} and queues[-1] == 16


@settings(max_examples=nightly_examples(15), deadline=None)
@given(
    st.integers(min_value=1, max_value=10),
    st.integers(min_value=1, max_value=30),
)
def test_step_load_sequence_equals_reference(before, after):
    assert (_step_sizes(tas, tgateway, before, after)
            == _step_sizes(jas, jgateway, before, after))


# -- the loop and its actuators over scripted fake gateways ------------------------

def _script_scale_up_down(autoscale, gateway):
    spec = autoscale.PolicySpec(min_invokers=1, max_invokers=8,
                                target_per_invoker=4, warm_pool_per_invoker=32,
                                down_cooldown_s=1.0)
    gw = FakeGateway(gateway, invokers=1)
    auto = autoscale.Autoscaler({"n0": gw}, spec, interval_s=0.5)
    script = [(0.0, 12, 0), (0.2, 30, 6), (0.5, 30, 6), (1.0, 0, 9),
              (1.5, 0, 1), (2.0, 0, 0), (2.2, 0, 0), (2.5, 5, 2), (3.0, 40, 2),
              (3.5, 0, 0), (4.5, 0, 0), (5.5, 0, 0), (6.5, 0, 0), (7.5, 0, 0)]
    fired = []
    for now, queue, inflight in script:
        gw.queue, gw.inflight = queue, inflight
        fired.append(auto.maybe_tick(now))
    return auto, {"fired": fired, "scale_calls": gw.scale_calls,
                  "warm_pool": gw.warm_pool}


def _script_node_join(autoscale, gateway):
    gws = {"n0": FakeGateway(gateway, invokers=2, queue=50)}
    added = []

    def add_node():
        nid = f"n{len(gws)}"
        gws[nid] = FakeGateway(gateway, invokers=2, queue=50)
        added.append(nid)
        return nid

    spec = autoscale.PolicySpec(min_invokers=1, max_invokers=2,
                                target_per_invoker=4, max_nodes=3,
                                node_up_patience=2)
    auto = autoscale.Autoscaler(lambda: gws, spec, interval_s=1.0,
                                add_node=add_node)
    for t in range(7):
        auto.tick(float(t))
    return auto, {"added": added}


def _script_node_leave(autoscale, gateway):
    gws = {nid: FakeGateway(gateway) for nid in ("n0", "n1", "n2")}
    removed = []

    def remove_node(nid):
        removed.append(nid)
        del gws[nid]

    spec = autoscale.PolicySpec(min_invokers=1, max_invokers=2,
                                target_per_invoker=4, min_nodes=1, max_nodes=3,
                                node_down_patience=2)
    auto = autoscale.Autoscaler(lambda: gws, spec, interval_s=1.0,
                                remove_node=remove_node)
    for t in range(3):  # n2 (the highest id) leaves at the second tick
        auto.tick(float(t))
    gws["n1"].inflight = 3  # busy again: its idle clock restarts
    auto.tick(3.0)
    gws["n1"].inflight = 0
    for t in range(4, 8):
        auto.tick(float(t))
    return auto, {"removed": removed, "left": sorted(gws)}


def _script_refused_remove(autoscale, gateway):
    gws = {"n0": FakeGateway(gateway), "n1": FakeGateway(gateway)}

    def remove_node(nid):
        raise RuntimeError("owns in-flight work")

    spec = autoscale.PolicySpec(max_nodes=2, node_down_patience=1)
    auto = autoscale.Autoscaler(lambda: gws, spec, interval_s=1.0,
                                remove_node=remove_node)
    auto.tick(0.0)
    auto.tick(1.0)
    return auto, {"left": sorted(gws)}


def _script_protected_node(autoscale, gateway):
    """Only the protected anchor is idle: nothing is ever nominated."""
    gws = {"n0": FakeGateway(gateway), "n1": FakeGateway(gateway, inflight=2)}
    removed = []
    spec = autoscale.PolicySpec(max_nodes=2, node_down_patience=1)
    auto = autoscale.Autoscaler(lambda: gws, spec, interval_s=1.0,
                                remove_node=removed.append)
    for t in range(4):
        auto.tick(float(t))
    snaps = {nid: gw.load_snapshot() for nid, gw in gws.items()}
    return auto, {"removed": removed,
                  "candidate": autoscale.pick_removal_candidate(snaps)}


SCRIPTS = {
    "scale_up_down": _script_scale_up_down,
    "node_join": _script_node_join,
    "node_leave": _script_node_leave,
    "refused_remove": _script_refused_remove,
    "protected_node": _script_protected_node,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_action_log_equals_reference(script):
    logs = {}
    for name, (autoscale, gateway) in PACKAGES.items():
        auto, extra = SCRIPTS[script](autoscale, gateway)
        logs[name] = (auto.actions, auto.ticks, auto.scale_actions,
                      auto.peak_invokers, auto.peak_nodes, extra)
    assert logs["torch"] == logs["jax"]
    kinds = {a["kind"] for a in logs["torch"][0]}
    expect = {
        "scale_up_down": {"scale_up", "scale_down"},
        "node_join": {"add_node"},
        "node_leave": {"remove_node"},
        "refused_remove": {"remove_node_refused"},
        "protected_node": set(),
    }[script]
    assert expect <= kinds


@settings(max_examples=nightly_examples(20), deadline=None)
@given(
    st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=5),
            st.integers(min_value=0, max_value=5),
        ),
        min_size=1,
        max_size=6,
    )
)
def test_removal_candidate_equals_reference(loads):
    picks = [
        autoscale.pick_removal_candidate({
            f"n{i}": _snap(gateway, queue=q, inflight=f)
            for i, (q, f) in enumerate(loads)
        }, protected=("n0",))
        for autoscale, gateway in PACKAGES.values()
    ]
    assert picks[0] == picks[1]


# -- on a real port client -----------------------------------------------------------

def _sleeper(client) -> None:
    def step(state, ms=5.0):
        time.sleep(ms / 1e3)
        return state + 1, state + 1

    client.register(StatefulFunction("sleeper", step, init=lambda: 0, jit=False))


def test_scales_up_under_burst_then_back_down_on_the_port():
    with MarvelClient(ClusterConfig(name="as", invokers=1, journal="none")) as client:
        _sleeper(client)
        auto = client.autoscaler(tas.PolicySpec(
            min_invokers=1, max_invokers=4, target_per_invoker=2,
            down_cooldown_s=0.0, warm_pool_per_invoker=32))
        assert isinstance(auto, tas.Autoscaler)
        futs = [client.submit("sleeper", session=f"s{i}") for i in range(32)]
        auto.maybe_tick(0.0)
        assert client.gateway.load_snapshot().invokers > 1
        for f in futs:
            f.result(timeout=30.0)
        client.gateway.quiesce(timeout=10.0)
        for t in range(1, 8):
            auto.maybe_tick(float(t))
        assert client.gateway.load_snapshot().invokers == 1
        assert auto.peak_invokers >= 2
        assert {a["kind"] for a in auto.actions} == {"scale_up", "scale_down"}
        assert client.gateway.warm_pool == 32


def test_facade_spec_overrides_and_quiet_ticks_on_the_port():
    with MarvelClient(ClusterConfig(name="as1", invokers=1, journal="none")) as client:
        auto = client.autoscaler(max_invokers=2)
        assert auto.spec.max_invokers == 2
        auto.maybe_tick(0.0)  # no traffic: nothing to do, no crash
        assert auto.actions == []
        over = client.autoscaler(tas.PolicySpec(max_invokers=6),
                                 interval_s=0.5, target_per_invoker=3)
        assert (over.spec.max_invokers, over.spec.target_per_invoker) == (6, 3)
        assert over.interval_s == 0.5


def test_sharded_client_wires_the_node_actuators():
    cfg = ClusterConfig(name="asn", nodes=2, sharded=True, invokers=1,
                        journal="none")
    with MarvelClient(cfg) as client:
        plain = client.autoscaler()
        assert plain._add_node is None and plain._remove_node is None
        assert sorted(plain._gateways()) == ["n0", "n1"]
        auto = client.autoscaler(max_nodes=3)
        assert auto._add_node == client.add_node
        assert auto._remove_node == client.remove_node
        gws = auto._gateways()
        assert sorted(gws) == ["n0", "n1"]
        assert all(isinstance(g, tgateway.Gateway) for g in gws.values())
        nid = auto._add_node()
        assert sorted(auto._gateways()) == ["n0", "n1", nid]
        auto.tick(0.0)  # snapshots every live node, idle: nothing to join
        assert auto.peak_nodes == 3
        auto._remove_node(nid)
        assert sorted(auto._gateways()) == ["n0", "n1"]


# -- traced serving on the CPU: the card phase's twin ----------------------------------

PROMPT, MAX_TOKENS = 8, 80


@pytest.fixture(scope="module")
def qwen():
    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    return cfg, params


def _serving_cluster(root, name: str, warm_pool: int) -> ClusterConfig:
    return ClusterConfig(
        name=name,
        tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / name / "pmem"))),
        invokers=1, warm_pool=warm_pool, commit_every=1,
        journal="pmem", journal_path=str(root / name / "journal"),
        serving=ServingConfig(block_tokens=4, lossless=True),
    )


class _Conversations:
    """Replay adapter: an arrival of ``(app, session)`` starts the
    conversation ``app/session`` on its first admitted arrival and steps
    it after that; the pool's futures are kept in order."""

    def __init__(self, pool, prompts):
        self.pool, self.prompts, self.futures = pool, prompts, {}

    def submit(self, fn, app, session, block=True, timeout=None, **inputs):
        assert fn == self.pool.decoder.fn.name and not inputs
        conv = f"{app}/{session}"
        if conv not in self.futures:
            fut = self.pool.start(conv, self.prompts[conv], block=block,
                                  timeout=timeout)
            self.futures[conv] = [fut]
        else:
            fut = self.pool.step(conv, block=block, timeout=timeout)
            self.futures[conv].append(fut)
        return fut


def _tok(fut) -> int:
    return int(fut.result().reshape(-1)[0])


def test_traced_serving_under_the_autoscaler_decodes_the_sequential_tokens(
        tmp_path, qwen):
    cfg, params = qwen
    # 138 arrivals in 0.5 s, above what one invoker serves on a CPU, so a
    # backlog builds and the autoscaler must grow the pool
    spec = TraceSpec(seed=3, duration=0.5, base_rate=150.0, tenants=2,
                     sessions_per_tenant=2, zipf_skew=0.8, amplitude=0.0,
                     bursts=(BurstSpec(start=0.1, duration=0.2, factor=4.0,
                                       tenant="t0"),),
                     ops=(OpSpec("decode"),))
    trace = generate_trace(spec)
    per_conv = {}
    for a in trace:
        per_conv[f"{a.tenant}/{a.session}"] = per_conv.get(f"{a.tenant}/{a.session}", 0) + 1
    assert max(per_conv.values()) <= MAX_TOKENS  # the cache's headroom
    rng = np.random.default_rng(0)
    convs = [f"t{i}/s{j}" for i in range(2) for j in range(2)]
    prompts = {c: rng.integers(0, cfg.vocab, (1, PROMPT)).astype(np.int32)
               for c in convs}

    with MarvelClient(_serving_cluster(tmp_path, "auto", 2)) as client:
        pool = client.serving(params, cfg, prompt_len=PROMPT,
                              max_tokens=MAX_TOKENS, device="cpu")
        auto = client.autoscaler(tas.PolicySpec(
            min_invokers=1, max_invokers=3, target_per_invoker=1,
            down_cooldown_s=0.2, warm_pool_per_invoker=1), interval_s=0.05)
        adapter = _Conversations(pool, prompts)
        res = replay(adapter.submit, trace, spec=spec, slo_ms=1000.0,
                     window_s=0.5, admission="shed", tick=auto.maybe_tick,
                     tick_interval=0.05)
        streams = {c: [_tok(f) for f in futs]
                   for c, futs in adapter.futures.items()}
        assert client.gateway.quiesce(timeout=30.0)
        for k in range(1, 9):
            auto.maybe_tick(res.wall_s + k)
        assert client.gateway.load_snapshot().invokers == 1
        stats = pool.stats()

    assert res.errors == 0 and res.offered == len(trace)
    for ts in res.tenants.values():
        assert ts.offered == ts.completed + ts.shed + ts.errors
    assert "scale_up" in {a["kind"] for a in auto.actions}
    assert auto.peak_invokers >= 2
    assert stats["demotions"] > 0  # a warm pool of 1-3 for 4 conversations

    # the sequential pass: each conversation alone, in a fresh pool
    with MarvelClient(_serving_cluster(tmp_path, "seq", 2)) as client:
        pool = client.serving(params, cfg, prompt_len=PROMPT,
                              max_tokens=MAX_TOKENS, device="cpu")
        for conv, stream in sorted(streams.items()):
            want = [_tok(pool.start(conv, prompts[conv]))]
            want += [_tok(pool.step(conv)) for _ in range(len(stream) - 1)]
            assert stream == want, conv
