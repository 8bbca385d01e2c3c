"""The port's trace generator and SLO replay harness against the reference.

``generate_trace`` must give the reference's arrivals bit for bit (the
same ``t`` floats, tenants, sessions and ops) for the same ``TraceSpec``;
``rate_at`` and the SLO math of ``ReplayResult`` must give the same
numbers on the same inputs; ``replay`` is held to count conservation
against a port ``MarvelClient``, in ``shed`` and ``block`` mode.  Each
package's objects are built from its own classes, and plain values
(floats, tuples, dicts) are compared.
"""

from __future__ import annotations

import json
import math
import time
from concurrent.futures import Future

import numpy as np
import pytest

import repro.core.gateway as jgateway
import repro.core.loadgen as jlg
import repro_torch.core.gateway as tgateway
import repro_torch.core.loadgen as tlg
from repro_torch.api import ClusterConfig, MarvelClient
from repro_torch.core.stateful import StatefulFunction
from tests.hypothesis_compat import given, nightly_examples, settings, st

PACKAGES = {"jax": (jlg, jgateway), "torch": (tlg, tgateway)}


def _spec(lg, bursts=(), ops=(("noop", 1.0, ()),), **kw):
    """A ``TraceSpec`` of package ``lg`` from plain values: ``bursts`` as
    ``(start, duration, factor, tenant)``, ``ops`` as ``(fn, weight,
    inputs)``."""
    return lg.TraceSpec(
        bursts=tuple(lg.BurstSpec(*b) for b in bursts),
        ops=tuple(lg.OpSpec(*o) for o in ops),
        **kw,
    )


def _arrivals(trace):
    return [(a.t, a.tenant, a.session, a.op.fn, a.op.weight, a.op.inputs)
            for a in trace]


SPECS = {
    "defaults": {},
    "diurnal": dict(seed=5, duration=6.0, base_rate=400.0, amplitude=0.5,
                    period=6.0),
    "burst_one_tenant": dict(seed=3, duration=6.0, base_rate=300.0,
                             amplitude=0.0, bursts=((2.0, 2.0, 4.0, "t0"),)),
    "burst_all_tenants": dict(seed=7, duration=4.0, base_rate=200.0,
                              bursts=((1.0, 1.5, 3.0, None),
                                      (2.0, 1.0, 2.0, "t1"))),
    "skews": dict(seed=11, duration=3.0, base_rate=250.0, tenants=6,
                  sessions_per_tenant=16, zipf_skew=1.3, session_skew=1.1,
                  amplitude=0.3, period=2.5),
    "op_mix": dict(seed=13, duration=3.0, base_rate=300.0, tenants=3,
                   ops=(("hot", 3.0, (("ms", 20.0),)),
                        ("cold", 1.0, (("ms", 1.0), ("n", 3))),
                        ("rare", 0.25, ()))),
    "one_tenant_one_session": dict(seed=17, duration=2.0, base_rate=50.0,
                                   tenants=1, sessions_per_tenant=1),
}


# -- generation ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_equals_reference_arrival_for_arrival(name):
    got = tlg.generate_trace(_spec(tlg, **SPECS[name]))
    want = jlg.generate_trace(_spec(jlg, **SPECS[name]))
    assert len(got) > 0
    assert _arrivals(got) == _arrivals(want)


@settings(max_examples=nightly_examples(20), deadline=None)
@given(
    st.integers(min_value=0, max_value=2**31 - 1),
    st.sampled_from([10.0, 80.0, 400.0]),
    st.integers(min_value=1, max_value=5),
    st.integers(min_value=1, max_value=9),
    st.sampled_from([0.0, 0.25, 0.9]),
    st.sampled_from([(), ((0.5, 0.5, 4.0, "t0"),), ((0.2, 1.0, 2.5, None),)]),
)
def test_trace_equals_reference_for_drawn_specs(seed, base_rate, tenants,
                                                 sessions, amplitude, bursts):
    kw = dict(seed=seed, duration=1.5, base_rate=base_rate, tenants=tenants,
              sessions_per_tenant=sessions, amplitude=amplitude, period=1.0,
              bursts=bursts, ops=(("a", 2.0, (("x", 1),)), ("b", 1.0, ())))
    got = tlg.generate_trace(_spec(tlg, **kw))
    assert _arrivals(got) == _arrivals(jlg.generate_trace(_spec(jlg, **kw)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_rate_at_equals_reference_on_a_grid(name):
    tspec, jspec = _spec(tlg, **SPECS[name]), _spec(jlg, **SPECS[name])
    for t in np.linspace(0.0, tspec.duration, 97).tolist():
        assert tlg.rate_at(tspec, t) == jlg.rate_at(jspec, t)
        for tenant in tspec.tenant_names():
            assert tlg.rate_at(tspec, t, tenant) == jlg.rate_at(jspec, t, tenant)


def test_spec_weights_equal_reference():
    kw = dict(tenants=5, sessions_per_tenant=7, zipf_skew=1.1, session_skew=0.4)
    tspec, jspec = tlg.TraceSpec(**kw), jlg.TraceSpec(**kw)
    assert tspec.tenant_names() == jspec.tenant_names()
    assert tspec.tenant_weights() == jspec.tenant_weights()
    assert tspec.session_weights() == jspec.session_weights()


# -- the SLO math on the same synthetic series ---------------------------------

def _series(lg, seed, tenants=3, n=40, duration=4.0):
    """Seeded per-tenant series: latencies 1 ms–2 s, some sheds and
    errors, one window of t1 all shed."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(tenants):
        name = f"t{i}"
        lat = [(float(t), float(l)) for t, l in zip(
            np.sort(rng.uniform(0.0, duration, n)),
            rng.lognormal(-3.0, 1.5, n).clip(1e-3, 2.0))]
        shed_t = [float(t) for t in rng.uniform(0.0, duration, int(rng.integers(0, 5)))]
        error_t = [float(t) for t in rng.uniform(0.0, duration, int(rng.integers(0, 2)))]
        if name == "t1":
            shed_t += [duration + 0.25, duration + 0.5]
        out[name] = lg.TenantSeries(
            name, offered=len(lat) + len(shed_t) + len(error_t) + 2,
            completed=len(lat), shed=len(shed_t), errors=len(error_t),
            latencies=lat, shed_t=shed_t, error_t=error_t)
    return out


def _result(lg, tenants, bursts=((1.0, 1.0, 4.0, "t0"),), slo_ms=100.0,
            window_s=0.5):
    res = lg.ReplayResult(spec=_spec(lg, duration=4.0, bursts=bursts),
                          slo_ms=slo_ms, window_s=window_s, wall_s=4.123456)
    res.tenants = tenants
    return res


def _slo_numbers(res):
    names = [None, *sorted(res.tenants), "absent"]
    iso = res.isolation()
    return {
        "totals": (res.offered, res.completed, res.shed, res.backpressured,
                   res.errors),
        "window_p99_ms": {n: res.window_p99_ms(n) for n in names},
        "p99_under_slo_frac": {n: res.p99_under_slo_frac(n) for n in names},
        "p99_ms": {n: (res.p99_ms(n), res.p99_ms(n, 1.0, 2.0), res.p99_ms(n, 3.0))
                   for n in names},
        "goodput_frac": {n: res.goodput_frac(n) for n in names},
        "isolation": (iso.burst_tenant, iso.burst_p99_ms, iso.calm_p99_ms,
                      iso.ratio),
        "isolation_t1": (res.isolation("t1").burst_p99_ms,
                         res.isolation("t1").calm_p99_ms),
        "series_dict": res.series_dict(),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slo_ms,window_s", [(100.0, 0.5), (20.0, 1.0)])
def test_slo_math_equals_reference(seed, slo_ms, window_s):
    got = _slo_numbers(_result(tlg, _series(tlg, seed), slo_ms=slo_ms,
                               window_s=window_s))
    want = _slo_numbers(_result(jlg, _series(jlg, seed), slo_ms=slo_ms,
                                window_s=window_s))
    assert got == want
    json.dumps(got["series_dict"])


@pytest.mark.parametrize("case", ["empty", "no_tenant_burst", "calm_zero"])
def test_slo_edge_cases_equal_reference(case):
    def build(lg):
        if case == "empty":
            return _result(lg, {})
        if case == "no_tenant_burst":
            return _result(lg, _series(lg, 5), bursts=((1.0, 1.0, 2.0, None),))
        # the bystander has samples only inside the burst: calm p99 is 0
        return _result(lg, {
            "t0": lg.TenantSeries("t0", offered=1, completed=1,
                                  latencies=[(1.5, 0.3)]),
            "t1": lg.TenantSeries("t1", offered=1, completed=1,
                                  latencies=[(1.2, 0.05)]),
        })

    got, want = _slo_numbers(build(tlg)), _slo_numbers(build(jlg))
    assert got == want
    if case == "calm_zero":
        assert got["isolation"][3] == math.inf


# -- replay ------------------------------------------------------------------

def _sleepy_client(**cfg) -> MarvelClient:
    client = MarvelClient(ClusterConfig(name="lg", journal="none", **cfg))

    def step(state, ms=1.0):
        time.sleep(ms / 1e3)
        return state + 1, state + 1

    client.register(StatefulFunction("sleeper", step, init=lambda: 0, jit=False))
    return client


def _saturating_spec() -> tlg.TraceSpec:
    return _spec(tlg, seed=9, duration=1.2, base_rate=120.0, tenants=2,
                 sessions_per_tenant=8, amplitude=0.0,
                 ops=(("sleeper", 1.0, (("ms", 20.0),)),))


def _conserved(res) -> None:
    assert res.offered == res.completed + res.shed + res.errors
    for ts in res.tenants.values():
        assert ts.offered == ts.completed + ts.shed + ts.errors
        assert len(ts.latencies) == ts.completed
        assert len(ts.shed_t) == ts.shed and len(ts.error_t) == ts.errors


def test_replay_sheds_under_saturation_on_the_port_client():
    spec = _saturating_spec()
    trace = tlg.generate_trace(spec)
    with _sleepy_client(invokers=1, target_inflight=1) as client:
        res = tlg.replay(client.submit, trace, spec=spec, slo_ms=100.0)
    assert res.offered == len(trace)
    _conserved(res)
    assert res.errors == 0
    assert res.shed > 0  # one inflight slot against ~120/s of 20 ms calls
    assert res.backpressured == 0
    assert 0.0 <= res.goodput_frac() < 1.0


def test_replay_block_mode_backpressures_on_the_port_client():
    spec = _saturating_spec()
    with _sleepy_client(invokers=2, target_inflight=2) as client:
        res = tlg.replay(client.submit, tlg.generate_trace(spec), spec=spec,
                         slo_ms=100.0, admission="block", retry_timeout=30.0)
    assert res.backpressured > 0
    _conserved(res)
    assert res.errors == 0


def test_replay_pumps_tick_in_order():
    spec = _spec(tlg, seed=1, duration=0.6, base_rate=60.0, tenants=1,
                 amplitude=0.0, ops=(("sleeper", 1.0, (("ms", 1.0),)),))
    ticks = []
    with _sleepy_client(invokers=2) as client:
        tlg.replay(client.submit, tlg.generate_trace(spec), spec=spec,
                   tick=ticks.append, tick_interval=0.05)
    assert len(ticks) >= 5
    assert ticks == sorted(ticks)


def test_replay_rejects_unknown_admission_policy():
    with pytest.raises(ValueError):
        tlg.replay(lambda **kw: None, [], admission="drop")


def _refusing_submit(gateway, retry: str):
    """A submit that refuses every non-blocking call with the package's
    own ``AdmissionError``; its blocking retry refuses again, raises
    another error, or returns a future that fails."""

    def submit(fn, app, session, block, timeout=None, **inputs):
        if not block or retry == "refused":
            raise gateway.AdmissionError("full")
        if retry == "raises":
            raise RuntimeError("invoker lost")
        fut = Future()
        fut.set_exception(gateway.AdmissionError("still full"))
        return fut

    return submit


@pytest.mark.parametrize("retry", ["refused", "raises", "future_refused"])
def test_failed_block_mode_retry_is_counted_once_as_in_reference(retry):
    """A blocking retry that fails is counted once, as a shed (admission)
    or an error, exactly as the reference counts it.  The reference's
    retry path then touches an undefined name inside the retry pool's
    worker, whose future nobody reads; the port drops that line, and the
    counts show it changed nothing."""
    counts = {}
    for name, (lg, gateway) in PACKAGES.items():
        spec = _spec(lg, seed=4, duration=0.3, base_rate=60.0, tenants=2,
                     amplitude=0.0)
        trace = lg.generate_trace(spec)
        res = lg.replay(_refusing_submit(gateway, retry), trace, spec=spec,
                        admission="block", retry_workers=2)
        _conserved(res)
        counts[name] = {
            t: (ts.offered, ts.completed, ts.shed, ts.backpressured, ts.errors,
                ts.shed_t, ts.error_t)
            for t, ts in res.tenants.items()
        }
        n = len(trace)
        assert res.offered == res.backpressured == n > 0
        if retry == "raises":
            assert res.errors == n and res.shed == 0
        else:
            assert res.shed == n and res.errors == 0
    assert counts["torch"] == counts["jax"]


def test_replay_counts_submit_errors_and_sheds_like_reference():
    """Shed mode over a submit that sheds every third call and raises on
    every fifth: the same per-tenant counts in both packages."""
    counts = {}
    for name, (lg, gateway) in PACKAGES.items():
        calls = [0]

        def submit(fn, app, session, block, **inputs):
            calls[0] += 1
            if calls[0] % 3 == 0:
                raise gateway.AdmissionError("shed")
            if calls[0] % 5 == 0:
                raise ValueError("bad input")
            fut = Future()
            fut.set_result(None)
            return fut

        spec = _spec(lg, seed=8, duration=0.4, base_rate=80.0, tenants=3)
        res = lg.replay(submit, lg.generate_trace(spec), spec=spec)
        _conserved(res)
        counts[name] = {t: (ts.offered, ts.completed, ts.shed, ts.errors)
                        for t, ts in res.tenants.items()}
    assert counts["torch"] == counts["jax"]
    assert sum(c[2] for c in counts["torch"].values()) > 0
    assert sum(c[3] for c in counts["torch"].values()) > 0
