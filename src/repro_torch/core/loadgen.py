"""Trace-driven load generation: seeded workloads + an SLO replay harness.

Every benchmark before this module drove *fixed* offered load — the warm
pool, admission control, and the cluster membership machinery had never
seen the diurnal, bursty, multi-tenant traffic the paper's "millions of
users" framing implies.  This module closes that gap in two halves:

* :func:`generate_trace` draws a deterministic arrival trace from a
  :class:`TraceSpec`: Poisson arrivals (thinning against the peak rate)
  under a diurnal sine envelope, multiplicative :class:`BurstSpec`
  episodes, Zipf-skewed tenants and sessions, and a pluggable op mix of
  :class:`OpSpec` entries.  Same seed, same trace — byte for byte.
* :func:`replay` fires a trace open-loop at a ``submit`` callable (the
  :class:`~repro_torch.api.MarvelClient` façade, single-node or sharded) and
  records per-tenant completion latencies, sheds, and backpressure
  stalls.  The returned :class:`ReplayResult` computes the SLO metrics
  the harness gates on: windowed ``p99_under_slo_frac`` (a shed counts
  as an infinite-latency sample, so a window that rejects >1% of its
  arrivals fails its p99), ``goodput_frac``, and the tenant-isolation
  ratio (did tenant A's burst move everyone else's p99?).

The replay loop is single-threaded and *pumps* an optional ``tick``
callback between dispatches — the autoscaler's control loop runs off
that pump (see :mod:`repro_torch.core.autoscale`), so a replayed experiment
stays deterministic in structure even though wall-clock latencies vary.
"""

from __future__ import annotations

import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gateway import AdmissionError

__all__ = [
    "Arrival",
    "BurstSpec",
    "IsolationReport",
    "OpSpec",
    "ReplayResult",
    "TenantSeries",
    "TraceSpec",
    "generate_trace",
    "rate_at",
    "replay",
]


# ---------------------------------------------------------------------------
# Trace specification
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpSpec:
    """One entry in the op mix: a function name, call kwargs, a weight."""

    fn: str
    weight: float = 1.0
    inputs: Tuple[Tuple[str, Any], ...] = ()

    def kwargs(self) -> Dict[str, Any]:
        return dict(self.inputs)


@dataclass(frozen=True)
class BurstSpec:
    """A burst episode: multiply one tenant's (or everyone's) rate.

    ``factor`` is the total multiplier while the episode is active — a
    ``factor=4.0`` burst is a "4x burst".  ``tenant=None``
    bursts the whole trace.
    """

    start: float
    duration: float
    factor: float
    tenant: Optional[str] = None

    def active(self, t: float) -> bool:
        return self.start <= t < self.start + self.duration

    @property
    def end(self) -> float:
        return self.start + self.duration


@dataclass(frozen=True)
class TraceSpec:
    """Seeded description of a workload trace.

    ``base_rate`` is the aggregate arrival rate (1/s) at envelope mean.
    Tenant ``i`` gets weight ``(i + 1) ** -zipf_skew`` (normalised);
    sessions within a tenant are skewed the same way by
    ``session_skew``.  The diurnal envelope is
    ``1 + amplitude * sin(2 * pi * t / period)``.
    """

    seed: int = 0
    duration: float = 10.0
    base_rate: float = 100.0
    tenants: int = 4
    sessions_per_tenant: int = 8
    zipf_skew: float = 0.8
    session_skew: float = 0.6
    amplitude: float = 0.25
    period: float = 60.0
    bursts: Tuple[BurstSpec, ...] = ()
    ops: Tuple[OpSpec, ...] = (OpSpec("noop"),)

    def tenant_names(self) -> List[str]:
        return [f"t{i}" for i in range(self.tenants)]

    def tenant_weights(self) -> List[float]:
        raw = [(i + 1) ** -self.zipf_skew for i in range(self.tenants)]
        total = sum(raw)
        return [w / total for w in raw]

    def session_weights(self) -> List[float]:
        raw = [(i + 1) ** -self.session_skew for i in range(self.sessions_per_tenant)]
        total = sum(raw)
        return [w / total for w in raw]


@dataclass(frozen=True)
class Arrival:
    """One trace event: at virtual time ``t``, tenant/session calls op."""

    t: float
    tenant: str
    session: str
    op: OpSpec


# ---------------------------------------------------------------------------
# Generation (Poisson thinning)
# ---------------------------------------------------------------------------


def _envelope(spec: TraceSpec, t: float) -> float:
    return 1.0 + spec.amplitude * math.sin(2.0 * math.pi * t / spec.period)


def _burst_factor(spec: TraceSpec, tenant: str, t: float) -> float:
    factor = 1.0
    for burst in spec.bursts:
        if burst.active(t) and burst.tenant in (None, tenant):
            factor *= burst.factor
    return factor


def rate_at(spec: TraceSpec, t: float, tenant: Optional[str] = None) -> float:
    """Instantaneous arrival rate (1/s) at virtual time ``t``.

    With ``tenant`` set, the rate of that tenant alone; otherwise the
    aggregate over all tenants.  Exposed for tests: the empirical rate
    of a generated trace must track this function.
    """
    env = _envelope(spec, t)
    names = spec.tenant_names()
    weights = spec.tenant_weights()
    if tenant is not None:
        idx = names.index(tenant)
        return spec.base_rate * env * weights[idx] * _burst_factor(spec, tenant, t)
    return sum(
        spec.base_rate * env * w * _burst_factor(spec, name, t)
        for name, w in zip(names, weights)
    )


def _peak_rate(spec: TraceSpec) -> float:
    """A safe upper bound on :func:`rate_at` for thinning."""
    factor = 1.0
    for burst in spec.bursts:
        factor *= max(1.0, burst.factor)
    return spec.base_rate * (1.0 + abs(spec.amplitude)) * factor


def generate_trace(spec: TraceSpec) -> List[Arrival]:
    """Draw the arrival list for ``spec`` — deterministic in the seed.

    Homogeneous Poisson at the peak rate, thinned to the instantaneous
    rate; each accepted arrival then samples its tenant proportional to
    ``weight * burst_factor(t)``, its session by the session skew, and
    its op by the op-mix weights.
    """
    rng = random.Random(spec.seed)
    names = spec.tenant_names()
    weights = spec.tenant_weights()
    session_weights = spec.session_weights()
    session_ids = list(range(spec.sessions_per_tenant))
    ops = list(spec.ops)
    op_weights = [op.weight for op in ops]
    lam_max = _peak_rate(spec)
    arrivals: List[Arrival] = []
    t = 0.0
    while True:
        t += rng.expovariate(lam_max)
        if t >= spec.duration:
            break
        tenant_rates = [
            w * _burst_factor(spec, name, t) for name, w in zip(names, weights)
        ]
        lam_t = spec.base_rate * _envelope(spec, t) * sum(tenant_rates)
        if rng.random() * lam_max > lam_t:
            continue
        tenant = rng.choices(names, weights=tenant_rates)[0]
        session = f"s{rng.choices(session_ids, weights=session_weights)[0]}"
        op = rng.choices(ops, weights=op_weights)[0] if len(ops) > 1 else ops[0]
        arrivals.append(Arrival(t=t, tenant=tenant, session=session, op=op))
    return arrivals


# ---------------------------------------------------------------------------
# Replay results
# ---------------------------------------------------------------------------


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


@dataclass
class TenantSeries:
    """Per-tenant replay record: counts plus timestamped samples."""

    tenant: str
    offered: int = 0
    completed: int = 0
    shed: int = 0
    backpressured: int = 0
    errors: int = 0
    latencies: List[Tuple[float, float]] = field(default_factory=list)
    shed_t: List[float] = field(default_factory=list)
    error_t: List[float] = field(default_factory=list)


@dataclass
class IsolationReport:
    """Did a burst on one tenant move the *other* tenants' p99?"""

    burst_tenant: str
    burst_p99_ms: float
    calm_p99_ms: float

    @property
    def ratio(self) -> float:
        if self.calm_p99_ms <= 0.0:
            return 1.0 if self.burst_p99_ms <= 0.0 else float("inf")
        return self.burst_p99_ms / self.calm_p99_ms


@dataclass
class ReplayResult:
    """Everything :func:`replay` measured, plus the SLO math over it.

    Latency samples are keyed by the *virtual* arrival time of their
    request, so windowed metrics line up with the trace's bursts no
    matter how long the wall-clock replay took.
    """

    spec: TraceSpec
    slo_ms: float
    window_s: float
    wall_s: float = 0.0
    tenants: Dict[str, TenantSeries] = field(default_factory=dict)

    # -- totals ---------------------------------------------------------

    def _sum(self, attr: str) -> int:
        return sum(getattr(ts, attr) for ts in self.tenants.values())

    @property
    def offered(self) -> int:
        return self._sum("offered")

    @property
    def completed(self) -> int:
        return self._sum("completed")

    @property
    def shed(self) -> int:
        return self._sum("shed")

    @property
    def backpressured(self) -> int:
        return self._sum("backpressured")

    @property
    def errors(self) -> int:
        return self._sum("errors")

    # -- windowed SLO ---------------------------------------------------

    def _series(self, tenant: Optional[str]) -> List[TenantSeries]:
        if tenant is None:
            return list(self.tenants.values())
        return [self.tenants[tenant]] if tenant in self.tenants else []

    def _window_samples(self, tenant: Optional[str]) -> Dict[int, List[float]]:
        """Latency ms per window; sheds/errors land as ``inf`` samples."""
        out: Dict[int, List[float]] = {}
        for ts in self._series(tenant):
            for t, lat in ts.latencies:
                out.setdefault(int(t / self.window_s), []).append(lat * 1e3)
            for t in ts.shed_t:
                out.setdefault(int(t / self.window_s), []).append(float("inf"))
            for t in ts.error_t:
                out.setdefault(int(t / self.window_s), []).append(float("inf"))
        return out

    def window_p99_ms(self, tenant: Optional[str] = None) -> Dict[int, float]:
        return {
            w: _pct(sorted(vals), 0.99)
            for w, vals in sorted(self._window_samples(tenant).items())
        }

    def p99_under_slo_frac(self, tenant: Optional[str] = None) -> float:
        """Fraction of non-empty windows whose p99 meets the SLO."""
        per_window = self.window_p99_ms(tenant)
        if not per_window:
            return 0.0
        ok = sum(1 for p99 in per_window.values() if p99 <= self.slo_ms)
        return ok / len(per_window)

    def p99_ms(
        self,
        tenant: Optional[str] = None,
        t0: float = 0.0,
        t1: float = float("inf"),
    ) -> float:
        vals = [
            lat * 1e3
            for ts in self._series(tenant)
            for t, lat in ts.latencies
            if t0 <= t < t1
        ]
        vals.sort()
        return _pct(vals, 0.99)

    def goodput_frac(self, tenant: Optional[str] = None) -> float:
        """Completions within SLO over everything offered."""
        offered = sum(ts.offered for ts in self._series(tenant))
        if offered == 0:
            return 1.0
        good = sum(
            1
            for ts in self._series(tenant)
            for _t, lat in ts.latencies
            if lat * 1e3 <= self.slo_ms
        )
        return good / offered

    # -- isolation ------------------------------------------------------

    def isolation(self, burst_tenant: Optional[str] = None) -> IsolationReport:
        """p99 of the *other* tenants during vs outside burst episodes."""
        bursts = [b for b in self.spec.bursts if b.tenant is not None]
        if burst_tenant is None and bursts:
            burst_tenant = bursts[0].tenant
        if burst_tenant is None:
            return IsolationReport("", 0.0, 0.0)
        episodes = [
            (b.start, b.end) for b in bursts if b.tenant in (None, burst_tenant)
        ]
        burst_ms: List[float] = []
        calm_ms: List[float] = []
        for name, ts in self.tenants.items():
            if name == burst_tenant:
                continue
            for t, lat in ts.latencies:
                in_burst = any(lo <= t < hi for lo, hi in episodes)
                (burst_ms if in_burst else calm_ms).append(lat * 1e3)
        burst_ms.sort()
        calm_ms.sort()
        return IsolationReport(
            burst_tenant=burst_tenant,
            burst_p99_ms=_pct(burst_ms, 0.99),
            calm_p99_ms=_pct(calm_ms, 0.99),
        )

    # -- export ---------------------------------------------------------

    def series_dict(self) -> Dict[str, Any]:
        """JSON-able per-tenant series for the nightly artifact."""
        return {
            "slo_ms": self.slo_ms,
            "window_s": self.window_s,
            "wall_s": round(self.wall_s, 3),
            "trace": {
                "seed": self.spec.seed,
                "duration": self.spec.duration,
                "base_rate": self.spec.base_rate,
                "tenants": self.spec.tenants,
            },
            "tenants": {
                name: {
                    "offered": ts.offered,
                    "completed": ts.completed,
                    "shed": ts.shed,
                    "backpressured": ts.backpressured,
                    "errors": ts.errors,
                    "latency_ms": [
                        [round(t, 4), round(lat * 1e3, 3)] for t, lat in ts.latencies
                    ],
                    "shed_t": [round(t, 4) for t in ts.shed_t],
                }
                for name, ts in sorted(self.tenants.items())
            },
        }


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def replay(
    submit: Callable[..., Any],
    trace: Sequence[Arrival],
    *,
    spec: Optional[TraceSpec] = None,
    slo_ms: float = 100.0,
    window_s: float = 0.5,
    admission: str = "shed",
    tick: Optional[Callable[[float], None]] = None,
    tick_interval: float = 0.05,
    retry_workers: int = 4,
    retry_timeout: float = 10.0,
    drain_timeout: float = 120.0,
) -> ReplayResult:
    """Fire ``trace`` open-loop at ``submit`` and measure the fallout.

    ``submit`` must have the :meth:`repro_torch.api.MarvelClient.submit`
    shape: ``submit(fn, app=..., session=..., block=..., **inputs)``
    returning a future.  ``admission="shed"`` counts every
    :class:`AdmissionError` as a shed request; ``admission="block"``
    instead hands rejected requests to a small retry pool that
    re-submits with ``block=True`` (counted as *backpressured*; a retry
    that still fails within ``retry_timeout`` degrades to a shed).

    ``tick`` is pumped with the current virtual time roughly every
    ``tick_interval`` seconds while the replay runs — wire the
    autoscaler's ``maybe_tick`` here.
    """
    if admission not in ("shed", "block"):
        raise ValueError(f"unknown admission policy: {admission!r}")
    if spec is None:
        spec = TraceSpec(duration=trace[-1].t if trace else 0.0)
    result = ReplayResult(spec=spec, slo_ms=slo_ms, window_s=window_s)
    for arr in trace:
        result.tenants.setdefault(arr.tenant, TenantSeries(arr.tenant))
    lock = threading.Lock()
    outstanding = [0]
    pool = None
    if admission == "block":
        pool = ThreadPoolExecutor(max_workers=retry_workers)

    def _finish(ts: TenantSeries, arr: Arrival, started: float, fut: Any) -> None:
        latency = time.perf_counter() - started
        with lock:
            try:
                fut.result()
            except AdmissionError:
                ts.shed += 1
                ts.shed_t.append(arr.t)
            except BaseException:
                ts.errors += 1
                ts.error_t.append(arr.t)
            else:
                ts.completed += 1
                ts.latencies.append((arr.t, latency))
            outstanding[0] -= 1

    def _retry(ts: TenantSeries, arr: Arrival, started: float) -> None:
        try:
            fut = submit(
                arr.op.fn,
                app=arr.tenant,
                session=arr.session,
                block=True,
                timeout=retry_timeout,
                **arr.op.kwargs(),
            )
            fut.result()
        except BaseException as exc:
            with lock:
                if isinstance(exc, AdmissionError):
                    ts.shed += 1
                    ts.shed_t.append(arr.t)
                else:
                    ts.errors += 1
                    ts.error_t.append(arr.t)
                outstanding[0] -= 1
            return
        latency = time.perf_counter() - started
        with lock:
            ts.completed += 1
            ts.latencies.append((arr.t, latency))
            outstanding[0] -= 1

    t0 = time.perf_counter()
    next_tick = tick_interval
    i = 0
    n = len(trace)
    while i < n:
        now = time.perf_counter() - t0
        if tick is not None and now >= next_tick:
            tick(now)
            next_tick += tick_interval
        arr = trace[i]
        if arr.t > now:
            horizon = min(arr.t, next_tick) if tick is not None else arr.t
            delay = horizon - now
            if delay > 0:
                time.sleep(min(delay, 0.02))
            continue
        i += 1
        ts = result.tenants[arr.tenant]
        started = time.perf_counter()
        with lock:
            ts.offered += 1
            outstanding[0] += 1
        try:
            fut = submit(
                arr.op.fn,
                app=arr.tenant,
                session=arr.session,
                block=False,
                **arr.op.kwargs(),
            )
        except AdmissionError:
            if pool is not None:
                with lock:
                    ts.backpressured += 1
                pool.submit(_retry, ts, arr, started)
            else:
                with lock:
                    ts.shed += 1
                    ts.shed_t.append(arr.t)
                    outstanding[0] -= 1
        except BaseException:
            with lock:
                ts.errors += 1
                ts.error_t.append(arr.t)
                outstanding[0] -= 1
        else:
            fut.add_done_callback(
                lambda f, ts=ts, arr=arr, started=started: _finish(
                    ts, arr, started, f
                )
            )
    deadline = time.perf_counter() + drain_timeout
    while time.perf_counter() < deadline:
        with lock:
            if outstanding[0] == 0:
                break
        now = time.perf_counter() - t0
        if tick is not None and now >= next_tick:
            tick(now)
            next_tick += tick_interval
        time.sleep(0.005)
    if pool is not None:
        pool.shutdown(wait=True)
    result.wall_s = time.perf_counter() - t0
    return result
