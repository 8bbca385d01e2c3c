"""Concurrent multi-tenant function gateway — the OpenWhisk front door.

In the paper, Marvel's stateful actions run on OpenWhisk: a *controller*
admits and routes activations to a pool of *invokers* (warm containers),
all sharing the Ignite/PMEM state tier.  This module is that serving
layer for the function runtime: the :class:`Gateway` fronts a pool of
:class:`Invoker` worker threads over one shared
:class:`~repro_torch.core.stateful.FunctionRuntime`.

Routing & consistency
    Invocations are keyed by ``(app, session)``.  Each key owns a FIFO
    *lane* plus an exclusive **state lease**: a lane is handed to at most
    one invoker at a time, so a session's state transitions are
    linearizable (per-session FIFO, exclusive writer) while distinct
    sessions execute fully in parallel across invokers.  The lease is the
    scheduling-level guarantee; the runtime's per-slot locks are the
    belt-and-braces enforcement underneath it.

Lock stripes (DESIGN.md §10)
    The lane map and the warm-pool LRU are sharded into N *stripes*
    keyed by the session hash, so concurrent submissions/completions of
    distinct sessions never contend on one global lock.  Admission
    accounting lives in one small dedicated lock — a shed/backpressure
    decision costs exactly one lock acquire.  Operations that need the
    whole view (``stats``, ``warm_contexts``, ``close``, eviction victim
    search) take the stripe locks in index order.  Lock order: stripe
    lock strictly outside the runtime's slot lock, never inverted.

Warm pool
    Initialized function/session contexts (hot device/DRAM state + the
    prepared step) form the warm pool, bounded by ``warm_pool`` with LRU
    eviction: victims are committed to the shared
    :class:`~repro_torch.storage.kvcache.StateCache` (so nothing is lost) and
    dropped from the hot view.  The LRU is striped but the capacity and
    the eviction order are global: every touch stamps a monotonic clock,
    and the victim is the globally-oldest unpinned stripe front.  A warm
    hit serves straight from the hot view; a cold start re-loads state
    from the DRAM/PMEM tier (and prepares the step again if it was
    dropped) — the warm/cold gap Faasm/Cloudburst measure and
    ``benchmarks/paper_fig7_gateway.py`` reproduces.

Group-commit acks
    When the runtime batches commits (``group_commit=True``), a warm
    invocation executes, releases its lane immediately (per-session FIFO
    is execution order), and resolves its Future only when the group
    flush makes the commit durable — no acked result can precede its
    durability, and no lane stalls on tier I/O.

Admission control & autoscaling
    ``target_inflight`` bounds queued+running invocations: past it,
    ``submit`` blocks (backpressure) or raises :class:`AdmissionError`
    (load shedding, ``block=False``).  ``add_invokers`` / ``remove_
    invokers`` resize the pool live; schedulers created via
    :meth:`Gateway.shared_scheduler` mirror the pool's worker slots, so
    MapReduce jobs (just another tenant) scale with the serving fleet.

Per-invoker accounting
    Each invoker carries :class:`InvokerStats` including its own
    :class:`~repro_torch.storage.tiers.TierStats`, populated via the tier
    accounting scope — per-worker I/O attribution on top of the global
    per-tier counters.  ``GatewayStats.tier`` rolls the per-invoker
    counters (plus the group committer's flusher share) into one view
    without double-counting promoted reads: each physical op lands in
    exactly one scoped TierStats.

See DESIGN.md §5 for the lifecycle diagram and lease protocol, §10 for
the warm-path fast lanes.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Queue
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.scheduler import Scheduler
from repro_torch.core.stateful import FunctionRuntime, Session
from repro_torch.storage.tiers import TierStats, tier_accounting

__all__ = [
    "AdmissionError",
    "Gateway",
    "GatewayClosedError",
    "GatewayStats",
    "InvokerStats",
    "LoadSnapshot",
]


class AdmissionError(RuntimeError):
    """Admission control rejected the invocation (gateway at capacity)."""


class GatewayClosedError(RuntimeError):
    """The gateway is closed and no longer accepts invocations."""


@dataclass
class InvokerStats:
    """Per-invoker serving counters (the OpenWhisk invoker health view)."""

    invoker: str
    invocations: int = 0
    warm_hits: int = 0
    cold_starts: int = 0
    errors: int = 0
    busy_seconds: float = 0.0
    alive: bool = True
    #: this invoker's share of tier I/O (scoped accounting).
    tier: TierStats = field(default_factory=TierStats)


@dataclass
class GatewayStats:
    """Aggregate gateway counters plus the per-invoker breakdown."""

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    evictions: int = 0
    inflight: int = 0
    warm_hits: int = 0
    cold_starts: int = 0
    #: lane-wait (submit → dispatch) percentiles over a recent sample
    #: window, in milliseconds (the fig7b contention metric).
    lane_wait_p50_ms: float = 0.0
    lane_wait_p99_ms: float = 0.0
    #: merged per-invoker + group-committer tier I/O (each physical op is
    #: attributed to exactly one scope — no double counting).
    tier: TierStats = field(default_factory=TierStats)
    invokers: List[InvokerStats] = field(default_factory=list)


@dataclass
class LoadSnapshot:
    """A cheap point-in-time load observation (the autoscaler's input).

    Unlike :class:`GatewayStats` this copies no wait samples and merges
    no :class:`TierStats`: it takes the stripe locks one at a time for a
    handful of integer reads, the admission lock once, and samples at
    most :attr:`Gateway.SNAPSHOT_WAITS` recent lane waits per stripe for
    the p99 — safe to poll on a tight control interval while the warm
    path runs hot."""

    #: total invocations queued in lanes (not yet dispatched).
    queue_depth: int
    #: per-stripe queue depths, in stripe index order.
    queue_per_stripe: List[int]
    #: admitted (queued + running + awaiting durable ack) invocations.
    inflight: int
    #: effective invoker count (alive minus pending cooperative retires).
    invokers: int
    #: cumulative warm hits / cold starts across the pool.
    warm_hits: int
    cold_starts: int
    #: cumulative admission rejections (shed + timed-out backpressure).
    rejected: int
    #: p99 lane wait (submit -> dispatch) over the bounded sample, ms.
    wait_p99_ms: float
    #: KV-cache pressure (serving subsystem, DESIGN.md §14): decode
    #: sessions resident in the fast tier vs. paged out to the slow
    #: level.  Zero when no serving pool installed a pressure provider.
    resident_sessions: int = 0
    paged_sessions: int = 0

    @property
    def warm_hit_rate(self) -> float:
        served = self.warm_hits + self.cold_starts
        return self.warm_hits / served if served else 1.0


@dataclass
class _Invocation:
    fn_name: str
    scoped_session: str
    init_kwargs: Optional[dict]
    inputs: dict
    future: Future
    enqueued: float


class _Lane:
    """FIFO queue + exclusive state lease for one (app, session)."""

    __slots__ = ("key", "scoped", "stripe", "pending", "leased")

    def __init__(self, key: Tuple[str, str], scoped: str,
                 stripe: "_Stripe") -> None:
        self.key = key
        self.scoped = scoped
        self.stripe = stripe
        self.pending: Deque[_Invocation] = deque()
        self.leased = False


class _Stripe:
    """One shard of the lane map + warm-pool LRU and its counters."""

    __slots__ = ("lock", "lanes", "lru", "submitted", "completed",
                 "evictions", "waits")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.lanes: Dict[Tuple[str, str], _Lane] = {}
        #: (fn, scoped_session) -> global touch stamp, oldest first.
        self.lru: "OrderedDict[Tuple[str, str], int]" = OrderedDict()
        self.submitted = 0
        self.completed = 0
        self.evictions = 0
        #: recent lane-wait samples (seconds), bounded window.
        self.waits: Deque[float] = deque(maxlen=2048)


class _Admission:
    """Global admission accounting: one small lock, one counter — a
    shed/backpressure decision costs a single lock acquire."""

    __slots__ = ("lock", "cond", "inflight", "rejected", "waiters")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.inflight = 0
        self.rejected = 0
        #: threads blocked on the condition (submitters + close-drain);
        #: completions skip the notify entirely when nobody waits.
        self.waiters = 0


#: queue token telling the invoker that pops it to retire itself.
_RETIRE = object()


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class Gateway:
    """Fronts a pool of invoker threads over one shared runtime.

    ``invokers``       initial pool size (threads).
    ``warm_pool``      max warm (fn, session) contexts kept hot; LRU
                       victims are committed + evicted to the cache tier.
    ``target_inflight`` admission bound on queued+running invocations
                       (None = unbounded); mutable at runtime.
    ``stripes``        lock stripes for the lane map / warm-pool LRU.
    """

    def __init__(
        self,
        runtime: FunctionRuntime,
        invokers: int = 4,
        warm_pool: int = 64,
        target_inflight: Optional[int] = None,
        stripes: int = 8,
        name: str = "gw",
    ) -> None:
        if invokers < 1:
            raise ValueError("gateway needs at least one invoker")
        if stripes < 1:
            raise ValueError("gateway needs at least one lock stripe")
        self.runtime = runtime
        self.name = name
        self.warm_pool = max(1, warm_pool)
        self.target_inflight = target_inflight
        self._stripes = [_Stripe() for _ in range(stripes)]
        self._n_stripes = stripes
        self._admission = _Admission()
        self._ready: "Queue[Any]" = Queue()
        #: global LRU touch clock (itertools.count is GIL-atomic).
        self._touch_clock = itertools.count()
        #: (fn, scoped_session) contexts exempt from warm-pool eviction.
        self._warm_pins: set = set()
        self._pin_lock = threading.Lock()
        #: eviction callback (serving subsystem): called as
        #: ``on_evict(fn_name, scoped_session)`` after a warm-pool victim
        #: is committed + demoted, on the evicting invoker's thread.  The
        #: serving pool uses it to route the victim's KV blocks through
        #: the pager (demote, don't drop).
        self.on_evict: Optional[Callable[[str, str], None]] = None
        #: KV-pressure provider: ``() -> (resident, paged)`` session
        #: counts surfaced in :meth:`load_snapshot` for the autoscaler.
        self._kv_pressure: Optional[Callable[[], Tuple[int, int]]] = None
        self._closed = False
        self._abort = False
        #: invoker pool bookkeeping (autoscaling, schedulers).
        self._pool_lock = threading.Lock()
        self._pending_retires = 0
        self._invoker_seq = 0
        self._threads: Dict[str, threading.Thread] = {}
        self._stats: Dict[str, InvokerStats] = {}
        self._alive: set = set()
        self._schedulers: List[Scheduler] = []
        self.add_invokers(invokers)

    # -- naming ------------------------------------------------------------
    @staticmethod
    def scoped_session(app: str, session: str) -> str:
        """The runtime-level session id for ``(app, session)``.  The
        ``default`` app maps to the bare session id so direct
        ``runtime.invoke`` calls and gateway traffic share state."""
        return session if app == "default" else f"{app}::{session}"

    def _stripe_of(self, scoped_session: str) -> _Stripe:
        return self._stripes[hash(scoped_session) % self._n_stripes]

    # -- submission --------------------------------------------------------
    def submit(
        self,
        fn_name: str,
        app: str = "default",
        session: str = "default",
        init_kwargs: Optional[dict] = None,
        block: bool = True,
        timeout: Optional[float] = None,
        **inputs: Any,
    ) -> Future:
        """Enqueue one invocation; returns a Future of its outputs.

        Per-(app, session) FIFO ordering is guaranteed; admission control
        applies before enqueue (blocking backpressure by default,
        :class:`AdmissionError` when ``block=False`` or on timeout).
        """
        scoped = self.scoped_session(app, session)
        item = _Invocation(
            fn_name, scoped, init_kwargs, inputs, Future(),
            time.perf_counter(),
        )
        adm = self._admission
        with adm.cond:
            if self._closed:
                raise GatewayClosedError(f"gateway {self.name} is closed")
            limit = self.target_inflight
            if limit is not None and adm.inflight >= limit:
                if not block:
                    adm.rejected += 1
                    raise AdmissionError(
                        f"gateway {self.name} at target_inflight={limit}"
                    )
                adm.waiters += 1
                try:
                    ok = adm.cond.wait_for(
                        lambda: self._closed
                        or self.target_inflight is None
                        or adm.inflight < self.target_inflight,
                        timeout,
                    )
                finally:
                    adm.waiters -= 1
                if self._closed:
                    raise GatewayClosedError(f"gateway {self.name} is closed")
                if not ok:
                    adm.rejected += 1
                    raise AdmissionError(
                        f"admission wait timed out after {timeout}s"
                    )
            adm.inflight += 1
        key = (app, session)
        stripe = self._stripe_of(scoped)
        enqueue_ready = False
        with stripe.lock:
            lane = stripe.lanes.get(key)
            if lane is None:
                lane = stripe.lanes.setdefault(
                    key, _Lane(key, scoped, stripe)
                )
            lane.pending.append(item)
            stripe.submitted += 1
            if not lane.leased:
                # Acquire the state lease: the lane enters the ready queue
                # exactly once; whichever invoker pops it is the session's
                # exclusive writer until the lane drains.
                lane.leased = True
                enqueue_ready = True
        if enqueue_ready:
            self._ready.put(lane)
        return item.future

    def invoke(
        self,
        fn_name: str,
        app: str = "default",
        session: str = "default",
        init_kwargs: Optional[dict] = None,
        **inputs: Any,
    ) -> Any:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(
            fn_name, app=app, session=session, init_kwargs=init_kwargs,
            **inputs,
        ).result()

    def session(self, session_id: str, app: str = "default") -> Session:
        """A :class:`Session` whose ``invoke`` submits through the
        gateway (FIFO lane, lease, warm pool, admission control)."""
        sess = self.runtime.session(self.scoped_session(app, session_id))

        def route(fn_name: str, **inputs: Any) -> Any:
            return self.invoke(fn_name, app=app, session=session_id, **inputs)

        sess._route = route
        return sess

    # -- invoker pool ------------------------------------------------------
    @property
    def invokers(self) -> List[str]:
        with self._pool_lock:
            return sorted(self._alive)

    def add_invokers(self, n: int = 1) -> List[str]:
        """Grow the pool by ``n`` live invoker threads (autoscale-up)."""
        new_ids: List[str] = []
        with self._pool_lock:
            if self._closed:
                raise GatewayClosedError(f"gateway {self.name} is closed")
            for _ in range(n):
                inv_id = f"{self.name}/inv{self._invoker_seq:03d}"
                self._invoker_seq += 1
                stats = InvokerStats(invoker=inv_id)
                self._stats[inv_id] = stats
                self._alive.add(inv_id)
                t = threading.Thread(
                    target=self._invoker_loop, args=(stats,),
                    name=inv_id, daemon=True,
                )
                self._threads[inv_id] = t
                new_ids.append(inv_id)
            schedulers = list(self._schedulers)
        for inv_id in new_ids:
            self._threads[inv_id].start()
        for sched in schedulers:
            sched.add_workers(new_ids)
        return new_ids

    def remove_invokers(self, n: int = 1) -> None:
        """Shrink the pool by ``n`` invokers (autoscale-down).  Retirement
        is cooperative: tokens are queued and whichever invokers pop them
        exit after finishing their current invocation."""
        with self._pool_lock:
            # Count retire tokens already queued but not yet consumed —
            # otherwise back-to-back scale-downs could drain the pool to
            # zero while every invoker is busy.
            effective = len(self._alive) - self._pending_retires
            if n >= effective:
                raise ValueError(
                    f"cannot remove {n} of {effective} effective invokers "
                    "(at least one must remain)"
                )
            self._pending_retires += n
        for _ in range(n):
            self._ready.put(_RETIRE)

    def scale_to(self, n: int) -> None:
        """Autoscaling hook: converge the pool to ``n`` invokers."""
        if n < 1:
            raise ValueError("pool must keep at least one invoker")
        with self._pool_lock:
            effective = len(self._alive) - self._pending_retires
        if n > effective:
            self.add_invokers(n - effective)
        elif n < effective:
            self.remove_invokers(effective - n)

    def shared_scheduler(self, **kwargs: Any) -> Scheduler:
        """A :class:`Scheduler` whose worker *slots* mirror this
        gateway's invokers: worker ids track live add/remove, so scaling
        the gateway scales MapReduce capacity in lockstep (and locality
        preferences can name invokers).  DAG task bodies still run on the
        scheduler's own (persistent, ``reuse_pool``) executor — gateway
        admission control does not bound them."""
        kwargs.setdefault("speculation_factor", None)
        sched = Scheduler(self.invokers, reuse_pool=True, **kwargs)
        with self._pool_lock:
            self._schedulers.append(sched)
        return sched

    # -- invoker loop ------------------------------------------------------

    #: max invocations one lease dispatch may drain from its lane: bounds
    #: how long a hot session monopolizes an invoker before the lane
    #: re-enters the ready queue behind other sessions.
    LANE_BATCH = 64

    def _invoker_loop(self, stats: InvokerStats) -> None:
        ready = self._ready
        while True:
            lane = ready.get()
            if lane is _RETIRE:
                with self._pool_lock:
                    self._pending_retires = max(0, self._pending_retires - 1)
                self._retire(stats)
                return
            stripe = lane.stripe
            t0 = time.perf_counter()
            # Run-to-completion batching: with group commit on and a
            # commit-per-invocation cadence, drain the lane's queued
            # same-function run in one lease dispatch — the runtime then
            # executes it under one slot-lock hold and commits once
            # (intermediate states are never even serialized; see
            # FunctionRuntime.invoke_batch_with_records).  A larger
            # cadence would commit mid-batch at a different point than
            # sequential execution, so only commit_every == 1 batches.
            batchable = (
                self.runtime.group_commit and self.runtime.commit_every == 1
            )
            items: List[_Invocation] = []
            with stripe.lock:
                item = lane.pending.popleft()
                stripe.waits.append(t0 - item.enqueued)
                items.append(item)
                if batchable:
                    while (
                        len(items) < self.LANE_BATCH
                        and lane.pending
                        and lane.pending[0].fn_name == item.fn_name
                    ):
                        nxt = lane.pending.popleft()
                        stripe.waits.append(t0 - nxt.enqueued)
                        items.append(nxt)
            aborting = self._abort
            #: futures whose durable ack rides the shared batch ticket
            deferred: List[Tuple[Future, Any]] = []
            ticket: Optional[Any] = None
            try:
                if aborting:
                    # close(drain=False): fail fast instead of executing
                    for it in items:
                        if not it.future.done():
                            it.future.set_exception(
                                GatewayClosedError(
                                    "gateway closed before dispatch"
                                )
                            )
                elif len(items) == 1:
                    if item.future.set_running_or_notify_cancel():
                        try:
                            result, tk = self._execute(item, stats)
                        except BaseException as exc:
                            stats.errors += 1
                            item.future.set_exception(exc)
                        else:
                            if tk is None:
                                item.future.set_result(result)
                            else:
                                ticket = tk
                                deferred.append((item.future, result))
                else:
                    runnable = [
                        it for it in items
                        if it.future.set_running_or_notify_cancel()
                    ]
                    if runnable:
                        try:
                            with tier_accounting(stats.tier):
                                results = (
                                    self.runtime.invoke_batch_with_records(
                                        item.fn_name,
                                        item.scoped_session,
                                        [(it.init_kwargs, it.inputs)
                                         for it in runnable],
                                        invoker=stats.invoker,
                                    )
                                )
                        except BaseException as exc:
                            stats.errors += len(runnable)
                            for it in runnable:
                                it.future.set_exception(exc)
                        else:
                            for it, (outputs, record, error) in zip(
                                runnable, results
                            ):
                                if error is not None:
                                    stats.errors += 1
                                    it.future.set_exception(error)
                                    continue
                                stats.invocations += 1
                                if record.warm:
                                    stats.warm_hits += 1
                                else:
                                    stats.cold_starts += 1
                                if record.commit_ticket is None:
                                    it.future.set_result(outputs)
                                else:
                                    # one shared batch-final ticket
                                    ticket = record.commit_ticket
                                    deferred.append((it.future, outputs))
                            self._touch_warm(
                                item.fn_name, item.scoped_session
                            )
            finally:
                stats.busy_seconds += time.perf_counter() - t0
                with stripe.lock:
                    if lane.pending:
                        # Keep the lease; lane re-enters the ready queue
                        # (possibly picked up by a different invoker —
                        # FIFO holds because the lease is never shared).
                        requeue = True
                    else:
                        lane.leased = False
                        requeue = False
                if requeue:
                    ready.put(lane)
                for _ in range(len(items) - len(deferred)):
                    self._complete(stripe)
                if deferred:
                    # Durable ack: these Futures resolve (and their
                    # inflight slots free) only when the group flush
                    # lands — the lane is already released, so the
                    # session keeps executing while its commit batches.
                    def _ack(t: Any,
                             deferred: List[Tuple[Future, Any]] = deferred,
                             stripe: _Stripe = stripe) -> None:
                        for fut, result in deferred:
                            if t.error is not None:
                                fut.set_exception(t.error)
                            else:
                                fut.set_result(result)
                            self._complete(stripe)

                    ticket.add_done_callback(_ack)

    def _complete(self, stripe: _Stripe) -> None:
        with stripe.lock:
            stripe.completed += 1
        adm = self._admission
        with adm.lock:
            adm.inflight -= 1
            if adm.waiters:
                adm.cond.notify_all()

    def _execute(self, item: _Invocation, stats: InvokerStats) -> Any:
        with tier_accounting(stats.tier):
            outputs, record = self.runtime.invoke_with_record(
                item.fn_name,
                session=item.scoped_session,
                init_kwargs=item.init_kwargs,
                invoker=stats.invoker,
                defer_commit=self.runtime.group_commit,
                **item.inputs,
            )
        stats.invocations += 1
        if record.warm:
            stats.warm_hits += 1
        else:
            stats.cold_starts += 1
        self._touch_warm(item.fn_name, item.scoped_session)
        return outputs, record.commit_ticket

    def _retire(self, stats: InvokerStats) -> None:
        with self._pool_lock:
            stats.alive = False
            self._alive.discard(stats.invoker)
            self._threads.pop(stats.invoker, None)
            schedulers = list(self._schedulers)
        for sched in schedulers:
            sched.remove_workers([stats.invoker])

    # -- warm pool ---------------------------------------------------------
    def pin_warm(
        self, fn_name: str, app: str = "default", session: str = "default"
    ) -> None:
        """Exempt a (fn, session) context from warm-pool LRU eviction.

        An iterative dataflow loop pins its loop session so centroid /
        rank state stays hot across supersteps even while other tenants
        churn the pool; :meth:`unpin_warm` when the loop ends.  Pinned
        contexts don't count against ``warm_pool`` when picking victims
        (pins express residency, not extra capacity)."""
        with self._pin_lock:
            self._warm_pins.add((fn_name, self.scoped_session(app, session)))

    def unpin_warm(
        self, fn_name: str, app: str = "default", session: str = "default"
    ) -> None:
        with self._pin_lock:
            self._warm_pins.discard(
                (fn_name, self.scoped_session(app, session))
            )

    def _lru_size(self) -> int:
        # len() is GIL-atomic per stripe; the sum is a sufficient
        # overflow signal — exact enforcement happens under stripe locks
        # in the eviction loop.
        return sum(len(s.lru) for s in self._stripes)

    def _touch_warm(self, fn_name: str, scoped_session: str) -> None:
        key = (fn_name, scoped_session)
        stripe = self._stripe_of(scoped_session)
        with stripe.lock:
            stripe.lru[key] = next(self._touch_clock)
            stripe.lru.move_to_end(key)
        if self._lru_size() > self.warm_pool:
            self._evict_overflow()

    def _evict_overflow(self) -> None:
        while self._lru_size() > self.warm_pool:
            # Victim = globally-oldest unpinned context.  Each stripe's
            # LRU front is its oldest entry, so scanning the fronts (in
            # stripe order) finds the global minimum touch stamp.
            best: Optional[Tuple[int, _Stripe, Tuple[str, str]]] = None
            for stripe in self._stripes:
                with stripe.lock:
                    for key, stamp in stripe.lru.items():
                        if key not in self._warm_pins:
                            if best is None or stamp < best[0]:
                                best = (stamp, stripe, key)
                            break  # only the oldest unpinned per stripe
            if best is None:
                return  # everything pinned: the pool runs hot
            stamp, stripe, key = best
            with stripe.lock:
                if stripe.lru.get(key) != stamp:
                    continue  # re-touched since the scan; pick again
                del stripe.lru[key]
            # Commit-then-demote outside the stripe locks (tier I/O); the
            # runtime's slot lock serializes against a concurrent invoke.
            # Demotion pushes the committed blob out of the cache's fast
            # tier (a real move on a TieredStore-backed cache), so cold
            # sessions stop occupying DRAM the warm pool wants.
            if self.runtime.evict(key[0], key[1], commit=True, demote=True):
                with stripe.lock:
                    stripe.evictions += 1
                hook = self.on_evict
                if hook is not None:
                    try:
                        hook(key[0], key[1])
                    except Exception:  # noqa: BLE001 — a bad hook must
                        pass  # not wedge the warm path's eviction loop

    def warm_contexts(self) -> List[Tuple[str, str]]:
        """(fn, scoped_session) contexts currently warm, LRU → MRU."""
        stamped: List[Tuple[int, Tuple[str, str]]] = []
        for stripe in self._stripes:  # all stripes, in order
            with stripe.lock:
                stamped.extend(
                    (stamp, key) for key, stamp in stripe.lru.items()
                )
        stamped.sort()
        return [key for _, key in stamped]

    # -- introspection -----------------------------------------------------

    #: most-recent lane-wait samples read per stripe by load_snapshot —
    #: bounds the snapshot's cost regardless of the stripes' 2048-deep
    #: sample windows.
    SNAPSHOT_WAITS = 64

    def load_snapshot(self) -> LoadSnapshot:
        """The autoscaler observable: per-stripe queue depth, inflight,
        warm/cold counters, and a bounded-sample wait p99.

        Stripe locks are taken one at a time (never all at once) and
        each critical section is a few integer reads plus a bounded
        slice of the wait deque — polling this on a 100ms control
        interval does not contend with the warm path the way a full
        :meth:`stats` rollup (which copies every wait sample and merges
        per-invoker :class:`TierStats`) would."""
        per_stripe: List[int] = []
        waits: List[float] = []
        for stripe in self._stripes:
            with stripe.lock:
                per_stripe.append(
                    sum(len(lane.pending) for lane in stripe.lanes.values())
                )
                n = len(stripe.waits)
                if n:
                    waits.extend(
                        list(stripe.waits)[max(0, n - self.SNAPSHOT_WAITS):]
                    )
        adm = self._admission
        with adm.lock:
            inflight = adm.inflight
            rejected = adm.rejected
        with self._pool_lock:
            invokers = len(self._alive) - self._pending_retires
            # plain int reads; InvokerStats counters are GIL-atomic.
            warm = sum(s.warm_hits for s in self._stats.values())
            cold = sum(s.cold_starts for s in self._stats.values())
        waits.sort()
        resident = paged = 0
        pressure = self._kv_pressure
        if pressure is not None:
            try:
                resident, paged = pressure()
            except Exception:  # noqa: BLE001 — snapshot stays cheap/safe
                resident = paged = 0
        return LoadSnapshot(
            queue_depth=sum(per_stripe),
            queue_per_stripe=per_stripe,
            inflight=inflight,
            invokers=invokers,
            warm_hits=warm,
            cold_starts=cold,
            rejected=rejected,
            wait_p99_ms=_pct(waits, 0.99) * 1e3,
            resident_sessions=resident,
            paged_sessions=paged,
        )

    def set_kv_pressure(
        self, provider: Optional[Callable[[], Tuple[int, int]]]
    ) -> None:
        """Install (or clear) the serving pool's KV-pressure provider —
        a cheap ``() -> (resident_sessions, paged_sessions)`` read
        surfaced through :meth:`load_snapshot`."""
        self._kv_pressure = provider

    def stats(self) -> GatewayStats:
        submitted = completed = evictions = 0
        waits: List[float] = []
        for stripe in self._stripes:  # all stripes, in order
            with stripe.lock:
                submitted += stripe.submitted
                completed += stripe.completed
                evictions += stripe.evictions
                waits.extend(stripe.waits)
        adm = self._admission
        with adm.lock:
            inflight = adm.inflight
            rejected = adm.rejected
        with self._pool_lock:
            per_invoker = list(self._stats.values())
        tier = TierStats()
        for s in per_invoker:
            tier.merge_into(s.tier)
        committer = getattr(self.runtime, "_committer", None)
        if committer is not None:
            # The flusher thread's I/O is scoped to the committer, not to
            # any invoker — merging it here keeps the rollup complete
            # without counting any physical op twice.
            tier.merge_into(committer.stats)
        waits.sort()
        return GatewayStats(
            submitted=submitted,
            completed=completed,
            rejected=rejected,
            evictions=evictions,
            inflight=inflight,
            warm_hits=sum(s.warm_hits for s in per_invoker),
            cold_starts=sum(s.cold_starts for s in per_invoker),
            lane_wait_p50_ms=_pct(waits, 0.50) * 1e3,
            lane_wait_p99_ms=_pct(waits, 0.99) * 1e3,
            tier=tier,
            invokers=per_invoker,
        )

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted invocation has fully completed —
        including deferred durable acks and their completion bookkeeping,
        which intentionally run *after* the invocation's Future resolves
        (the warm path never waits on accounting).  Unlike
        ``close(drain=True)`` the gateway stays open.  Returns False on
        timeout.  Callers comparing ``stats()`` counters against a known
        submission count should quiesce first."""
        adm = self._admission
        with adm.cond:
            adm.waiters += 1
            try:
                return adm.cond.wait_for(lambda: adm.inflight == 0, timeout)
            finally:
                adm.waiters -= 1

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop admitting; optionally drain in-flight work; retire the
        pool.  With ``drain=False``, still-pending invocations fail with
        :class:`GatewayClosedError`."""
        adm = self._admission
        with adm.cond:
            if self._closed:
                return
            self._closed = True
            adm.cond.notify_all()  # wake blocked submitters
            if drain:
                # Inflight includes deferred (group-commit) acks, so a
                # drained close implies every acked Future is durable.
                adm.waiters += 1
                try:
                    adm.cond.wait_for(lambda: adm.inflight == 0, timeout)
                finally:
                    adm.waiters -= 1
            else:
                self._abort = True  # invokers fail pending items fast
        with self._pool_lock:
            n_alive = len(self._alive)
            threads = list(self._threads.values())
        for _ in range(n_alive):
            self._ready.put(_RETIRE)
        for t in threads:
            t.join(timeout=5.0)
        pending: List[_Invocation] = []
        for stripe in self._stripes:
            # Under the stripe lock: a straggler invoker (join timed out)
            # pops lane items under this same lock, so draining is safe.
            with stripe.lock:
                for lane in stripe.lanes.values():
                    pending.extend(lane.pending)
                    lane.pending.clear()
        for item in pending:
            if not item.future.done():
                item.future.set_exception(
                    GatewayClosedError("gateway closed before dispatch")
                )
        with self._pool_lock:
            schedulers = list(self._schedulers)
        for sched in schedulers:
            sched.close()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close(drain=exc[0] is None)
