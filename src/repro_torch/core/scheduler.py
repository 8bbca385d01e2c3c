"""Task scheduler — the YARN analog.

Plans and executes task sets (map waves, reduce waves) over a pool of
worker slots with the fault-tolerance features a 1000-node deployment
needs and the paper defers to future work:

  * retry with bounded attempts on task failure,
  * speculative execution: when a task runs longer than
    ``speculation_factor ×`` the median completed duration, a backup
    attempt is launched and the first finisher wins (straggler
    mitigation),
  * locality-aware placement: tasks carry preferred workers (from the
    BlockStore replica map) and the scheduler matches when possible,
  * elastic pool: workers can be added/removed between waves.

Execution is thread-based; tasks are host-side functions (MapReduce tasks
do tier I/O + compute).  Determinism for tests comes from task outputs
being content-addressed, not from scheduling order.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import TaskContext, TaskSpec, task_token

__all__ = ["Task", "TaskResult", "Scheduler", "TaskFailedError"]


class TaskFailedError(RuntimeError):
    pass


@dataclass
class Task:
    task_id: str
    run: Callable[[str], Any]  # worker_id -> result
    #: preferred worker ids (data locality), best-effort.
    preferred: Sequence[str] = ()


@dataclass
class TaskResult:
    task_id: str
    value: Any
    worker: str
    attempts: int
    speculative_win: bool
    seconds: float
    #: perf_counter timestamps of the winning attempt (pipeline metrics).
    started: float = 0.0
    ended: float = 0.0


@dataclass
class _Attempt:
    task: Task
    worker: str
    future: Future
    started: float
    speculative: bool


class Scheduler:
    def __init__(
        self,
        workers: Sequence[str],
        max_attempts: int = 3,
        speculation_factor: Optional[float] = 2.0,
        min_speculation_seconds: float = 0.05,
        reuse_pool: bool = False,
    ) -> None:
        """``reuse_pool=True`` keeps one ThreadPoolExecutor alive across
        ``run_dag`` calls (grown when workers are added) instead of
        creating/tearing one down per run — the shared-pool mode the
        gateway uses so MapReduce jobs ride the same invoker pool as
        function invocations (call :meth:`close` when done)."""
        self.workers: List[str] = list(workers)
        self.max_attempts = max_attempts
        self.speculation_factor = speculation_factor
        self.min_speculation_seconds = min_speculation_seconds
        self.reuse_pool = reuse_pool
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        self._retired_pools: List[ThreadPoolExecutor] = []

    # -- elastic pool ----------------------------------------------------------
    def add_workers(self, workers: Sequence[str]) -> None:
        with self._lock:
            self.workers.extend(w for w in workers if w not in self.workers)

    def remove_workers(self, workers: Sequence[str]) -> None:
        with self._lock:
            self.workers = [w for w in self.workers if w not in workers]

    @contextlib.contextmanager
    def pooled(self):
        """Keep one executor alive across consecutive :meth:`run_dag`
        calls for the duration of the scope — an iterative loop's
        supersteps reuse warm threads instead of paying pool setup and
        teardown per superstep.  Restores the previous mode on exit and
        reaps the pool if this scope was the one that created it (a
        scheduler already in ``reuse_pool`` mode keeps its pool)."""
        with self._lock:
            prev = self.reuse_pool
            self.reuse_pool = True
        try:
            yield self
        finally:
            with self._lock:
                self.reuse_pool = prev
            if not prev:
                self.close()

    def close(self) -> None:
        """Shut down the persistent pool(s) (``reuse_pool=True`` mode)."""
        with self._lock:
            pools = list(self._retired_pools)
            if self._pool is not None:
                pools.append(self._pool)
            self._pool, self._pool_size = None, 0
            self._retired_pools.clear()
        for pool in pools:
            pool.shutdown(wait=False, cancel_futures=True)

    def _acquire_pool(self, slots: int) -> Tuple[ThreadPoolExecutor, bool]:
        """An executor with >= ``slots`` threads; bool = caller owns it.

        Growth never shuts the outgrown pool down — a concurrent
        ``run_dag`` may still be submitting to it; outgrown pools are
        parked and reaped in :meth:`close`.
        """
        if not self.reuse_pool:
            return ThreadPoolExecutor(max_workers=slots), True
        with self._lock:
            if self._pool is None or self._pool_size < slots:
                if self._pool is not None:
                    self._retired_pools.append(self._pool)
                self._pool = ThreadPoolExecutor(max_workers=slots)
                self._pool_size = slots
            return self._pool, False

    # -- execution -----------------------------------------------------------
    def run_wave(self, tasks: Sequence[Task]) -> Dict[str, TaskResult]:
        """Run a wave of tasks to completion; returns task_id -> result.

        A wave is the degenerate DAG: dependency-free barrier tasks.
        Retry, locality, and speculation all come from :meth:`run_dag`.
        """
        specs = [
            TaskSpec(
                t.task_id,
                (lambda ctx, t=t: t.run(ctx.worker)),
                preferred=t.preferred,
            )
            for t in tasks
        ]
        return self.run_dag(specs)

    # -- continuous DAG execution ---------------------------------------------
    def run_dag(
        self,
        specs: Sequence[TaskSpec],
        initial_tokens: Sequence[str] = (),
        subscribers: Sequence[Callable[[Callable[[str], None]], Callable[[], None]]] = (),
    ) -> Dict[str, TaskResult]:
        """Continuous, dependency-aware execution of a task DAG.

        Unlike :meth:`run_wave` there is no barrier: any task whose
        dependency tokens are all published is dispatched immediately, and
        *streaming* tasks launch right away on overlap slots and consume
        tokens as they appear — so consumers overlap with producers.

        ``initial_tokens`` primes the token table (journal-resumed work).
        ``subscribers`` are callables receiving the run's thread-safe
        ``publish`` function and returning an unsubscribe callable — the
        hook tier ``watch`` plugs into, turning storage commits into
        dataflow events.

        Retains :meth:`run_wave` semantics per task: bounded retry,
        locality preference, and speculative backups (barrier tasks only —
        a streaming attempt owns a live event cursor and cannot be raced).
        """
        if not self.workers:
            raise RuntimeError("scheduler has no workers")
        specs = list(specs)
        if len({s.task_id for s in specs}) != len(specs):
            raise ValueError("duplicate task ids in DAG")
        results: Dict[str, TaskResult] = {}
        attempts_used: Dict[str, int] = {s.task_id: 0 for s in specs}
        durations: List[float] = []
        live: Dict[Future, _Attempt] = {}

        lock = threading.Lock()
        published: set = set(initial_tokens)
        missing: Dict[str, set] = {
            s.task_id: set(s.deps) - published for s in specs
        }
        waiters: Dict[str, List[str]] = {}
        for s in specs:
            for dep in s.deps:
                waiters.setdefault(dep, []).append(s.task_id)
        #: task_id -> event queue of the live streaming attempt.
        stream_queues: Dict[str, "queue.Queue[str]"] = {}
        spec_by_id = {s.task_id: s for s in specs}
        stop_event = threading.Event()

        def publish(token: str) -> None:
            with lock:
                if token in published:
                    return
                published.add(token)
                for tid in waiters.get(token, ()):
                    missing[tid].discard(token)
                for tid, q in stream_queues.items():
                    listens = spec_by_id[tid].listens
                    if listens is not None and listens(token):
                        q.put(token)

        unsubscribes = [sub(publish) for sub in subscribers]

        pending: List[TaskSpec] = list(specs)
        # Compute slots (producers/barrier tasks) and overlap slots
        # (streaming consumers) — one of each per worker, so pipelined
        # consumers can never starve producers: no self-deadlock.
        with self._lock:
            run_workers = list(self.workers)
        free: List[str] = list(run_workers)
        overlap_free: List[str] = list(run_workers)
        pool, own_pool = self._acquire_pool(2 * max(1, len(run_workers)))

        def runnable() -> List[TaskSpec]:
            with lock:
                return [s for s in pending if not missing[s.task_id]]

        def launch(spec: TaskSpec, speculative: bool) -> None:
            slots = overlap_free if spec.streaming else free
            worker = next((w for w in spec.preferred if w in slots), None)
            if worker is None and slots:
                worker = slots[0]
            if worker is None:
                return
            slots.remove(worker)
            attempts_used[spec.task_id] += 1
            events = None
            if spec.streaming:
                events = queue.Queue()
                with lock:
                    # Prime with everything already published so a late
                    # launch (or a retry) never misses data tokens.
                    if spec.listens is not None:
                        for tok in published:
                            if spec.listens(tok):
                                events.put(tok)
                    stream_queues[spec.task_id] = events
            ctx = TaskContext(
                worker=worker, publish=publish, events=events,
                stopped=stop_event,
            )
            fut = pool.submit(spec.run, ctx)
            live[fut] = _Attempt(spec, worker, fut, time.perf_counter(), speculative)

        try:
            while len(results) < len(specs):
                # Launch every ready task a slot can take; one pass over
                # the ready snapshot per round (tokens published by these
                # launches are picked up next tick).
                progressed = True
                while progressed:
                    progressed = False
                    for spec in runnable():  # insertion order: producers first
                        slots = overlap_free if spec.streaming else free
                        if not slots:
                            continue
                        pending.remove(spec)
                        launch(spec, speculative=False)
                        progressed = True
                if not live:
                    stuck = {
                        s.task_id: sorted(missing[s.task_id])
                        for s in pending
                    }
                    raise TaskFailedError(
                        f"DAG stalled: no running tasks, waiting on {stuck}"
                        if stuck else
                        "tasks failed permanently: "
                        f"{[s for s in attempts_used if s not in results]}"
                    )
                done, _ = wait(live.keys(), timeout=0.01, return_when=FIRST_COMPLETED)
                now = time.perf_counter()
                for fut in done:
                    att = live.pop(fut)
                    spec: TaskSpec = att.task
                    tid = spec.task_id
                    (overlap_free if spec.streaming else free).append(att.worker)
                    with lock:
                        if stream_queues.get(tid) is not None and not any(
                            a.task.task_id == tid for a in live.values()
                        ):
                            stream_queues.pop(tid, None)
                    if tid in results:
                        continue  # a sibling attempt already won
                    err = fut.exception()
                    dur = now - att.started
                    if err is None:
                        durations.append(dur)
                        res = TaskResult(
                            tid, fut.result(), att.worker,
                            attempts_used[tid], att.speculative, dur,
                            started=att.started, ended=now,
                        )
                        if spec.on_complete is not None:
                            # Runs before the task token publishes, so a
                            # journal commit is durable before dependents
                            # can observe completion.
                            spec.on_complete(res)
                        results[tid] = res
                        publish(task_token(tid))
                        for tok in spec.produces:
                            publish(tok)
                    else:
                        if getattr(err, "non_retryable", False):
                            raise err
                        still_running = any(
                            a.task.task_id == tid for a in live.values()
                        )
                        if attempts_used[tid] < self.max_attempts:
                            pending.append(spec)  # retry
                        elif not still_running:
                            raise TaskFailedError(
                                f"task {tid} failed after "
                                f"{attempts_used[tid]} attempts"
                            ) from err
                # Speculation: back up slow barrier-task outliers.  Gate on
                # "nothing launchable is waiting" (pending tasks blocked on
                # unmet deps — e.g. wave-mode reducers — must not suppress
                # backups for straggler producers).
                with lock:
                    launchable_waiting = any(
                        not missing[s.task_id] for s in pending
                    )
                if (
                    self.speculation_factor is not None
                    and durations
                    and free
                    and not launchable_waiting
                ):
                    median = sorted(durations)[len(durations) // 2]
                    threshold = max(
                        self.min_speculation_seconds,
                        median * self.speculation_factor,
                    )
                    running_tids = [a.task.task_id for a in live.values()]
                    for att in list(live.values()):
                        if not free:
                            break
                        spec = att.task
                        tid = spec.task_id
                        if (
                            not spec.streaming
                            and spec.speculatable
                            and now - att.started > threshold
                            and running_tids.count(tid) == 1
                            and attempts_used[tid] < self.max_attempts
                        ):
                            launch(spec, speculative=True)
            return results
        finally:
            stop_event.set()
            for unsub in unsubscribes:
                unsub()
            if own_pool:
                pool.shutdown(wait=False, cancel_futures=True)
