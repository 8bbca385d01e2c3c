"""Stage-DAG execution model — jobs as partition-granular dataflow.

The original engine ran MapReduce Corral-style: a hard barrier between the
map wave and the reduce wave, with every shuffle partition fully
materialized before any reducer started.  This module is the seam that
removes the barrier: a job is declared as *stages* of :class:`TaskSpec`\\ s
whose edges are **tokens** — opaque strings naming either a finished task
(``task:<id>``) or a committed piece of data (a tier key, one shuffle
partition).  The scheduler (:meth:`repro_torch.core.scheduler.Scheduler.run_dag`)
dispatches any task whose dependency tokens are published, so consumers
start while producers are still running, and task sets from *several* jobs
can be concatenated and run over one worker pool.

Two consumption styles:

  * **barrier** task (``streaming=False``): dispatched only once every
    token in ``deps`` is published.  This reproduces wave semantics
    exactly (the old reduce wave is a barrier task depending on every map
    task token).
  * **streaming** task (``streaming=True``): dispatched immediately (its
    ``deps`` are usually empty) on an *overlap slot* and handed a
    :class:`TaskContext` whose ``events`` queue receives every published
    token matching ``listens`` — including tokens published *before* the
    task launched (the queue is primed), so late launches and retries
    never miss data.  A streaming reducer merges shuffle partitions as
    they commit instead of re-scanning the tier after the barrier.

Overlap slots: each worker owns one compute slot (producers) plus one
overlap slot (streaming consumers).  Streaming tasks therefore never
starve producers of compute slots — the DAG cannot deadlock on its own
pipelining, which models a FaaS node running an I/O-bound reducer
container alongside a compute-bound mapper container (see DESIGN.md §4).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set

__all__ = ["TaskContext", "TaskSpec", "StageDag", "task_token"]


def task_token(task_id: str) -> str:
    """Token published when task ``task_id`` completes successfully."""
    return f"task:{task_id}"


@dataclass
class TaskContext:
    """Runtime handle given to a DAG task's ``run`` callable.

    ``events`` is None for barrier tasks.  ``publish`` lets a task announce
    data tokens mid-run (partition commits); publishing is idempotent.
    ``stopped`` is set when the run is aborting — streaming tasks polling
    ``events`` must check it and bail out.
    """

    worker: str
    publish: Callable[[str], None]
    events: Optional["queue.Queue[str]"] = None
    stopped: threading.Event = field(default_factory=threading.Event)

    def next_event(self, timeout: float = 0.02) -> Optional[str]:
        """One token from the stream, or None on timeout.

        Raises RuntimeError if the run is aborting (permanent failure
        elsewhere in the DAG) so blocked consumers unwind promptly.
        """
        if self.events is None:
            raise RuntimeError("next_event() on a non-streaming task")
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            if self.stopped.is_set():
                raise RuntimeError("DAG run aborted while awaiting events")
            return None


@dataclass
class TaskSpec:
    """One schedulable task in a stage DAG."""

    task_id: str
    run: Callable[[TaskContext], Any]
    #: stage name, for grouping/metrics only (execution order comes from
    #: tokens, not stages).
    stage: str = ""
    #: preferred worker ids (data locality), best-effort.
    preferred: Sequence[str] = ()
    #: tokens that must all be published before dispatch.
    deps: frozenset = frozenset()
    #: extra tokens published on successful completion (``task:<id>`` is
    #: always published implicitly).
    produces: Sequence[str] = ()
    #: streaming consumer — runs on an overlap slot with an event queue.
    streaming: bool = False
    #: predicate selecting which published tokens feed ``events``.
    listens: Optional[Callable[[str], bool]] = None
    #: called (in the scheduler loop) with the TaskResult after success —
    #: journal commits hook in here, *before* dependents can observe the
    #: task token.
    on_complete: Optional[Callable[[Any], None]] = None
    #: eligible for speculative backup attempts (barrier tasks only; a
    #: streaming attempt owns a live event cursor and cannot be raced).
    speculatable: bool = True


class StageDag:
    """Assembler/validator for a set of :class:`TaskSpec`.

    Mostly bookkeeping sugar: jobs lower themselves into specs and use the
    dag to validate token wiring before handing ``specs`` to the
    scheduler.  ``merge`` concatenates independent jobs so they share one
    ``run_dag`` call (one worker pool, interleaved dispatch).
    """

    def __init__(self, name: str = "dag") -> None:
        self.name = name
        self.specs: List[TaskSpec] = []
        self._ids: Set[str] = set()
        #: tokens that prime the scheduler's token table instead of being
        #: produced by a live task — populated by :meth:`resume` and
        #: passed as ``run_dag(initial_tokens=...)``.
        self.initial_tokens: List[str] = []
        #: (task_id, stage) of journal-resumed tasks (no live spec).
        self._resumed: List[tuple] = []

    def add(self, spec: TaskSpec) -> TaskSpec:
        if spec.task_id in self._ids:
            raise ValueError(f"duplicate task id {spec.task_id!r}")
        self._ids.add(spec.task_id)
        self.specs.append(spec)
        return spec

    def resume(
        self, task_id: str, stage: str = "", produces: Sequence[str] = ()
    ) -> None:
        """Record ``task_id`` as already complete (journal-resumed): its
        task token plus ``produces`` prime the token table instead of
        scheduling work.  The task still counts toward
        :meth:`stage_tokens`, so later-stage barriers stay satisfiable
        when part of an earlier stage resumed."""
        if task_id in self._ids:
            raise ValueError(f"duplicate task id {task_id!r}")
        self._ids.add(task_id)
        self._resumed.append((task_id, stage))
        self.initial_tokens.append(task_token(task_id))
        self.initial_tokens.extend(produces)

    def stage_tasks(self, stage: str) -> List[TaskSpec]:
        return [s for s in self.specs if s.stage == stage]

    def stage_tokens(self, stage: str) -> frozenset:
        """Completion-token set of every task in ``stage`` — live *and*
        resumed — i.e. the barrier dependency for a following stage."""
        toks = {task_token(s.task_id) for s in self.specs if s.stage == stage}
        toks.update(
            task_token(tid) for tid, st in self._resumed if st == stage
        )
        return frozenset(toks)

    def merge(self, other: "StageDag") -> "StageDag":
        for spec in other.specs:
            self.add(spec)
        for tid, stage in other._resumed:
            if tid in self._ids:
                raise ValueError(f"duplicate task id {tid!r}")
            self._ids.add(tid)
            self._resumed.append((tid, stage))
        self.initial_tokens.extend(other.initial_tokens)
        return self

    def validate(self, external_tokens: Iterable[str] = ()) -> None:
        """Every dep must be producible: by a task token, a declared
        ``produces`` entry, or an external token (tier watch / journal
        priming — ``self.initial_tokens`` is always included).  Catches
        typos that would hang the run forever."""
        producible: Set[str] = set(external_tokens)
        producible.update(self.initial_tokens)
        for spec in self.specs:
            producible.add(task_token(spec.task_id))
            producible.update(spec.produces)
        missing: Dict[str, List[str]] = {}
        for spec in self.specs:
            bad = [d for d in spec.deps if d not in producible]
            if bad:
                missing[spec.task_id] = bad
        if missing:
            raise ValueError(f"unsatisfiable deps: {missing}")
