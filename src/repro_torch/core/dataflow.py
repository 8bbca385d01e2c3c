"""Iterative multi-stage dataflow engine — N-stage jobs and fixed-point
loops lowered onto the stage-DAG machinery.

The MapReduce front-end (``core/mapreduce.py``) expresses exactly one job
shape: two stages with a shuffle between them.  The paper's statefulness
argument, though, pays off hardest on *iterative* analytics — PageRank,
k-means, any fixed-point computation — where the same loop-carried state
is touched every superstep and a stock-serverless runtime reloads it from
S3 each time (Cloudburst and Faasm both motivate shared in-memory state
with precisely these workloads; see PAPERS.md).  This module generalizes
the execution layer:

  * **declarative stages** — a job is an ordered list of :class:`Stage`\\ s
    of :class:`StageTask`\\ s; :func:`lower_stages` wires consecutive
    stages with barrier tokens (or per-stage overrides / streaming
    consumers) and emits one validated
    :class:`~repro_torch.core.dag.StageDag`.  MapReduce now lowers through the
    same helper — it is just a 2-stage dataflow.
  * **one-shot N-stage jobs** — :func:`run_stages` executes a stage list
    with task-granular journaled resume (a re-run skips tasks whose
    commit marker and declared ``outputs`` both survive).  TeraSort's
    sample → range-partition → per-partition-sort pipeline, inexpressible
    in the MapReduce front-end, is three such stages.
  * **fixed-point loops** — :func:`run_loop` drives supersteps: each
    iteration instantiates a fresh per-iteration stage set (task ids
    namespaced ``df/<job>/itNNNNN/...``), runs it on a pooled scheduler
    (warm threads across supersteps), evaluates a convergence predicate
    *between* supersteps, and commits a per-iteration marker to the
    :class:`~repro_torch.core.journal.StateJournal` so a crash mid-iteration
    resumes at the last completed superstep **byte-identically**.

Loop state protocol (DESIGN.md §8):

  * loop-carried state lives in a caller-supplied tier under versioned
    keys ``df/<job>/state/itNNNNN/<name>`` (:class:`LoopContext` owns the
    naming); superstep *k* reads version *k-1* and writes version *k*;
  * on a :class:`~repro_torch.storage.hierarchy.TieredStore` the whole job
    prefix is **pinned** in the fast level for the life of the loop
    (``pin``/``unpin`` placement hook) — state stays hot instead of
    round-tripping through the modeled S3 home between supersteps;
  * the iteration marker commits strictly *after* the superstep's state
    blobs (they land during the DAG run), so a torn run leaves blobs
    without a marker — the resume path re-runs that superstep from the
    previous version and, tasks being deterministic, reproduces the same
    bytes — but never a marker whose state is missing;
  * after marker *k* commits, version *k-1* retires (blobs deleted,
    marker retracted): the journal and the pinned working set stay O(1)
    in the iteration count.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.core.dag import StageDag, TaskContext, TaskSpec, task_token
from repro_torch.core.journal import StateJournal
from repro_torch.core.scheduler import Scheduler, TaskResult
from repro_torch.storage.tiers import Tier

if TYPE_CHECKING:  # annotation only — keeps the import graph acyclic
    from repro_torch.core.device_shuffle import DeviceExec
    from repro_torch.core.gateway import Gateway
    from repro_torch.storage.kvcache import StateCache

__all__ = [
    "Stage",
    "StageTask",
    "LoopContext",
    "LoopReport",
    "StageRunReport",
    "current_device_exec",
    "lower_stages",
    "run_stages",
    "run_loop",
    "stage_task_id",
]


# Device-execution context for the *current* task, set around opted-in
# task bodies (tasks run on scheduler worker threads, so this must be
# thread-local, not a module global).
_DEVICE_TLS = threading.local()


def current_device_exec() -> Optional["DeviceExec"]:
    """The :class:`~repro_torch.core.device_shuffle.DeviceExec` of the running
    stage task, or ``None`` when the job runs host-side.  Task bodies
    that have a device lowering (e.g. TeraSort's scatter) consult this
    instead of taking a parameter — the engine owns the mode."""
    return getattr(_DEVICE_TLS, "exec", None)


def _with_device(
    run: Callable[[TaskContext], Any], device: "DeviceExec"
) -> Callable[[TaskContext], Any]:
    def wrapped(ctx: TaskContext) -> Any:
        _DEVICE_TLS.exec = device
        try:
            return run(ctx)
        finally:
            _DEVICE_TLS.exec = None

    return wrapped


# -- declarative stages -------------------------------------------------------

@dataclass
class StageTask:
    """One task of a dataflow stage.

    ``tid`` is relative to the lowering namespace (``lower_stages``
    prefixes it); ``deps`` entries of the form ``task:<tid>`` are
    namespaced the same way, so intra-graph task dependencies can be
    declared without knowing the final namespace.  Data-key deps (tier
    keys) pass through untouched.
    """

    tid: str
    run: Optional[Callable[[TaskContext], Any]] = None
    preferred: Sequence[str] = ()
    #: streaming consumer — overlap slot + event queue, no stage barrier.
    streaming: bool = False
    listens: Optional[Callable[[str], bool]] = None
    #: extra dependency tokens beyond the stage barrier.
    deps: Sequence[str] = ()
    #: extra tokens published on completion.
    produces: Sequence[str] = ()
    #: tier keys this task writes — ``run_stages`` checks these on resume
    #: (committed marker + missing output = the tier lost it: re-run).
    outputs: Sequence[str] = ()
    on_complete: Optional[Callable[[TaskResult], None]] = None
    speculatable: bool = True
    #: already committed by a prior run: its token (plus produces/outputs)
    #: primes the DAG instead of scheduling work.
    resumed: bool = False
    #: opt in to device execution: when the run gets a ``device=``
    #: context, this task's body sees it via :func:`current_device_exec`.
    device: bool = False


@dataclass
class Stage:
    """An ordered group of tasks.

    ``after`` names the stages whose *every* task must complete before
    this stage's (non-streaming) tasks dispatch.  ``None`` (default)
    means the previous stage in the list; ``()`` means no barrier —
    streaming stages and independent side-stages want that.
    """

    name: str
    tasks: List[StageTask]
    after: Optional[Sequence[str]] = None


def stage_task_id(job: str, tid: str) -> str:
    """The namespaced DAG task id ``run_stages`` gives task ``tid``."""
    return f"df/{job}/{tid}"


def lower_stages(
    name: str,
    stages: Sequence[Stage],
    namespace: str = "",
    external_tokens: Sequence[str] = (),
) -> StageDag:
    """Lower ordered ``stages`` into one validated :class:`StageDag`.

    Consecutive stages are wired with barrier tokens over the *full*
    task set of the dependency stage — live and resumed tasks alike
    (resumed tokens ride ``dag.initial_tokens``).  ``namespace`` (must
    end with ``/`` when given) prefixes every task id and rewrites
    ``task:`` deps accordingly — the iterative loop uses it for
    per-iteration instantiation.  ``external_tokens`` declares deps
    satisfied from outside the DAG (tier-watch subscribers, data already
    in the tier) so validation doesn't reject them as unsatisfiable.
    """
    if namespace and not namespace.endswith("/"):
        raise ValueError("namespace must end with '/'")
    dag = StageDag(name)
    seen_stages: set = set()

    def ns_dep(dep: str) -> str:
        if dep.startswith("task:"):
            return task_token(namespace + dep[len("task:"):])
        return dep

    for i, st in enumerate(stages):
        if st.name in seen_stages:
            raise ValueError(f"duplicate stage name {st.name!r}")
        after = st.after
        if after is None:
            after = (stages[i - 1].name,) if i else ()
        barrier: frozenset = frozenset()
        for dep_stage in after:
            if dep_stage not in seen_stages:
                # Stages register in list order, so a barrier may only
                # name an *earlier* stage — a forward barrier could
                # never be satisfied and would stall the run.
                raise ValueError(
                    f"stage {st.name!r} depends on unknown (or later) "
                    f"stage {dep_stage!r}"
                )
            barrier |= dag.stage_tokens(dep_stage)
        seen_stages.add(st.name)
        for t in st.tasks:
            sid = namespace + t.tid
            if t.resumed:
                dag.resume(
                    sid, stage=st.name,
                    produces=list(t.produces) + list(t.outputs),
                )
                continue
            if t.run is None:
                raise ValueError(f"live task {sid!r} has no run callable")
            deps = frozenset(ns_dep(d) for d in t.deps)
            if not t.streaming:
                deps |= barrier
            dag.add(TaskSpec(
                sid, t.run, stage=st.name, preferred=tuple(t.preferred),
                deps=deps, produces=tuple(t.produces),
                streaming=t.streaming, listens=t.listens,
                on_complete=t.on_complete, speculatable=t.speculatable,
            ))
    dag.validate(external_tokens=external_tokens)
    return dag


# -- shared engine plumbing ---------------------------------------------------

def _resolve_scheduler(
    scheduler: Optional[Scheduler], gateway: Optional["Gateway"]
) -> Scheduler:
    if scheduler is None and gateway is not None:
        scheduler = gateway.shared_scheduler()
    if scheduler is None:
        scheduler = Scheduler(workers=[f"w{i}" for i in range(4)])
    return scheduler


def _modeled(tier: Tier) -> float:
    return tier.stats.modeled_seconds


def _chain(
    first: Optional[Callable[[TaskResult], None]],
    second: Callable[[TaskResult], None],
) -> Callable[[TaskResult], None]:
    if first is None:
        return second

    def both(res: TaskResult) -> None:
        first(res)
        second(res)

    return both


# -- one-shot N-stage jobs ----------------------------------------------------

@dataclass
class StageRunReport:
    job: str
    tasks: int = 0
    resumed_tasks: int = 0
    wall_seconds: float = 0.0
    #: modeled device seconds the state tier charged inline during the run.
    modeled_io_seconds: float = 0.0
    #: tasks that ran with a device-execution context bound.
    device_tasks: int = 0
    results: Dict[str, TaskResult] = field(default_factory=dict)

    def result(self, tid: str) -> TaskResult:
        """Result of bare task id ``tid`` (namespace resolved)."""
        return self.results[stage_task_id(self.job, tid)]


def run_stages(
    name: str,
    stages: Sequence[Stage],
    state: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    subscribers: Sequence[Callable] = (),
    external_tokens: Sequence[str] = (),
) -> StageRunReport:
    """Deprecated entry point — delegate through the :mod:`repro_torch.api`
    façade (same engine, byte-identical outputs).  New code should use
    :meth:`repro_torch.api.MarvelClient.stages`."""
    from repro_torch.api import _legacy_run_stages

    return _legacy_run_stages(
        name, stages, state, scheduler=scheduler, journal=journal,
        gateway=gateway, subscribers=subscribers,
        external_tokens=external_tokens,
    )


def _run_stages_impl(
    name: str,
    stages: Sequence[Stage],
    state: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    subscribers: Sequence[Callable] = (),
    external_tokens: Sequence[str] = (),
    device: Optional["DeviceExec"] = None,
) -> StageRunReport:
    """Execute a non-iterative N-stage dataflow job end to end.

    With ``journal``, every task commit is journaled under
    ``df/<name>/done/<tid>``; a re-run resumes tasks whose marker is
    committed *and* whose declared ``outputs`` are still present in
    ``state`` (a volatile tier may have lost them since).
    ``external_tokens`` declares data-key deps satisfied from outside
    the DAG — typically keys the ``subscribers`` tier watch publishes.
    ``device`` binds a device-execution context around every task that
    declared ``device=True`` (see :func:`current_device_exec`); tasks
    without a device lowering run unchanged.
    """
    scheduler = _resolve_scheduler(scheduler, gateway)
    sj = StateJournal(journal, f"df/{name}") if journal is not None else None
    committed = sj.entries() if sj is not None else {}
    report = StageRunReport(job=name)
    prepared: List[Stage] = []
    for st in stages:
        tasks: List[StageTask] = []
        for t in st.tasks:
            report.tasks += 1
            if (
                not t.resumed
                and t.tid in committed
                and all(state.contains(k) for k in t.outputs)
            ):
                t = replace(t, resumed=True)
            if t.resumed:
                report.resumed_tasks += 1
            elif sj is not None:
                def commit(res: TaskResult, tid: str = t.tid) -> None:
                    sj.commit(tid, {"task": tid})

                t = replace(t, on_complete=_chain(t.on_complete, commit))
            if (
                device is not None and t.device
                and not t.resumed and t.run is not None
            ):
                t = replace(t, run=_with_device(t.run, device))
                report.device_tasks += 1
            tasks.append(t)
        prepared.append(Stage(st.name, tasks, after=st.after))
    dag = lower_stages(name, prepared, namespace=f"df/{name}/",
                       external_tokens=external_tokens)
    t0 = time.perf_counter()
    io0 = _modeled(state)
    report.results = scheduler.run_dag(
        dag.specs, initial_tokens=dag.initial_tokens, subscribers=subscribers
    )
    report.wall_seconds = time.perf_counter() - t0
    report.modeled_io_seconds = _modeled(state) - io0
    return report


# -- fixed-point loops --------------------------------------------------------

class LoopContext:
    """Runtime handle given to a loop's ``init``/``superstep``/``converged``.

    Owns the versioned key naming for loop-carried state and tracks which
    state names the current superstep wrote (the iteration marker's key
    set).  ``write``/``read`` are thread-safe — superstep tasks call them
    concurrently from scheduler workers.
    """

    def __init__(self, job: str, state: Tier) -> None:
        self.job = job
        self.state = state
        self.prefix = f"df/{job}"
        #: current iteration: 0 is ``init``, supersteps are 1..N.
        self.iteration = 0
        #: raw DAG results of the just-finished superstep.
        self.results: Dict[str, TaskResult] = {}
        self._written: set = set()
        self._wlock = threading.Lock()

    # -- key naming -------------------------------------------------------
    def state_key(self, name: str, iteration: Optional[int] = None) -> str:
        it = self.iteration if iteration is None else iteration
        return f"{self.prefix}/state/it{it:05d}/{name}"

    def input_key(self, name: str) -> str:
        """Static (non-loop-carried) inputs live outside the versioned
        state area but inside the pinned job prefix."""
        return f"{self.prefix}/input/{name}"

    def task_id(self, tid: str) -> str:
        """The namespaced DAG task id of ``tid`` in the current superstep."""
        return f"{self.prefix}/it{self.iteration:05d}/{tid}"

    # -- loop state I/O ---------------------------------------------------
    def write(self, name: str, blob: bytes) -> None:
        """Write loop state ``name`` for the **current** iteration."""
        self.state.put(self.state_key(name), blob)
        with self._wlock:
            self._written.add(name)

    def write_many(self, blobs: Mapping[str, bytes]) -> None:
        """Batched :meth:`write` — one tier request for the whole set."""
        self.state.put_many(
            {self.state_key(nm): b for nm, b in blobs.items()}
        )
        with self._wlock:
            self._written.update(blobs)

    def read(self, name: str, iteration: Optional[int] = None) -> bytes:
        """Read loop state — from the **previous** iteration by default
        (the loop-carried edge); pass ``iteration`` for anything else."""
        it = self.iteration - 1 if iteration is None else iteration
        return self.state.get(self.state_key(name, it))

    def read_current(self, name: str) -> bytes:
        """Read state written earlier in the *current* superstep (a later
        stage consuming an earlier stage's output)."""
        return self.read(name, self.iteration)

    def result(self, tid: str) -> TaskResult:
        """A just-finished superstep task's result, by bare task id."""
        return self.results[self.task_id(tid)]


@dataclass
class LoopReport:
    job: str
    #: supersteps executed by this call (init counts when it ran here).
    iterations: int = 0
    #: committed supersteps skipped via the journal (init included).
    resumed_iterations: int = 0
    converged: bool = False
    #: highest committed iteration (0 = init; -1 = nothing ran).
    last_iteration: int = -1
    wall_seconds: float = 0.0
    modeled_io_seconds: float = 0.0
    #: one entry per superstep executed here:
    #: ``{"iteration", "wall_s", "modeled_s", "tasks"}``.
    per_iteration: List[dict] = field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        return self.wall_seconds + self.modeled_io_seconds


def _marker(iteration: int) -> str:
    return f"it{iteration:05d}"


def _resume_point(
    sj: Optional[StateJournal], ctx: LoopContext
) -> Tuple[int, bool, List[str]]:
    """Highest committed iteration whose state blobs all survive, with
    its converged flag and key set; (-1, False, []) when starting fresh.

    Also retracts every *other* marker: an interrupted GC (crash after
    ``commit(k)`` but before ``retract(k-1)``) or a marker whose blobs
    the tier lost would otherwise linger forever — the loop journal must
    stay O(1) in the iteration count across any crash schedule.
    """
    if sj is None:
        return -1, False, []

    def intact(meta: dict, k: int) -> bool:
        return all(
            ctx.state.contains(ctx.state_key(nm, k))
            for nm in meta.get("keys", [])
        )

    entries = sj.entries(prefix="it")
    picked = -1
    meta: dict = {}
    # Zero-padded marker ids: lexicographic == numeric, newest first.
    for eid in sorted(entries, reverse=True):
        k = int(eid[2:])
        if intact(entries[eid], k):
            picked, meta = k, entries[eid]
            break
    for eid in entries:
        if int(eid[2:]) != picked:
            sj.retract(eid)
    if picked < 0:
        return -1, False, []
    return picked, bool(meta.get("converged")), list(meta.get("keys", []))


def _sweep_stale_state(ctx: LoopContext, keep: int) -> None:
    """Drop every state version except ``keep``: versions below it are
    GC leftovers whose delete was interrupted; versions above it are
    partial blobs from a superstep that crashed before its marker — both
    would otherwise sit in the (pinned!) fast level forever."""
    base = f"{ctx.prefix}/state/it"
    for key in list(ctx.state.keys()):
        if not key.startswith(base):
            continue
        version = key[len(base):len(base) + 5]
        if version.isdigit() and int(version) != keep:
            ctx.state.delete(key)


def run_loop(
    name: str,
    init: Callable[[LoopContext], None],
    superstep: Callable[[LoopContext], Sequence[Stage]],
    converged: Callable[[LoopContext], bool],
    state: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    max_iterations: int = 50,
    pin_state: bool = True,
    halt_after: Optional[int] = None,
) -> LoopReport:
    """Deprecated entry point — delegate through the :mod:`repro_torch.api`
    façade (same engine, byte-identical outputs).  New code should use
    :meth:`repro_torch.api.MarvelClient.iterate`."""
    from repro_torch.api import _legacy_run_loop

    return _legacy_run_loop(
        name, init, superstep, converged, state, scheduler=scheduler,
        journal=journal, gateway=gateway, max_iterations=max_iterations,
        pin_state=pin_state, halt_after=halt_after,
    )


def _run_loop_impl(
    name: str,
    init: Callable[[LoopContext], None],
    superstep: Callable[[LoopContext], Sequence[Stage]],
    converged: Callable[[LoopContext], bool],
    state: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    max_iterations: int = 50,
    pin_state: bool = True,
    halt_after: Optional[int] = None,
) -> LoopReport:
    """Drive a fixed-point dataflow loop to convergence.

    ``init`` writes iteration-0 state through the :class:`LoopContext`;
    ``superstep`` returns the stage set for the current iteration (tasks
    read version *k-1* via ``ctx.read`` and write version *k* via
    ``ctx.write``); ``converged`` runs between supersteps over the
    just-finished iteration's state/results.

    ``journal``: per-iteration commit markers — a re-run (same ``name``,
    same journal) resumes at the last completed superstep byte-identically
    instead of recomputing it.  ``pin_state``: on a
    :class:`~repro_torch.storage.hierarchy.TieredStore` the job prefix is
    pinned in the fast level for the life of the loop.  ``halt_after``:
    stop (without convergence) after executing that many supersteps in
    this call — the crash-schedule test hook.
    """
    ctx = LoopContext(name, state)
    sj = (
        StateJournal(journal, f"{ctx.prefix}/loop")
        if journal is not None else None
    )
    report = LoopReport(job=name)
    scheduler = _resolve_scheduler(scheduler, gateway)
    pinned = pin_state and hasattr(state, "pin")
    if pinned:
        state.pin(ctx.prefix + "/")
    try:
        with scheduler.pooled():
            t0 = time.perf_counter()
            io0 = _modeled(state)
            start, was_converged, prev_keys = _resume_point(sj, ctx)
            if sj is not None:
                # keep=-1 (nothing resumable) sweeps every version: a
                # journaled loop without an intact marker has no
                # committed state, only a dead run's leftovers.
                _sweep_stale_state(ctx, keep=start)
            if start >= 0:
                report.resumed_iterations = start + 1
                report.last_iteration = start
                report.converged = was_converged
                if was_converged:
                    return report
            else:
                # iteration 0: init writes the seed state.
                ctx.iteration = 0
                ctx._written.clear()
                w0, m0 = time.perf_counter(), _modeled(state)
                init(ctx)
                prev_keys = sorted(ctx._written)
                if sj is not None:
                    sj.commit(_marker(0), {"keys": prev_keys,
                                           "converged": False})
                report.iterations += 1
                report.last_iteration = 0
                report.per_iteration.append({
                    "iteration": 0,
                    "wall_s": time.perf_counter() - w0,
                    "modeled_s": _modeled(state) - m0,
                    "tasks": 0,
                })
            while not report.converged:
                k = report.last_iteration + 1
                if k > max_iterations:
                    break
                if halt_after is not None and report.iterations >= halt_after:
                    break
                ctx.iteration = k
                ctx.results = {}
                ctx._written.clear()
                w0, m0 = time.perf_counter(), _modeled(state)
                stages = list(superstep(ctx))
                dag = lower_stages(
                    f"{name}/it{k:05d}", stages,
                    namespace=f"{ctx.prefix}/it{k:05d}/",
                )
                ctx.results = scheduler.run_dag(
                    dag.specs, initial_tokens=dag.initial_tokens
                )
                conv = bool(converged(ctx))
                keys = sorted(ctx._written)
                # Marker strictly after the superstep's state blobs (they
                # landed during the DAG run): a torn run re-executes this
                # superstep; a marker never summarizes missing state.
                if sj is not None:
                    sj.commit(_marker(k), {"keys": keys, "converged": conv})
                # Version k-1 retires: k is all the next superstep (and a
                # resume) needs.  Marker first, then blobs — an
                # interrupted GC leaves garbage blobs that the next
                # resume's sweep collects, never a marker whose state is
                # half-deleted.
                if sj is not None:
                    sj.retract(_marker(k - 1))
                for nm in prev_keys:
                    state.delete(ctx.state_key(nm, k - 1))
                prev_keys = keys
                report.iterations += 1
                report.last_iteration = k
                report.converged = conv
                report.per_iteration.append({
                    "iteration": k,
                    "wall_s": time.perf_counter() - w0,
                    "modeled_s": _modeled(state) - m0,
                    "tasks": len(dag.specs),
                })
            report.wall_seconds = time.perf_counter() - t0
            report.modeled_io_seconds = _modeled(state) - io0
            return report
    finally:
        if pinned:
            state.unpin(ctx.prefix + "/")
