"""MapReduce front-end: lowers jobs onto the stage-DAG execution engine.

This is the faithful reproduction of the paper's measured system: the same
job runs with its shuffle (intermediate) data living in

  * ``DramTier``                     — Marvel w/ IGFS (best curve, Fig. 4-6),
  * ``PmemTier`` / sim PMEM          — Marvel w/ PMEM-HDFS,
  * ``SimulatedTier(SSD_SPEC)``      — local-SSD baseline,
  * ``SimulatedTier(S3_SPEC)``       — Corral/Lambda baseline (slow, and
                                       trips the 15 GB quota → job failure).

Input/output live in a :class:`BlockStore` (HDFS analog).  Mappers are
scheduled with block locality; intermediate partitions are content-keyed so
retried/speculative attempts are idempotent.  Job progress is journaled at
*partition* granularity in a :class:`StateJournal`, so a crashed job
resumes mid-wave without redoing finished work.

A job is two stages of the DAG (see ``core/dag.py`` and DESIGN.md §4):

  * ``mode="wave"``       — reduce tasks depend on every map-task token:
    the classic barrier.  Byte-identical behaviour to the pre-DAG engine.
  * ``mode="pipelined"``  — map tasks batch-publish their partitions
    (``put_many``) and the tier's watch hook turns each landing blob into
    a dataflow token; *streaming* reduce tasks launch immediately on
    overlap slots and fetch/decode partitions as they commit, so shuffle
    movement overlaps the map tail.  Outputs are bit-identical to wave
    mode: merge order is canonicalized before the final reduce.

Record model: inputs are newline-separated byte records; ``mapper(record)``
yields ``(key, value)`` pairs; ``reducer(key, values)`` yields output pairs.
A ``combiner`` (defaults to the reducer for associative reductions) runs
map-side to cut shuffle volume.
"""

from __future__ import annotations

import hashlib
import io
import math
import pickle
import struct
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, Iterable, Iterator, List, Optional,
    Sequence, Tuple,
)

from repro_torch.core.dag import StageDag, TaskContext
from repro_torch.core.dataflow import Stage, StageTask, lower_stages

if TYPE_CHECKING:  # annotation only — keeps the import graph acyclic
    from repro_torch.core.device_shuffle import DeviceExec
    from repro_torch.core.gateway import Gateway
from repro_torch.core.journal import StateJournal
from repro_torch.core.scheduler import Scheduler, TaskResult
from repro_torch.storage.blockstore import BlockStore
from repro_torch.storage.kvcache import StateCache
from repro_torch.storage.tiers import Tier

__all__ = ["MapReduceJob", "JobReport", "LoweredJob", "lower_job", "run_job",
           "run_jobs"]

KV = Tuple[Any, Any]


@dataclass
class MapReduceJob:
    name: str
    mapper: Callable[[bytes], Iterable[KV]]
    reducer: Callable[[Any, List[Any]], Iterable[KV]]
    combiner: Optional[Callable[[Any, List[Any]], Iterable[KV]]] = None
    n_reducers: int = 4
    #: Declared reduction semantics.  ``"sum"`` promises the reducer
    #: yields exactly ``(k, sum(vs))`` per key and the sum is
    #: order-independent; device mode then lowers eligible reduce tasks
    #: onto the device segment-sum and may reorder over-capacity pairs
    #: through the spill path.  ``None`` (opaque reducer) always runs the
    #: host reducer and partitions with exact-sized device buffers.
    reduce_kind: Optional[str] = None


@dataclass
class JobReport:
    job: str
    input_bytes: int = 0
    intermediate_bytes: int = 0
    output_bytes: int = 0
    map_tasks: int = 0
    reduce_tasks: int = 0
    wall_seconds: float = 0.0
    #: modeled device seconds accumulated in the intermediate tier
    modeled_io_seconds: float = 0.0
    speculative_wins: int = 0
    retried_tasks: int = 0
    resumed_tasks: int = 0
    #: execution mode this report came from ("wave" or "pipelined")
    mode: str = "wave"
    #: seconds of reduce-task runtime overlapped with the map stage
    overlap_seconds: float = 0.0
    #: shuffle partitions consumed by reducers before the map stage ended
    partitions_streamed: int = 0
    #: device execution mode (``device=``) accounting — zeros on host runs
    device_mode: bool = False
    #: pairs whose partition step ran on the CUDA histogram kernel
    device_pairs: int = 0
    #: key groups whose reduce ran as the device segment-sum
    device_groups: int = 0
    #: over-capacity pairs recovered through the spill tier (not dropped)
    device_spilled_pairs: int = 0
    #: reduce tasks that fell back to the host reducer (ineligible sums)
    device_fallback_tasks: int = 0

    @property
    def total_seconds(self) -> float:
        """Wall time plus the modeled (not-slept) device time."""
        return self.wall_seconds + self.modeled_io_seconds


# -- intermediate partition encoding (grouped kv runs) -------------------------

def _encode_pairs(pairs: List[KV]) -> bytes:
    payload = pickle.dumps(pairs, protocol=pickle.HIGHEST_PROTOCOL)
    return struct.pack("<Q", len(payload)) + payload


def _decode_pairs(blob: bytes) -> List[KV]:
    (n,) = struct.unpack_from("<Q", blob, 0)
    return pickle.loads(blob[8 : 8 + n])


def _group(pairs: Iterable[KV]) -> Dict[Any, List[Any]]:
    groups: Dict[Any, List[Any]] = defaultdict(list)
    for k, v in pairs:
        groups[k].append(v)
    return groups


def _partition(key: Any, n: int) -> int:
    # Stable across processes (hash() is salted for str/bytes).
    if isinstance(key, bytes):
        h = int.from_bytes(key[:8].ljust(8, b"\0"), "little") ^ len(key)
    elif isinstance(key, str):
        return _partition(key.encode(), n)
    elif isinstance(key, int):  # includes bool (legacy placement)
        h = key
    else:
        # Composite/float/etc. keys (e.g. a join on tuple keys): fall back
        # to a deterministic digest of the pickled key.  (The old int()
        # coercion collapsed distinct floats onto one partition and raised
        # TypeError for tuples/None.)
        digest = hashlib.blake2b(
            pickle.dumps(key, protocol=pickle.HIGHEST_PROTOCOL), digest_size=8
        ).digest()
        h = int.from_bytes(digest, "little")
    return h % n


def _device_reducible(job: MapReduceJob, groups: Dict[Any, List[Any]]) -> bool:
    """May this reduce task lower onto the device segment-sum?

    Only when the declared reduction is ``"sum"`` over Python ints whose
    exact total provably fits the device's int32 accumulator
    (``max|v| · n_pairs < 2^31`` bounds every partial sum).  Anything
    else — float values (addition-order sensitive), custom reducers,
    possible overflow — falls back to the host reducer, which is
    bit-identical by construction.
    """
    if job.reduce_kind != "sum":
        return False
    total = 0
    vmax = 0
    for vs in groups.values():
        total += len(vs)
        for v in vs:
            if not isinstance(v, int):
                return False
            a = -v if v < 0 else v
            if a > vmax:
                vmax = a
    return vmax * total < 2**31


# -- lowering: MapReduceJob -> 2-stage DAG ------------------------------------

@dataclass
class LoweredJob:
    """A MapReduce job lowered to DAG task specs, plus the hooks and the
    finalizer that turns raw task results into a :class:`JobReport`.

    Several LoweredJobs can be concatenated into one ``run_dag`` call
    (:func:`run_jobs`) so independent jobs share a single worker pool.
    ``prepare`` re-snapshots the wall/IO baselines and must be called
    immediately before the run so a report never includes time spent
    lowering *other* jobs.  (Jobs sharing one intermediate tier each see
    the tier's full modeled delta for the merged run — per-tenant I/O
    attribution needs per-task accounting this model doesn't carry.)
    """

    job: MapReduceJob
    dag: StageDag
    initial_tokens: List[str]
    subscribers: List[Callable]
    prepare: Callable[[], None]
    finalize: Callable[[Dict[str, TaskResult]], JobReport]


def lower_job(
    job: MapReduceJob,
    store: BlockStore,
    input_path: str,
    output_path: str,
    intermediate: Tier,
    journal: Optional[StateCache] = None,
    fail_map_attempts: Optional[Dict[str, int]] = None,
    mode: str = "wave",
    device: Optional["DeviceExec"] = None,
) -> LoweredJob:
    """Lower ``job`` to a 2-stage DAG (map stage, reduce stage).

    With ``device``, the map-side partition step runs on the CUDA
    histogram kernel (:func:`~repro_torch.core.device_shuffle.device_partition`)
    and eligible reduce tasks run as the device segment-sum;
    over-capacity partitions spill through ``intermediate`` instead of
    being dropped.  Output bytes are identical to the host path.
    """
    if mode not in ("wave", "pipelined"):
        raise ValueError(f"unknown mode {mode!r}")
    blocks = store.locate(input_path)
    n_maps = len(blocks)
    combiner = job.combiner
    jprefix = f"mr/{job.name}"
    sj = StateJournal(journal, jprefix) if journal is not None else None
    baseline = {
        "t0": time.perf_counter(),
        "io": intermediate.stats.modeled_seconds,
    }

    def prepare() -> None:
        baseline["t0"] = time.perf_counter()
        baseline["io"] = intermediate.stats.modeled_seconds

    fail_budget = dict(fail_map_attempts or {})
    resumed: List[str] = []

    def spec_id(tid: str) -> str:
        # Task ids are job-namespaced so several jobs can share one DAG
        # run; journal entries keep the bare id (layout-compatible with
        # journals written before the DAG refactor).
        return f"{jprefix}/{tid}"

    def part_key(map_tid: str, p: int) -> str:
        return f"{jprefix}/{map_tid}/part_{p:04d}"

    def commit(res: TaskResult) -> None:
        if sj is not None:
            # journal the durable facts only (not runtime telemetry)
            meta = {k: v for k, v in res.value.items() if k != "fetch_times"}
            tid = meta["task"]
            entries = {tid: meta}
            # Partition-granular commits: a resumed run re-primes the DAG
            # token table from these without touching the data tier.
            # (Dot separator: on PmemTier a '/' would need ``tid`` to be a
            # directory, but the task marker above is already a file.)
            for p in meta.get("sizes", {}):
                entries[f"{tid}.part_{int(p):04d}"] = {
                    "bytes": meta["sizes"][p]
                }
            # Task marker last: a torn batch (crash mid-commit) may leave
            # partitions without their task marker — the resume path then
            # just re-runs the task — but never a marker whose partition
            # entries are missing.
            sj.commit_many_ordered(entries, marker=tid)

    # ---- map stage ----------------------------------------------------------
    map_task_ids = [f"map_{i:05d}" for i in range(n_maps)]

    # One journal read for the whole resume: task entries plus the
    # partition-granular `<tid>.part_NNNN` entries committed alongside
    # them.  Legacy journals (pre-DAG) carry partitions in the task
    # meta's "sizes" instead.
    committed_entries = sj.entries() if sj is not None else {}
    committed_parts: Dict[str, List[int]] = {}
    for entry in committed_entries:
        if ".part_" in entry:
            owner, _, pnum = entry.partition(".part_")
            committed_parts.setdefault(owner, []).append(int(pnum))

    def journaled_parts(tid: str) -> List[int]:
        parts = committed_parts.get(tid)
        if parts is None:
            meta = committed_entries.get(tid, {})
            parts = [int(p) for p in meta.get("sizes", {})]
        return sorted(parts)

    def map_resumable(tid: str) -> bool:
        """Committed *and* every journaled partition blob still present
        (a volatile intermediate tier may have lost them since)."""
        if tid not in committed_entries:
            return False
        return all(
            intermediate.contains(part_key(tid, p))
            for p in journaled_parts(tid)
        )

    def make_map_task(i: int) -> StageTask:
        tid = map_task_ids[i]
        block_meta = blocks[i]

        def run(ctx: TaskContext) -> dict:
            if fail_budget.get(tid, 0) > 0:
                fail_budget[tid] -= 1
                raise RuntimeError(f"injected failure in {tid}")
            data = store.read_block(block_meta, prefer_node=ctx.worker)
            pairs: List[KV] = []
            for record in data.split(b"\n"):
                if record:
                    pairs.extend(job.mapper(record))
            if combiner is not None:
                pairs = [
                    kv
                    for k, vs in _group(pairs).items()
                    for kv in combiner(k, vs)
                ]
            parts: Dict[int, List[KV]] = defaultdict(list)
            if device is not None and pairs:
                from repro_torch.core import device_shuffle as _ds

                dest = [_partition(k, job.n_reducers) for k, _ in pairs]
                # Capacity-bounded buffers (with tier spill for overflow)
                # are only byte-safe when the reduction is an integer sum:
                # spill appends reorder pairs within a partition.
                cap = None
                if job.reduce_kind == "sum" and all(
                    isinstance(v, int) for _, v in pairs
                ):
                    cap = max(1, math.ceil(
                        device.capacity_factor * len(pairs) / job.n_reducers
                    ))
                idx_parts, overflow = _ds.device_partition(
                    dest, job.n_reducers, capacity=cap,
                    device=device.device,
                )
                for p, idxs in enumerate(idx_parts):
                    if len(idxs):
                        parts[p] = [pairs[i] for i in idxs]
                if len(overflow):
                    # Over-capacity pairs take the slow path: one real
                    # round-trip through the intermediate tier (the spill
                    # cost), then merge back into their partitions.
                    skey = f"{jprefix}/{tid}/spill"
                    intermediate.put(skey, _encode_pairs(
                        [(dest[i], pairs[i]) for i in overflow]
                    ))
                    for d, kv in _decode_pairs(intermediate.get(skey)):
                        parts[d].append(kv)
                    device.account(spilled_pairs=len(overflow))
                device.account(
                    partitioned_pairs=len(pairs), device_tasks=1
                )
            else:
                for k, v in pairs:
                    parts[_partition(k, job.n_reducers)].append((k, v))
            blobs = {
                part_key(tid, p): _encode_pairs(ppairs)
                for p, ppairs in sorted(parts.items())
            }
            # Batched publish: one modeled request for the whole task's
            # shuffle output; the tier watch turns each landing partition
            # into a token for streaming reducers.
            if blobs:
                intermediate.put_many(blobs)
            return {
                "task": tid,
                "sizes": {p: len(blobs[part_key(tid, p)]) for p in parts},
            }

        return StageTask(
            spec_id(tid), run,
            preferred=list(block_meta.replicas), on_complete=commit,
        )

    map_tasks: List[StageTask] = []
    for i, tid in enumerate(map_task_ids):
        if map_resumable(tid):
            resumed.append(tid)
            map_tasks.append(StageTask(
                spec_id(tid), resumed=True,
                produces=[part_key(tid, p) for p in journaled_parts(tid)],
            ))
            continue
        map_tasks.append(make_map_task(i))

    # ---- reduce stage ----------------------------------------------------------

    def make_reduce_task(p: int) -> StageTask:
        tid = f"reduce_{p:04d}"
        suffix = f"/part_{p:04d}"

        def write_output(groups: Dict[Any, List[Any]]) -> dict:
            out = io.BytesIO()
            skeys = sorted(groups.keys(), key=repr)
            if device is not None and skeys and _device_reducible(job, groups):
                from repro_torch.core import device_shuffle as _ds

                ids: List[int] = []
                vals: List[int] = []
                for i, k in enumerate(skeys):
                    vs = groups[k]
                    ids.extend([i] * len(vs))
                    vals.extend(vs)
                totals = _ds.device_segment_reduce(
                    ids, vals, len(skeys), device=device.device
                )
                for i, k in enumerate(skeys):
                    out.write(
                        repr(k).encode() + b"\t"
                        + repr(int(totals[i])).encode() + b"\n"
                    )
                device.account(reduced_groups=len(skeys), device_tasks=1)
            else:
                if device is not None and skeys:
                    device.account(fallback_tasks=1)
                for k in skeys:
                    for ok, ov in job.reducer(k, groups[k]):
                        out.write(repr(ok).encode() + b"\t" + repr(ov).encode() + b"\n")
            blob = out.getvalue()
            store.write(f"{output_path}/part_{p:04d}", blob)
            return {"task": tid, "bytes": len(blob)}

        def run_barrier(ctx: TaskContext) -> dict:
            pairs: List[KV] = []
            for mt in map_task_ids:
                key = part_key(mt, p)
                if intermediate.contains(key):
                    pairs.extend(_decode_pairs(intermediate.get(key)))
            return write_output(_group(pairs))

        def run_streaming(ctx: TaskContext) -> dict:
            # Incremental merge: fetch + decode each partition as its
            # token arrives (overlapping the map tail); the final group +
            # reduce runs over partitions in canonical (map-index) order
            # so output bytes are identical to barrier mode for any
            # reducer, commutative or not.
            fetched: Dict[str, List[KV]] = {}
            done_maps: set = set()
            fetch_times: List[float] = []
            # Data tokens always precede their map's task token (the put
            # happens inside the map run; the token publishes after), so
            # once every map token is seen and the queue is drained, no
            # more data for this job can arrive.
            while len(done_maps) < n_maps or not ctx.events.empty():
                tok = ctx.next_event(timeout=0.02)
                if tok is None:
                    continue
                if tok.startswith("task:"):
                    done_maps.add(tok)
                elif tok not in fetched:
                    fetched[tok] = _decode_pairs(intermediate.get(tok))
                    # Timestamped so finalize can judge overlap against
                    # the map stage's true end, not this queue's order.
                    fetch_times.append(time.perf_counter())
            pairs: List[KV] = []
            for key in sorted(fetched):  # map_%05d: lexicographic == index
                pairs.extend(fetched[key])
            res = write_output(_group(pairs))
            res["fetch_times"] = fetch_times
            return res

        def listens(tok: str) -> bool:
            return (
                tok.startswith(f"task:{jprefix}/map_")
                or (tok.startswith(f"{jprefix}/map_") and tok.endswith(suffix))
            )

        if mode == "wave":
            return StageTask(spec_id(tid), run_barrier, on_complete=commit)
        return StageTask(
            spec_id(tid), run_streaming,
            streaming=True, listens=listens, on_complete=commit,
        )

    reduce_tasks: List[StageTask] = []
    for p in range(job.n_reducers):
        tid = f"reduce_{p:04d}"
        if tid in committed_entries:
            resumed.append(tid)
            reduce_tasks.append(StageTask(spec_id(tid), resumed=True))
            continue
        reduce_tasks.append(make_reduce_task(p))

    # MapReduce is the trivial dataflow: a 2-stage job.  Wave mode is the
    # default stage barrier (reduce after every map — live and resumed
    # alike); pipelined reducers declare no barrier (``after=()``) and
    # stream partitions off the tier watch instead.
    dag = lower_stages(job.name, [
        Stage("map", map_tasks),
        Stage("reduce", reduce_tasks,
              after=None if mode == "wave" else ()),
    ])
    initial_tokens = dag.initial_tokens
    # Only pipelined reducers listen to data tokens; wave mode skips the
    # watch so barrier jobs don't pay a publish per shuffle partition.
    subscribers: List[Callable] = (
        [] if mode == "wave"
        else [lambda publish: intermediate.watch(jprefix + "/", publish)]
    )

    # ---- finalize: raw task results -> JobReport ----------------------------
    def finalize(results: Dict[str, TaskResult]) -> JobReport:
        report = JobReport(job=job.name, mode=mode)
        report.input_bytes = store.file_meta(input_path).length
        report.map_tasks = n_maps
        report.reduce_tasks = job.n_reducers
        report.resumed_tasks = len(resumed)
        own = {
            tid: res for tid, res in results.items()
            if tid.startswith(jprefix + "/")
        }
        for res in own.values():
            report.speculative_wins += int(res.speculative_win)
            report.retried_tasks += int(res.attempts > 1)
        map_results = [
            r for tid, r in own.items()
            if tid.startswith(f"{jprefix}/map_")
        ]
        reduce_results = [
            r for tid, r in own.items()
            if tid.startswith(f"{jprefix}/reduce_")
        ]
        if map_results:
            map_end = max(r.ended for r in map_results)
            for r in reduce_results:
                report.overlap_seconds += max(
                    0.0, min(r.ended, map_end) - r.started
                )
                # A partition "streamed" iff a reducer consumed it before
                # the map stage actually finished.
                report.partitions_streamed += sum(
                    1 for t in r.value.get("fetch_times", ()) if t < map_end
                )
        # intermediate volume (authoritative: what's in the tier for this job)
        for key in intermediate.keys():
            if key.startswith(jprefix + "/map_"):
                report.intermediate_bytes += intermediate.size_of(key)
        for p in range(job.n_reducers):
            path = f"{output_path}/part_{p:04d}"
            if store.exists(path):
                report.output_bytes += store.file_meta(path).length
        report.wall_seconds = time.perf_counter() - baseline["t0"]
        report.modeled_io_seconds = (
            intermediate.stats.modeled_seconds - baseline["io"]
        )
        if device is not None:
            report.device_mode = True
            report.device_pairs = device.partitioned_pairs
            report.device_groups = device.reduced_groups
            report.device_spilled_pairs = device.spilled_pairs
            report.device_fallback_tasks = device.fallback_tasks
        return report

    return LoweredJob(job, dag, initial_tokens, subscribers, prepare, finalize)


# -- engine ---------------------------------------------------------------

def run_job(
    job: MapReduceJob,
    store: BlockStore,
    input_path: str,
    output_path: str,
    intermediate: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional[StateCache] = None,
    fail_map_attempts: Optional[Dict[str, int]] = None,
    mode: str = "wave",
    gateway: Optional["Gateway"] = None,
    adaptive: bool = False,
) -> JobReport:
    """Deprecated entry point — delegate through the :mod:`repro_torch.api`
    façade (same engine, byte-identical outputs).  New code should build
    a :class:`repro_torch.api.MarvelClient` and use ``client.dataset(...)`` or
    ``client.mapreduce(...)``."""
    from repro_torch.api import _legacy_run_job

    return _legacy_run_job(
        job, store, input_path, output_path, intermediate,
        scheduler=scheduler, journal=journal,
        fail_map_attempts=fail_map_attempts, mode=mode, gateway=gateway,
        adaptive=adaptive,
    )


def _run_job_impl(
    job: MapReduceJob,
    store: BlockStore,
    input_path: str,
    output_path: str,
    intermediate: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional[StateCache] = None,
    fail_map_attempts: Optional[Dict[str, int]] = None,
    mode: str = "wave",
    gateway: Optional["Gateway"] = None,
    adaptive: bool = False,
    device: Optional["DeviceExec"] = None,
) -> JobReport:
    """Execute ``job`` end to end (the engine behind the façade).

    ``journal``: if given, map/reduce commits are recorded; re-running the
    same job resumes from the journal (stateful recovery).
    ``fail_map_attempts``: test hook — ``{task_id: n}`` makes the first
    ``n`` attempts of that task raise (exercises retry paths).
    ``mode``: ``"wave"`` (barrier between stages, the paper's measured
    configuration) or ``"pipelined"`` (streaming shuffle).
    ``gateway``: schedule the job on worker slots mirroring the gateway's
    invoker pool (scales with the serving fleet) instead of a dedicated
    scheduler.
    ``device``: a :class:`~repro_torch.core.device_shuffle.DeviceExec` context —
    partition on the CUDA histogram kernel, reduce eligible sums on the
    device segment-sum, spill over-capacity pairs through the
    intermediate tier.  Output bytes are identical to host execution.
    ``adaptive``: front ``intermediate`` with a write-back DRAM level
    (:func:`~repro_torch.storage.hierarchy.adaptive_shuffle_tier`) — map tasks
    ack shuffle output at DRAM latency while the background flusher
    drains to the given tier; the hierarchy is flushed before the report
    is finalized, so durability and journaled resume are unchanged.
    """
    if scheduler is None and gateway is not None:
        scheduler = gateway.shared_scheduler()
    if scheduler is None:
        scheduler = Scheduler(workers=[f"w{i}" for i in range(4)])
    hierarchy = None
    if adaptive:
        from repro_torch.storage.hierarchy import adaptive_shuffle_tier

        hierarchy = adaptive_shuffle_tier(
            intermediate, journal=journal, name=f"mr-{job.name}"
        )
        intermediate = hierarchy
    ok = False
    try:
        lowered = lower_job(
            job, store, input_path, output_path, intermediate,
            journal=journal, fail_map_attempts=fail_map_attempts, mode=mode,
            device=device,
        )
        lowered.prepare()
        results = scheduler.run_dag(
            lowered.dag.specs,
            initial_tokens=lowered.initial_tokens,
            subscribers=lowered.subscribers,
        )
        if hierarchy is not None:
            # Drain outstanding write-backs so the backing tier is
            # complete before the report (the drain wall-time overlaps
            # nothing here, but everything the flusher already moved
            # during the run was free).
            hierarchy.flush()
        report = lowered.finalize(results)
        ok = True
        return report
    finally:
        if hierarchy is not None:
            # On failure, don't retry a (possibly broken) home tier for
            # the flush timeout and mask the real error — acked shuffle
            # data is still replayable from the journal on the next run.
            hierarchy.close(flush=ok)


def run_jobs(
    lowered: Sequence[LoweredJob],
    scheduler: Optional[Scheduler] = None,
    gateway: Optional["Gateway"] = None,
) -> List[JobReport]:
    """Run several lowered jobs over ONE worker pool, interleaved.

    The DAGs are concatenated into a single ``run_dag`` call, so a short
    job's reducers overlap a long job's map tail — multi-tenant serving of
    the shared state tier (DESIGN.md §6).  Passing ``gateway`` runs the
    merged DAG on the gateway's invoker pool (DESIGN.md §5).
    """
    if scheduler is None and gateway is not None:
        scheduler = gateway.shared_scheduler()
    if scheduler is None:
        scheduler = Scheduler(workers=[f"w{i}" for i in range(4)])
    merged = StageDag("multi-job")
    tokens: List[str] = []
    subscribers: List[Callable] = []
    for lj in lowered:
        merged.merge(lj.dag)
        tokens.extend(lj.initial_tokens)
        subscribers.extend(lj.subscribers)
        lj.prepare()
    results = scheduler.run_dag(
        merged.specs, initial_tokens=tokens, subscribers=subscribers
    )
    return [lj.finalize(results) for lj in lowered]


# -- canonical workloads (paper §4.2, Table 1) --------------------------------

def wordcount_job(n_reducers: int = 4) -> MapReduceJob:
    def mapper(record: bytes) -> Iterator[KV]:
        for w in record.split():
            yield (w, 1)

    def reducer(k: Any, vs: List[Any]) -> Iterator[KV]:
        yield (k, sum(vs))

    return MapReduceJob("wordcount", mapper, reducer, combiner=reducer,
                        n_reducers=n_reducers, reduce_kind="sum")


def grep_job(pattern: bytes, n_reducers: int = 4) -> MapReduceJob:
    import re

    rx = re.compile(pattern)

    def mapper(record: bytes) -> Iterator[KV]:
        for w in record.split():
            if rx.search(w):
                yield (w, 1)

    def reducer(k: Any, vs: List[Any]) -> Iterator[KV]:
        yield (k, sum(vs))

    return MapReduceJob("grep", mapper, reducer, combiner=reducer,
                        n_reducers=n_reducers, reduce_kind="sum")


def aggregation_job(n_reducers: int = 4) -> MapReduceJob:
    """SUM(value) GROUP BY key over ``key,value`` CSV records."""

    def mapper(record: bytes) -> Iterator[KV]:
        k, _, v = record.partition(b",")
        yield (k, float(v))

    def reducer(k: Any, vs: List[Any]) -> Iterator[KV]:
        yield (k, sum(vs))

    # Float sums are addition-order sensitive: reduce_kind stays None so
    # device runs keep exact-capacity partitioning + the host reducer.
    return MapReduceJob("aggregation", mapper, reducer, combiner=reducer,
                        n_reducers=n_reducers)


def scan_job(predicate: Callable[[bytes], bool], n_reducers: int = 4) -> MapReduceJob:
    """SELECT * WHERE predicate — map-heavy, small output."""

    def mapper(record: bytes) -> Iterator[KV]:
        if predicate(record):
            yield (record, b"")

    def reducer(k: Any, vs: List[Any]) -> Iterator[KV]:
        yield (k, len(vs))

    return MapReduceJob("scan", mapper, reducer, n_reducers=n_reducers)


def join_job(n_reducers: int = 4) -> MapReduceJob:
    """Reduce-side equi-join of records tagged ``L,key,val`` / ``R,key,val``.

    Intermediate blowup is the cross-tag copy — matches Table 1's join row
    (intermediate ≈ 4× input).
    """

    def mapper(record: bytes) -> Iterator[KV]:
        tag, _, rest = record.partition(b",")
        k, _, v = rest.partition(b",")
        yield (k, (tag, v))

    def reducer(k: Any, vs: List[Any]) -> Iterator[KV]:
        left = [v for t, v in vs if t == b"L"]
        right = [v for t, v in vs if t == b"R"]
        for lv in left:
            for rv in right:
                yield (k, (lv, rv))

    return MapReduceJob("join", mapper, reducer, n_reducers=n_reducers)
