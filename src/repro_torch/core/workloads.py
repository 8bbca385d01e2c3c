"""Paper-class dataflow workloads: PageRank, k-means, TeraSort.

Library front-ends over :mod:`repro_torch.core.dataflow` — each is the shape of
workload the paper's statefulness argument targets but its measured jobs
(wordcount, grep: single-pass, 2-stage) never exercise:

  * :func:`pagerank_loop` — sparse adjacency partitions as static input,
    the rank vector as loop-carried state: every superstep re-reads the
    previous ranks, so keeping them pinned in the fast tier vs reloading
    from the modeled S3 home is the whole game
    (``benchmarks/paper_fig9_iterative.py`` measures exactly that gap);
  * :func:`kmeans_loop` — centroids as loop state, optionally resident in
    a **gateway session** (a :class:`~repro_torch.core.stateful.
    StatefulFunction` slot): warm invokers then read centroids from the
    hot view and skip the tier reload entirely;
  * :func:`terasort` — sample → range-partition → per-partition sort, a
    3-stage non-iterative DAG the MapReduce front-end cannot express.

Everything is deterministic byte-for-byte given the same inputs: float
reductions run in fixed (partition-index) order, so the stateful/pinned
and cold-reload configurations — and a journal-resumed re-run — produce
identical output bytes.  Tests and the fig9 smoke gate assert this.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dataflow import (
    LoopContext,
    LoopReport,
    Stage,
    StageRunReport,
    StageTask,
    _run_loop_impl,
    _run_stages_impl,
    current_device_exec,
)

if TYPE_CHECKING:  # annotation only
    from repro_torch.core.device_shuffle import DeviceExec
from repro_torch.core.scheduler import Scheduler
from repro_torch.storage import serde
from repro_torch.storage.tiers import Tier

if TYPE_CHECKING:  # annotation only
    from repro_torch.core.gateway import Gateway
    from repro_torch.storage.kvcache import StateCache

__all__ = [
    "PageRankResult",
    "KMeansResult",
    "pagerank_graph",
    "pagerank_loop",
    "kmeans_points",
    "kmeans_loop",
    "terasort",
    "terasort_output",
]


# -- small codecs (fixed dtypes, deterministic bytes) -------------------------

def _pack_edges(src: np.ndarray, dst: np.ndarray) -> bytes:
    return (
        struct.pack("<Q", len(src))
        + src.astype("<i8").tobytes()
        + dst.astype("<i8").tobytes()
    )


def _unpack_edges(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    (n,) = struct.unpack_from("<Q", blob, 0)
    body = np.frombuffer(blob, dtype="<i8", offset=8)
    return body[:n], body[n:]


def _f64(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype="<f8")


# -- PageRank -----------------------------------------------------------------

def _part_bounds(n: int, parts: int) -> List[int]:
    return [i * n // parts for i in range(parts + 1)]


def pagerank_graph(
    n_nodes: int, n_edges: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """A deterministic random directed graph (self-loops removed)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int64)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int64)
    keep = src != dst
    return src[keep], dst[keep]


@dataclass
class PageRankResult:
    report: LoopReport
    #: final rank vector (float64, sums to ~1 minus the dangling leak).
    ranks: np.ndarray
    #: canonical concatenated rank bytes — the byte-identity handle.
    rank_bytes: bytes


def pagerank_loop(
    name: str,
    state: Tier,
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    n_parts: int = 4,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iterations: int = 20,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    pin_state: bool = True,
    halt_after: Optional[int] = None,
) -> PageRankResult:
    """Power-iteration PageRank as an iterative 2-stage dataflow.

    Superstep *k*: stage ``contrib`` (one task per adjacency partition —
    read rank part *k-1*, scatter weighted contributions per destination
    partition) then stage ``apply`` (one task per rank partition — sum
    contributions in partition order, apply damping, report the L1
    residual).  Converged when the summed residual drops under ``tol``.
    """
    bounds = _part_bounds(n_nodes, n_parts)
    order = np.lexsort((dst, src))  # canonical edge order per partition
    src, dst = src[order], dst[order]

    ctx_probe = LoopContext(name, state)  # key naming only
    for i in range(n_parts):
        key = ctx_probe.input_key(f"adj/p{i:03d}")
        if not state.contains(key):
            m = (src >= bounds[i]) & (src < bounds[i + 1])
            state.put(key, _pack_edges(src[m], dst[m]))

    def init(ctx: LoopContext) -> None:
        for j in range(n_parts):
            size = bounds[j + 1] - bounds[j]
            ctx.write(
                f"rank/p{j:03d}",
                np.full(size, 1.0 / n_nodes, dtype="<f8").tobytes(),
            )

    def make_contrib(i: int):
        def run(_tc) -> dict:
            ctx = current_ctx[0]
            s, d = _unpack_edges(ctx.state.get(ctx.input_key(f"adj/p{i:03d}")))
            ranks = _f64(ctx.read(f"rank/p{i:03d}"))
            local = s - bounds[i]
            deg = np.bincount(local, minlength=bounds[i + 1] - bounds[i])
            w = ranks[local] / deg[local]
            blobs = {}
            for j in range(n_parts):
                m = (d >= bounds[j]) & (d < bounds[j + 1])
                contrib = np.bincount(
                    d[m] - bounds[j], weights=w[m],
                    minlength=bounds[j + 1] - bounds[j],
                )
                blobs[f"contrib/p{i:03d}to{j:03d}"] = (
                    contrib.astype("<f8").tobytes()
                )
            ctx.write_many(blobs)
            return {"edges": int(len(s))}

        return run

    def make_apply(j: int):
        def run(_tc) -> dict:
            ctx = current_ctx[0]
            size = bounds[j + 1] - bounds[j]
            total = np.zeros(size, dtype="<f8")
            for i in range(n_parts):  # fixed order: deterministic float sum
                total += _f64(ctx.read_current(f"contrib/p{i:03d}to{j:03d}"))
            new = (1.0 - damping) / n_nodes + damping * total
            prev = _f64(ctx.read(f"rank/p{j:03d}"))
            ctx.write(f"rank/p{j:03d}", new.tobytes())
            return {"residual": float(np.abs(new - prev).sum())}

        return run

    # Tasks close over the live LoopContext via one mutable cell (the
    # stage factories are instantiated fresh each superstep, but the run
    # callables want the *current* iteration's ctx).
    current_ctx: List[LoopContext] = [ctx_probe]

    def superstep(ctx: LoopContext) -> Sequence[Stage]:
        current_ctx[0] = ctx
        return [
            Stage("contrib", [
                StageTask(f"contrib_{i:03d}", make_contrib(i))
                for i in range(n_parts)
            ]),
            Stage("apply", [
                StageTask(f"apply_{j:03d}", make_apply(j))
                for j in range(n_parts)
            ]),
        ]

    def converged(ctx: LoopContext) -> bool:
        residual = sum(
            ctx.result(f"apply_{j:03d}").value["residual"]
            for j in range(n_parts)
        )
        return residual < tol

    report = _run_loop_impl(
        name, init, superstep, converged, state,
        scheduler=scheduler, journal=journal, gateway=gateway,
        max_iterations=max_iterations, pin_state=pin_state,
        halt_after=halt_after,
    )
    ctx_probe.iteration = max(0, report.last_iteration)
    parts = [
        _f64(ctx_probe.read_current(f"rank/p{j:03d}"))
        for j in range(n_parts)
    ]
    ranks = np.concatenate(parts) if parts else np.zeros(0)
    return PageRankResult(report, ranks, ranks.astype("<f8").tobytes())


# -- k-means ------------------------------------------------------------------

def kmeans_points(
    n_points: int, dim: int, k: int, seed: int = 0, spread: float = 0.15
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic well-separated blobs: (points, true_centers)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, size=(k, dim))
    labels = rng.integers(0, k, size=n_points)
    pts = centers[labels] + rng.normal(0.0, spread, size=(n_points, dim))
    return pts.astype("<f8"), centers.astype("<f8")


@dataclass
class KMeansResult:
    report: LoopReport
    centroids: np.ndarray
    centroid_bytes: bytes
    #: fraction of assign-stage centroid reads served from the hot
    #: gateway-session view (0.0 when no gateway was used).
    warm_read_frac: float


def _kmeans_fn_name(name: str) -> str:
    return f"kmeans/{name}"


def _register_kmeans_fn(runtime, fn_name: str) -> None:
    """Centroid-holder stateful function: state = {"it", "centroids"}.

    ``jit=False``: the step is host-side numpy (partition sums arrive as
    plain arrays), matching the MapReduce-task style of function."""
    if fn_name in runtime.functions:
        return

    def fn_init(centroids: bytes, k: int, dim: int, it: int) -> dict:
        return {
            "it": int(it),
            "centroids": np.frombuffer(centroids, dtype="<f8")
            .reshape(k, dim).copy(),
        }

    def fn_step(st: dict, sums, counts):
        old = st["centroids"]
        counts = np.asarray(counts, dtype="<f8").reshape(-1, 1)
        new = np.where(
            counts > 0, np.asarray(sums) / np.maximum(counts, 1.0), old
        )
        shift = float(np.abs(new - old).max())
        state = {"it": int(st["it"]) + 1, "centroids": new}
        return state, (new.astype("<f8").tobytes(), shift)

    from repro_torch.core.stateful import StatefulFunction

    runtime.register(StatefulFunction(fn_name, fn_step, fn_init, jit=False))


def kmeans_loop(
    name: str,
    state: Tier,
    points: np.ndarray,
    k: int,
    n_parts: int = 4,
    tol: float = 1e-6,
    max_iterations: int = 30,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    pin_state: bool = True,
    halt_after: Optional[int] = None,
) -> KMeansResult:
    """Lloyd's k-means as an iterative assign/update dataflow.

    With ``gateway``, the centroid state additionally lives in a gateway
    **session** (:class:`~repro_torch.core.stateful.StatefulFunction` slot
    pinned in the warm pool): assign tasks read centroids from the hot
    view when its iteration tag matches — warm invokers skip the tier
    reload — and fall back to the versioned tier state otherwise (fresh
    start, crash resume).  Output bytes are identical either way.
    """
    n_points, dim = points.shape
    pbounds = _part_bounds(n_points, n_parts)
    ctx_probe = LoopContext(name, state)
    for i in range(n_parts):
        key = ctx_probe.input_key(f"points/p{i:03d}")
        if not state.contains(key):
            state.put(key, points[pbounds[i]:pbounds[i + 1]].tobytes())

    fn_name = _kmeans_fn_name(name)
    session_id = f"df::{name}"
    runtime = gateway.runtime if gateway is not None else None
    if gateway is not None:
        _register_kmeans_fn(runtime, fn_name)
        gateway.pin_warm(fn_name, session=session_id)
    warm_reads = [0, 0]  # [warm, total] across assign tasks
    warm_lock = threading.Lock()  # assign tasks run on parallel workers

    def init(ctx: LoopContext) -> None:
        # Deterministic seeding: the k lexicographically-first points.
        seed_idx = np.argsort(
            [points[i].tobytes() for i in range(n_points)]
        )[:k]
        ctx.write("centroids", points[np.sort(seed_idx)].tobytes())

    def read_centroids(ctx: LoopContext) -> np.ndarray:
        if runtime is not None:
            blob = runtime.state_bytes(fn_name, session=session_id)
            if blob is not None:
                st = serde.loads(blob)
                if int(st["it"]) == ctx.iteration - 1:
                    with warm_lock:
                        warm_reads[0] += 1
                        warm_reads[1] += 1
                    return np.asarray(st["centroids"], dtype="<f8")
        with warm_lock:
            warm_reads[1] += 1
        return _f64(ctx.read("centroids")).reshape(k, dim)

    def make_assign(i: int):
        def run(_tc) -> dict:
            ctx = current_ctx[0]
            cent = read_centroids(ctx)
            pts = _f64(
                ctx.state.get(ctx.input_key(f"points/p{i:03d}"))
            ).reshape(-1, dim)
            d2 = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2)
            assign = np.argmin(d2, axis=1)
            sums = np.zeros((k, dim), dtype="<f8")
            np.add.at(sums, assign, pts)
            counts = np.bincount(assign, minlength=k).astype("<i8")
            ctx.write(
                f"partial/p{i:03d}", sums.tobytes() + counts.tobytes()
            )
            return {"points": int(len(pts))}

        return run

    def update_run(_tc) -> dict:
        ctx = current_ctx[0]
        sums = np.zeros((k, dim), dtype="<f8")
        counts = np.zeros(k, dtype="<i8")
        for i in range(n_parts):  # fixed order: deterministic float sum
            blob = ctx.read_current(f"partial/p{i:03d}")
            sums += np.frombuffer(blob, dtype="<f8", count=k * dim) \
                .reshape(k, dim)
            counts += np.frombuffer(blob, dtype="<i8", offset=8 * k * dim)
        if runtime is not None:
            sess = gateway.session(session_id)
            blob = runtime.state_bytes(fn_name, session=session_id)
            stale = (
                blob is None
                or int(serde.loads(blob)["it"]) != ctx.iteration - 1
            )
            if stale:
                # Fresh start or journal resume: re-seed the session from
                # the authoritative versioned tier state.
                runtime.reset_state(fn_name, session=session_id)
                prev = ctx.read("centroids")
                new_bytes, shift = sess.invoke(
                    fn_name,
                    init_kwargs={
                        "centroids": prev, "k": k, "dim": dim,
                        "it": ctx.iteration - 1,
                    },
                    sums=sums, counts=counts,
                )
            else:
                new_bytes, shift = sess.invoke(fn_name, sums=sums,
                                               counts=counts)
        else:
            old = _f64(ctx.read("centroids")).reshape(k, dim)
            c = counts.astype("<f8").reshape(-1, 1)
            new = np.where(c > 0, sums / np.maximum(c, 1.0), old)
            new_bytes = new.astype("<f8").tobytes()
            shift = float(np.abs(new - old).max())
        ctx.write("centroids", new_bytes)
        return {"shift": float(shift)}

    current_ctx: List[LoopContext] = [ctx_probe]

    def superstep(ctx: LoopContext) -> Sequence[Stage]:
        current_ctx[0] = ctx
        return [
            Stage("assign", [
                StageTask(f"assign_{i:03d}", make_assign(i))
                for i in range(n_parts)
            ]),
            Stage("update", [StageTask("update", update_run)]),
        ]

    def converged(ctx: LoopContext) -> bool:
        return ctx.result("update").value["shift"] < tol

    try:
        report = _run_loop_impl(
            name, init, superstep, converged, state,
            scheduler=scheduler, journal=journal, gateway=gateway,
            max_iterations=max_iterations, pin_state=pin_state,
            halt_after=halt_after,
        )
    finally:
        if gateway is not None:
            gateway.unpin_warm(fn_name, session=session_id)
    ctx_probe.iteration = max(0, report.last_iteration)
    blob = ctx_probe.read_current("centroids")
    frac = warm_reads[0] / warm_reads[1] if warm_reads[1] else 0.0
    return KMeansResult(
        report, _f64(blob).reshape(k, dim), blob, frac
    )


# -- TeraSort -----------------------------------------------------------------

def _records(blob: bytes) -> List[bytes]:
    return [r for r in blob.split(b"\n") if r]


def terasort(
    name: str,
    state: Tier,
    input_parts: Sequence[bytes],
    n_ranges: int = 4,
    sample_every: int = 8,
    scheduler: Optional[Scheduler] = None,
    journal: Optional["StateCache"] = None,
    gateway: Optional["Gateway"] = None,
    device: Optional["DeviceExec"] = None,
) -> StageRunReport:
    """Sample → range-partition → per-partition sort over newline-separated
    byte records — the canonical 3-stage DAG (one ``bounds`` task inside
    the partition stage feeds the scatter tasks via an intra-stage dep).
    Output ranges land at ``df/<name>/out/rNNN``; concatenated in range
    order they are the globally sorted record stream
    (:func:`terasort_output`).

    With ``device``, the scatter tasks lower their range-bucketing onto
    the CUDA histogram kernel (exact-capacity buffers — records are
    opaque bytes, so nothing spills); output bytes are identical to the
    host path because the device pack preserves per-bucket record order.
    """
    prefix = f"df/{name}"
    n_inputs = len(input_parts)
    for i, blob in enumerate(input_parts):
        key = f"{prefix}/input/p{i:03d}"
        if not state.contains(key):
            state.put(key, blob)

    def make_sample(i: int):
        key_in = f"{prefix}/input/p{i:03d}"
        key_out = f"{prefix}/tmp/sample/p{i:03d}"

        def run(_tc) -> dict:
            recs = _records(state.get(key_in))
            sample = recs[::sample_every]
            state.put(key_out, b"\n".join(sample))
            return {"sampled": len(sample)}

        return run, [key_out]

    bounds_key = f"{prefix}/tmp/bounds"

    def bounds_run(_tc) -> dict:
        sample: List[bytes] = []
        for i in range(n_inputs):
            sample.extend(_records(state.get(f"{prefix}/tmp/sample/p{i:03d}")))
        sample.sort()
        cuts = [
            sample[(j + 1) * len(sample) // n_ranges - 1]
            for j in range(n_ranges - 1)
        ] if sample else []
        state.put(bounds_key, b"\n".join(cuts))
        return {"cuts": len(cuts)}

    def make_scatter(i: int):
        key_in = f"{prefix}/input/p{i:03d}"
        outs = [
            f"{prefix}/tmp/scatter/p{i:03d}_r{j:03d}" for j in range(n_ranges)
        ]

        def run(_tc) -> dict:
            cuts = _records(state.get(bounds_key))
            recs = _records(state.get(key_in))
            buckets: List[List[bytes]] = [[] for _ in range(n_ranges)]
            dev = current_device_exec()
            if dev is not None and recs:
                from bisect import bisect_left

                from repro_torch.core.device_shuffle import device_partition

                # bisect_left(cuts, rec) == the scan loop below: the
                # count of cuts strictly below the record.
                dest = [bisect_left(cuts, rec) for rec in recs]
                idx_parts, _ = device_partition(
                    dest, n_ranges, device=dev.device
                )
                for j, idxs in enumerate(idx_parts):
                    buckets[j] = [recs[i] for i in idxs]
                dev.account(partitioned_pairs=len(recs))
            else:
                for rec in recs:
                    j = 0
                    while j < len(cuts) and rec > cuts[j]:
                        j += 1
                    buckets[j].append(rec)
            state.put_many({
                outs[j]: b"\n".join(buckets[j]) for j in range(n_ranges)
            })
            return {"records": sum(len(b) for b in buckets)}

        return run, outs

    def make_sort(j: int):
        key_out = f"{prefix}/out/r{j:03d}"

        def run(_tc) -> dict:
            recs: List[bytes] = []
            for i in range(n_inputs):  # fixed gather order
                recs.extend(_records(
                    state.get(f"{prefix}/tmp/scatter/p{i:03d}_r{j:03d}")
                ))
            recs.sort()
            state.put(key_out, b"\n".join(recs))
            return {"records": len(recs)}

        return run, [key_out]

    sample_tasks, partition_tasks, sort_tasks = [], [], []
    for i in range(n_inputs):
        run, outs = make_sample(i)
        sample_tasks.append(
            StageTask(f"sample_{i:03d}", run, outputs=outs)
        )
    partition_tasks.append(
        StageTask("bounds", bounds_run, outputs=[bounds_key])
    )
    for i in range(n_inputs):
        run, outs = make_scatter(i)
        partition_tasks.append(StageTask(
            f"scatter_{i:03d}", run, deps=["task:bounds"], outputs=outs,
            device=True,
        ))
    for j in range(n_ranges):
        run, outs = make_sort(j)
        sort_tasks.append(StageTask(f"sort_{j:03d}", run, outputs=outs))

    return _run_stages_impl(
        name,
        [
            Stage("sample", sample_tasks),
            Stage("partition", partition_tasks),
            Stage("sort", sort_tasks),
        ],
        state,
        scheduler=scheduler, journal=journal, gateway=gateway,
        device=device,
    )


def terasort_output(state: Tier, name: str, n_ranges: int) -> List[bytes]:
    """The globally sorted record stream (ranges concatenated in order)."""
    out: List[bytes] = []
    for j in range(n_ranges):
        out.extend(_records(state.get(f"df/{name}/out/r{j:03d}")))
    return out
