"""Unified Marvel client — one declarative entry point over the gateway,
the dataflow engine, and the tiered state store.

After PRs 1-4 every example and benchmark hand-assembled its own stack:
build tiers, wrap a :class:`~repro_torch.storage.hierarchy.TieredStore`,
construct a :class:`~repro_torch.core.journal.StateJournal`, spin up a
:class:`~repro_torch.core.gateway.Gateway`, then pick the right engine entry
point (``run_job`` vs ``run_stages`` vs ``run_loop``).  Cloudburst and
Faasm both show that the *client-facing* surface — a small, consistent
API over sessions, shared state, and job submission — is what makes
stateful FaaS usable; this module is that surface for Marvel:

  * :class:`ClusterConfig` — one declarative description of a cluster
    (tier stack + capacities, invoker count, placement policy, journal
    home, block store geometry, fault injection).  Validation is strict
    and typed: a bad config raises :class:`ConfigError`, never a
    half-built cluster (construction is transactional — partially built
    components are torn down before the error propagates).
  * :class:`MarvelClient` — a context manager owning the lifecycle of
    the tier stack, :class:`~repro_torch.storage.kvcache.StateCache` journal,
    :class:`~repro_torch.core.stateful.FunctionRuntime`, :class:`Gateway`, and
    pooled :class:`~repro_torch.core.scheduler.Scheduler` built from that
    config.  Everything the engine layers expose is reachable from it:

      - ``client.dataset(parts).map(f).shuffle(by=k).reduce(g).run()`` —
        a lazy fluent plan lowered onto the MapReduce 2-stage dataflow;
      - ``client.stages(name, [...])`` — one-shot N-stage jobs;
      - ``client.iterate(name, init=..., superstep=..., until=...)`` —
        fixed-point loops with pinned, journaled loop state;
      - ``client.session(app)`` / ``client.function(...)`` — stateful
        function invocation through the gateway (FIFO lanes, leases,
        warm pool, admission control);
      - ``client.pagerank`` / ``client.kmeans`` / ``client.terasort`` —
        the paper-class workloads on the client's own stack.

  * :class:`JobHandle` + unified :class:`JobReport` — every submission
    path returns the same report schema (wall/modeled seconds, task and
    iteration counts, per-level tier rollup) regardless of which engine
    ran it, replacing the three divergent shapes
    (``mapreduce.JobReport`` / ``StageRunReport`` / ``LoopReport``).
    The raw engine report stays available as ``handle.raw``; unknown
    field reads fail loudly (``report.field("typo")`` raises).

The façade *lowers* onto the existing engines — it re-implements no
execution.  The legacy entry points (``run_job``, ``run_stages``,
``run_loop``) survive as deprecation shims that delegate here via
:meth:`MarvelClient.from_components`, byte-identical outputs and
journaled resume included (asserted by ``tests/test_api.py``).

See DESIGN.md §9 for the config schema, the lazy-plan lowering rules,
and the lifecycle/ownership diagram.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import torch

from repro_torch.core import dataflow as _dataflow
from repro_torch.core import mapreduce as _mapreduce
from repro_torch.core.cluster import ClusterRouter, LinkSpec, NetworkFabric, Node
from repro_torch.core.dataflow import LoopContext, Stage
from repro_torch.core.gateway import Gateway
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.stateful import FunctionRuntime, Session, StatefulFunction
from repro_torch.storage.blockstore import BlockStore, DataNode
from repro_torch.storage.faults import FaultInjectingTier
from repro_torch.storage.hierarchy import PlacementPolicy, TieredStore, TierLevel
from repro_torch.storage.kvcache import StateCache
from repro_torch.storage.tiers import (
    PMEM_SPEC,
    S3_SPEC,
    SSD_SPEC,
    DeviceSpec,
    DramTier,
    PmemTier,
    SimulatedTier,
    Tier,
    TierStats,
)

__all__ = [
    "ClientClosedError",
    "ClusterConfig",
    "ConfigError",
    "Dataset",
    "FaultSpec",
    "JobHandle",
    "JobReport",
    "MarvelClient",
    "REPORT_FIELDS",
    "ServingConfig",
    "TierSpec",
]


class ConfigError(ValueError):
    """A :class:`ClusterConfig` failed validation or could not be built.

    The contract is transactional: when this is raised, no cluster
    component survives — anything partially constructed has been torn
    down (no leaked invoker threads, flushers, or tier state).
    """


class ClientClosedError(RuntimeError):
    """The :class:`MarvelClient` is closed; submissions are refused."""


# -- declarative cluster description ------------------------------------------

#: tier kinds buildable by name alone.
_TIER_KINDS = ("dram", "pmem", "ssd", "s3")


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise ConfigError(
            "device=True needs a CUDA GPU; pass device_interpret=True to "
            "run the kernels' plain versions on the CPU (CPU CI)"
        )


@dataclass(frozen=True)
class TierSpec:
    """One level of the state-tier stack.

    ``kind`` names a built-in device model (``dram``, ``pmem``, ``ssd``,
    ``s3``); ``device`` overrides it with a custom
    :class:`~repro_torch.storage.tiers.DeviceSpec` (the quota-scaled S3 of the
    fig4 benchmark, say); ``path`` makes ``pmem`` a real mmap-backed
    :class:`~repro_torch.storage.tiers.PmemTier` instead of the modeled one.
    ``capacity_bytes`` bounds the level inside a multi-tier stack — the
    last (home) level must be unbounded.
    """

    kind: str = "dram"
    capacity_bytes: Optional[int] = None
    device: Optional[DeviceSpec] = None
    path: Optional[str] = None
    #: make the modeled device actually sleep its modeled seconds
    #: (scaled) — benchmarks use this so overlap is real wall time.
    sleep: bool = False
    sleep_scale: float = 1.0

    def build(self) -> Tier:
        if self.device is not None:
            return SimulatedTier(self.device, sleep=self.sleep,
                                 sleep_scale=self.sleep_scale)
        if self.kind == "dram":
            return DramTier()
        if self.kind == "pmem" and self.path:
            return PmemTier(self.path)
        spec = {"pmem": PMEM_SPEC, "ssd": SSD_SPEC, "s3": S3_SPEC}.get(self.kind)
        if spec is None:
            raise ConfigError(f"unknown tier kind {self.kind!r}")
        return SimulatedTier(spec, sleep=self.sleep,
                             sleep_scale=self.sleep_scale)


@dataclass(frozen=True)
class FaultSpec:
    """Seeded fault injection wrapped around the home (bottom) tier level.

    Mirrors :class:`~repro_torch.storage.faults.FaultInjectingTier` — rates are
    per-op probabilities, ``schedule`` forces faults at exact per-kind op
    indices.  Deterministic given the op sequence.
    """

    seed: int = 0
    put_error_rate: float = 0.0
    get_error_rate: float = 0.0
    torn_put_many_rate: float = 0.0
    spike_rate: float = 0.0
    spike_seconds: float = 0.005
    schedule: Tuple[Tuple[str, int], ...] = ()

    def wrap(self, tier: Tier) -> FaultInjectingTier:
        return FaultInjectingTier(
            tier,
            seed=self.seed,
            put_error_rate=self.put_error_rate,
            get_error_rate=self.get_error_rate,
            torn_put_many_rate=self.torn_put_many_rate,
            spike_rate=self.spike_rate,
            spike_seconds=self.spike_seconds,
            schedule=self.schedule,
        )


@dataclass(frozen=True)
class ServingConfig:
    """Knobs for the KV-paging serving subsystem (DESIGN.md §14).

    ``block_tokens`` sets the paged-block granularity (token slots per
    (session, layer, block) tier key); ``dram_budget_bytes`` bounds the
    bytes of KV blocks resident for *hot* sessions — the serving pool
    demotes idle sessions and then sheds new conversations against it
    (``None`` admits everything).  ``lossless=True`` demotes raw bytes
    instead of int8-quantized blocks (byte-identity mode);
    ``prefetch_on_resume`` controls promotion-on-resume (off = cold
    sessions demand-fault their blocks inside the next decode step).
    """

    block_tokens: int = 16
    dram_budget_bytes: Optional[int] = None
    lossless: bool = False
    prefetch_on_resume: bool = True
    admission: bool = True

    def validate(self) -> None:
        if self.block_tokens < 1:
            raise ConfigError("serving.block_tokens must be >= 1")
        if self.dram_budget_bytes is not None and self.dram_budget_bytes <= 0:
            raise ConfigError(
                "serving.dram_budget_bytes must be positive (or None)"
            )


@dataclass(frozen=True)
class ClusterConfig:
    """Everything a Marvel cluster is, in one declarative value.

    ``tiers`` runs fastest → slowest; a single entry is used directly, two
    or more become a :class:`TieredStore` under ``placement`` (defaulting
    to write-back with first-read promotion — the fig8/fig9 configuration).
    ``journal`` picks the durability home for commit markers and
    write-back redo records: ``"volatile"`` (DRAM StateCache — stock
    Marvel), ``"pmem"`` (write-through to a PmemTier at ``journal_path``),
    or ``"none"``.  ``faults`` wraps the home tier level with seeded
    fault injection.  The block-store knobs (``nodes`` / ``block_size`` /
    ``replication``) shape the HDFS-analog input/output store.
    """

    name: str = "marvel"
    tiers: Tuple[Union[TierSpec, str], ...] = ("dram",)
    placement: Optional[PlacementPolicy] = None
    invokers: int = 4
    warm_pool: int = 64
    target_inflight: Optional[int] = None
    journal: str = "volatile"
    journal_path: Optional[str] = None
    nodes: int = 4
    block_size: int = 1 << 20
    replication: int = 2
    #: multi-node mode: build ``nodes`` full per-node stacks (each its own
    #: tier hierarchy, invoker pool, journal, and DataNode) behind a
    #: consistent-hash :class:`~repro_torch.core.cluster.ClusterRouter`.  The
    #: default keeps today's single-stack geometry, where ``nodes`` only
    #: shapes the block store; ``sharded=True, nodes=1`` is byte-identical
    #: to it (golden-equivalence tested).
    sharded: bool = False
    #: cost model of the inter-node network links (sharded mode only);
    #: ``None`` = the ~10 GbE :class:`~repro_torch.core.cluster.LinkSpec`
    #: default.
    network: Optional["LinkSpec"] = None
    #: function-state commit cadence (1 = commit after every invocation).
    commit_every: int = 1
    #: batch concurrent function-state commits into group flushes (the
    #: warm-path fast lane, DESIGN.md §10).  Invocation Futures then ack
    #: on durability, not on tier write completion; recovery bytes are
    #: unchanged.  Disable for the strictly sequential
    #: put(blob)+put(marker) op sequence (e.g. exact fault schedules).
    group_commit: bool = True
    #: lock stripes sharding the gateway's lane map / warm-pool LRU.
    gateway_stripes: int = 8
    faults: Optional[FaultSpec] = None
    #: device execution mode: lower the dataflow partition step onto the
    #: CUDA histogram kernel and eligible reduces onto the device
    #: segment-sum (outputs stay byte-identical to host mode).
    device: bool = False
    #: ``True`` runs the kernels' plain versions on the CPU (the analog
    #: of the reference's interpret mode; required for ``device=True``
    #: without a GPU — CPU CI).  ``None``/``False`` run on the GPU and
    #: are *only* valid when CUDA is available.
    device_interpret: Optional[bool] = None
    #: sizing of the device partition send buffers relative to a
    #: balanced split; overflow beyond it spills through the
    #: intermediate tier instead of being dropped.
    device_capacity_factor: float = 1.3
    #: KV-paging serving subsystem defaults consumed by
    #: :meth:`MarvelClient.serving` (``None`` = subsystem defaults).
    serving: Optional[ServingConfig] = None

    def tier_specs(self) -> List[TierSpec]:
        out: List[TierSpec] = []
        for t in self.tiers:
            out.append(TierSpec(kind=t) if isinstance(t, str) else t)
        return out

    def validate(self) -> None:
        """Raise :class:`ConfigError` on any inconsistency; return None
        iff a :class:`MarvelClient` can be built from this config."""
        if not self.name or "/" in self.name:
            raise ConfigError(f"bad cluster name {self.name!r}")
        specs = self.tier_specs()
        if not specs:
            raise ConfigError("tiers must name at least one level")
        for spec in specs:
            if spec.device is None and spec.kind not in _TIER_KINDS:
                raise ConfigError(
                    f"unknown tier kind {spec.kind!r} "
                    f"(expected one of {_TIER_KINDS})"
                )
            if spec.capacity_bytes is not None and spec.capacity_bytes <= 0:
                raise ConfigError(
                    f"tier {spec.kind!r}: capacity_bytes must be positive"
                )
        if specs[-1].capacity_bytes is not None:
            raise ConfigError("the home (last) tier level must be unbounded")
        if self.invokers < 1:
            raise ConfigError("invokers must be >= 1")
        if self.warm_pool < 1:
            raise ConfigError("warm_pool must be >= 1")
        if self.target_inflight is not None and self.target_inflight < 1:
            raise ConfigError("target_inflight must be >= 1 (or None)")
        if self.journal not in ("volatile", "pmem", "none"):
            raise ConfigError(
                f"journal must be 'volatile', 'pmem', or 'none', "
                f"not {self.journal!r}"
            )
        if self.journal == "pmem" and not self.journal_path:
            raise ConfigError("journal='pmem' requires journal_path")
        if self.nodes < 1:
            raise ConfigError("nodes must be >= 1")
        if self.block_size < 1:
            raise ConfigError("block_size must be >= 1")
        if not 1 <= self.replication <= self.nodes:
            raise ConfigError(
                f"replication {self.replication} must be within "
                f"[1, nodes={self.nodes}]"
            )
        if self.commit_every < 1:
            raise ConfigError("commit_every must be >= 1")
        if self.gateway_stripes < 1:
            raise ConfigError("gateway_stripes must be >= 1")
        if self.device_capacity_factor <= 0:
            raise ConfigError("device_capacity_factor must be > 0")
        if self.device and self.device_interpret is not True:
            _require_cuda()
        if self.serving is not None:
            self.serving.validate()
        if self.faults is not None:
            fs = self.faults
            for rate_name in ("put_error_rate", "get_error_rate",
                              "torn_put_many_rate", "spike_rate"):
                rate = getattr(fs, rate_name)
                if not 0.0 <= rate <= 1.0:
                    raise ConfigError(f"faults.{rate_name} must be in [0, 1]")
            for kind, idx in fs.schedule:
                if kind not in ("put", "get", "torn", "spike") or idx < 0:
                    raise ConfigError(
                        f"faults.schedule entry {(kind, idx)!r} invalid"
                    )


# -- unified report ------------------------------------------------------------

#: canonical numeric fields every unified report carries (the benchmark
#: serialization schema — ``benchmarks/common.py::emit_job`` writes these
#: and ``benchmarks/compare.py`` refuses TRACKED fields outside them).
REPORT_FIELDS = (
    "wall_seconds",
    "modeled_io_seconds",
    "total_seconds",
    "tasks",
    "resumed_tasks",
    "iterations",
)


@dataclass
class JobReport:
    """The one report schema every façade submission returns.

    ``kind`` says which engine ran the job (``"mapreduce"`` /
    ``"stages"`` / ``"loop"``); engine-specific facts live in ``extra``
    under stable names; ``tiers`` is the per-level I/O rollup captured
    from the client's tier stack across the run.  :meth:`field` is the
    loud accessor: unknown names raise instead of silently returning a
    default — the per-benchmark ad-hoc key bug class this schema removes.
    """

    job: str
    kind: str
    wall_seconds: float = 0.0
    modeled_io_seconds: float = 0.0
    tasks: int = 0
    resumed_tasks: int = 0
    iterations: int = 0
    converged: Optional[bool] = None
    tiers: Dict[str, Dict[str, float]] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return self.wall_seconds + self.modeled_io_seconds

    def field(self, name: str) -> Any:
        """Schema-checked field access: canonical fields and declared
        extras only — a typo raises ``KeyError`` with the valid names."""
        if name in REPORT_FIELDS:
            return getattr(self, name)
        if name in ("job", "kind", "converged"):
            return getattr(self, name)
        if name in self.extra:
            return self.extra[name]
        raise KeyError(
            f"unknown JobReport field {name!r}; canonical fields are "
            f"{REPORT_FIELDS}, extras here: {sorted(self.extra)}"
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "job": self.job,
            "kind": self.kind,
            "converged": self.converged,
        }
        for name in REPORT_FIELDS:
            out[name] = getattr(self, name)
        out["tiers"] = self.tiers
        out.update(self.extra)
        return out


def _stats_dict(stats: TierStats) -> Dict[str, float]:
    return {
        "bytes_read": stats.bytes_read,
        "bytes_written": stats.bytes_written,
        "read_ops": stats.read_ops,
        "write_ops": stats.write_ops,
        "modeled_seconds": stats.modeled_seconds,
    }


def unify_report(raw: Any, tiers: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> JobReport:
    """Normalize any engine report shape into the unified schema."""
    tiers = tiers or {}
    if isinstance(raw, _mapreduce.JobReport):
        return JobReport(
            job=raw.job,
            kind="mapreduce",
            wall_seconds=raw.wall_seconds,
            modeled_io_seconds=raw.modeled_io_seconds,
            tasks=raw.map_tasks + raw.reduce_tasks,
            resumed_tasks=raw.resumed_tasks,
            tiers=tiers,
            extra={
                "mode": raw.mode,
                "map_tasks": raw.map_tasks,
                "reduce_tasks": raw.reduce_tasks,
                "input_bytes": raw.input_bytes,
                "intermediate_bytes": raw.intermediate_bytes,
                "output_bytes": raw.output_bytes,
                "speculative_wins": raw.speculative_wins,
                "retried_tasks": raw.retried_tasks,
                "overlap_seconds": raw.overlap_seconds,
                "partitions_streamed": raw.partitions_streamed,
                "device_mode": int(raw.device_mode),
                "device_pairs": raw.device_pairs,
                "device_groups": raw.device_groups,
                "device_spilled_pairs": raw.device_spilled_pairs,
                "device_fallback_tasks": raw.device_fallback_tasks,
            },
        )
    if isinstance(raw, _dataflow.StageRunReport):
        return JobReport(
            job=raw.job,
            kind="stages",
            wall_seconds=raw.wall_seconds,
            modeled_io_seconds=raw.modeled_io_seconds,
            tasks=raw.tasks,
            resumed_tasks=raw.resumed_tasks,
            tiers=tiers,
            extra={"device_tasks": raw.device_tasks},
        )
    if isinstance(raw, _dataflow.LoopReport):
        return JobReport(
            job=raw.job,
            kind="loop",
            wall_seconds=raw.wall_seconds,
            modeled_io_seconds=raw.modeled_io_seconds,
            tasks=sum(r.get("tasks", 0) for r in raw.per_iteration),
            resumed_tasks=raw.resumed_iterations,
            iterations=raw.iterations,
            converged=raw.converged,
            tiers=tiers,
            extra={
                "last_iteration": raw.last_iteration,
                "resumed_iterations": raw.resumed_iterations,
                "per_iteration": list(raw.per_iteration),
            },
        )
    raise TypeError(f"cannot unify report of type {type(raw).__name__}")


@dataclass
class JobHandle:
    """What every façade submission returns: the unified report, the raw
    engine report, and the job's result payload (workload-specific —
    e.g. the final rank bytes for PageRank, the output path for a
    dataset job)."""

    job: str
    kind: str
    report: JobReport
    raw: Any
    result: Any = None


# -- the client ----------------------------------------------------------------

class MarvelClient:
    """Owns one Marvel cluster built from a :class:`ClusterConfig`.

    Construction is transactional (see :class:`ConfigError`); ``close``
    is idempotent and tears down the gateway (draining in-flight work),
    the pooled scheduler, and the tier stack.  Use as a context manager:

        with MarvelClient(ClusterConfig(tiers=("dram", "s3"))) as client:
            out = client.dataset(parts).map(f).shuffle().reduce(g).run()

    :meth:`from_components` wraps pre-built components *without* owning
    them — the legacy ``run_job``/``run_stages``/``run_loop`` shims
    delegate through it, so old call sites run the exact same engine path
    as façade users (byte-identical outputs, journaled resume intact).
    """

    def __init__(self, config: Optional[ClusterConfig] = None,
                 **overrides: Any) -> None:
        if config is None:
            config = ClusterConfig()
        if overrides:
            try:
                config = replace(config, **overrides)
            except TypeError as exc:
                raise ConfigError(f"unknown ClusterConfig field: {exc}") from exc
        config.validate()
        self.config = config
        self._closed = False
        self._owned = True
        self._dataset_seq = 0
        self.state: Optional[Tier] = None
        self.store: Optional[BlockStore] = None
        self.journal: Optional[StateCache] = None
        self.runtime: Optional[FunctionRuntime] = None
        self.gateway: Optional[Gateway] = None
        self.scheduler: Optional[Scheduler] = None
        self.cluster: Optional[ClusterRouter] = None
        try:
            self._build()
        except ConfigError:
            self._teardown_partial()
            raise
        except Exception as exc:
            self._teardown_partial()
            raise ConfigError(f"cluster construction failed: {exc}") from exc

    # -- construction ------------------------------------------------------
    def _build_stack(self, name: str, journal_path: Optional[str]):
        """Build one single-machine Marvel stack (tiers, journal cache,
        runtime, gateway, scheduler).  The non-sharded client *is* one
        stack; sharded mode builds one per node from the same specs —
        which is what makes ``sharded=True, nodes=1`` byte-identical to
        the single-node path."""
        cfg = self.config
        durable = PmemTier(journal_path) if cfg.journal == "pmem" else None
        journal = StateCache(write_through=durable) if cfg.journal != "none" else None
        specs = cfg.tier_specs()
        built = [spec.build() for spec in specs]
        if cfg.faults is not None:
            built[-1] = cfg.faults.wrap(built[-1])
        if len(built) == 1:
            state = built[0]
        else:
            policy = cfg.placement or PlacementPolicy(
                write_back=True, promote_after=1
            )
            state = TieredStore(
                [
                    TierLevel(spec.kind, tier, spec.capacity_bytes)
                    for spec, tier in zip(specs, built)
                ],
                policy=policy,
                journal=journal,
                name=name,
            )
        # Function/session state rides the stack's tier hierarchy (the
        # Marvel architecture: one state hierarchy under everything) and
        # shares the journal's durability home when one is configured.
        runtime = FunctionRuntime(
            cache=StateCache(memory=state, write_through=durable),
            commit_every=cfg.commit_every,
            group_commit=cfg.group_commit,
        )
        gateway = Gateway(
            runtime,
            invokers=cfg.invokers,
            warm_pool=cfg.warm_pool,
            target_inflight=cfg.target_inflight,
            stripes=cfg.gateway_stripes,
            name=name,
        )
        scheduler = gateway.shared_scheduler()
        return state, journal, runtime, gateway, scheduler, durable

    def _build(self) -> None:
        cfg = self.config
        if cfg.sharded:
            self._build_cluster()
            return
        (
            self.state,
            self.journal,
            self.runtime,
            self.gateway,
            self.scheduler,
            _durable,
        ) = self._build_stack(cfg.name, cfg.journal_path)
        self.store = BlockStore(
            [DataNode(f"{cfg.name}/n{i}", DramTier())
             for i in range(cfg.nodes)],
            block_size=cfg.block_size,
            replication=cfg.replication,
        )

    def _build_cluster(self) -> None:
        """Sharded mode: ``nodes`` full per-node stacks behind a
        consistent-hash router.  Node 0's components double as the
        client's own ``state``/``journal``/``runtime``/``gateway``/
        ``scheduler`` so every single-stack façade path still works (and
        at ``nodes=1`` is exactly the non-sharded build — same names,
        same journal path)."""
        cfg = self.config
        nodes: List[Node] = []
        try:
            for i in range(cfg.nodes):
                name = cfg.name if i == 0 else f"{cfg.name}-n{i}"
                jpath = cfg.journal_path
                if jpath is not None and i > 0:
                    jpath = f"{jpath}-n{i}"
                state, journal, runtime, gateway, scheduler, durable = (
                    self._build_stack(name, jpath)
                )
                nodes.append(
                    Node(
                        node_id=f"n{i}",
                        state=state,
                        runtime=runtime,
                        gateway=gateway,
                        datanode=DataNode(f"{cfg.name}/n{i}", DramTier()),
                        journal=journal,
                        durable=durable,
                        workers=cfg.invokers,
                    )
                )
                if i == 0:
                    self.state = state
                    self.journal = journal
                    self.runtime = runtime
                    self.gateway = gateway
                    self.scheduler = scheduler
        except Exception:
            for node in nodes:
                try:
                    node.close(drain=False)
                except Exception:
                    pass
            raise
        self.store = BlockStore(
            [n.datanode for n in nodes],
            block_size=cfg.block_size,
            replication=cfg.replication,
        )
        self.cluster = ClusterRouter(
            nodes, store=self.store, fabric=NetworkFabric(cfg.network)
        )
        #: next node index for elastic add_node (node ids stay unique
        #: across the cluster's lifetime, even after removals).
        self._node_seq = cfg.nodes

    def _teardown_partial(self) -> None:
        """Best-effort rollback of a failed build — nothing may leak."""
        if self.cluster is not None:
            try:
                self.cluster.close(drain=False)
            except Exception:
                pass
            self.cluster = None
            self.state = self.store = self.journal = None
            self.runtime = self.gateway = self.scheduler = None
            self._closed = True
            return
        if self.gateway is not None:
            try:
                self.gateway.close(drain=False)
            except Exception:
                pass
        if self.runtime is not None:
            try:
                self.runtime.close()
            except Exception:
                pass
        if isinstance(self.state, TieredStore):
            try:
                self.state.close(flush=False)
            except Exception:
                pass
        self.state = self.store = self.journal = None
        self.runtime = self.gateway = self.scheduler = None
        self._closed = True

    @classmethod
    def from_components(
        cls,
        *,
        store: Optional[BlockStore] = None,
        state: Optional[Tier] = None,
        scheduler: Optional[Scheduler] = None,
        journal: Optional[StateCache] = None,
        gateway: Optional[Gateway] = None,
        name: str = "legacy",
    ) -> "MarvelClient":
        """Wrap pre-built components without taking ownership.

        ``close`` on such a client is a no-op for the wrapped components
        (the caller built them, the caller closes them).  This is the
        deprecation-shim path: legacy entry points hand their arguments
        here and run through the same façade methods as new code.
        """
        client = cls.__new__(cls)
        client.config = ClusterConfig(name=name)
        client._closed = False
        client._owned = False
        client.store = store
        client.state = state
        client.scheduler = scheduler
        client.journal = journal
        client.gateway = gateway
        client.runtime = gateway.runtime if gateway is not None else None
        client.cluster = None
        client._dataset_seq = 0
        return client

    # -- lifecycle ---------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, drain: bool = True) -> None:
        """Idempotent teardown: gateway (and its pooled scheduler) first,
        then the tier stack.  ``drain=False`` fails pending invocations
        fast instead of finishing them (the crash-path exit)."""
        if self._closed:
            return
        self._closed = True
        if not self._owned:
            return
        if self.cluster is not None:
            # node 0's components are the client's own; the router closes
            # every node with the same gateway-then-runtime-then-tiers
            # ordering as the single-stack path below.
            self.cluster.close(drain=drain)
            return
        if self.gateway is not None:
            self.gateway.close(drain=drain)
        if self.runtime is not None:
            # drain the group committer after the gateway (whose drained
            # close already awaited every in-flight durable ack).
            self.runtime.close()
        if isinstance(self.state, TieredStore):
            self.state.close(flush=drain)

    def __enter__(self) -> "MarvelClient":
        self._check_open()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.close(drain=exc_type is None)

    def _check_open(self) -> None:
        if self._closed:
            raise ClientClosedError(
                f"MarvelClient {self.config.name!r} is closed"
            )

    # -- tier accounting ---------------------------------------------------
    @staticmethod
    def _stack_rollup(state: Tier) -> Dict[str, Dict[str, float]]:
        if isinstance(state, TieredStore):
            return {
                name: _stats_dict(stats)
                for name, stats in state.stats_by_level().items()
            }
        return {state.name: _stats_dict(state.stats)}

    def tier_rollup(self) -> Dict[str, Dict[str, float]]:
        """Per-level physical I/O counters of the state stack (single
        tiers report one level under their own name).  Multi-node
        clusters report every node's levels under ``<node>/<level>``
        plus the network fabric under ``net`` — storage vs network bytes
        in one rollup."""
        if self.cluster is not None and len(self.cluster.nodes) > 1:
            out: Dict[str, Dict[str, float]] = {}
            for nid, node in sorted(self.cluster.nodes.items()):
                for level, stats in self._stack_rollup(node.state).items():
                    out[f"{nid}/{level}"] = stats
            out["net"] = _stats_dict(self.cluster.fabric.total)
            return out
        if self.state is None:
            return {}
        return self._stack_rollup(self.state)

    def _handle(self, raw: Any, result: Any = None) -> JobHandle:
        report = unify_report(raw, tiers=self.tier_rollup())
        return JobHandle(job=report.job, kind=report.kind, report=report,
                         raw=raw, result=result)

    def _device_exec(self, device: Optional[bool]):
        """A fresh per-submission device-execution context, or ``None``.

        ``device=None`` inherits the config's mode; a per-call
        ``device=True`` is validated the same way the config is (CUDA
        required unless ``device_interpret=True``, which runs the plain
        versions of the kernels on the CPU)."""
        cfg = self.config
        if device is None:
            device = cfg.device
        if not device:
            return None
        if cfg.device_interpret is True:
            where = torch.device("cpu")
        else:
            _require_cuda()
            where = torch.device("cuda")
        from repro_torch.core.device_shuffle import DeviceExec

        return DeviceExec(
            device=where, capacity_factor=cfg.device_capacity_factor,
        )

    # -- stateful functions (gateway surface) ------------------------------
    def register(self, fn: StatefulFunction) -> StatefulFunction:
        self._check_open()
        if self.cluster is not None:
            # a session may hash onto any node: register everywhere.
            return self.cluster.register(fn)
        return self.runtime.register(fn)

    def function(self, name: str, init: Callable[..., Any],
                 jit: bool = True) -> Callable:
        """Decorator registering a stateful function on the runtime (on
        every node's runtime in sharded mode)."""
        self._check_open()
        if self.cluster is not None:
            def deco(step: Callable) -> StatefulFunction:
                return self.register(
                    StatefulFunction(name, step, init, jit=jit)
                )

            return deco
        return self.runtime.function(name, init, jit=jit)

    def session(self, session_id: str = "default",
                app: str = "default") -> Session:
        """A session whose ``invoke`` routes through the gateway (FIFO
        lane, state lease, warm pool, admission control).  Sharded
        clients resolve the ring owner per call, so the session survives
        node loss and re-homing."""
        self._check_open()
        if self.cluster is not None:
            return self.cluster.session(session_id, app=app)
        if self.gateway is None:
            raise ConfigError("this client wraps no gateway")
        return self.gateway.session(session_id, app=app)

    def invoke(self, fn_name: str, app: str = "default",
               session: str = "default", **inputs: Any) -> Any:
        self._check_open()
        if self.cluster is not None:
            return self.cluster.invoke(fn_name, app=app, session=session,
                                       **inputs)
        return self.gateway.invoke(fn_name, app=app, session=session,
                                   **inputs)

    def submit(self, fn_name: str, app: str = "default",
               session: str = "default",
               init_kwargs: Optional[dict] = None, block: bool = True,
               timeout: Optional[float] = None, **inputs: Any):
        """Async invoke: returns the gateway Future.  ``block=False``
        turns admission backpressure into an immediate
        :class:`~repro_torch.core.gateway.AdmissionError` (load shedding) —
        the reference's open-loop trace replay (``core/loadgen.py``, not
        ported yet) submits through this.  Sharded clients resolve the ring owner per call."""
        self._check_open()
        if self.cluster is not None:
            return self.cluster.submit(
                fn_name, app=app, session=session, init_kwargs=init_kwargs,
                block=block, timeout=timeout, **inputs,
            )
        return self.gateway.submit(
            fn_name, app=app, session=session, init_kwargs=init_kwargs,
            block=block, timeout=timeout, **inputs,
        )

    # -- elastic membership (sharded mode) ---------------------------------
    def add_node(self) -> str:
        """Grow a sharded cluster by one node built from the same
        :class:`ClusterConfig` specs as the original fleet.  The node
        joins the ring (only its arcs re-home; their sessions migrate
        lazily on first touch), the block store, and gets every
        registered function.  Returns the new node id."""
        self._check_open()
        if self.cluster is None:
            raise ConfigError(
                "add_node needs a sharded cluster "
                "(ClusterConfig(sharded=True))"
            )
        cfg = self.config
        i = self._node_seq
        self._node_seq += 1
        jpath = cfg.journal_path
        if jpath is not None:
            jpath = f"{jpath}-n{i}"
        state, journal, runtime, gateway, _scheduler, durable = (
            self._build_stack(f"{cfg.name}-n{i}", jpath)
        )
        node = Node(
            node_id=f"n{i}",
            state=state,
            runtime=runtime,
            gateway=gateway,
            datanode=DataNode(f"{cfg.name}/n{i}", DramTier()),
            journal=journal,
            durable=durable,
            workers=cfg.invokers,
        )
        self.cluster.add_node(node)
        return node.node_id

    def remove_node(self, node_id: str) -> Dict[str, Any]:
        """Gracefully shrink a sharded cluster (see
        :meth:`~repro_torch.core.cluster.ClusterRouter.remove_node` — refuses
        while the node owns in-flight work).  Node ``n0`` anchors the
        client's own ``state``/``gateway``/``scheduler`` and cannot be
        removed."""
        self._check_open()
        if self.cluster is None:
            raise ConfigError(
                "remove_node needs a sharded cluster "
                "(ClusterConfig(sharded=True))"
            )
        if node_id == "n0":
            raise ConfigError(
                "cannot remove n0: it anchors the client's own components"
            )
        return self.cluster.remove_node(node_id)

    def serving(
        self,
        params: Any,
        model_cfg: Any,
        *,
        prompt_len: int,
        max_tokens: int,
        config: Optional[ServingConfig] = None,
        app: str = "serve",
        fn_name: str = "decode",
        device: Any = "cuda",
    ):
        """Build the KV-paging serving pool (DESIGN.md §14) over this
        client's tier stack and gateway: a paged decode function is
        registered, warm-pool evictions route the victim's KV blocks
        through the pager, and the gateway's load snapshots grow
        resident/paged session counts.  ``config`` falls back to
        ``ClusterConfig.serving``, then subsystem defaults.  Returns a
        :class:`~repro_torch.serving.ServingPool`.

        Prefill and decode run on ``device``: the GPU unless the caller
        passes ``device="cpu"`` (the kernels' plain versions, for CPU
        tests); a CUDA device without CUDA raises :class:`ConfigError`.
        ``params`` must already lie on that device."""
        self._check_open()
        if self.cluster is not None:
            raise ConfigError(
                "serving() drives a single-stack client; sharded serving "
                "is not supported yet"
            )
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise ConfigError(
                "serving() runs on a CUDA GPU; pass device='cpu' to run the "
                "kernels' plain versions on the CPU (CPU CI)"
            )
        from repro_torch.serving import KVPager, PagedDecoder, ServingPool

        scfg = config or self.config.serving or ServingConfig()
        scfg.validate()
        pager = KVPager(
            self.state,
            device=device,
            block_tokens=scfg.block_tokens,
            lossless=scfg.lossless,
            dram_budget_bytes=scfg.dram_budget_bytes,
            prefetch_on_resume=scfg.prefetch_on_resume,
        )
        decoder = PagedDecoder(
            params, model_cfg, pager,
            prompt_len=prompt_len, max_tokens=max_tokens, name=fn_name,
        )
        self.register(decoder.fn)
        return ServingPool(
            self.gateway, pager, decoder, app=app,
            admission=scfg.admission,
        )

    def autoscaler(self, *args: Any, **kwargs: Any):
        """Not ported yet: the autoscaler and the load generator come
        with the cluster slice (ROADMAP.md, queue A item 7)."""
        raise NotImplementedError(
            "MarvelClient.autoscaler() is not ported yet: see ROADMAP.md, "
            "queue A item 7 (loadgen/autoscale)"
        )

    # -- dataset / dataflow surface ----------------------------------------
    def dataset(self, parts: Sequence[bytes],
                name: Optional[str] = None) -> "Dataset":
        """A lazy dataset over newline-separated byte-record blobs.

        Nothing executes until ``.run()`` / ``.collect()``: the fluent
        chain builds a plan that lowers onto the MapReduce 2-stage
        dataflow at submission time."""
        self._check_open()
        if name is None:
            self._dataset_seq += 1
            name = f"ds{self._dataset_seq:04d}"
        return Dataset(self, tuple(parts), name=name)

    def mapreduce(
        self,
        job: "_mapreduce.MapReduceJob",
        input_path: str,
        output_path: str,
        mode: str = "wave",
        adaptive: bool = False,
        fail_map_attempts: Optional[Dict[str, int]] = None,
        intermediate: Optional[Tier] = None,
        store: Optional[BlockStore] = None,
        device: Optional[bool] = None,
    ) -> JobHandle:
        """Run a :class:`~repro_torch.core.mapreduce.MapReduceJob` on the
        client's stack (or explicit overrides).  This is the lowering
        target of the dataset API and of the legacy ``run_job`` shim.
        ``device`` (default: the config's mode) lowers the partition /
        eligible-reduce steps onto the CUDA kernel layer — output
        bytes are identical to host execution.

        Multi-node sharded clients run the job on the cluster router
        (replica-local maps, ring-owned reduces, fabric-charged shuffle
        — byte-identical output to the single-node engine) unless the
        call overrides the store/intermediate/fault knobs or asks for
        device mode, which stay on node 0's single-stack engine."""
        self._check_open()
        use_cluster = (
            self.cluster is not None
            and len(self.cluster.nodes) > 1
            and store is None
            and intermediate is None
            and fail_map_attempts is None
            and not (self.config.device if device is None else device)
        )
        if use_cluster:
            net0 = self.cluster.fabric.total
            net_bytes0 = net0.bytes_written
            net_s0 = net0.modeled_seconds
            raw = self.cluster.run_mapreduce(job, input_path, output_path)
            handle = self._handle(raw, result=output_path)
            handle.report.extra.update(
                nodes=len(self.cluster.live_nodes()),
                net_bytes=net0.bytes_written - net_bytes0,
                net_seconds=net0.modeled_seconds - net_s0,
            )
            return handle
        raw = _mapreduce._run_job_impl(
            job,
            store if store is not None else self.store,
            input_path,
            output_path,
            intermediate if intermediate is not None else self.state,
            scheduler=self.scheduler,
            journal=self.journal,
            fail_map_attempts=fail_map_attempts,
            mode=mode,
            gateway=self.gateway,
            adaptive=adaptive,
            device=self._device_exec(device),
        )
        return self._handle(raw, result=output_path)

    def stages(
        self,
        name: str,
        stages: Sequence[Stage],
        state: Optional[Tier] = None,
        subscribers: Sequence[Callable] = (),
        external_tokens: Sequence[str] = (),
        device: Optional[bool] = None,
    ) -> JobHandle:
        """Execute a one-shot N-stage dataflow job (task-granular
        journaled resume when the client carries a journal).  ``device``
        binds a device-execution context around tasks that opted in with
        ``StageTask(device=True)``."""
        self._check_open()
        raw = _dataflow._run_stages_impl(
            name,
            stages,
            state if state is not None else self.state,
            scheduler=self.scheduler,
            journal=self.journal,
            gateway=self.gateway,
            subscribers=subscribers,
            external_tokens=external_tokens,
            device=self._device_exec(device),
        )
        return self._handle(raw)

    def iterate(
        self,
        name: str,
        *,
        init: Callable[[LoopContext], None],
        superstep: Callable[[LoopContext], Sequence[Stage]],
        until: Callable[[LoopContext], bool],
        state: Optional[Tier] = None,
        max_iterations: int = 50,
        pin_state: bool = True,
        halt_after: Optional[int] = None,
    ) -> JobHandle:
        """Drive a fixed-point loop to convergence (``until`` evaluated
        between supersteps) with loop state pinned hot in the client's
        tier stack and per-iteration journaled commit markers."""
        self._check_open()
        raw = _dataflow._run_loop_impl(
            name,
            init,
            superstep,
            until,
            state if state is not None else self.state,
            scheduler=self.scheduler,
            journal=self.journal,
            gateway=self.gateway,
            max_iterations=max_iterations,
            pin_state=pin_state,
            halt_after=halt_after,
        )
        return self._handle(raw)

    # -- paper-class workload conveniences ---------------------------------
    def pagerank(self, name: str, src: Any, dst: Any, n_nodes: int,
                 **kwargs: Any) -> JobHandle:
        """PageRank on the client's stack; ``handle.result`` is the
        :class:`~repro_torch.core.workloads.PageRankResult`."""
        self._check_open()
        from repro_torch.core import workloads

        res = workloads.pagerank_loop(
            name, self.state, src, dst, n_nodes,
            scheduler=self.scheduler, journal=self.journal, **kwargs,
        )
        handle = self._handle(res.report, result=res)
        handle.report.extra["output_bytes"] = len(res.rank_bytes)
        return handle

    def kmeans(self, name: str, points: Any, k: int,
               warm_session: bool = True, **kwargs: Any) -> JobHandle:
        """k-means on the client's stack.  ``warm_session=True`` keeps
        centroids hot in a pinned gateway session (warm invokers skip
        the tier reload); ``handle.result`` is the
        :class:`~repro_torch.core.workloads.KMeansResult`."""
        self._check_open()
        from repro_torch.core import workloads

        res = workloads.kmeans_loop(
            name, self.state, points, k,
            scheduler=self.scheduler, journal=self.journal,
            gateway=self.gateway if warm_session else None, **kwargs,
        )
        handle = self._handle(res.report, result=res)
        handle.report.extra["warm_read_frac"] = res.warm_read_frac
        return handle

    def terasort(self, name: str, input_parts: Sequence[bytes],
                 n_ranges: int = 4, device: Optional[bool] = None,
                 **kwargs: Any) -> JobHandle:
        """TeraSort (3-stage sample → range-partition → sort DAG);
        ``handle.result`` is the globally sorted record list.  With
        ``device`` the scatter stage buckets on the CUDA kernel."""
        self._check_open()
        from repro_torch.core import workloads

        raw = workloads.terasort(
            name, self.state, input_parts, n_ranges=n_ranges,
            scheduler=self.scheduler, journal=self.journal,
            device=self._device_exec(device), **kwargs,
        )
        out = workloads.terasort_output(self.state, name, n_ranges)
        return self._handle(raw, result=out)


# -- lazy fluent dataset plan --------------------------------------------------

@dataclass(frozen=True)
class Dataset:
    """A lazy plan over partitioned byte records.

    Each fluent call returns a new plan; nothing touches the cluster
    until ``run``/``collect``, which lowers the plan onto the MapReduce
    2-stage dataflow (``map`` → map stage, ``shuffle`` → the partitioned
    exchange, ``reduce`` → reduce stage) and executes it through the
    owning client.  Records are newline-separated within each part.
    """

    client: MarvelClient
    parts: Tuple[bytes, ...]
    name: str
    mapper: Optional[Callable[[bytes], Iterable[Tuple[Any, Any]]]] = None
    combiner: Optional[Callable[[Any, List[Any]], Iterable[Tuple[Any, Any]]]] = None
    reducer: Optional[Callable[[Any, List[Any]], Iterable[Tuple[Any, Any]]]] = None
    key_fn: Optional[Callable[[Any], Any]] = None
    partitions: int = 4
    #: declared reduce semantics (see MapReduceJob.reduce_kind) — lets
    #: device runs lower the reduce onto the device segment-sum.
    reduce_kind: Optional[str] = None

    def map(self, fn: Callable[[bytes], Iterable[Tuple[Any, Any]]]
            ) -> "Dataset":
        """``fn(record) -> iterable[(key, value)]`` — the map phase."""
        if self.mapper is not None:
            raise ConfigError(f"dataset {self.name!r} already has a mapper")
        return replace(self, mapper=fn)

    def combine(self, fn: Callable[[Any, List[Any]],
                                   Iterable[Tuple[Any, Any]]]) -> "Dataset":
        """Map-side combiner (cuts shuffle volume; must be associative)."""
        return replace(self, combiner=fn)

    def shuffle(self, by: Optional[Callable[[Any], Any]] = None,
                partitions: int = 4) -> "Dataset":
        """The partitioned exchange: pairs are re-keyed by ``by`` (default:
        keep the map key) and hash-partitioned into ``partitions``."""
        if partitions < 1:
            raise ConfigError("shuffle needs at least one partition")
        return replace(self, key_fn=by, partitions=partitions)

    def reduce(self, fn: Callable[[Any, List[Any]],
                                  Iterable[Tuple[Any, Any]]],
               kind: Optional[str] = None) -> "Dataset":
        """``fn(key, values) -> iterable[(key, value)]`` — the reduce
        phase over each shuffle group.  ``kind="sum"`` declares that
        ``fn`` yields exactly ``(k, sum(vs))`` (order-independent), which
        lets device runs use the device segment-sum and the spill path."""
        if self.reducer is not None:
            raise ConfigError(f"dataset {self.name!r} already has a reducer")
        if kind not in (None, "sum"):
            raise ConfigError(f"unknown reduce kind {kind!r}")
        return replace(self, reducer=fn, reduce_kind=kind)

    # -- lowering ----------------------------------------------------------
    def _lower(self) -> "_mapreduce.MapReduceJob":
        if self.mapper is None:
            raise ConfigError(
                f"dataset {self.name!r}: .map(fn) is required before run()"
            )
        if self.reducer is None:
            raise ConfigError(
                f"dataset {self.name!r}: .reduce(fn) is required before run()"
            )
        mapper = self.mapper
        if self.key_fn is not None:
            key_fn, inner = self.key_fn, self.mapper

            def mapper(record: bytes):
                for k, v in inner(record):
                    yield key_fn(k), v

        return _mapreduce.MapReduceJob(
            self.name, mapper, self.reducer, combiner=self.combiner,
            n_reducers=self.partitions, reduce_kind=self.reduce_kind,
        )

    def run(self, output_path: Optional[str] = None, mode: str = "wave",
            adaptive: bool = False,
            device: Optional[bool] = None) -> JobHandle:
        """Lower the plan and execute it; returns the unified handle."""
        self.client._check_open()
        job = self._lower()
        input_path = f"/api/{self.name}/in"
        output_path = output_path or f"/api/{self.name}/out"
        store = self.client.store
        joined = b"\n".join(self.parts)
        if store.exists(input_path):
            # A re-run of the *same* dataset reuses its input (and its
            # journal); a different dataset colliding on the name would
            # silently compute over the wrong data — refuse instead.
            if store.read(input_path) != joined:
                raise ConfigError(
                    f"dataset name {self.name!r} already holds different "
                    f"input data at {input_path}; pass a unique name"
                )
        else:
            store.write(input_path, joined, record_delim=b"\n")
        return self.client.mapreduce(
            job, input_path, output_path, mode=mode, adaptive=adaptive,
            device=device,
        )

    def collect(self, mode: str = "wave",
                device: Optional[bool] = None) -> List[bytes]:
        """Run and return the output records (``repr(k)\\trepr(v)`` lines)
        in deterministic partition-then-key order."""
        handle = self.run(mode=mode, device=device)
        out: List[bytes] = []
        store = self.client.store
        for p in range(self.partitions):
            path = f"{handle.result}/part_{p:04d}"
            if store.exists(path):
                out.extend(
                    line for line in store.read(path).split(b"\n") if line
                )
        return out


# -- legacy entry-point delegation ---------------------------------------------

def _deprecated(old: str, new: str) -> None:
    # stacklevel: 1=this line, 2=_legacy_run_*, 3=the shim in core/*,
    # 4=the user's call site — the frame the warning should name.
    warnings.warn(
        f"{old} is deprecated; use {new} (see DESIGN.md §9)",
        DeprecationWarning,
        stacklevel=4,
    )


def _legacy_run_job(
    job: "_mapreduce.MapReduceJob",
    store: BlockStore,
    input_path: str,
    output_path: str,
    intermediate: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional[StateCache] = None,
    fail_map_attempts: Optional[Dict[str, int]] = None,
    mode: str = "wave",
    gateway: Optional[Gateway] = None,
    adaptive: bool = False,
) -> "_mapreduce.JobReport":
    _deprecated("repro_torch.core.mapreduce.run_job",
                "repro_torch.api.MarvelClient.dataset(...).run() / .mapreduce(...)")
    client = MarvelClient.from_components(
        store=store, state=intermediate, scheduler=scheduler,
        journal=journal, gateway=gateway,
    )
    return client.mapreduce(
        job, input_path, output_path, mode=mode, adaptive=adaptive,
        fail_map_attempts=fail_map_attempts,
    ).raw


def _legacy_run_stages(
    name: str,
    stages: Sequence[Stage],
    state: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional[StateCache] = None,
    gateway: Optional[Gateway] = None,
    subscribers: Sequence[Callable] = (),
    external_tokens: Sequence[str] = (),
) -> "_dataflow.StageRunReport":
    _deprecated("repro_torch.core.dataflow.run_stages",
                "repro_torch.api.MarvelClient.stages(...)")
    client = MarvelClient.from_components(
        state=state, scheduler=scheduler, journal=journal, gateway=gateway,
    )
    return client.stages(
        name, stages, subscribers=subscribers,
        external_tokens=external_tokens,
    ).raw


def _legacy_run_loop(
    name: str,
    init: Callable[[LoopContext], None],
    superstep: Callable[[LoopContext], Sequence[Stage]],
    converged: Callable[[LoopContext], bool],
    state: Tier,
    scheduler: Optional[Scheduler] = None,
    journal: Optional[StateCache] = None,
    gateway: Optional[Gateway] = None,
    max_iterations: int = 50,
    pin_state: bool = True,
    halt_after: Optional[int] = None,
) -> "_dataflow.LoopReport":
    _deprecated("repro_torch.core.dataflow.run_loop",
                "repro_torch.api.MarvelClient.iterate(...)")
    client = MarvelClient.from_components(
        state=state, scheduler=scheduler, journal=journal, gateway=gateway,
    )
    return client.iterate(
        name, init=init, superstep=superstep, until=converged,
        max_iterations=max_iterations, pin_state=pin_state,
        halt_after=halt_after,
    ).raw
