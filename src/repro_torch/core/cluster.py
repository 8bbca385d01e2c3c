"""Multi-node cluster: sharded gateways + state over simulated nodes.

The paper's Marvel deployment is a *cluster* — OpenWhisk invokers spread
over machines with a PMEM-backed HDFS underneath (paper §3) — but until
this module everything ran as one process sharing one tier stack.  Here a
:class:`Node` owns a full single-machine Marvel: its own tier hierarchy,
its own :class:`~repro_torch.core.gateway.Gateway` invoker pool, its own
journal cache, and one :class:`~repro_torch.storage.blockstore.DataNode` of the
shared :class:`~repro_torch.storage.blockstore.BlockStore`.

A :class:`ClusterRouter` fronts the nodes:

* **Placement** is consistent hashing (:class:`HashRing`, Cloudburst's
  idiom): sessions and shuffle partitions hash onto a ring of virtual
  nodes, so ``add_node``/``remove_node`` re-home only the moved arc.
* **The network is modeled like a tier.**  :class:`NetworkFabric` charges
  every cross-node byte against a per-link latency/bandwidth model with
  the same :class:`~repro_torch.storage.tiers.TierStats` accounting as the
  storage tiers — ``JobReport`` can roll up network vs storage bytes.
  Links can be partitioned (:class:`LinkPartitionError`), extending the
  storage fault harness to the fabric.
* **Cross-node shuffle** reuses the single-node engine's partition
  function, pair encoding, and output format byte-for-byte: each map runs
  on a replica-local node, ships every partition blob to the partition's
  ring owner over the fabric, and each reduce concatenates blobs in
  map-index order — so cluster output is byte-identical to the
  single-node engine for *any* reducer, commutative or not.
* **Whole-node crash** kills the node's threads and volatile tiers but
  not its PMEM.  ``fail_node`` re-homes the dead node's sessions onto
  survivors by replaying its surviving durable journal (``state/...``
  blobs + ``fn/done/...`` markers) over the fabric, then restores block
  replication — sessions resume byte-identically on their new owner, the
  same contract the single-node crash matrix asserts.

Construction stays in :mod:`repro_torch.api` (``ClusterConfig(sharded=True,
nodes=N)``); this module only defines the machinery.
"""

from __future__ import annotations

import io
import threading
import time
from bisect import bisect_right
from collections import defaultdict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from dataclasses import dataclass
from hashlib import blake2b
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.gateway import Gateway, LoadSnapshot, Session
from repro_torch.core.journal import StateJournal
from repro_torch.core.mapreduce import (
    JobReport,
    MapReduceJob,
    _decode_pairs,
    _encode_pairs,
    _group,
    _partition,
)
from repro_torch.core.stateful import FunctionRuntime, StatefulFunction
from repro_torch.storage.blockstore import BlockMeta, BlockStore, DataNode
from repro_torch.storage.faults import LinkPartitionError
from repro_torch.storage.kvcache import StateCache
from repro_torch.storage.tiers import Tier, TierStats

__all__ = [
    "ClusterRouter",
    "HashRing",
    "LinkSpec",
    "NetworkFabric",
    "Node",
    "NodeDownError",
]


class NodeDownError(RuntimeError):
    """An operation was routed to (or executing on) a dead node."""


# -- the modeled network tier --------------------------------------------------


@dataclass(frozen=True)
class LinkSpec:
    """One point-to-point link's cost model (distinct from storage tiers).

    Defaults model a 10 GbE datacenter link; ``sleep=True`` makes
    transfers really take their modeled time (the scaling benchmark uses
    this so multi-node parallelism shows up in wall clock)."""

    latency: float = 50e-6  # per-transfer setup seconds
    bandwidth: float = 1.25 * 2**30  # bytes/second (~10 GbE)
    sleep: bool = False
    sleep_scale: float = 1.0


class NetworkFabric:
    """All-to-all modeled links between nodes, with per-link accounting.

    Same :class:`TierStats` schema as the storage tiers: a transfer is
    ``write_ops``/``bytes_written`` on the directed ``src->dst`` link and
    its modeled cost is ``latency*ops + nbytes/bandwidth``.  Local
    transfers (``src == dst``) are free — shipping a shuffle partition to
    its own node never charges the fabric, exactly like the single-node
    engine."""

    def __init__(self, spec: Optional[LinkSpec] = None) -> None:
        self.spec = spec or LinkSpec()
        self.total = TierStats()
        self._links: Dict[Tuple[str, str], TierStats] = defaultdict(TierStats)
        self._partitioned: Set[frozenset] = set()
        self._lock = threading.Lock()

    # -- partitions (the fault harness, extended to links) -----------------
    def partition(self, a: str, b: str) -> None:
        """Partition the (symmetric) link between two nodes."""
        with self._lock:
            self._partitioned.add(frozenset((a, b)))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None) -> None:
        """Heal one link, or every link when called with no arguments."""
        with self._lock:
            if a is None:
                self._partitioned.clear()
            else:
                self._partitioned.discard(frozenset((a, b)))

    def is_partitioned(self, a: str, b: str) -> bool:
        with self._lock:
            return frozenset((a, b)) in self._partitioned

    # -- transfers ---------------------------------------------------------
    def transfer(self, src: str, dst: str, nbytes: int, ops: int = 1) -> float:
        """Charge one cross-node transfer; returns the modeled seconds.

        Raises :class:`LinkPartitionError` while the link is partitioned
        (nothing is charged)."""
        if src == dst:
            return 0.0
        if self.is_partitioned(src, dst):
            raise LinkPartitionError(f"link {src}<->{dst} is partitioned")
        spec = self.spec
        modeled = spec.latency * ops + nbytes / spec.bandwidth
        with self._lock:
            for stats in (self._links[(src, dst)], self.total):
                stats.write_ops += ops
                stats.bytes_written += nbytes
                stats.modeled_seconds += modeled
        if spec.sleep and modeled > 0:
            time.sleep(modeled * spec.sleep_scale)
        return modeled

    def stats_by_link(self) -> Dict[str, TierStats]:
        """Per-directed-link counters, keyed ``"src->dst"``."""
        with self._lock:
            return {
                f"{a}->{b}": TierStats().merge(stats)
                for (a, b), stats in sorted(self._links.items())
            }


# -- consistent hashing --------------------------------------------------------

#: Sorts after every real node id at equal hash — makes ``bisect_right``
#: pick the first ring point strictly clockwise of a key's hash.
_MAX_NODE_ID = "\U0010ffff"


class HashRing:
    """Consistent-hash ring with virtual nodes (Cloudburst placement).

    Each node contributes ``vnodes`` points; a key belongs to the first
    point clockwise from its hash.  Adding or removing a node moves only
    the arcs adjacent to that node's points — every other key keeps its
    owner (asserted by the arc-stability property test)."""

    def __init__(self, node_ids: Sequence[str] = (), vnodes: int = 64) -> None:
        self.vnodes = vnodes
        self._points: List[Tuple[int, str]] = []  # sorted (hash, node_id)
        self._nodes: Set[str] = set()
        for nid in node_ids:
            self.add_node(nid)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(blake2b(key.encode(), digest_size=8).digest(), "big")

    @property
    def node_ids(self) -> List[str]:
        return sorted(self._nodes)

    def add_node(self, node_id: str) -> None:
        if node_id in self._nodes:
            return
        self._nodes.add(node_id)
        for v in range(self.vnodes):
            self._points.append((self._hash(f"{node_id}#{v}"), node_id))
        self._points.sort()

    def remove_node(self, node_id: str) -> None:
        self._nodes.discard(node_id)
        self._points = [(h, n) for h, n in self._points if n != node_id]

    def owner(self, key: str) -> str:
        if not self._points:
            raise RuntimeError("hash ring is empty (no live nodes)")
        h = self._hash(key)
        i = bisect_right(self._points, (h, _MAX_NODE_ID)) % len(self._points)
        return self._points[i][1]

    def owners(self, key: str, k: int) -> List[str]:
        """The first ``k`` distinct nodes clockwise from ``key`` (replica
        placement order)."""
        if not self._points:
            raise RuntimeError("hash ring is empty (no live nodes)")
        h = self._hash(key)
        start = bisect_right(self._points, (h, _MAX_NODE_ID))
        out: List[str] = []
        for j in range(len(self._points)):
            nid = self._points[(start + j) % len(self._points)][1]
            if nid not in out:
                out.append(nid)
                if len(out) == k:
                    break
        return out


# -- one simulated machine -----------------------------------------------------


class Node:
    """One cluster node: its own tier stack, invoker pool, and journal.

    ``durable`` is the node's PMEM tier — the piece that survives
    :meth:`crash` (DRAM, threads, and task pool all die) and that the
    router replays to re-home the node's sessions."""

    def __init__(
        self,
        node_id: str,
        state: Tier,
        runtime: FunctionRuntime,
        gateway: Gateway,
        datanode: DataNode,
        journal: Optional[StateCache] = None,
        durable: Optional[Tier] = None,
        workers: int = 4,
    ) -> None:
        self.node_id = node_id
        self.state = state
        self.runtime = runtime
        self.gateway = gateway
        self.datanode = datanode
        self.journal = journal
        self.durable = durable
        self.alive = True
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers),
            thread_name_prefix=f"{node_id}-task",
        )

    def submit(self, fn: Callable[[], Any]) -> Future:
        """Run a cluster task (map/reduce) on this node's worker pool."""
        if not self.alive:
            raise NodeDownError(self.node_id)
        try:
            return self._pool.submit(fn)
        except RuntimeError as exc:  # pool shut down by a concurrent crash
            raise NodeDownError(self.node_id) from exc

    def _close_state(self, flush: bool) -> None:
        close = getattr(self.state, "close", None)
        if callable(close):
            try:
                close(flush=flush)
            except TypeError:
                close()

    def crash(self) -> None:
        """Whole-node failure: threads and volatile tiers die, PMEM lives."""
        if not self.alive:
            return
        self.alive = False
        self._pool.shutdown(wait=False, cancel_futures=True)
        self.gateway.close(drain=False)
        self.runtime.crash()
        self.runtime.close()
        self._close_state(flush=False)

    def close(self, drain: bool = True) -> None:
        if not self.alive:
            return
        self.alive = False
        self._pool.shutdown(wait=True)
        self.gateway.close(drain=drain)
        self.runtime.close()
        self._close_state(flush=True)


def _modeled_seconds(tier: Tier) -> float:
    by_level = getattr(tier, "stats_by_level", None)
    if callable(by_level):
        return sum(s.modeled_seconds for s in by_level().values())
    stats = getattr(tier, "stats", None)
    return stats.modeled_seconds if stats is not None else 0.0


# -- the router ----------------------------------------------------------------


class ClusterRouter:
    """Routes sessions and dataset jobs to their ring-owning node."""

    def __init__(
        self,
        nodes: Sequence[Node],
        store: BlockStore,
        fabric: Optional[NetworkFabric] = None,
        vnodes: int = 64,
    ) -> None:
        if not nodes:
            raise ValueError("ClusterRouter needs at least one Node")
        self.nodes: Dict[str, Node] = {n.node_id: n for n in nodes}
        self.store = store
        self.fabric = fabric or NetworkFabric()
        self.ring = HashRing([n.node_id for n in nodes], vnodes=vnodes)
        self._functions: List[StatefulFunction] = []
        self._lock = threading.Lock()
        #: node ids that joined after sessions existed: their first touch
        #: of a moved-arc session triggers the lazy migration below.
        self._lazy_migrate: Set[str] = set()
        #: scoped session -> completion event of its (single) migration
        #: check — concurrent first touches wait instead of racing it.
        self._homed: Dict[str, threading.Event] = {}
        #: cumulative lazy-migration accounting (observability).
        self.migrations: Dict[str, int] = {"sessions": 0, "bytes": 0}

    # -- membership --------------------------------------------------------
    def live_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.alive]

    def add_node(self, node: Node) -> None:
        """Grow the cluster: the new node joins the ring (only its arcs
        re-home), the block store, and gets every registered function.

        Sessions on the moved arcs are **not** shipped eagerly — the ring
        flip makes the new node the only ingest point for them, and the
        first routed touch of each one migrates its committed state and
        journal markers from the previous owner (see
        :meth:`_migrate_session`).  Arc stability bounds the work to the
        new node's share of the key space."""
        with self._lock:
            self.nodes[node.node_id] = node
            self.ring.add_node(node.node_id)
            self.store.add_node(node.datanode)
            for fn in self._functions:
                node.runtime.register(fn)
            self._lazy_migrate.add(node.node_id)
            # ownership changed: every session's homing must be re-checked
            # on its next touch.
            self._homed.clear()

    def remove_node(self, node_id: str) -> Dict[str, Any]:
        """Graceful scale-in (the autoscaler's shrink actuator).

        Refuses (raises ``RuntimeError``) while the node owns in-flight
        or queued invocations — the caller quiesces first; the autoscaler
        only ever nominates idle nodes.  Otherwise: flip the ring (new
        traffic re-homes immediately), drain stragglers admitted in the
        window before the flip, push every committed session/journal key
        to its new ring owner over the fabric, close the node, and
        restore block replication (blocks need a surviving replica —
        ``replication >= 2`` — exactly like :meth:`fail_node`)."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            raise NodeDownError(node_id)
        if len(self.live_nodes()) <= 1:
            raise RuntimeError("cannot remove the last live node")
        snap = node.gateway.load_snapshot()
        if snap.inflight or snap.queue_depth:
            raise RuntimeError(
                f"node {node_id} owns in-flight work (inflight="
                f"{snap.inflight}, queued={snap.queue_depth}); "
                "quiesce before removing it"
            )
        with self._lock:
            self.ring.remove_node(node_id)
            self._lazy_migrate.discard(node_id)
            self._homed.clear()
        # Drain anything admitted between the snapshot and the ring flip,
        # then make every slot's latest state durable in the cache.
        node.gateway.quiesce(timeout=30.0)
        node.runtime.commit_all()
        sessions: Set[str] = set()
        net_bytes = 0
        keys = node.runtime.cache.keys("state/") + node.runtime.cache.keys(
            "fn/done/"
        )
        for key in sorted(keys):
            if key.startswith("state/"):
                scoped = key[len("state/") :].rsplit("/", 1)[0]
            else:
                scoped = key[len("fn/done/") :].rsplit("/", 1)[0]
            target = self.nodes[self.ring.owner(scoped)]
            blob = node.runtime.cache.get(key)
            self.fabric.transfer(node_id, target.node_id, len(blob))
            target.runtime.cache.put(key, blob)
            sessions.add(scoped)
            net_bytes += len(blob)
        node.close(drain=True)
        self.store.fail_node(node.datanode.node_id)
        reblocks = self.re_replicate()
        with self._lock:
            del self.nodes[node_id]
        return {
            "node": node_id,
            "sessions_moved": len(sessions),
            "net_bytes": net_bytes,
            "blocks_rereplicated": reblocks,
        }

    def load_snapshots(self) -> Dict[str, LoadSnapshot]:
        """Per-live-node gateway load observations (the autoscaler poll).
        Each snapshot is the cheap one-stripe-at-a-time read — safe on a
        tight control interval."""
        return {n.node_id: n.gateway.load_snapshot() for n in self.live_nodes()}

    # -- session routing ---------------------------------------------------
    def register(self, fn: StatefulFunction) -> StatefulFunction:
        """Register on every live node — a session may land anywhere."""
        with self._lock:
            self._functions.append(fn)
            for node in self.live_nodes():
                node.runtime.register(fn)
        return fn

    def owner_node(self, session: str = "default", app: str = "default") -> Node:
        scoped = Gateway.scoped_session(app, session)
        node = self.nodes[self.ring.owner(scoped)]
        if not node.alive:
            raise NodeDownError(node.node_id)
        if self._lazy_migrate and node.node_id in self._lazy_migrate:
            self._ensure_homed(scoped, node)
        return node

    def _ensure_homed(self, scoped: str, target: Node) -> None:
        """First-touch homing check for a session owned by a recently
        added node: exactly one caller runs the migration; concurrent
        touches of the same session wait for it instead of racing."""
        with self._lock:
            ev = self._homed.get(scoped)
            if ev is not None:
                owner = False
            else:
                ev = self._homed[scoped] = threading.Event()
                owner = True
        if not owner:
            ev.wait(timeout=30.0)
            return
        try:
            self._migrate_session(scoped, target)
        finally:
            ev.set()

    def _migrate_session(self, scoped: str, target: Node) -> None:
        """Move one session's committed state + journal markers onto its
        new ring owner (the add-node analog of the crash-path
        :meth:`_rehome_from_durable`, but from a *live* previous owner).

        The previous owner's hot slots for the session are committed
        first (under the runtime slot lock, so an in-flight invocation
        that slipped in before the ring flip serializes ahead of the
        move), then the ``state/`` and ``fn/done/`` keys ship over the
        fabric and are deleted at the source — a later crash of the old
        owner cannot resurrect a stale copy."""
        prefixes = (f"state/{scoped}/", f"fn/done/{scoped}/")
        if any(target.runtime.cache.keys(p) for p in prefixes):
            return  # the target already holds this session
        for src in self.live_nodes():
            if src.node_id == target.node_id:
                continue
            for fn_name, sess in list(src.runtime.hot_state):
                if sess == scoped:
                    src.runtime.evict(fn_name, scoped, commit=True)
            keys = [k for p in prefixes for k in src.runtime.cache.keys(p)]
            if not keys:
                continue
            moved = 0
            for key in sorted(keys):
                blob = src.runtime.cache.get(key)
                self.fabric.transfer(src.node_id, target.node_id, len(blob))
                target.runtime.cache.put(key, blob)
                src.runtime.cache.delete(key)
                moved += len(blob)
            with self._lock:
                self.migrations["sessions"] += 1
                self.migrations["bytes"] += moved
            return

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
        return self.owner_node(session, app).gateway.submit(
            fn_name,
            app=app,
            session=session,
            init_kwargs=init_kwargs,
            block=block,
            timeout=timeout,
            **inputs,
        )

    def invoke(
        self,
        fn_name: str,
        app: str = "default",
        session: str = "default",
        **inputs: Any,
    ) -> Any:
        return self.owner_node(session, app).gateway.invoke(
            fn_name, app=app, session=session, **inputs
        )

    def session(self, session_id: str = "default", app: str = "default") -> Session:
        """A session whose invokes re-resolve the owner on every call, so
        it keeps working across node loss and re-homing."""
        sess = self.owner_node(session_id, app).runtime.session(
            Gateway.scoped_session(app, session_id)
        )

        def route(fn_name: str, **inputs: Any) -> Any:
            return self.invoke(fn_name, app=app, session=session_id, **inputs)

        sess._route = route
        return sess

    # -- node loss + re-homing ---------------------------------------------
    def _node_of_datanode(self, datanode_id: str) -> str:
        for nid, node in self.nodes.items():
            if node.datanode.node_id == datanode_id:
                return nid
        return datanode_id

    def re_replicate(self) -> int:
        """Restore block replication, charging copies to the fabric.

        Partitioned links make their candidate unreachable — the block
        stays under-replicated until the link heals (asserted by the
        partition-tolerance cell of the crash matrix)."""

        def on_copy(src_dn: str, dst_dn: str, nbytes: int) -> None:
            self.fabric.transfer(
                self._node_of_datanode(src_dn),
                self._node_of_datanode(dst_dn),
                nbytes,
            )

        return self.store.re_replicate(on_copy=on_copy)

    def fail_node(self, node_id: str) -> Dict[str, Any]:
        """Whole-node crash: kill it, shrink the ring, replay its PMEM
        journal onto the survivors, and restore block replication.

        Returns a re-homing summary (sessions moved, bytes shipped,
        blocks re-replicated)."""
        node = self.nodes[node_id]
        summary: Dict[str, Any] = {
            "node": node_id,
            "sessions_rehomed": 0,
            "state_keys": 0,
            "journal_keys": 0,
            "net_bytes": 0,
            "blocks_rereplicated": 0,
        }
        if not node.alive:
            return summary
        node.crash()
        with self._lock:
            self.ring.remove_node(node_id)
            self._lazy_migrate.discard(node_id)
            self._homed.clear()
        self.store.fail_node(node.datanode.node_id)
        if not self.live_nodes():
            raise RuntimeError("cluster lost its last node")
        if node.durable is not None:
            summary.update(self._rehome_from_durable(node))
        summary["blocks_rereplicated"] = self.re_replicate()
        return summary

    def _rehome_from_durable(self, dead: Node) -> Dict[str, Any]:
        """Replay the crashed node's surviving PMEM onto the new owners.

        Two key families move: ``state/<session>/<fn>`` committed state
        blobs and ``fn/done/<session>/<fn>`` journal markers.  Both land
        in the new owner's runtime cache (memory + its own PMEM), so the
        next invocation on the survivor resumes the session's sequence
        from the journal scan with byte-identical state."""
        sessions: Set[str] = set()
        state_keys = journal_keys = net_bytes = 0
        for key in sorted(dead.durable.keys()):
            if key.startswith("state/"):
                scoped = key[len("state/") :].rsplit("/", 1)[0]
                state_keys += 1
            elif key.startswith("fn/done/"):
                scoped = key[len("fn/done/") :].rsplit("/", 1)[0]
                journal_keys += 1
            else:
                continue  # job journals re-plan from shuffle-blob presence
            target = self.nodes[self.ring.owner(scoped)]
            blob = dead.durable.get(key)
            self.fabric.transfer(dead.node_id, target.node_id, len(blob))
            target.runtime.cache.put(key, blob)
            sessions.add(scoped)
            net_bytes += len(blob)
        return {
            "sessions_rehomed": len(sessions),
            "state_keys": state_keys,
            "journal_keys": journal_keys,
            "net_bytes": net_bytes,
        }

    # -- cluster MapReduce -------------------------------------------------
    def run_mapreduce(
        self,
        job: MapReduceJob,
        input_path: str,
        output_path: str,
        on_map_done: Optional[Callable[[int], None]] = None,
    ) -> JobReport:
        """Run a job with replica-local maps and ring-owned reduces.

        Byte-identity contract: partitions use the engine's
        ``_partition``/``_encode_pairs``, each reduce concatenates its
        partition blobs in map-index order, and output lines are the
        engine's sorted ``repr(k)\\trepr(v)`` format — so the output file
        bytes equal a single-node run of the same job on the same input.

        ``on_map_done(completed_count)`` fires after each map completes
        and may call :meth:`fail_node` — the router re-plans: maps whose
        partition blobs died with their owner re-run, reduces re-home to
        the shrunken ring (the kill-one-node-mid-job row of fig11)."""
        t0 = time.perf_counter()
        jprefix = f"mr/{job.name}"
        blocks = self.store.locate(input_path)
        n_maps = len(blocks)
        map_ids = [f"map_{i:05d}" for i in range(n_maps)]
        n_red = job.n_reducers
        modeled0 = {nid: _modeled_seconds(n.state) for nid, n in self.nodes.items()}

        def pkey(tid: str, p: int) -> str:
            return f"{jprefix}/{tid}/part_{p:04d}"

        def part_owner(p: int) -> Node:
            return self.nodes[self.ring.owner(f"{jprefix}/part_{p:04d}")]

        # Completed maps and their per-partition blob sizes.  An entry is
        # only valid while every listed blob is present on the partition's
        # *current* ring owner — node loss invalidates entries, which is
        # exactly the re-plan trigger.
        done: Dict[str, Dict[int, int]] = {}
        exclusions: Dict[str, Set[str]] = defaultdict(set)

        def blobs_present(tid: str, sizes: Dict[int, int]) -> bool:
            return all(
                part_owner(p).alive and part_owner(p).state.contains(pkey(tid, p))
                for p in sizes
            )

        # Cross-run resume: a map journaled on any surviving node whose
        # blobs still sit on the current owners does not re-run.
        for node in self.live_nodes():
            if node.journal is None:
                continue
            for tid, meta in StateJournal(node.journal, jprefix).entries().items():
                if tid not in map_ids or tid in done:
                    continue
                sizes = {int(p): int(s) for p, s in (meta.get("sizes") or {}).items()}
                if blobs_present(tid, sizes):
                    done[tid] = sizes
        resumed = len(done)
        completed = len(done)

        def pick_map_node(block: BlockMeta, excluded: Set[str]) -> Node:
            for dn in block.replicas:
                nid = self._node_of_datanode(dn)
                node = self.nodes.get(nid)
                if node is not None and node.alive and nid not in excluded:
                    return node
            live = [n for n in self.live_nodes() if n.node_id not in excluded]
            if not live:
                live = self.live_nodes()
            if not live:
                raise RuntimeError("no live nodes to run maps")
            return live[HashRing._hash(block.block_id) % len(live)]

        def map_runner(i: int, node: Node) -> Callable[[], Dict[int, int]]:
            tid = map_ids[i]
            block = blocks[i]

            def run() -> Dict[int, int]:
                if not node.alive:
                    raise NodeDownError(node.node_id)
                data = self.store.read_block(block, prefer_node=node.datanode.node_id)
                pairs = []
                for record in data.split(b"\n"):
                    if record:
                        pairs.extend(job.mapper(record))
                if job.combiner is not None:
                    pairs = [
                        kv
                        for k, vs in _group(pairs).items()
                        for kv in job.combiner(k, vs)
                    ]
                parts: Dict[int, list] = defaultdict(list)
                for k, v in pairs:
                    parts[_partition(k, n_red)].append((k, v))
                sizes: Dict[int, int] = {}
                by_owner: Dict[str, Dict[str, bytes]] = defaultdict(dict)
                for p, ppairs in sorted(parts.items()):
                    blob = _encode_pairs(ppairs)
                    sizes[p] = len(blob)
                    by_owner[part_owner(p).node_id][pkey(tid, p)] = blob
                for owner_id in sorted(by_owner):
                    owner = self.nodes[owner_id]
                    if not owner.alive:
                        raise NodeDownError(owner_id)
                    blobs = by_owner[owner_id]
                    # One modeled request per destination node for the
                    # whole task, mirroring the engine's batched put_many.
                    self.fabric.transfer(
                        node.node_id,
                        owner_id,
                        sum(len(b) for b in blobs.values()),
                    )
                    owner.state.put_many(blobs)
                if node.journal is not None:
                    StateJournal(node.journal, jprefix).commit_many_ordered(
                        {
                            **{
                                f"{tid}.part_{p:04d}": {"size": sizes[p]}
                                for p in sorted(sizes)
                            },
                            tid: {"sizes": sizes},
                        },
                        marker=tid,
                    )
                return sizes

            return run

        def run_maps() -> None:
            nonlocal completed
            rounds = 0
            while len(done) < n_maps:
                rounds += 1
                if rounds > 2 * max(2, len(self.nodes)):
                    raise RuntimeError(
                        f"cluster job {job.name}: maps did not converge"
                    )
                futs = []
                for i, tid in enumerate(map_ids):
                    if tid in done:
                        continue
                    try:
                        node = pick_map_node(blocks[i], exclusions[tid])
                        futs.append((tid, node, node.submit(map_runner(i, node))))
                    except NodeDownError:
                        continue
                for tid, node, fut in futs:
                    try:
                        sizes = fut.result()
                    except LinkPartitionError:
                        # Re-route this map around the partitioned link.
                        exclusions[tid].add(node.node_id)
                    except (NodeDownError, CancelledError):
                        continue  # node died mid-round; re-plan next round
                    else:
                        done[tid] = sizes
                        completed += 1
                        if on_map_done is not None:
                            on_map_done(completed)
                # Node loss during the round invalidates blobs that lived
                # on the dead owner: those maps go back in the plan.
                for tid in [t for t, s in done.items() if not blobs_present(t, s)]:
                    del done[tid]

        def reduce_runner(p: int, owner: Node) -> Callable[[], int]:
            def run() -> int:
                if not owner.alive:
                    raise NodeDownError(owner.node_id)
                pairs = []
                for tid in map_ids:  # map-index order: byte-identity
                    key = pkey(tid, p)
                    if owner.state.contains(key):
                        pairs.extend(_decode_pairs(owner.state.get(key)))
                groups = _group(pairs)
                out = io.BytesIO()
                for k in sorted(groups.keys(), key=repr):
                    for ok, ov in job.reducer(k, groups[k]):
                        out.write(repr(ok).encode() + b"\t" + repr(ov).encode() + b"\n")
                blob = out.getvalue()
                self.store.write(f"{output_path}/part_{p:04d}", blob)
                if owner.journal is not None:
                    StateJournal(owner.journal, jprefix).commit(
                        f"reduce_{p:04d}", {"bytes": len(blob)}
                    )
                return len(blob)

            return run

        reduce_done: Dict[int, int] = {}
        for attempt in range(2 * max(2, len(self.nodes))):
            run_maps()
            futs = []
            for p in range(n_red):
                if p in reduce_done:
                    continue
                try:
                    owner = part_owner(p)
                    futs.append((p, owner.submit(reduce_runner(p, owner))))
                except NodeDownError:
                    continue
            for p, fut in futs:
                try:
                    reduce_done[p] = fut.result()
                except (NodeDownError, CancelledError):
                    continue
            if len(reduce_done) == n_red:
                break
            # A reduce owner died: its partition blobs are gone, so some
            # maps are invalid again — loop back through the map plan.
            for tid in [t for t, s in done.items() if not blobs_present(t, s)]:
                del done[tid]
        else:
            raise RuntimeError(f"cluster job {job.name}: reduces did not converge")

        modeled = sum(
            _modeled_seconds(n.state) - modeled0.get(nid, 0.0)
            for nid, n in self.nodes.items()
            if n.alive
        )
        return JobReport(
            job=job.name,
            input_bytes=sum(b.length for b in blocks),
            intermediate_bytes=sum(sum(s.values()) for s in done.values()),
            output_bytes=sum(reduce_done.values()),
            map_tasks=n_maps,
            reduce_tasks=n_red,
            wall_seconds=time.perf_counter() - t0,
            modeled_io_seconds=modeled,
            resumed_tasks=resumed,
            mode="cluster",
        )

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        for node in self.nodes.values():
            node.close(drain=drain)
