"""Storage tiers for Marvel.

The paper's central design object is a *tiered storage hierarchy*:

    Ignite (DRAM)  >  PMEM (AppDirect, DAX ext4)  >  local SSD  >  S3

Marvel keeps intermediate (shuffle) state in the top tier and durable
input/output in the PMEM tier, and shows that the S3-mediated baseline is
both slow and quota-limited (Lambda fails at 15 GB input).

On a GPU host there is no Optane DIMM; the tier *interface* is what the
system consumes.  We provide:

  * ``DramTier``     — plain in-process store (Ignite/IGFS analog).
  * ``PmemTier``     — mmap-backed, byte-addressable, persistent store
                       (AppDirect analog; on a real host this sits on a
                       DAX mount or NVMe — see DESIGN.md §2).
  * ``SimulatedTier``— wraps another tier and *models* the device's
                       bandwidth/latency/quotas (paper Table 2 for SSD,
                       AWS-documented limits for S3).  Used so the paper's
                       comparisons (Fig. 1/4/5) are reproducible on any box.

Every tier implements the same ``Tier`` protocol: byte-blob get/put/delete
plus accounting.  All sizes in bytes, all times in seconds.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

__all__ = [
    "TierStats",
    "Tier",
    "DramTier",
    "PmemTier",
    "SimulatedTier",
    "DeviceSpec",
    "PMEM_SPEC",
    "SSD_SPEC",
    "S3_SPEC",
    "QuotaExceededError",
    "tier_accounting",
    "tier_accounting_capture",
]


class QuotaExceededError(RuntimeError):
    """Raised by a simulated tier when a provider quota trips.

    Models the paper's observation that Corral-on-Lambda *fails* past 15 GB
    of input due to S3/Lambda rate limits (paper §1, §4.2 obs. (1)).
    Marked non-retryable: the scheduler fails the job immediately instead
    of burning attempts (quotas don't clear on retry).
    """

    non_retryable = True


@dataclass
class TierStats:
    """I/O accounting for one tier (drives the paper-figure benchmarks)."""

    bytes_read: int = 0
    bytes_written: int = 0
    read_ops: int = 0
    write_ops: int = 0
    #: Modeled (simulated) seconds spent in device time; real tiers leave 0.
    modeled_seconds: float = 0.0
    #: Wall-clock seconds actually spent inside tier calls.
    wall_seconds: float = 0.0

    def merge(self, other: "TierStats") -> "TierStats":
        return TierStats(
            self.bytes_read + other.bytes_read,
            self.bytes_written + other.bytes_written,
            self.read_ops + other.read_ops,
            self.write_ops + other.write_ops,
            self.modeled_seconds + other.modeled_seconds,
            self.wall_seconds + other.wall_seconds,
        )

    def merge_into(self, other: "TierStats") -> None:
        """In-place accumulate ``other`` (the hierarchy per-level rollup
        and the capture-and-forward accounting scope use this)."""
        self.bytes_read += other.bytes_read
        self.bytes_written += other.bytes_written
        self.read_ops += other.read_ops
        self.write_ops += other.write_ops
        self.modeled_seconds += other.modeled_seconds
        self.wall_seconds += other.wall_seconds


#: Thread-local accounting scope.  Tier stats are global per tier; a
#: multi-tenant caller (one gateway invoker among many) additionally wants
#: *its* share of the I/O.  ``tier_accounting(stats)`` routes every tier op
#: performed by the current thread into ``stats`` as well — per-scope
#: attribution without touching every call site.
_ACCOUNTING = threading.local()


@contextlib.contextmanager
def tier_accounting(stats: TierStats):
    """Also charge every tier op on this thread to ``stats`` (nestable —
    the enclosing scope is restored on exit).  The scoped stats are only
    touched by the owning thread, so no lock is needed on them."""
    prev = getattr(_ACCOUNTING, "stats", None)
    _ACCOUNTING.stats = stats
    try:
        yield stats
    finally:
        _ACCOUNTING.stats = prev


def _scoped_stats() -> Optional[TierStats]:
    return getattr(_ACCOUNTING, "stats", None)


@contextlib.contextmanager
def tier_accounting_capture():
    """Capture this thread's physical tier charges into a fresh
    :class:`TierStats` while still forwarding them to any enclosing
    ``tier_accounting`` scope on exit.

    The :class:`~repro_torch.storage.hierarchy.TieredStore` uses this to learn
    how much modeled device time an op paid *inline* (its logical
    accounting) without hiding the physical ops from a gateway invoker's
    per-worker attribution — each op lands in the enclosing scope exactly
    once, so promoted reads are never double-counted there.
    """
    prev = getattr(_ACCOUNTING, "stats", None)
    captured = TierStats()
    _ACCOUNTING.stats = captured
    try:
        yield captured
    finally:
        _ACCOUNTING.stats = prev
        if prev is not None:
            prev.merge_into(captured)


class WatchRegistry:
    """Prefix-subscription registry: thread-safe, fire-after-commit.

    Shared by every tier and the :class:`~repro_torch.storage.kvcache.StateCache`
    so watch semantics (handle lifecycle, snapshot-under-lock, fire
    outside it) live in exactly one place.
    """

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._watchers: Dict[int, Tuple[str, Callable[[str], None]]] = {}
        self._seq = 0

    def watch(self, prefix: str, callback: Callable[[str], None]) -> Callable[[], None]:
        with self._lock:
            handle = self._seq
            self._seq += 1
            self._watchers[handle] = (prefix, callback)

        def unsubscribe() -> None:
            with self._lock:
                self._watchers.pop(handle, None)

        return unsubscribe

    def notify(self, key: str) -> None:
        if not self._watchers:
            return
        with self._lock:
            callbacks = [
                cb for prefix, cb in self._watchers.values()
                if key.startswith(prefix)
            ]
        for cb in callbacks:
            cb(key)


class Tier:
    """Byte-blob storage tier protocol."""

    name: str = "tier"
    #: Whether contents survive process restart (PMEM yes, DRAM no).
    persistent: bool = False

    def __init__(self) -> None:
        self.stats = TierStats()
        self._lock = threading.Lock()
        self._watch = WatchRegistry(self._lock)

    # -- protocol ---------------------------------------------------------
    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def put_many(self, items: Mapping[str, bytes]) -> None:
        """Batched put.  The base implementation just loops; tiers with a
        per-op cost model override this to charge one request latency for
        the whole batch (the streaming-shuffle fast path)."""
        for key, value in items.items():
            self.put(key, value)

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def contains(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> Iterator[str]:
        """Enumerate keys, optionally restricted to ``prefix``.

        Tiers push the filter down to their native index (dict scan,
        directory subtree) so a namespaced listing never enumerates —
        or accounts against — unrelated keys; the KV pager's per-session
        block listing made this a hot path."""
        raise NotImplementedError

    def size_of(self, key: str) -> int:
        return len(self.get(key))

    def clear(self) -> None:
        for k in list(self.keys()):
            self.delete(k)

    # -- events ----------------------------------------------------------
    def watch(self, prefix: str, callback: Callable[[str], None]) -> Callable[[], None]:
        """Invoke ``callback(key)`` after every committed put under
        ``prefix``.  Returns an unsubscribe callable.

        This is the hook that turns the state tier into an event bus: the
        DAG scheduler subscribes, so a shuffle partition landing in the
        tier immediately becomes a dataflow token for streaming consumers
        (no polling, no ``keys()`` rescans).
        Callbacks run on the writer's thread and must be cheap/non-blocking.
        """
        return self._watch.watch(prefix, callback)

    def _notify(self, key: str) -> None:
        """Fire watch callbacks for ``key`` (call *after* the value is
        readable, outside the tier lock)."""
        self._watch.notify(key)

    # -- accounting helpers -------------------------------------------------
    def _account_read(self, nbytes: int, wall: float, modeled: float = 0.0) -> None:
        with self._lock:
            self.stats.bytes_read += nbytes
            self.stats.read_ops += 1
            self.stats.wall_seconds += wall
            self.stats.modeled_seconds += modeled
        scoped = _scoped_stats()
        if scoped is not None:
            scoped.bytes_read += nbytes
            scoped.read_ops += 1
            scoped.wall_seconds += wall
            scoped.modeled_seconds += modeled

    def _account_write(self, nbytes: int, wall: float, modeled: float = 0.0) -> None:
        with self._lock:
            self.stats.bytes_written += nbytes
            self.stats.write_ops += 1
            self.stats.wall_seconds += wall
            self.stats.modeled_seconds += modeled
        scoped = _scoped_stats()
        if scoped is not None:
            scoped.bytes_written += nbytes
            scoped.write_ops += 1
            scoped.wall_seconds += wall
            scoped.modeled_seconds += modeled


class DramTier(Tier):
    """In-process DRAM store — the Ignite/IGFS analog.

    Fast path for intermediate (shuffle) data and function state; volatile.
    """

    name = "dram"
    persistent = False

    def __init__(self, capacity_bytes: Optional[int] = None) -> None:
        super().__init__()
        self._data: Dict[str, bytes] = {}
        self._capacity = capacity_bytes
        self._used = 0

    def put(self, key: str, value: bytes) -> None:
        t0 = time.perf_counter()
        with self._lock:
            old = self._data.get(key)
            new_used = self._used - (len(old) if old else 0) + len(value)
            if self._capacity is not None and new_used > self._capacity:
                raise MemoryError(
                    f"DramTier capacity {self._capacity} exceeded ({new_used} needed)"
                )
            self._data[key] = value
            self._used = new_used
        self._account_write(len(value), time.perf_counter() - t0)
        self._notify(key)

    def put_many(self, items: Mapping[str, bytes]) -> None:
        t0 = time.perf_counter()
        with self._lock:
            # Validate the whole batch before mutating: a capacity failure
            # must not leave unnotified, unaccounted orphan blobs behind.
            new_used = self._used
            for key, value in items.items():
                old = self._data.get(key)
                new_used += len(value) - (len(old) if old else 0)
            if self._capacity is not None and new_used > self._capacity:
                raise MemoryError(
                    f"DramTier capacity {self._capacity} exceeded "
                    f"({new_used} needed)"
                )
            self._data.update(items)
            self._used = new_used
        wall = time.perf_counter() - t0
        for key, value in items.items():
            self._account_write(len(value), wall / max(1, len(items)))
            self._notify(key)

    def get(self, key: str) -> bytes:
        t0 = time.perf_counter()
        value = self._data[key]
        self._account_read(len(value), time.perf_counter() - t0)
        return value

    def delete(self, key: str) -> None:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._used -= len(old)

    def contains(self, key: str) -> bool:
        return key in self._data

    def keys(self, prefix: str = "") -> Iterator[str]:
        if not prefix:
            return iter(list(self._data.keys()))
        return iter([k for k in self._data if k.startswith(prefix)])

    def size_of(self, key: str) -> int:
        return len(self._data[key])

    @property
    def used_bytes(self) -> int:
        return self._used


class PmemTier(Tier):
    """mmap-backed persistent tier — the PMEM AppDirect / DAX-ext4 analog.

    Each blob is one file under ``root``; reads/writes go through ``mmap``
    so access is byte-addressable like a DAX mapping.  Contents survive
    process restart — this is the substrate for the checkpoint/restart
    fault-tolerance story (paper §4.3, implemented here).
    """

    name = "pmem"
    persistent = True

    def __init__(self, root: str) -> None:
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        # Keys may contain '/', which maps to subdirectories.
        safe = key.replace("..", "_")
        return os.path.join(self.root, safe)

    def put(self, key: str, value: bytes) -> None:
        t0 = time.perf_counter()
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w+b") as f:
            if value:
                f.truncate(len(value))
                with mmap.mmap(f.fileno(), len(value)) as m:
                    m[:] = value
                    m.flush()  # persistence point (clwb/sfence analog)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publish
        self._account_write(len(value), time.perf_counter() - t0)
        self._notify(key)

    def get(self, key: str) -> bytes:
        t0 = time.perf_counter()
        path = self._path(key)
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                value = b""
            else:
                with mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ) as m:
                    value = bytes(m)
        self._account_read(len(value), time.perf_counter() - t0)
        return value

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.remove(path)

    def contains(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def keys(self, prefix: str = "") -> Iterator[str]:
        # Keys map to paths, so a '/'-delimited prefix names a directory
        # subtree: walk only that subtree instead of the whole root.
        start = self.root
        if prefix:
            dir_part = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
            start = os.path.join(self.root, dir_part.replace("..", "_"))
            if not os.path.isdir(start):
                return iter([])
        out = []
        for dirpath, _dirnames, filenames in os.walk(start):
            for fn in filenames:
                if fn.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, self.root)
                if prefix and not rel.startswith(prefix):
                    continue
                out.append(rel)
        return iter(out)

    def size_of(self, key: str) -> int:
        return os.path.getsize(self._path(key))


@dataclass(frozen=True)
class DeviceSpec:
    """Bandwidth/latency/quota model of a storage device or service.

    Constants for PMEM/SSD come from paper Table 2 (fio, 4 KiB blocks);
    S3 constants follow the AWS-documented request-rate and Lambda quotas
    the paper cites for the 15 GB failure.
    """

    name: str
    read_bw: float  # bytes/s sustained
    write_bw: float  # bytes/s sustained
    read_latency: float  # seconds per op
    write_latency: float  # seconds per op
    #: max bytes a single job may move through this device (None = unlimited).
    transfer_quota: Optional[int] = None
    #: max concurrent requests before throttling errors (None = unlimited).
    request_quota: Optional[int] = None


# Paper Table 2 (seq read/write rows; GiB/s → bytes/s).
PMEM_SPEC = DeviceSpec(
    name="pmem",
    read_bw=41.0 * 2**30,
    write_bw=13.6 * 2**30,
    read_latency=0.6e-6,
    write_latency=1.9e-6,
)
SSD_SPEC = DeviceSpec(
    name="ssd",
    read_bw=0.4 * 2**30,
    write_bw=0.5 * 2**30,
    read_latency=4.7e-3,
    write_latency=5.0e-3,
)
# S3 through Lambda: ~90 MB/s effective per function stream, ~20 ms first
# byte; 15 GB aggregate transfer quota (the paper-observed failure point),
# 3500 PUT / 5500 GET per prefix-second modeled via request_quota.
S3_SPEC = DeviceSpec(
    name="s3",
    read_bw=90e6,
    write_bw=90e6,
    read_latency=20e-3,
    write_latency=30e-3,
    transfer_quota=15 * 10**9,
    request_quota=5500,
)


class SimulatedTier(Tier):
    """Wraps a backing tier with a :class:`DeviceSpec` cost/quota model.

    The blob actually lives in the backing store (so correctness is real);
    the *time* each op would take on the modeled device is accumulated in
    ``stats.modeled_seconds``.  ``sleep=True`` additionally sleeps a scaled
    fraction of the modeled time so end-to-end wall-clock comparisons (the
    paper's Fig. 4/5) show the same ordering without taking hours.
    """

    def __init__(
        self,
        spec: DeviceSpec,
        backing: Optional[Tier] = None,
        sleep: bool = False,
        sleep_scale: float = 1e-3,
    ) -> None:
        super().__init__()
        self.spec = spec
        self.name = f"sim:{spec.name}"
        self.persistent = backing.persistent if backing else False
        self._backing = backing if backing is not None else DramTier()
        self._sleep = sleep
        self._sleep_scale = sleep_scale
        self._transferred = 0

    # -- cost model -------------------------------------------------------
    def _charge(self, nbytes: int, write: bool, ops: int = 1) -> float:
        """Model ``ops`` request latencies + ``nbytes`` of transfer.

        A batched put (``put_many``) charges a single request latency for
        the whole batch — bandwidth is paid in full either way.
        """
        spec = self.spec
        if spec.transfer_quota is not None:
            with self._lock:
                self._transferred += nbytes
                if self._transferred > spec.transfer_quota:
                    raise QuotaExceededError(
                        f"{spec.name}: transfer quota {spec.transfer_quota} B "
                        f"exceeded ({self._transferred} B moved) — this is the "
                        f"paper's 15 GB Lambda/S3 failure mode"
                    )
        bw = spec.write_bw if write else spec.read_bw
        lat = spec.write_latency if write else spec.read_latency
        modeled = lat * ops + nbytes / bw
        if self._sleep:
            time.sleep(modeled * self._sleep_scale)
        return modeled

    # -- protocol ---------------------------------------------------------
    def put(self, key: str, value: bytes) -> None:
        t0 = time.perf_counter()
        modeled = self._charge(len(value), write=True)
        self._backing.put(key, value)
        self._account_write(len(value), time.perf_counter() - t0, modeled)
        self._notify(key)

    def put_many(self, items: Mapping[str, bytes]) -> None:
        """One modeled request for the whole batch (scatter/multi-part
        write) — the streaming shuffle's escape from per-blob latency."""
        if not items:
            return  # no request, no charge
        t0 = time.perf_counter()
        total = sum(len(v) for v in items.values())
        modeled = self._charge(total, write=True, ops=1)
        self._backing.put_many(items)
        wall = time.perf_counter() - t0
        n = max(1, len(items))
        for key, value in items.items():
            self._account_write(len(value), wall / n, modeled / n)
            self._notify(key)

    def get(self, key: str) -> bytes:
        t0 = time.perf_counter()
        value = self._backing.get(key)
        modeled = self._charge(len(value), write=False)
        self._account_read(len(value), time.perf_counter() - t0, modeled)
        return value

    def delete(self, key: str) -> None:
        self._backing.delete(key)

    def contains(self, key: str) -> bool:
        return self._backing.contains(key)

    def keys(self, prefix: str = "") -> Iterator[str]:
        return self._backing.keys(prefix)

    def size_of(self, key: str) -> int:
        return self._backing.size_of(key)

    def reset_quota(self) -> None:
        with self._lock:
            self._transferred = 0
