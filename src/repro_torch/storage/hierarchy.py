"""Adaptive multi-tier cache hierarchy — policy-driven data placement.

The paper's tiers (Ignite/DRAM > PMEM > SSD > S3) were, until this module,
*statically* assigned: every caller picked one :class:`~repro_torch.storage.
tiers.Tier` up front and data never moved.  :class:`TieredStore` presents
the single ``Tier`` protocol over an **ordered stack** of tiers and moves
data between them according to a :class:`PlacementPolicy`:

  * **read-through promotion** — a key served from a lower level has its
    hit count bumped; once it clears the size/frequency admission bar it
    is copied into the fastest level (the Cloudburst "autoscaling cache
    colocated with functions" win, PAPERS.md);
  * **capacity-triggered demotion** — each level carries a byte budget;
    overflow picks LRU (or cost-aware: lowest hits-per-byte) victims and
    pushes them one level down, cascading;
  * **write-back** — puts land in the fastest level and are acknowledged;
    a background flusher batches dirty keys via ``put_many`` into the
    *home* (bottom) level.  Crash safety comes from redo records in a
    :class:`~repro_torch.core.journal.StateJournal`: when the journal rides a
    durable cache, an acknowledged put survives any crash/torn-flush
    schedule (the flusher only clears a dirty record after the home write
    of that exact version succeeded);
  * **prefetch** — ``prefetch(prefix)`` subscribes to the home (or an
    explicit source) tier's ``watch()`` events and pulls matching keys
    into the fast level in the background, so shuffle partitions
    committed by a producer are already hot when the consumer asks
    (FaaSFS-style transparent tiering behind one namespace).

Accounting is two-layered (see ``stats`` vs :meth:`physical_stats`):
``self.stats`` counts **logical** ops — one read per ``get`` no matter how
many levels it touched, with ``modeled_seconds`` covering only the device
time paid *inline* (a write-back put of a hot key costs DRAM, not S3).
Each level tier keeps its own physical counters; :meth:`stats_by_level`
/ :meth:`physical_stats` roll them up via :meth:`TierStats.merge`.  A
promoted read is therefore never double-counted at the logical layer,
while thread-scoped accounting (``tier_accounting``) still sees every
physical op exactly once via the capture-and-forward scope.

See DESIGN.md §7 for the promotion/demotion/write-back state machine and
the OpenWhisk/Ignite mapping.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from repro_torch.storage.tiers import (
    DramTier,
    Tier,
    TierStats,
    tier_accounting_capture,
)

if TYPE_CHECKING:  # deferred: repro_torch.core imports back into repro_torch.storage
    from repro_torch.storage.kvcache import StateCache

__all__ = [
    "PlacementPolicy",
    "TierLevel",
    "TieredStore",
    "adaptive_shuffle_tier",
]


@dataclass(frozen=True)
class PlacementPolicy:
    """Knobs for promotion, demotion, and the write path."""

    #: hits at a lower level before a key is promoted to the fast level.
    promote_after: int = 2
    #: keys larger than this never get promoted (None = any size) — the
    #: size half of size/frequency-aware admission.
    max_promote_bytes: Optional[int] = None
    #: write-back (ack from the fast level, background flush to home) vs
    #: write-through (home write inline with the put).
    write_back: bool = False
    #: victim selection when a level overflows: "lru" (least recently
    #: used) or "cost" (lowest hits-per-byte — big cold keys go first).
    eviction: str = "lru"
    #: background flusher cadence and batch bound (write-back only).
    flush_interval: float = 0.02
    flush_batch: int = 64

    def admits(self, freq: int, nbytes: int) -> bool:
        if freq < self.promote_after:
            return False
        return self.max_promote_bytes is None or nbytes <= self.max_promote_bytes


@dataclass
class TierLevel:
    """One level of the stack: a tier plus its byte budget.

    ``capacity_bytes=None`` means unbounded — required for the home
    (bottom) level, which is where overflow ultimately drains.
    """

    name: str
    tier: Tier
    capacity_bytes: Optional[int] = None


@dataclass
class _Entry:
    """Placement record for one key."""

    level: int  # fastest level currently holding the key
    size: int
    freq: int = 0
    version: int = 0
    #: the home (bottom) level also holds a clean copy of this version.
    home_copy: bool = False


class TieredStore(Tier):
    """The single ``Tier`` protocol over an ordered stack of tiers.

    ``levels`` runs fastest → slowest; the last level is the **home**
    level: unbounded, and the durability target of write-back flushes.
    ``journal`` (a :class:`StateCache`, ideally durable) carries the
    write-back redo log; without it, write-back still works but an
    acknowledged-unflushed put dies with the volatile fast level.

    Thread-safe: placement metadata is under one store lock, held across
    inline tier ops (they are fast levels by construction); the flusher's
    home ``put_many`` runs outside it so a slow home device never blocks
    the hot path.
    """

    def __init__(
        self,
        levels: Sequence[Union[TierLevel, Tier]],
        policy: Optional[PlacementPolicy] = None,
        journal: Optional["StateCache"] = None,
        name: str = "hier",
    ) -> None:
        super().__init__()
        if not levels:
            raise ValueError("TieredStore needs at least one level")
        self.levels: List[TierLevel] = [
            lv if isinstance(lv, TierLevel) else TierLevel(lv.name, lv)
            for lv in levels
        ]
        if self.levels[-1].capacity_bytes is not None:
            raise ValueError("the home (bottom) level must be unbounded")
        self.policy = policy or PlacementPolicy()
        self.name = name
        self.persistent = self.levels[-1].tier.persistent
        self._home = len(self.levels) - 1
        self._entries: Dict[str, _Entry] = {}
        #: per-level LRU order of resident keys (OrderedDict as a set).
        self._lru: List["OrderedDict[str, None]"] = [
            OrderedDict() for _ in self.levels
        ]
        self._used: List[int] = [0 for _ in self.levels]
        self._dirty: Dict[str, int] = {}  # key -> version awaiting flush
        #: pinned key prefixes: matching keys are held in the fast level —
        #: never demotion victims, promoted on first read (see :meth:`pin`).
        self._pins: set = set()
        #: keys snapshotted by a flush round whose home ``put_many`` has
        #: not completed yet.  A demotion must not land such a key at the
        #: home level: the in-flight (possibly stale) batch write could
        #: clobber it after the dirty record was cleared.
        self._inflight_flush: set = set()
        self._mutex = threading.RLock()
        #: flusher wake-up signal, deliberately NOT built on ``_mutex``:
        #: cross-store prefetch callbacks run on the writer's thread and
        #: must never need another store's placement lock.
        self._wake = threading.Event()
        self._flush_serial = threading.Lock()
        self._prefetch_lock = threading.Lock()
        if journal is not None:
            # Late import: repro_torch.core pulls repro_torch.storage back in.
            from repro_torch.core.journal import StateJournal

            self._journal = StateJournal(journal, f"{name}/wb")
        else:
            self._journal = None
        self._journal_cache = journal
        self.promotions = 0
        self.demotions = 0
        self.flush_errors = 0
        self._hits: List[int] = [0 for _ in self.levels]
        self._closed = False
        self._flusher: Optional[threading.Thread] = None
        self._prefetch_worker: Optional[threading.Thread] = None
        self._prefetch_queue: List[Tuple[Tier, str]] = []
        self._unsubscribes: List[Callable[[], None]] = []
        if self.policy.write_back:
            self._flusher = threading.Thread(
                target=self._flusher_loop, name=f"{name}-flusher", daemon=True
            )
            self._flusher.start()

    # -- journal redo-log keys --------------------------------------------
    def _data_key(self, key: str) -> str:
        return f"{self.name}/wbdata/{key}"

    # -- placement internals (call with self._mutex held) -----------------
    def _touch(self, key: str, level: int) -> None:
        lru = self._lru[level]
        lru[key] = None
        lru.move_to_end(key)

    def _drop_from_level(self, key: str, level: int, size: int) -> None:
        self._lru[level].pop(key, None)
        self._used[level] -= size

    def _adopt(self, key: str) -> Optional[_Entry]:
        """Fault in a key written to the underlying tiers out-of-band
        (pre-existing data, or data re-exposed by ``recover``)."""
        for i, lv in enumerate(self.levels):
            if lv.tier.contains(key):
                size = lv.tier.size_of(key)
                ent = _Entry(level=i, size=size, home_copy=(i == self._home))
                self._entries[key] = ent
                self._used[i] += size
                self._touch(key, i)
                return ent
        return None

    def _pinned(self, key: str) -> bool:
        return any(key.startswith(p) for p in self._pins)

    def _victim(
        self, level: int, protect: Optional[str], skip: Optional[set] = None
    ) -> Optional[str]:
        lru = self._lru[level]
        if self.policy.eviction == "cost":
            # Lowest hits-per-byte goes first: big cold keys are the
            # cheapest capacity to reclaim.
            best, best_score = None, None
            for key in lru:
                if (
                    key == protect
                    or (skip is not None and key in skip)
                    or self._pinned(key)
                ):
                    continue
                ent = self._entries[key]
                score = ent.freq / max(1, ent.size)
                if best_score is None or score < best_score:
                    best, best_score = key, score
            return best
        for key in lru:  # LRU order: oldest first
            if (
                key != protect
                and (skip is None or key not in skip)
                and not self._pinned(key)
            ):
                return key
        return None

    def _ensure_room(self, level: int, nbytes: int, protect: str) -> None:
        cap = self.levels[level].capacity_bytes
        if cap is None:
            return
        undemotable: set = set()
        while self._used[level] + nbytes > cap:
            victim = self._victim(level, protect, skip=undemotable)
            if victim is None:
                break  # nothing evictable; let the level run hot briefly
            if not self._demote_locked(victim):
                undemotable.add(victim)

    def _demote_locked(self, key: str) -> bool:
        """Move ``key`` one level down (cascading capacity).  Returns
        False when the key is already home (nothing to demote) or is
        pinned by an in-flight flush."""
        ent = self._entries.get(key)
        if ent is None or ent.level >= self._home:
            return False
        if self._pinned(key):
            # Placement-policy pin: loop-carried dataflow state must stay
            # in the fast level for the life of the pin — explicit demote
            # requests (warm-pool spills) are refused too.
            return False
        src, dst = ent.level, ent.level + 1
        if dst == self._home and key in self._inflight_flush:
            # A flush round snapshotted this key and its home put_many
            # has not landed yet: writing home here and clearing the
            # dirty record would let the in-flight (older) batch clobber
            # the newer value afterwards.  Leave the key where it is;
            # the flusher settles it within a round.
            return False
        src_tier = self.levels[src].tier
        if dst == self._home and ent.home_copy and key not in self._dirty:
            # Clean copy already lives at home: demotion is just a drop
            # (no value read — the bytes would be discarded).
            pass
        else:
            value = src_tier.get(key)
            self._ensure_room(dst, len(value), protect=key)
            self.levels[dst].tier.put(key, value)
            if dst == self._home:
                ent.home_copy = True
                self._clear_dirty(key, ent.version)
        src_tier.delete(key)
        self._drop_from_level(key, src, ent.size)
        ent.level = dst
        self._used[dst] += ent.size
        self._touch(key, dst)
        self.demotions += 1
        return True

    def _promote_locked(self, key: str, value: bytes) -> None:
        ent = self._entries[key]
        src = ent.level
        # Detach from the source level *before* making room: the cascade
        # below walks LRU lists, and the key must not be victimizable
        # mid-promotion (a stale src would corrupt the byte accounting).
        if src != self._home or not ent.home_copy:
            # Move semantics between non-home levels; a clean home copy
            # stays put (inclusive bottom) so a later demotion is free.
            self.levels[src].tier.delete(key)
        self._drop_from_level(key, src, ent.size)
        self._ensure_room(0, len(value), protect=key)
        self.levels[0].tier.put(key, value)
        ent.level = 0
        self._used[0] += ent.size
        self._touch(key, 0)
        self.promotions += 1

    def _clear_dirty(self, key: str, version: int) -> None:
        if self._dirty.get(key) == version:
            del self._dirty[key]
            if self._journal is not None:
                self._journal.retract(key)
                self._journal_cache.delete(self._data_key(key))

    # -- logical accounting -------------------------------------------------
    def _logical_read(self, nbytes: int, wall: float, modeled: float) -> None:
        with self._lock:
            self.stats.bytes_read += nbytes
            self.stats.read_ops += 1
            self.stats.wall_seconds += wall
            self.stats.modeled_seconds += modeled

    def _logical_write(self, nbytes: int, wall: float, modeled: float,
                       ops: int = 1) -> None:
        with self._lock:
            self.stats.bytes_written += nbytes
            self.stats.write_ops += ops
            self.stats.wall_seconds += wall
            self.stats.modeled_seconds += modeled

    # -- Tier protocol ------------------------------------------------------
    def put(self, key: str, value: bytes) -> None:
        t0 = time.perf_counter()
        with tier_accounting_capture() as inline:
            with self._mutex:
                self._install(key, value)
                self._journal_put({key: value})
                if not self.policy.write_back:
                    self._write_home(key, value)
                else:
                    self._dirty[key] = self._entries[key].version
        if self.policy.write_back:
            self._wake.set()
        self._logical_write(len(value), time.perf_counter() - t0,
                            inline.modeled_seconds)
        self._notify(key)

    def put_many(self, items: Mapping[str, bytes]) -> None:
        if not items:
            return
        t0 = time.perf_counter()
        with tier_accounting_capture() as inline:
            with self._mutex:
                for key, value in items.items():
                    self._install(key, value)
                self._journal_put(items)
                if not self.policy.write_back:
                    # Same single-level guard as _write_home: on a
                    # one-level store _install already wrote the values.
                    if self._home != 0:
                        self.levels[self._home].tier.put_many(items)
                    for key in items:
                        self._entries[key].home_copy = True
                else:
                    for key in items:
                        self._dirty[key] = self._entries[key].version
        if self.policy.write_back:
            self._wake.set()
        total = sum(len(v) for v in items.values())
        self._logical_write(total, time.perf_counter() - t0,
                            inline.modeled_seconds, ops=len(items))
        for key in items:
            self._notify(key)

    def _install(self, key: str, value: bytes) -> None:
        """Land ``value`` in the fast level and update placement."""
        ent = self._entries.get(key)
        if ent is not None:
            self._drop_from_level(key, ent.level, ent.size)
            if ent.level != 0 and ent.level != self._home:
                self.levels[ent.level].tier.delete(key)
            ent.size = len(value)
            ent.level = 0
            ent.version += 1
            ent.home_copy = False
        else:
            ent = _Entry(level=0, size=len(value), version=1)
            self._entries[key] = ent
        self._ensure_room(0, ent.size, protect=key)
        self.levels[0].tier.put(key, value)
        self._used[0] += ent.size
        self._touch(key, 0)

    def _write_home(self, key: str, value: bytes) -> None:
        if self._home == 0:
            self._entries[key].home_copy = True
            return
        self.levels[self._home].tier.put(key, value)
        self._entries[key].home_copy = True

    def _journal_put(self, items: Mapping[str, bytes]) -> None:
        if self._journal is None or not self.policy.write_back:
            return
        # Redo blobs first, then their markers: a torn journal batch can
        # leave orphan blobs (garbage, harmless) but never a marker whose
        # blob is missing — recovery skips markers without blobs anyway.
        self._journal_cache.put_many(
            {self._data_key(k): v for k, v in items.items()}
        )
        self._journal.commit_many(
            {k: {"bytes": len(v), "seq": self._entries[k].version}
             for k, v in items.items()}
        )

    def get(self, key: str) -> bytes:
        t0 = time.perf_counter()
        with tier_accounting_capture() as inline:
            with self._mutex:
                ent = self._entries.get(key)
                if ent is None:
                    ent = self._adopt(key)
                if ent is None:
                    raise KeyError(key)
                value = self.levels[ent.level].tier.get(key)
                ent.freq += 1
                self._hits[ent.level] += 1
                self._touch(key, ent.level)
                if ent.level > 0 and (
                    self._pinned(key)
                    or self.policy.admits(ent.freq, ent.size)
                ):
                    # Pinned keys skip the frequency admission bar: the
                    # first read after a crash re-adopts them straight
                    # into the fast level.
                    self._promote_locked(key, value)
        self._logical_read(len(value), time.perf_counter() - t0,
                           inline.modeled_seconds)
        return value

    def contains(self, key: str) -> bool:
        with self._mutex:
            if key in self._entries:
                return True
        return any(lv.tier.contains(key) for lv in self.levels)

    def delete(self, key: str) -> None:
        with self._mutex:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._drop_from_level(key, ent.level, ent.size)
                self._clear_dirty(key, ent.version)
            self._dirty.pop(key, None)
            for lv in self.levels:
                lv.tier.delete(key)

    def keys(self, prefix: str = "") -> Iterator[str]:
        seen = set()
        with self._mutex:
            if prefix:
                seen.update(
                    k for k in self._entries if k.startswith(prefix)
                )
            else:
                seen.update(self._entries.keys())
        for lv in self.levels:
            seen.update(lv.tier.keys(prefix))
        return iter(sorted(seen))

    def size_of(self, key: str) -> int:
        with self._mutex:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._adopt(key)
            if ent is not None:
                return ent.size
        raise KeyError(key)

    # -- explicit placement -------------------------------------------------
    def demote(self, key: str) -> bool:
        """Push ``key`` one level down (the gateway's warm-pool spill:
        evicted session state leaves DRAM for the next tier instead of
        being dropped).  Returns True if the key moved."""
        with self._mutex:
            if key not in self._entries and self._adopt(key) is None:
                return False
            return self._demote_locked(key)

    def pin(self, prefix: str, eager: bool = True) -> None:
        """Placement-policy hook: hold every key under ``prefix`` in the
        fast level — pinned keys are never demotion victims, explicit
        ``demote`` refuses them, and reads promote them past the
        size/frequency admission bar.  An iterative dataflow job pins its
        loop-state prefix so supersteps never round-trip through the
        modeled S3 home; :meth:`unpin` releases the keys back to normal
        policy when the loop retires them.

        With ``eager=True`` already-resident matching keys are promoted
        immediately (synchronously, under the placement lock);
        ``eager=False`` only registers the pin — resumed keys then reach
        the fast level via :meth:`promote_async` or on first read (the
        KV pager's promotion-on-resume path, which must not pay the
        slow-level read latency inside the resume call).  If the pinned
        set outgrows the fast level's budget the level runs hot (pins
        express a placement *requirement*, not extra capacity).
        """
        with self._mutex:
            self._pins.add(prefix)
            if not eager:
                return
            for key in [
                k for k, e in self._entries.items()
                if e.level > 0 and k.startswith(prefix)
            ]:
                value = self.levels[self._entries[key].level].tier.get(key)
                self._promote_locked(key, value)

    def unpin(self, prefix: str) -> None:
        """Remove a :meth:`pin`; matching keys become ordinary
        promotion/demotion candidates again (nothing moves eagerly)."""
        with self._mutex:
            self._pins.discard(prefix)

    @property
    def pinned_prefixes(self) -> List[str]:
        with self._mutex:
            return sorted(self._pins)

    def level_of(self, key: str) -> Optional[str]:
        """Name of the level currently serving ``key`` (None = absent)."""
        with self._mutex:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._adopt(key)
            return self.levels[ent.level].name if ent is not None else None

    # -- write-back flushing ------------------------------------------------
    def _snapshot_batch(self) -> List[Tuple[str, int, bytes]]:
        with self._mutex:
            batch: List[Tuple[str, int, bytes]] = []
            for key in list(self._dirty)[: self.policy.flush_batch]:
                ent = self._entries.get(key)
                if ent is None:  # deleted since marked dirty
                    self._dirty.pop(key, None)
                    continue
                value = self.levels[ent.level].tier.get(key)
                batch.append((key, ent.version, value))
                # Pin: no demotion may land this key at home until the
                # round's put_many resolved (see _demote_locked).
                self._inflight_flush.add(key)
            return batch

    def _flush_once(self) -> int:
        """One flush round: snapshot → home ``put_many`` → clear the
        dirty records whose version is unchanged.  A torn home write
        leaves every record dirty (idempotent retry); acked data stays
        readable in the fast level and replayable from the journal, so
        **no acknowledged put is ever lost**."""
        with self._flush_serial:
            batch = self._snapshot_batch()
            if not batch:
                return 0
            try:
                # One batched request for the whole round (the
                # SimulatedTier charges a single modeled latency — same
                # fast path the streaming shuffle uses).
                self.levels[self._home].tier.put_many(
                    {key: value for key, _, value in batch}
                )
                with self._mutex:
                    for key, version, _ in batch:
                        ent = self._entries.get(key)
                        if ent is not None and ent.version == version:
                            ent.home_copy = True
                        elif ent is None:
                            # Deleted while the flush was in flight: undo
                            # the resurrected home copy.
                            self.levels[self._home].tier.delete(key)
                        self._clear_dirty(key, version)
            finally:
                with self._mutex:
                    self._inflight_flush.difference_update(
                        k for k, _, _ in batch
                    )
            return len(batch)

    def _flusher_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.policy.flush_interval)
            self._wake.clear()
            self._drain_prefetch()
            try:
                while self._flush_once():
                    pass
            except Exception:
                # Keys stay dirty; retried next round.  heal()-style
                # recovery on the home tier makes the retry succeed.
                self.flush_errors += 1
                time.sleep(self.policy.flush_interval)
            with self._mutex:
                # close(flush=True) drains synchronously before setting
                # the flag, so exiting here never abandons dirty keys
                # the caller wanted flushed.
                if self._closed:
                    return

    def flush(self, timeout: Optional[float] = 30.0) -> int:
        """Synchronously drain the dirty set (retrying failed rounds
        until ``timeout``).  Returns the number of keys flushed."""
        flushed = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._mutex:
                if not self._dirty:
                    return flushed
            try:
                flushed += self._flush_once()
            except Exception:
                self.flush_errors += 1
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                time.sleep(min(0.005, self.policy.flush_interval))

    @property
    def dirty_keys(self) -> List[str]:
        with self._mutex:
            return sorted(self._dirty)

    # -- prefetch -----------------------------------------------------------
    def prefetch(
        self, prefix: str, source: Optional[Tier] = None
    ) -> Callable[[], None]:
        """Watch ``source`` (default: the home tier) and pull every key
        committed under ``prefix`` into the fast level in the background
        — a consumer's hierarchy warms itself from a producer's commits
        before the first ``get`` (the shuffle-prefetch path).  Returns
        the unsubscribe callable."""
        src = source if source is not None else self.levels[self._home].tier

        def on_commit(key: str) -> None:
            # Cheap, lock-light enqueue on the writer's thread (which may
            # hold *another* store's placement lock); the promotion I/O
            # happens on this store's background worker.
            with self._prefetch_lock:
                self._prefetch_queue.append((src, key))
            self._wake.set()

        if self._flusher is None:
            self._ensure_prefetch_worker()
        unsub = src.watch(prefix, on_commit)
        self._unsubscribes.append(unsub)
        return unsub

    def promote_async(self, keys: Iterable[str]) -> int:
        """Enqueue already-resident ``keys`` for background promotion to
        the fast level — the KV pager's promotion-on-resume: a returning
        session's blocks climb out of the slow level on the prefetch
        worker, ahead of the next decode step, instead of demand-faulting
        inside it.  Keys already fast, dirty, or absent are skipped by
        the drain worker's usual freshness rules.  Returns the number of
        keys enqueued."""
        batch: List[Tuple[Tier, str]] = []
        with self._mutex:
            for key in keys:
                ent = self._entries.get(key)
                if ent is None:
                    ent = self._adopt(key)
                if ent is None or ent.level == 0:
                    continue
                batch.append((self.levels[ent.level].tier, key))
        if not batch:
            return 0
        with self._prefetch_lock:
            self._prefetch_queue.extend(batch)
        if self._flusher is None:
            self._ensure_prefetch_worker()
        self._wake.set()
        return len(batch)

    def _ensure_prefetch_worker(self) -> None:
        """One persistent drain worker for stores without a flusher
        (write-through policy) — never a thread per watch event."""
        with self._mutex:
            if self._prefetch_worker is not None or self._closed:
                return
            self._prefetch_worker = threading.Thread(
                target=self._prefetch_loop,
                name=f"{self.name}-prefetch", daemon=True,
            )
            self._prefetch_worker.start()

    def _prefetch_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            self._drain_prefetch()
            with self._mutex:
                if self._closed:
                    return

    def _skip_prefetch(self, key: str) -> bool:
        """A prefetched (source) copy must never clobber a local copy
        that may be newer: anything resident above home, or anything
        dirty (our write awaiting flush).  Only keys we know solely
        through the shared home level — or not at all — are pulled."""
        ent = self._entries.get(key)
        if ent is None:
            return False
        return ent.level < self._home or key in self._dirty

    def _drain_prefetch(self) -> int:
        pulled = 0
        while True:
            with self._prefetch_lock:
                if not self._prefetch_queue:
                    return pulled
                src, key = self._prefetch_queue.pop(0)
            with self._mutex:
                if self._skip_prefetch(key):
                    continue  # local copy is as new or newer
            try:
                value = src.get(key)
            except (KeyError, FileNotFoundError, IOError):
                continue
            with self._mutex:
                if self._skip_prefetch(key):
                    continue
                ent = self._entries.get(key)
                if ent is not None:
                    # Resident at home: the home tier keeps its copy
                    # (inclusive bottom), only the placement record moves.
                    self._drop_from_level(key, ent.level, ent.size)
                at_home = ent is not None and ent.level == self._home
                is_home_src = src is self.levels[self._home].tier
                self._entries[key] = _Entry(
                    level=0, size=len(value), home_copy=at_home or is_home_src,
                    freq=ent.freq if ent else 0,
                    version=ent.version if ent else 0,
                )
                self._ensure_room(0, len(value), protect=key)
                self.levels[0].tier.put(key, value)
                self._used[0] += len(value)
                self._touch(key, 0)
                pulled += 1

    # -- crash / recovery ---------------------------------------------------
    def crash(self) -> None:
        """Volatile levels lose their contents (node failure); placement
        is rebuilt from whatever the persistent levels still hold."""
        with self._mutex:
            for lv in self.levels:
                if not lv.tier.persistent:
                    lv.tier.clear()
            self._entries.clear()
            self._dirty.clear()
            self._inflight_flush.clear()
            for lru in self._lru:
                lru.clear()
            self._used = [0 for _ in self.levels]
            # Re-adopt survivors, fastest level wins.
            for i, lv in enumerate(self.levels):
                for key in lv.tier.keys():
                    if key in self._entries:
                        continue
                    size = lv.tier.size_of(key)
                    self._entries[key] = _Entry(
                        level=i, size=size, home_copy=(i == self._home)
                    )
                    self._used[i] += size
                    self._touch(key, i)

    def recover(self) -> int:
        """Replay unflushed write-back redo records from the journal:
        every acknowledged put whose flush had not completed is
        reinstalled (still dirty, so it flushes again).  Returns the
        number of keys replayed."""
        if self._journal is None:
            return 0
        replayed = 0
        with self._mutex:
            for key, meta in self._journal.entries().items():
                data_key = self._data_key(key)
                if not self._journal_cache.contains(data_key):
                    continue  # torn journal batch: blob never landed
                value = self._journal_cache.get(data_key)
                self._install(key, value)
                self._entries[key].version = int(meta.get("seq", 1))
                self._dirty[key] = self._entries[key].version
                replayed += 1
        if replayed:
            self._wake.set()
        return replayed

    # -- stats rollup -------------------------------------------------------
    def stats_by_level(self) -> Dict[str, TierStats]:
        """Physical per-level counters (each level's own tier stats)."""
        return {lv.name: lv.tier.stats for lv in self.levels}

    def physical_stats(self) -> TierStats:
        """All levels merged into one :class:`TierStats` (physical ops:
        a promoted read shows up as one lower-level read plus one
        fast-level write — the logical ``self.stats`` counts it once)."""
        rolled = TierStats()
        for lv in self.levels:
            rolled = rolled.merge(lv.tier.stats)
        return rolled

    def hit_rates(self) -> Dict[str, float]:
        """Fraction of gets served per level (by level name)."""
        total = max(1, sum(self._hits))
        return {
            lv.name: self._hits[i] / total for i, lv in enumerate(self.levels)
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self, flush: bool = True) -> None:
        if self._closed:
            return
        for unsub in self._unsubscribes:
            unsub()
        self._unsubscribes.clear()
        if flush and self.policy.write_back:
            self.flush()
        with self._mutex:
            self._closed = True
        self._wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        if self._prefetch_worker is not None:
            self._prefetch_worker.join(timeout=5.0)

    def __enter__(self) -> "TieredStore":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close(flush=exc[0] is None)


def adaptive_shuffle_tier(
    backing: Tier,
    journal: Optional["StateCache"] = None,
    name: str = "shuffle",
    fast_capacity: Optional[int] = None,
) -> TieredStore:
    """A write-back DRAM front over ``backing`` for shuffle traffic.

    Map tasks' ``put_many`` lands in DRAM and is acknowledged there —
    the modeled S3/SSD latency moves off the map task's critical path
    onto the background flusher.  With a durable ``journal`` the redo
    log makes those acks crash-safe, and any unflushed partitions from
    a previous run are replayed immediately (``recover``), so journaled
    job resume still finds every committed partition.
    """
    store = TieredStore(
        [
            TierLevel("dram", DramTier(), fast_capacity),
            TierLevel(backing.name, backing),
        ],
        policy=PlacementPolicy(write_back=True, promote_after=1),
        journal=journal,
        name=name,
    )
    store.recover()
    return store
