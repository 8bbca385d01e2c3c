"""Ignite/IGFS analog: an in-memory KV state cache with TTL + spill.

Marvel deploys Apache Ignite as the fast shared tier holding (a) function
state and (b) intermediate (shuffle) data.  The essential properties the
runtime consumes:

  * shared across all functions of an application (here: process-wide),
  * near-DRAM latency,
  * optional write-through to a persistent tier (the paper's §4.3 "Ignite
    on top of PMEM" future work — implemented here so state survives
    failures),
  * namespacing per application/session.

Values are arbitrary bytes; the pytree (de)serialization lives in
``storage/serde.py`` so tensors and arrays can ride through unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Mapping, Optional

from repro_torch.storage.tiers import DramTier, Tier, WatchRegistry

__all__ = ["StateCache"]


def _tier_keys(tier: Tier, prefix: str):
    """Delegate a prefix listing to the tier; fall back to filtering for
    legacy tiers whose ``keys()`` takes no prefix."""
    try:
        return tier.keys(prefix)
    except TypeError:
        return (k for k in tier.keys() if k.startswith(prefix))


class StateCache:
    """In-memory KV cache with optional write-through persistence.

    ``write_through=None`` reproduces stock Marvel (volatile Ignite).
    Passing a persistent tier gives the checkpoint-capable variant: every
    put lands in DRAM *and* the persistent tier, and ``recover()`` reloads
    the DRAM view after a (simulated) crash.

    Thread-safety: safe for concurrent use by many invokers.  Individual
    ops are atomic (tiers lock internally; TTL bookkeeping is under the
    cache lock; ``get`` tolerates a concurrent ``delete`` between its
    membership check and the read by falling through to the demand-fault
    path).  Cross-key consistency is the caller's job — the gateway's
    per-session leases guarantee one writer per state key.
    """

    def __init__(
        self,
        memory: Optional[Tier] = None,
        write_through: Optional[Tier] = None,
    ) -> None:
        self.memory = memory if memory is not None else DramTier()
        self.write_through = write_through
        self._ttl: Dict[str, float] = {}
        #: key -> version stamp of the blob last stored via
        #: :meth:`put_versioned` (volatile; cleared on ``crash``).
        self._versions: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._watch = WatchRegistry(self._lock)

    # -- basic KV -----------------------------------------------------------
    def put(self, key: str, value: bytes, ttl: Optional[float] = None) -> None:
        self.memory.put(key, value)
        with self._lock:
            if ttl is not None:
                self._ttl[key] = time.monotonic() + ttl
            self._versions.pop(key, None)  # overwrite invalidates the memo
        if self.write_through is not None:
            self.write_through.put(key, value)
        self._notify(key)

    def put_many(self, items: Mapping[str, bytes]) -> None:
        """Batched put: one request to each tier for the whole batch (the
        tiers charge a single modeled latency — see ``Tier.put_many``)."""
        self.memory.put_many(items)
        with self._lock:
            for key in items:  # overwrite kills any stale TTL / version memo
                self._ttl.pop(key, None)
                self._versions.pop(key, None)
        if self.write_through is not None:
            self.write_through.put_many(items)
        for key in items:
            self._notify(key)

    def put_versioned(self, key: str, value: bytes, version: int) -> bool:
        """Put ``value`` unless this exact ``version`` of ``key`` was
        already stored through this method — the lazy serde fast path:
        committing an unchanged state becomes a dict probe instead of a
        physical tier write.  Version stamps must be unique per distinct
        value (the runtime draws them from one monotonic clock).  The
        memo is volatile: ``crash()`` clears it, so the first commit
        after recovery always re-persists.  Returns True iff the tier
        write happened."""
        with self._lock:
            if self._versions.get(key) == version:
                return False
        self.put(key, value)
        with self._lock:
            self._versions[key] = version
        return True

    def watch(self, prefix: str, callback: Callable[[str], None]) -> Callable[[], None]:
        """Invoke ``callback(key)`` after every *commit* (put/put_many)
        under ``prefix``.  Returns an unsubscribe callable.

        The cache keeps its own registry rather than delegating to the
        DRAM tier: internal re-reads (demand faults after a crash,
        ``recover()``) land in the memory tier too but are not new
        commits and must not produce events.
        """
        return self._watch.watch(prefix, callback)

    def _notify(self, key: str) -> None:
        self._watch.notify(key)

    def get(self, key: str) -> bytes:
        with self._lock:
            expiry = self._ttl.get(key)
            expired = expiry is not None and time.monotonic() > expiry
            if expired:
                self.memory.delete(key)
                del self._ttl[key]
        if not expired:
            try:
                return self.memory.get(key)
            except (KeyError, FileNotFoundError):
                pass  # deleted/evicted concurrently — try the durable tier
        # Demand-fault from the persistent tier (crash recovery path).
        if self.write_through is not None and self.write_through.contains(key):
            value = self.write_through.get(key)
            self.memory.put(key, value)
            return value
        raise KeyError(key)

    def contains(self, key: str) -> bool:
        if self.memory.contains(key):
            return True
        return self.write_through is not None and self.write_through.contains(key)

    def delete(self, key: str) -> None:
        self.memory.delete(key)
        if self.write_through is not None:
            self.write_through.delete(key)
        with self._lock:
            self._ttl.pop(key, None)
            self._versions.pop(key, None)

    def demote(self, key: str) -> bool:
        """Push ``key`` out of the fast tier without losing it — the
        gateway's warm-pool eviction calls this so a spilled session's
        state blob stops occupying DRAM.

        On a :class:`~repro_torch.storage.hierarchy.TieredStore` memory tier
        this is a real one-level demotion; on a plain memory tier with
        write-through it drops the DRAM copy (the durable copy serves
        the next read); with neither there is nowhere to demote *to* and
        the key stays put.  Returns True if the key actually moved.
        """
        demoter = getattr(self.memory, "demote", None)
        if demoter is not None:
            return bool(demoter(key))
        if self.write_through is not None and self.write_through.contains(key):
            self.memory.delete(key)
            return True
        return False

    def keys(self, prefix: str = "") -> List[str]:
        """Prefix-filtered listing, pushed down to the tiers.

        Tiers filter against their native index (dict scan, directory
        subtree walk) so a namespaced listing never enumerates unrelated
        keys — the KV pager's per-session block enumeration made the
        old scan-everything-then-filter loop a hot path.  Tiers from
        outside this package that predate the ``prefix`` parameter are
        still accepted (filtered here instead)."""
        seen = set()
        seen.update(_tier_keys(self.memory, prefix))
        if self.write_through is not None:
            seen.update(_tier_keys(self.write_through, prefix))
        return sorted(seen)

    # -- crash / recovery --------------------------------------------------
    def crash(self) -> None:
        """Drop the volatile view (simulates node loss of the DRAM tier).

        A hierarchy-backed memory tier loses only its volatile *levels*
        (``TieredStore.crash``) — wiping its persistent levels too would
        simulate a disk fire, not a node failure."""
        crasher = getattr(self.memory, "crash", None)
        if crasher is not None:
            crasher()
        else:
            self.memory.clear()
        with self._lock:
            self._ttl.clear()
            self._versions.clear()  # next put_versioned must re-persist

    def recover(self) -> int:
        """Reload the fast view from persistent storage; returns keys
        restored (journal-replayed write-back keys count for a hierarchy
        memory tier)."""
        n = 0
        recoverer = getattr(self.memory, "recover", None)
        if recoverer is not None:
            n += int(recoverer())
        if self.write_through is None:
            return n
        for k in self.write_through.keys():
            self.memory.put(k, self.write_through.get(k))
            n += 1
        return n

    # -- namespacing helper --------------------------------------------------
    def namespaced(self, namespace: str) -> "NamespacedCache":
        return NamespacedCache(self, namespace)


class NamespacedCache:
    """View of a :class:`StateCache` under a fixed key prefix."""

    def __init__(self, cache: StateCache, namespace: str) -> None:
        self._cache = cache
        self._prefix = namespace.rstrip("/") + "/"

    def put(self, key: str, value: bytes, ttl: Optional[float] = None) -> None:
        self._cache.put(self._prefix + key, value, ttl)

    def get(self, key: str) -> bytes:
        return self._cache.get(self._prefix + key)

    def contains(self, key: str) -> bool:
        return self._cache.contains(self._prefix + key)

    def delete(self, key: str) -> None:
        self._cache.delete(self._prefix + key)

    def keys(self) -> List[str]:
        plen = len(self._prefix)
        return [k[plen:] for k in self._cache.keys(self._prefix)]
