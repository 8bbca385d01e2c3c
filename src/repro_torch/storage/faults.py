"""Deterministic fault injection for storage tiers.

Crash paths (torn commits, flaky devices, latency spikes) are the part of
the paper's durability story that example-based tests cannot reach: the
interesting failures happen *mid-operation*.  :class:`FaultInjectingTier`
wraps any :class:`~repro_torch.storage.tiers.Tier` and injects faults from a
**seeded RNG** plus an optional explicit per-op schedule, so every failing
run is reproducible bit-for-bit:

  * ``put``/``get`` raising :class:`IOError` (device error, lost NIC),
  * **torn** ``put_many``: a strict prefix of the batch lands in the
    backing tier, then the op raises — models a crash mid-multi-part
    commit (the case partition-granular journaling must survive),
  * latency spikes: a slow op (sleeps ``spike_seconds``) without an error
    — models the paper's observed S3 tail latencies.

Faults are counted per *kind* against a monotonically increasing op
counter, so ``schedule={("put", 3)}`` means "the 4th put fails" regardless
of interleaving with gets.  ``heal()`` turns all injection off (the tier
keeps serving), which crash/recovery tests use to flip from the failing
phase to the recovery phase.
"""

from __future__ import annotations

import random
import time
from typing import Iterable, Iterator, Mapping, Optional, Set, Tuple

from repro_torch.storage.tiers import Tier

__all__ = [
    "FaultInjectingTier",
    "InjectedIOError",
    "LinkPartitionError",
    "TornWriteError",
]


class InjectedIOError(IOError):
    """An injected device error (distinguishable from real IOErrors)."""


class LinkPartitionError(InjectedIOError):
    """A cross-node transfer attempted over a partitioned network link.

    Raised by :class:`repro_torch.core.cluster.NetworkFabric` while a link is
    partitioned (``fabric.partition(a, b)``); heals with
    ``fabric.heal()``.  Subclassing :class:`InjectedIOError` keeps the
    cluster fault matrix on the same error taxonomy as the storage
    fault-injection harness."""


class TornWriteError(InjectedIOError):
    """A ``put_many`` that persisted only a strict prefix of the batch."""

    def __init__(self, message: str, landed: int, total: int) -> None:
        super().__init__(message)
        self.landed = landed
        self.total = total


class FaultInjectingTier(Tier):
    """Wraps ``backing`` with seeded, schedulable fault injection.

    ``*_error_rate`` are per-op probabilities drawn from ``random.Random
    (seed)`` — deterministic given the op sequence.  ``schedule`` is a set
    of ``(kind, op_index)`` pairs forcing a fault at an exact per-kind op
    index (0-based); kinds are ``"put"``, ``"get"``, ``"torn"`` (applies
    to ``put_many``), and ``"spike"`` (applies to both put and get).
    """

    def __init__(
        self,
        backing: Tier,
        seed: int = 0,
        put_error_rate: float = 0.0,
        get_error_rate: float = 0.0,
        torn_put_many_rate: float = 0.0,
        spike_rate: float = 0.0,
        spike_seconds: float = 0.005,
        schedule: Optional[Iterable[Tuple[str, int]]] = None,
    ) -> None:
        super().__init__()
        self._backing = backing
        self.name = f"faulty:{backing.name}"
        self.persistent = backing.persistent
        self._rng = random.Random(seed)
        self.put_error_rate = put_error_rate
        self.get_error_rate = get_error_rate
        self.torn_put_many_rate = torn_put_many_rate
        self.spike_rate = spike_rate
        self.spike_seconds = spike_seconds
        self._schedule: Set[Tuple[str, int]] = set(schedule or ())
        self._ops = {"put": 0, "get": 0, "torn": 0, "spike": 0}
        self._armed = True
        self.injected = {"put": 0, "get": 0, "torn": 0, "spike": 0}

    # -- control -----------------------------------------------------------
    def heal(self) -> None:
        """Stop injecting (the tier keeps serving, faults stay counted)."""
        self._armed = False

    def arm(self) -> None:
        self._armed = True

    def _trip(self, kind: str, rate: float) -> bool:
        """One fault decision; advances the per-kind op counter either way
        (so RNG draws and schedule indices are stable across arm/heal)."""
        with self._lock:
            idx = self._ops[kind]
            self._ops[kind] += 1
            fire = (kind, idx) in self._schedule or (
                rate > 0.0 and self._rng.random() < rate
            )
            if fire and self._armed:
                self.injected[kind] += 1
                return True
            return False

    def _maybe_spike(self) -> None:
        if self._trip("spike", self.spike_rate):
            time.sleep(self.spike_seconds)

    # -- protocol ----------------------------------------------------------
    def put(self, key: str, value: bytes) -> None:
        self._maybe_spike()
        if self._trip("put", self.put_error_rate):
            raise InjectedIOError(f"injected put failure for {key!r}")
        self._backing.put(key, value)
        self._notify(key)

    def put_many(self, items: Mapping[str, bytes]) -> None:
        if self._trip("torn", self.torn_put_many_rate) and len(items) > 0:
            # Persist a strict prefix (possibly empty), then fail: the
            # batch is torn exactly where a crash mid-commit would tear it.
            pairs = list(items.items())
            landed = self._rng.randrange(len(pairs))
            for key, value in pairs[:landed]:
                self._backing.put(key, value)
                self._notify(key)
            raise TornWriteError(
                f"injected torn put_many: {landed}/{len(pairs)} landed",
                landed, len(pairs),
            )
        self._maybe_spike()
        self._backing.put_many(items)
        for key in items:
            self._notify(key)

    def get(self, key: str) -> bytes:
        self._maybe_spike()
        if self._trip("get", self.get_error_rate):
            raise InjectedIOError(f"injected get failure for {key!r}")
        return self._backing.get(key)

    def delete(self, key: str) -> None:
        self._backing.delete(key)

    def contains(self, key: str) -> bool:
        return self._backing.contains(key)

    def keys(self, prefix: str = "") -> Iterator[str]:
        return self._backing.keys(prefix)

    def size_of(self, key: str) -> int:
        return self._backing.size_of(key)

    @property
    def stats(self):  # I/O accounting lives in the backing tier
        return self._backing.stats

    @stats.setter
    def stats(self, value) -> None:  # Tier.__init__ assigns; ignore
        pass
