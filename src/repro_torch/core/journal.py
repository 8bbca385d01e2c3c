"""Unified commit journal — one durability abstraction for every workload.

Before this module the repo had two ad-hoc journals: the MapReduce engine
wrote ``mr/<job>/done/<task>`` markers straight into a
:class:`~repro_torch.storage.kvcache.StateCache`, and the stateful function
runtime serialized session state under ``state/...`` with its own commit
cadence.  :class:`StateJournal` is the shared abstraction both now use:

  * entries are **partition-granular**: a map task commits itself *and*
    each shuffle partition it published, so a job interrupted mid-wave
    resumes from individual committed partitions, not just wave
    boundaries;
  * commits carry a small JSON meta blob (sizes, sequence numbers) that
    recovery uses to re-prime the DAG token table without touching the
    data tier;
  * durability follows the backing cache: a volatile cache gives
    stock-Marvel semantics, a write-through (PMEM) cache survives crashes
    — the paper's central trade, unchanged.

Key layout is compatible with the pre-refactor MapReduce journal
(``<ns>/done/<entry>``), so journals written by older runs still resume.

Thread-safety: the journal itself holds no mutable state — every op is a
single atomic :class:`StateCache` operation, so concurrent invokers can
commit through one journal instance.  Crash consistency under a torn
``put_many`` (see :class:`~repro_torch.storage.faults.FaultInjectingTier`) is an
*ordering* contract: batches persist in mapping order, so commit markers
that summarize other entries must come **last** in the batch —
:meth:`StateJournal.commit_many_ordered` encodes that rule.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.storage.kvcache import StateCache
from repro_torch.storage.tiers import TierStats, tier_accounting

__all__ = ["CommitTicket", "GroupCommitter", "StateJournal"]


class StateJournal:
    """Append-only commit markers, namespaced, over a :class:`StateCache`."""

    def __init__(self, cache: StateCache, namespace: str) -> None:
        self.cache = cache
        self.namespace = namespace.rstrip("/")

    def _key(self, entry_id: str) -> str:
        return f"{self.namespace}/done/{entry_id}"

    # -- commit side -------------------------------------------------------
    def commit(self, entry_id: str, meta: Optional[dict] = None) -> None:
        self.cache.put(self._key(entry_id), json.dumps(meta or {}).encode())

    def commit_many(self, entries: Dict[str, dict]) -> None:
        self.cache.put_many(
            {self._key(e): json.dumps(m or {}).encode()
             for e, m in entries.items()}
        )

    def commit_many_ordered(
        self, entries: Dict[str, dict], marker: str
    ) -> None:
        """Commit a batch whose ``marker`` entry summarizes the rest.

        The marker is moved to the **end** of the batch so a torn
        ``put_many`` (crash mid-commit) can persist detail entries without
        their summary, but never a summary whose details are missing — the
        invariant mid-wave resume relies on.
        """
        ordered = {e: m for e, m in entries.items() if e != marker}
        if marker in entries:
            ordered[marker] = entries[marker]
        self.commit_many(ordered)

    def retract(self, entry_id: str) -> None:
        """Remove a commit marker (write-back dirty records retire this
        way once their home flush lands)."""
        self.cache.delete(self._key(entry_id))

    # -- recovery side -----------------------------------------------------
    def committed(self, entry_id: str) -> bool:
        return self.cache.contains(self._key(entry_id))

    def meta(self, entry_id: str) -> dict:
        return json.loads(self.cache.get(self._key(entry_id)))

    def entries(self, prefix: str = "") -> Dict[str, dict]:
        """All committed entry ids (under ``prefix``) with their meta."""
        base = f"{self.namespace}/done/{prefix}"
        plen = len(f"{self.namespace}/done/")
        out: Dict[str, dict] = {}
        for key in self.cache.keys(base):
            out[key[plen:]] = json.loads(self.cache.get(key))
        return out

    def pending(self, entry_ids: Iterable[str]) -> List[str]:
        """The subset of ``entry_ids`` not yet committed (work remaining)."""
        return [e for e in entry_ids if not self.committed(e)]

    def clear(self) -> None:
        for key in self.cache.keys(f"{self.namespace}/done/"):
            self.cache.delete(key)


# -- group commit --------------------------------------------------------------

class CommitTicket:
    """Resolution handle for one group-committed (blob, marker) pair.

    Resolves exactly once, when the flush round containing the pair lands
    (``error is None``) or fails (``error`` set — e.g. a torn
    ``put_many``).  ``add_done_callback`` runs the callback on the flusher
    thread, or inline if already resolved; each registered callback runs
    exactly once regardless of the registration/resolution race.
    """

    __slots__ = ("_done", "error", "_callbacks")

    def __init__(self) -> None:
        # No Event allocated up front: the warm path resolves tickets via
        # callbacks (the gateway's deferred ack), so most tickets are
        # never waited on — blockers allocate their own event in wait().
        self._done = False
        self.error: Optional[BaseException] = None
        self._callbacks: List[Callable[["CommitTicket"], None]] = []

    def done(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until durable; re-raise the flush error if it failed."""
        if not self._done:
            event = threading.Event()
            self.add_done_callback(lambda _t: event.set())
            if not event.wait(timeout):
                raise TimeoutError("group commit did not flush in time")
        if self.error is not None:
            raise self.error

    def add_done_callback(
        self, fn: Callable[["CommitTicket"], None]
    ) -> None:
        self._callbacks.append(fn)  # GIL-atomic append
        if self._done:
            self._drain()

    def _resolve(self, error: Optional[BaseException]) -> None:
        self.error = error
        self._done = True
        self._drain()

    def _drain(self) -> None:
        # pop() is atomic, so a callback runs once even when resolver and
        # a concurrent add_done_callback both reach here.
        while self._callbacks:
            try:
                cb = self._callbacks.pop()
            except IndexError:
                break
            cb(self)


class _PendingCommit:
    __slots__ = ("blob_key", "blob", "entry_id", "meta", "tickets",
                 "on_durable")

    def __init__(self, blob_key: str) -> None:
        self.blob_key = blob_key
        self.blob: bytes = b""
        self.entry_id: Optional[str] = None
        self.meta: Optional[dict] = None
        self.tickets: List[CommitTicket] = []
        self.on_durable: List[Callable[[], None]] = []


class GroupCommitter:
    """Coalesces concurrent state commits into batched ``put_many`` calls.

    Warm invocations enqueue a ``(state blob, journal marker)`` pair and
    continue; a dedicated flusher drains the queue and lands one
    ``put_many`` per round — so N concurrent sessions pay one modeled
    tier request instead of 2N.  Commits to the *same* state key coalesce
    (latest blob/marker win; every enqueuer's ticket resolves together) —
    safe because the gateway's lease makes each session's enqueues
    already serialized.

    Crash ordering: the batch interleaves ``blob, marker, blob, marker,
    ...`` — the pair-adjacent generalization of
    :meth:`StateJournal.commit_many_ordered`'s marker-last rule.  Tiers
    persist ``put_many`` batches in mapping order and a torn batch lands
    a strict prefix, so a crash mid-flush can strand at most one blob
    without its marker and **never** a marker without its blob — the
    same exposure as the unbatched put-blob-then-put-marker path, which
    is what keeps recovery byte-identical at the last landed marker.

    ``stats`` accounts the flusher thread's tier I/O (it runs outside
    any invoker's accounting scope).
    """

    def __init__(
        self,
        journal: StateJournal,
        flush_interval: float = 0.0,
        name: str = "group-commit",
    ) -> None:
        self.journal = journal
        self.flush_interval = flush_interval
        self.stats = TierStats()
        self.batches = 0  # flush rounds that performed I/O
        self.entries = 0  # coalesced pairs flushed
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._wake = threading.Event()
        self._pending: "OrderedDict[str, _PendingCommit]" = OrderedDict()
        self._inflight = 0  # pairs drained but not yet resolved
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    # -- commit side -------------------------------------------------------
    def enqueue(
        self,
        blob_key: str,
        blob: bytes,
        entry_id: Optional[str] = None,
        meta: Optional[dict] = None,
        on_durable: Optional[Callable[[], None]] = None,
    ) -> CommitTicket:
        """Queue one blob (+ its journal marker) for the next flush."""
        ticket = CommitTicket()
        with self._lock:
            if self._closed:
                raise RuntimeError("group committer is closed")
            pc = self._pending.get(blob_key)
            if pc is None:
                pc = _PendingCommit(blob_key)
                self._pending[blob_key] = pc
            pc.blob = blob
            pc.entry_id = entry_id
            pc.meta = meta
            pc.tickets.append(ticket)
            if on_durable is not None:
                pc.on_durable.append(on_durable)
        self._wake.set()
        return ticket

    def flush(self, timeout: Optional[float] = 30.0) -> bool:
        """Block until everything enqueued so far is resolved (durable or
        failed).  Returns False on timeout."""
        self._wake.set()
        with self._idle:
            return self._idle.wait_for(
                lambda: not self._pending and self._inflight == 0, timeout
            )

    def drop_pending(self, error: BaseException) -> None:
        """Discard everything still queued (a crash before the flush):
        the pairs never reach the tier and their tickets fail with
        ``error`` — queued-but-unflushed commits are volatile state."""
        with self._lock:
            drained = list(self._pending.values())
            self._pending.clear()
        for pc in drained:
            for t in pc.tickets:
                t._resolve(error)

    def close(self, flush: bool = True) -> None:
        """Stop accepting commits; drain (default) and join the flusher."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if not flush:
            self.drop_pending(
                RuntimeError("group committer closed before flush")
            )
        self._wake.set()
        self._thread.join(timeout=10.0)

    # -- flusher -----------------------------------------------------------
    def _run(self) -> None:
        with tier_accounting(self.stats):
            while True:
                self._wake.wait()
                if self.flush_interval > 0.0:
                    # accumulation window: let concurrent invokers pile
                    # more commits into this round before it pays I/O.
                    time.sleep(self.flush_interval)
                with self._lock:
                    drained = list(self._pending.values())
                    self._pending.clear()
                    self._wake.clear()
                    self._inflight = len(drained)
                    closed = self._closed
                if drained:
                    self._flush_round(drained)
                with self._idle:
                    self._inflight = 0
                    self._idle.notify_all()
                    if closed and not self._pending:
                        return

    def _flush_round(self, drained: List[_PendingCommit]) -> None:
        batch: "OrderedDict[str, bytes]" = OrderedDict()
        for pc in drained:  # pair-adjacent: every marker right after its blob
            batch[pc.blob_key] = pc.blob
            if pc.entry_id is not None:
                batch[self.journal._key(pc.entry_id)] = json.dumps(
                    pc.meta or {}
                ).encode()
        err: Optional[BaseException] = None
        try:
            self.journal.cache.put_many(batch)
        except BaseException as exc:
            err = exc
        self.batches += 1
        self.entries += len(drained)
        for pc in drained:
            if err is None:
                for cb in pc.on_durable:
                    try:
                        cb()
                    except Exception:
                        pass  # bookkeeping must not kill the flusher
            for t in pc.tickets:
                t._resolve(err)
