"""Stateful function execution — Marvel's contribution (1), functionally.

OpenWhisk actions are stateless; Marvel makes them stateful by giving every
action access to a shared in-memory state tier (Ignite) keyed by
application/session, with durable spill to PMEM.

Step functions are pure, so statefulness lives in the *runtime*:

  * a :class:`StatefulFunction` declares named state slots; its pure step
    is ``(state, **inputs) -> (state, outputs)``,
  * the :class:`FunctionRuntime` owns the authoritative state in a
    :class:`StateCache` (DRAM tier, optional PMEM write-through) and keeps
    a device-resident *hot view* so repeated invocations don't round-trip
    through host memory — this is exactly the Ignite-vs-S3 distinction the
    paper measures,
  * sessions namespace state per application instance (a training run, a
    serving conversation, a MapReduce job).

Failure semantics: ``runtime.crash()`` drops device + DRAM state; if the
cache has write-through (the PMEM variant) the session resumes from the
last committed state, otherwise it's lost — reproducing the paper's
argument for persistent-memory-backed state.

Thread-safety & the warm fast path (DESIGN.md §10): each ``(function,
session)`` owns a :class:`_StateSlot` carrying its own re-entrant lock,
hot state, version stamps, and a :class:`~repro_torch.storage.serde.
VersionedCodec`.  A warm invocation touches *only* its slot — the global
runtime lock guards slot/session **registration** (cold starts) and
nothing on the steady-state path.  Lock order: gateway stripe lock
strictly outside the slot lock, slot lock strictly outside the runtime
registration lock, never inverted.

Dirty tracking is by object identity: a step that returns the same state
object it received (including a clean :class:`~repro_torch.storage.serde.
CowState`) did not mutate, so its commit is elided — no re-serialization,
no tier write, no journal marker.  Steps must therefore never mutate
state in place (they are declared pure; return a new tree — or use
``cow=True`` — when changing state).

With ``group_commit=True`` the runtime owns a :class:`~repro_torch.core.
journal.GroupCommitter`: invocations dispatched with
``defer_commit=True`` enqueue their (blob, marker) pair and return a
:class:`~repro_torch.core.journal.CommitTicket` on the record instead of
blocking on tier I/O; concurrent sessions' commits coalesce into one
batched ``put_many``.  Synchronous entry points (``commit``, ``evict``,
``commit_all``) still block until durable — they ride the committer too
so flush ordering is preserved — and the sequential no-committer path
performs the byte-for-byte identical put(blob)+put(marker) sequence the
crash/recovery matrix pins down.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.journal import CommitTicket, GroupCommitter, StateJournal
from repro_torch.storage import serde
from repro_torch.storage.kvcache import StateCache

__all__ = ["StatefulFunction", "FunctionRuntime", "Session", "InvocationRecord"]


@dataclass
class StatefulFunction:
    """A named, stateful serverless function.

    ``step`` must be pure: ``(state, **inputs) -> (new_state, outputs)``.
    ``init`` builds the initial state pytree from kwargs.

    ``cow=True`` hands the step a :class:`~repro_torch.storage.serde.CowState`
    copy-on-write handle over dict-shaped state, so imperative bodies
    (``state["n"] += 1``) stay pure from the runtime's point of view and
    read-only invocations keep the no-mutation identity the commit
    elision fast path keys on.  Copy-on-write is host-side only: as in
    the reference package, it requires ``jit=False``.

    The port runs every step eagerly: ``jit`` is kept so configurations
    mean the same in both packages, and the step itself is what
    :meth:`compiled_step` hands out.
    """

    name: str
    step: Callable[..., Tuple[Any, Any]]
    init: Callable[..., Any]
    #: a traceable step (the reference jits it; the port runs it eagerly).
    jit: bool = True
    #: wrap state in a CowState handle before the step (requires jit=False).
    cow: bool = False
    _compiled: Optional[Callable] = None

    def __post_init__(self) -> None:
        if self.cow and self.jit:
            raise ValueError(
                f"function {self.name!r}: cow=True requires jit=False "
                "(a CowState handle cannot cross the jit boundary)"
            )

    def compiled_step(self) -> Callable:
        if self._compiled is None:
            self._compiled = self.step  # eager: nothing to trace
        return self._compiled

    def drop_compiled(self) -> None:
        """Forget the prepared step (a fully-cold start prepares it again)."""
        self._compiled = None


@dataclass
class InvocationRecord:
    function: str
    session: str
    #: per-session invocation sequence (recovery replays one session's
    #: invocations in this order; sessions are mutually independent).
    seq: int
    wall_seconds: float
    cold: bool
    #: hot (device/DRAM view) hit — False means the state was re-loaded
    #: from the cache tier (a warm-pool miss / post-eviction reload).
    warm: bool = True
    #: invoker worker that executed this invocation ("" = direct call).
    invoker: str = ""
    #: pending group commit this invocation's durability rides on (None =
    #: committed synchronously, elided, or below the commit cadence).
    commit_ticket: Optional[CommitTicket] = field(
        default=None, repr=False, compare=False
    )


class Session:
    """Per-application state namespace (an OpenWhisk activation chain).

    Owns the per-session invocation sequence.  After a crash the runtime
    rebuilds a session from the :class:`StateJournal`, resuming ``seq``
    from the last committed invocation so recovery ordering stays
    per-session (not position in the global log).

    When the session was obtained from a :class:`~repro_torch.core.gateway.
    Gateway`, ``invoke`` routes through the gateway (FIFO lane, lease,
    warm pool, admission control) instead of calling the runtime inline.
    """

    def __init__(self, runtime: "FunctionRuntime", session_id: str,
                 seq: int = 0) -> None:
        self.runtime = runtime
        self.session_id = session_id
        self.seq = seq
        self._seq_lock = threading.Lock()
        #: set by ``Gateway.session()`` — submits invocations via the
        #: gateway so multi-tenant routing policies apply.
        self._route: Optional[Callable[..., Any]] = None

    def next_seq(self) -> int:
        with self._seq_lock:
            seq = self.seq
            self.seq += 1
            return seq

    def invoke(self, fn_name: str, **inputs: Any) -> Any:
        if self._route is not None:
            return self._route(fn_name, **inputs)
        return self.runtime.invoke(fn_name, session=self.session_id, **inputs)


class _StateSlot:
    """Everything one (function, session) owns: its hot state, version
    stamps, serde memo, and the lock that linearizes its transitions.

    ``version`` is a globally unique stamp of the current state object
    (drawn from the runtime's monotonic clock on every mutation);
    ``committed_version`` is the stamp the durable cache blob reflects.
    ``version == committed_version`` ⇔ clean ⇔ a commit is elided.
    ``pending`` counts invocations since the last commit attempt (the
    ``commit_every`` cadence); ``lazy`` counts elided (read-only)
    invocations for the fig7b contention benchmark.
    """

    __slots__ = ("lock", "state", "present", "version", "committed_version",
                 "pending", "lazy", "codec", "last_seq")

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.state: Any = None
        self.present = False
        self.version = 0
        self.committed_version = 0
        self.pending = 0
        self.lazy = 0
        self.codec = serde.VersionedCodec()
        self.last_seq: Optional[int] = None


class FunctionRuntime:
    """Executes stateful functions against the tiered state store.

    ``commit_every`` controls how often hot state is serialized into the
    cache (and thus to PMEM when the cache has write-through) — the knob
    trading I/O overhead against recovery freshness, which is the paper's
    central trade.  ``group_commit=True`` starts a
    :class:`~repro_torch.core.journal.GroupCommitter` so gateway-dispatched
    invocations batch their commits (call :meth:`close` to drain it).
    """

    def __init__(
        self,
        cache: Optional[StateCache] = None,
        commit_every: int = 1,
        group_commit: bool = False,
        flush_interval: float = 0.0,
    ) -> None:
        self.cache = cache if cache is not None else StateCache()
        self.commit_every = max(1, commit_every)
        self.functions: Dict[str, StatefulFunction] = {}
        self.log: list[InvocationRecord] = []
        #: same journal abstraction the MapReduce engine uses — commit
        #: markers ride the cache (durable iff the cache write-throughs).
        self.journal = StateJournal(self.cache, "fn")
        self.group_commit = group_commit
        self._committer: Optional[GroupCommitter] = (
            GroupCommitter(self.journal, flush_interval=flush_interval)
            if group_commit else None
        )
        self._sessions: Dict[str, Session] = {}
        self._slots: Dict[Tuple[str, str], _StateSlot] = {}
        #: monotonic state-version stamps, unique across all slots so a
        #: stamp can never alias a different value (StateCache's
        #: ``put_versioned`` memo relies on this).
        self._version_clock = itertools.count(1)
        #: registration lock only (functions / sessions / slot creation);
        #: the warm invoke path never takes it.
        self._lock = threading.RLock()

    # -- registry -----------------------------------------------------------
    def register(self, fn: StatefulFunction) -> StatefulFunction:
        with self._lock:
            self.functions[fn.name] = fn
        return fn

    def function(self, name: str, init: Callable[..., Any], jit: bool = True):
        """Decorator: ``@rt.function("f", init=...)`` over the step fn."""

        def deco(step: Callable[..., Tuple[Any, Any]]) -> StatefulFunction:
            return self.register(StatefulFunction(name, step, init, jit=jit))

        return deco

    # -- sessions -----------------------------------------------------------
    def session(self, session_id: str) -> Session:
        """The per-session namespace; rebuilt from the journal after a
        crash so ``seq`` resumes from the last *committed* invocation."""
        sess = self._sessions.get(session_id)  # GIL-atomic warm path
        if sess is not None:
            return sess
        # Journal scan (tier I/O) outside the runtime lock — a cold
        # session must not stall every other invoker.  Concurrent first
        # touches may both scan; setdefault keeps exactly one Session.
        committed = self.journal.entries(prefix=f"{session_id}/")
        seq = max(
            (m.get("seq", -1) + 1 for m in committed.values()), default=0
        )
        with self._lock:
            return self._sessions.setdefault(
                session_id, Session(self, session_id, seq=seq)
            )

    # -- state plumbing -------------------------------------------------------
    def _state_key(self, fn_name: str, session: str) -> str:
        return f"state/{session}/{fn_name}"

    def _slot(self, hot_key: Tuple[str, str]) -> _StateSlot:
        slot = self._slots.get(hot_key)  # GIL-atomic warm path
        if slot is not None:
            return slot
        with self._lock:
            return self._slots.setdefault(hot_key, _StateSlot())

    #: read-only compatibility view of the hot (fn, session) states.
    @property
    def hot_state(self) -> Dict[Tuple[str, str], Any]:
        return {
            k: s.state for k, s in list(self._slots.items()) if s.present
        }

    @property
    def lazy_hits(self) -> int:
        """Invocations whose commit was elided because the step returned
        the identical state object (the serde fast path's hit counter)."""
        return sum(s.lazy for s in list(self._slots.values()))

    @property
    def commit_batches(self) -> int:
        """Group-commit flush rounds that performed tier I/O (0 when the
        runtime commits synchronously)."""
        return self._committer.batches if self._committer is not None else 0

    @property
    def commit_entries(self) -> int:
        """Coalesced (blob, marker) pairs flushed by the group committer
        (0 when the runtime commits synchronously)."""
        return self._committer.entries if self._committer is not None else 0

    def _load_state(
        self, fn: StatefulFunction, slot: _StateSlot, session: str,
        init_kwargs: dict,
    ) -> Tuple[Any, bool, bool]:
        """Returns ``(state, cold, warm)`` — ``warm`` is a hot-view hit;
        ``cold`` means the state was created from ``init`` just now.
        Caller must hold the slot lock."""
        if slot.present:
            return slot.state, False, True
        key = self._state_key(fn.name, session)
        if self.cache.contains(key):  # warm-from-cache (recovery or eviction)
            data = self.cache.get(key)
            state = serde.loads(data)
            slot.state = state
            slot.present = True
            v = next(self._version_clock)
            slot.version = v
            slot.committed_version = v  # the blob *is* this state
            slot.codec.prime(data, v)  # dumps(loads(b)) == b round-trip
            return state, False, False
        state = fn.init(**init_kwargs)  # cold start
        slot.state = state
        slot.present = True
        slot.version = next(self._version_clock)  # committed stays behind
        return state, True, False

    def commit(self, fn_name: str, session: str) -> None:
        """Serialize hot state into the cache (durable if write-through).

        The state blob and its journal marker (which per-session ``seq``
        the blob reflects) commit together, so recovery knows exactly how
        far each session got.  A clean slot (state identical to the
        durable blob) is a no-op; with a group committer the commit rides
        the batch queue and blocks until its flush lands.
        """
        slot = self._slots.get((fn_name, session))
        if slot is None:
            return
        with slot.lock:
            self._commit_locked(fn_name, session, slot, defer=False)

    def _commit_locked(
        self, fn_name: str, session: str, slot: _StateSlot,
        defer: bool = False,
    ) -> Optional[CommitTicket]:
        """Commit one slot; caller holds the slot lock.  Returns the
        pending :class:`CommitTicket` when ``defer`` and a group
        committer is active (None once durable / elided)."""
        slot.pending = 0
        if not slot.present or slot.version == slot.committed_version:
            return None  # nothing new to make durable — elide entirely
        data = slot.codec.encode(slot.state, slot.version)
        key = self._state_key(fn_name, session)
        v = slot.version
        last = slot.last_seq
        if self._committer is not None:
            def on_durable() -> None:
                # Lock-free monotonic raise (the flusher thread must not
                # block on a slot lock a waiting evictor holds); a stale
                # read can only leave the stamp low, which at worst costs
                # one redundant re-commit, never a lost write.
                if v > slot.committed_version:
                    slot.committed_version = v

            ticket = self._committer.enqueue(
                key, data,
                entry_id=f"{session}/{fn_name}" if last is not None else None,
                meta={"seq": last} if last is not None else None,
                on_durable=on_durable,
            )
            if defer:
                return ticket
            ticket.wait()
            return None
        # Sequential path: identical op sequence to unbatched commits —
        # put(blob) then put(marker), marker strictly after its blob.
        self.cache.put_versioned(key, data, v)
        if last is not None:
            # Stamp the seq this fn's state actually reflects (its own last
            # invocation) — not the session-wide counter, which may include
            # later invocations of *other* functions whose state is not yet
            # durable.
            self.journal.commit(f"{session}/{fn_name}", {"seq": last})
        slot.committed_version = v
        return None

    def commit_all(self) -> None:
        for fn_name, session in list(self._slots.keys()):
            self.commit(fn_name, session)
        if self._committer is not None:
            self._committer.flush()

    def evict(
        self, fn_name: str, session: str, commit: bool = True,
        demote: bool = False,
    ) -> bool:
        """Drop a warm context (hot state) — the gateway's LRU spill.

        Dirty state is committed to the cache first (never silently
        dropped), so a later invocation warm-loads the exact same state
        from the DRAM/PMEM tier.  With ``demote=True`` the committed
        state blob is additionally pushed out of the cache's fast tier
        (:meth:`StateCache.demote`) — an evicted-cold session should not
        keep occupying DRAM that hot sessions want.  Returns True if a
        context was evicted.
        """
        slot = self._slots.get((fn_name, session))
        if slot is None:
            return False
        with slot.lock:
            if not slot.present:
                return False
            if commit and slot.version != slot.committed_version:
                self._commit_locked(fn_name, session, slot, defer=False)
            slot.state = None
            slot.present = False
            if demote:
                self.cache.demote(self._state_key(fn_name, session))
        return True

    # -- invoke -----------------------------------------------------------
    def invoke(
        self,
        fn_name: str,
        session: str = "default",
        init_kwargs: Optional[dict] = None,
        **inputs: Any,
    ) -> Any:
        """Invoke a stateful function; state is read/updated transparently."""
        outputs, _ = self.invoke_with_record(
            fn_name, session=session, init_kwargs=init_kwargs, **inputs
        )
        return outputs

    def invoke_with_record(
        self,
        fn_name: str,
        session: str = "default",
        init_kwargs: Optional[dict] = None,
        invoker: str = "",
        defer_commit: bool = False,
        **inputs: Any,
    ) -> Tuple[Any, InvocationRecord]:
        """Like :meth:`invoke`, also returning this call's
        :class:`InvocationRecord` (the gateway reads warm/cold — and the
        pending group-commit ticket — off it; scanning ``log`` would race
        other invokers).  With ``defer_commit=True`` and a group-commit
        runtime, a due commit is enqueued instead of awaited and the
        record carries its ticket."""
        fn = self.functions[fn_name]
        t0 = time.perf_counter()
        sess = self._sessions.get(session)
        if sess is None:
            sess = self.session(session)
        slot = self._slot((fn.name, session))
        ticket: Optional[CommitTicket] = None
        # The slot lock serializes invoke/commit/evict per (fn, session):
        # state transitions are linearizable per slot, while other
        # sessions (other slots) execute fully in parallel — the warm
        # path touches no global lock.
        with slot.lock:
            state, cold, warm = self._load_state(
                fn, slot, session, init_kwargs or {}
            )
            step_state = serde.CowState(state) if fn.cow else state
            new_state, outputs = fn.compiled_step()(step_state, **inputs)
            if fn.cow and isinstance(new_state, serde.CowState):
                new_state = new_state.collapse()
            seq = sess.next_seq()
            slot.last_seq = seq
            if new_state is not state:
                slot.state = new_state
                slot.version = next(self._version_clock)
            else:
                slot.lazy += 1  # identity ⇒ read-only ⇒ commit elidable
            slot.pending += 1
            if slot.pending >= self.commit_every:
                ticket = self._commit_locked(
                    fn.name, session, slot, defer=defer_commit
                )
            record = InvocationRecord(
                fn.name, session, seq, time.perf_counter() - t0, cold,
                warm=warm, invoker=invoker, commit_ticket=ticket,
            )
            self.log.append(record)  # list.append is GIL-atomic
        return outputs, record

    def invoke_batch_with_records(
        self,
        fn_name: str,
        session: str,
        requests: List[Tuple[Optional[dict], dict]],
        invoker: str = "",
    ) -> List[Tuple[Any, Optional[InvocationRecord],
                    Optional[BaseException]]]:
        """Run several queued invocations of one session back-to-back
        under a single slot-lock hold, committing **once** at the end —
        the lane-lease generalization of the group commit.  The
        committer's latest-wins coalescing already guarantees that only
        the final blob of a flush round reaches the tier; executing the
        whole run before encoding means the intermediate states are
        never serialized at all.

        ``requests`` is ``[(init_kwargs, inputs), ...]`` in FIFO order.
        Returns one ``(outputs, record, error)`` triple per request: a
        failed step leaves the state untouched (``record`` is None, the
        error is captured, later requests still run) — identical
        semantics to invoking each request sequentially.  Every
        successful record carries the shared batch-final commit ticket.

        Callers must only batch when ``commit_every == 1`` (the gateway's
        guard): with a larger cadence, a mid-batch threshold crossing
        would commit at a different point than sequential execution.
        """
        fn = self.functions[fn_name]
        sess = self._sessions.get(session)
        if sess is None:
            sess = self.session(session)
        slot = self._slot((fn.name, session))
        results: List[
            Tuple[Any, Optional[InvocationRecord], Optional[BaseException]]
        ] = []
        records: List[InvocationRecord] = []
        with slot.lock:
            for init_kwargs, inputs in requests:
                t0 = time.perf_counter()
                try:
                    state, cold, warm = self._load_state(
                        fn, slot, session, init_kwargs or {}
                    )
                    step_state = (
                        serde.CowState(state) if fn.cow else state
                    )
                    new_state, outputs = fn.compiled_step()(
                        step_state, **inputs
                    )
                    if fn.cow and isinstance(new_state, serde.CowState):
                        new_state = new_state.collapse()
                except Exception as exc:
                    results.append((None, None, exc))
                    continue
                seq = sess.next_seq()
                slot.last_seq = seq
                if new_state is not state:
                    slot.state = new_state
                    slot.version = next(self._version_clock)
                else:
                    slot.lazy += 1
                slot.pending += 1
                record = InvocationRecord(
                    fn.name, session, seq, time.perf_counter() - t0,
                    cold, warm=warm, invoker=invoker,
                )
                records.append(record)
                results.append((outputs, record, None))
            ticket: Optional[CommitTicket] = None
            if slot.pending >= self.commit_every:
                ticket = self._commit_locked(
                    fn.name, session, slot, defer=True
                )
            if ticket is not None:
                for record in records:
                    record.commit_ticket = ticket
            for record in records:
                self.log.append(record)
        return results

    def peek_state(self, fn_name: str, session: str = "default") -> Any:
        slot = self._slots.get((fn_name, session))
        return slot.state if slot is not None and slot.present else None

    def state_bytes(
        self, fn_name: str, session: str = "default"
    ) -> Optional[bytes]:
        """Canonical serialized bytes of this slot's current state: the
        hot view if present, else the committed cache blob, else None.
        Byte-identity checks on loop-carried session state (the iterative
        dataflow engine, the crash/recovery matrix) ride this instead of
        reaching into ``hot_state``/``cache`` separately."""
        slot = self._slots.get((fn_name, session))
        if slot is not None:
            with slot.lock:
                if slot.present:
                    return slot.codec.encode(slot.state, slot.version)
        key = self._state_key(fn_name, session)
        if self.cache.contains(key):
            return self.cache.get(key)
        return None

    def reset_state(self, fn_name: str, session: str = "default") -> None:
        """Drop a slot's state everywhere — hot view *and* cache blob —
        so the next invocation cold-starts from ``init``.  An iterative
        loop resuming from its own journal uses this to re-seed a
        session whose cached state is stale (from an older superstep)
        rather than warm-loading the wrong bytes."""
        slot = self._slots.get((fn_name, session))
        if slot is not None:
            with slot.lock:
                slot.state = None
                slot.present = False
                slot.pending = 0
                slot.version = 0
                slot.committed_version = 0
                slot.codec.invalidate()
                self.cache.delete(self._state_key(fn_name, session))
        else:
            self.cache.delete(self._state_key(fn_name, session))

    def state_report(self, fn_name: str, session: str = "default") -> str:
        """Where this slot's state currently lives:

        * ``"hot"``  — device/DRAM view in this process,
        * ``"warm"`` — recoverable from the cache tier (commit survived),
        * ``"lost"`` — gone; the next invocation cold-starts (the paper's
          stock-serverless failure mode).
        """
        slot = self._slots.get((fn_name, session))
        if slot is not None and slot.present:
            return "hot"
        if self.cache.contains(self._state_key(fn_name, session)):
            return "warm"
        return "lost"

    # -- failure/recovery -----------------------------------------------------
    def crash(self) -> None:
        """Lose device + DRAM state (node failure). PMEM tier survives.
        Group commits still queued (not yet flushed) were volatile too —
        they are dropped and their tickets fail."""
        with self._lock:
            self._slots.clear()
            self._sessions.clear()  # rebuilt from the journal on next use
        if self._committer is not None:
            self._committer.drop_pending(
                RuntimeError("node crashed before the group commit flushed")
            )
        self.cache.crash()

    def recover(self) -> int:
        """Repopulate the DRAM tier from write-through storage."""
        return self.cache.recover()

    def close(self) -> None:
        """Drain and stop the group committer (no-op without one)."""
        if self._committer is not None:
            self._committer.close(flush=True)
