"""``ServingPool`` — the gateway-facing face of the KV pager.

Three integrations turn the pager into a serving subsystem:

  * **eviction routes through the pager** — the gateway's warm-pool LRU
    eviction fires :attr:`Gateway.on_evict`; the pool demotes the evicted
    conversation's KV blocks to the PMEM level (quantized int8 by
    default) instead of letting them squat in DRAM as a dead blob.
  * **KV pressure is observable** — the pool installs a provider so
    :meth:`Gateway.load_snapshot` reports resident/paged session counts;
    the autoscaler sees KV pressure the same way it sees queue
    depth.
  * **admission sheds instead of thrashing** — a new conversation that
    doesn't fit the DRAM block budget first demotes idle
    least-recently-used sessions; when nothing is demotable the
    conversation is shed (:class:`AdmissionError`), never admitted into a
    thrash loop.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from repro_torch.core.gateway import AdmissionError, Gateway
from repro_torch.serving.decode_runtime import PagedDecoder
from repro_torch.serving.kvpager import KVPager

__all__ = ["ServingPool"]


class ServingPool:
    """Session-granular decode serving over a gateway + pager pair.

    One conversation = one gateway session = one pager session (keyed by
    the gateway's scoped session id, so warm-pool evictions and pager
    demotions name the same thing).
    """

    def __init__(
        self,
        gateway: Gateway,
        pager: KVPager,
        decoder: PagedDecoder,
        *,
        app: str = "serve",
        admission: bool = True,
    ) -> None:
        self.gateway = gateway
        self.pager = pager
        self.decoder = decoder
        self.app = app
        self.admission = admission
        self.shed = 0
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()
        gateway.on_evict = self._on_evict
        gateway.set_kv_pressure(
            lambda: (pager.resident_sessions, pager.paged_sessions)
        )

    # -- gateway hooks ------------------------------------------------------
    def _scoped(self, conversation: str) -> str:
        return self.gateway.scoped_session(self.app, conversation)

    def _on_evict(self, fn_name: str, scoped_session: str) -> None:
        """Warm-pool eviction of a decode context: demote, don't drop.
        Runs on the evicting invoker's thread — the pager's per-session
        lock serializes against a concurrent resume."""
        if fn_name != self.decoder.fn.name:
            return
        self.pager.demote(scoped_session)

    # -- admission ----------------------------------------------------------
    def _admit(self, scoped: str) -> None:
        if not self.admission:
            return
        est = self.pager.typical_session_bytes()
        if self.pager.can_admit(est):
            return
        # Make room by demoting idle LRU sessions before giving up.
        for victim in self.pager.lru_hot():
            if victim == scoped or self._busy(victim):
                continue
            self.pager.demote(victim)
            if self.pager.can_admit(est):
                return
        self.shed += 1
        raise AdmissionError(
            f"serving pool: DRAM block budget exhausted "
            f"({self.pager.dram_bytes()}B resident, "
            f"budget {self.pager.dram_budget_bytes}B) — shedding {scoped!r}"
        )

    def _busy(self, scoped: str) -> bool:
        with self._lock:
            return self._inflight.get(scoped, 0) > 0

    def _track(self, scoped: str, future: Any) -> Any:
        with self._lock:
            self._inflight[scoped] = self._inflight.get(scoped, 0) + 1

        def _done(_f: Any) -> None:
            with self._lock:
                self._inflight[scoped] = max(
                    0, self._inflight.get(scoped, 1) - 1
                )

        future.add_done_callback(_done)
        return future

    # -- conversation lifecycle ---------------------------------------------
    def start(self, conversation: str, prompt: Any, **submit_kwargs: Any):
        """Admit a new conversation and run its prefill + first token.
        Returns the gateway Future of the first generated token; raises
        :class:`AdmissionError` (after demoting what it can) when the
        DRAM block budget cannot take one more resident session."""
        scoped = self._scoped(conversation)
        self._admit(scoped)
        fut = self.gateway.submit(
            self.decoder.fn.name, app=self.app, session=conversation,
            init_kwargs={"session": scoped, "prompt": prompt},
            **submit_kwargs,
        )
        return self._track(scoped, fut)

    def step(self, conversation: str, **submit_kwargs: Any):
        """One more decoded token for an admitted conversation.  A cold
        (demoted) conversation demand-faults its blocks back on this
        step — call :meth:`resume` ahead of time to hide that latency."""
        scoped = self._scoped(conversation)
        fut = self.gateway.submit(
            self.decoder.fn.name, app=self.app, session=conversation,
            **submit_kwargs,
        )
        return self._track(scoped, fut)

    def suspend(self, conversation: str) -> bool:
        """Explicitly push a conversation cold: commit + drop its warm
        decode context, then demote its KV blocks."""
        scoped = self._scoped(conversation)
        self.gateway.runtime.evict(
            self.decoder.fn.name, scoped, commit=True, demote=True
        )
        return self.pager.demote(scoped)

    def resume(self, conversation: str,
               prefetch: Optional[bool] = None) -> bool:
        """Promotion-on-resume: re-pin the conversation's blocks and
        start pulling them back to DRAM in the background, ahead of the
        next :meth:`step`."""
        return self.pager.resume(self._scoped(conversation),
                                 prefetch=prefetch)

    def is_resident(self, conversation: str) -> bool:
        return self.pager.is_hot(self._scoped(conversation))

    def drop(self, conversation: str) -> None:
        scoped = self._scoped(conversation)
        self.gateway.runtime.evict(
            self.decoder.fn.name, scoped, commit=False, demote=False
        )
        self.pager.drop(scoped)

    # -- introspection ------------------------------------------------------
    def conversations(self) -> List[str]:
        prefix = "" if self.app == "default" else f"{self.app}::"
        return [
            s[len(prefix):] for s in self.pager.sessions
            if s.startswith(prefix)
        ]

    def stats(self) -> Dict[str, int]:
        out = dict(self.pager.stats.as_dict())
        out["resident_sessions"] = self.pager.resident_sessions
        out["paged_sessions"] = self.pager.paged_sessions
        out["dram_bytes"] = self.pager.dram_bytes()
        out["shed"] = self.shed
        return out
