"""Autoscaler policy loop over gateway observables.

The paper's elasticity story ("invokers come and go, state survives in
PMEM") only matters if *something* decides when invokers come and go.
This module is that something: a small, deterministic control loop that
samples each gateway's cheap :meth:`~repro_torch.core.gateway.Gateway.load_snapshot`
on a control interval and drives the existing actuators —

========================  =================================================
observable                actuator
========================  =================================================
queue depth / inflight    :meth:`Gateway.scale_to` (invoker pool size)
invoker count             ``Gateway.warm_pool`` (capacity tracks the pool)
fleet saturation          ``add_node`` callback (cluster join + lazy
                          session migration, the re-homing path)
idle node                 ``remove_node`` callback (drain, ship state,
                          leave the ring)
========================  =================================================

Design points:

* **Tick-driven, not threaded.**  :meth:`Autoscaler.maybe_tick` is
  pumped by the caller (the replay loop's ``tick`` hook) with the
  current time; a tick fires only when a control interval has elapsed.
  No background thread, no nondeterministic sampling.
* **Pure decision core.**  :meth:`PolicyController.decide` maps an
  observation to a target invoker count with no side effects, so the
  property tests can drive it with arbitrary traffic and assert bounds
  and convergence without building a gateway.
* **Hysteresis.**  Scale-up is demand-proportional (one tick reaches
  ``ceil(demand / target_per_invoker)``); scale-down sheds one invoker
  at a time, only when the queue is empty and demand fits comfortably
  in the smaller pool, and only after ``down_cooldown_s`` — a step
  load converges without oscillating.
* **Node safety.**  :func:`pick_removal_candidate` never nominates a
  node with inflight or queued work, never the protected anchor node,
  and the router's ``remove_node`` independently re-checks — belt and
  braces around in-flight state.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Union

from repro_torch.core.gateway import Gateway, LoadSnapshot

__all__ = [
    "Autoscaler",
    "PolicyController",
    "PolicySpec",
    "pick_removal_candidate",
]


@dataclass(frozen=True)
class PolicySpec:
    """Tuning knobs for the control loop.

    ``target_per_invoker`` is the demand (queued + inflight requests)
    one invoker is expected to absorb; the up rule scales the pool to
    ``ceil(demand / target_per_invoker)`` whenever the backlog alone
    exceeds the pool's target.  ``max_nodes=None`` disables the node
    actuators even when callbacks are wired.
    """

    min_invokers: int = 1
    max_invokers: int = 8
    target_per_invoker: int = 4
    up_cooldown_s: float = 0.0
    down_cooldown_s: float = 1.0
    warm_pool_per_invoker: Optional[int] = None
    min_nodes: int = 1
    max_nodes: Optional[int] = None
    node_up_patience: int = 3
    node_down_patience: int = 10
    protected_nodes: tuple = ("n0",)

    def clamp(self, n: int) -> int:
        return max(self.min_invokers, min(self.max_invokers, n))


class PolicyController:
    """Per-gateway decision state: cooldown clocks around a pure rule."""

    def __init__(self, spec: PolicySpec) -> None:
        self.spec = spec
        self._last_up = -math.inf
        self._last_down = -math.inf

    def decide(self, snap: LoadSnapshot, invokers: int, now: float) -> int:
        """Target invoker count for one gateway — no side effects.

        Up: the queue alone exceeds what the current pool should carry.
        Down: queue empty *and* total demand fits in half the shrunken
        pool's capacity.  Both respect their cooldowns; anything else
        holds steady.
        """
        spec = self.spec
        demand = snap.queue_depth + snap.inflight
        if (
            snap.queue_depth > spec.target_per_invoker * invokers
            and now - self._last_up >= spec.up_cooldown_s
        ):
            want = math.ceil(demand / max(1, spec.target_per_invoker))
            return spec.clamp(max(invokers + 1, want))
        if (
            snap.queue_depth == 0
            and invokers > spec.min_invokers
            and demand * 2 <= spec.target_per_invoker * (invokers - 1)
            and now - self._last_down >= spec.down_cooldown_s
        ):
            return spec.clamp(invokers - 1)
        return invokers

    def note_action(self, now: float, scaled_up: bool) -> None:
        if scaled_up:
            self._last_up = now
        # Any resize resets the down clock: shrink one step per window.
        self._last_down = now


def pick_removal_candidate(
    snapshots: Mapping[str, LoadSnapshot],
    protected: Iterable[str] = ("n0",),
) -> Optional[str]:
    """The node safest to retire, or ``None``.

    Only nodes with zero inflight *and* zero queued work qualify;
    protected nodes (the client's anchor ``n0``) never do.  Among
    qualifiers, the highest node id wins — nodes leave in the reverse
    of join order, which keeps ring churn minimal.
    """
    blocked = set(protected)
    idle = [
        nid
        for nid, snap in snapshots.items()
        if nid not in blocked and snap.inflight == 0 and snap.queue_depth == 0
    ]
    return max(idle) if idle else None


GatewayMap = Union[Mapping[str, Gateway], Callable[[], Mapping[str, Gateway]]]


@dataclass
class _NodeChurn:
    """Consecutive-tick counters behind the node actuators."""

    hot_ticks: int = 0
    idle_ticks: Dict[str, int] = field(default_factory=dict)


class Autoscaler:
    """The policy loop: snapshot every gateway, decide, actuate, log.

    ``gateways`` is a mapping (static fleet) or a zero-arg callable
    returning one (live cluster membership).  ``add_node`` /
    ``remove_node`` are optional callbacks — on a sharded client wire
    them to :meth:`MarvelClient.add_node` / :meth:`remove_node`; they
    fire only when ``spec.max_nodes`` is set.

    Every actuation lands in :attr:`actions` with its tick time, so a
    benchmark can report ``scale_actions`` and audit churn.
    """

    def __init__(
        self,
        gateways: GatewayMap,
        spec: Optional[PolicySpec] = None,
        *,
        interval_s: float = 0.1,
        add_node: Optional[Callable[[], str]] = None,
        remove_node: Optional[Callable[[str], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.spec = spec or PolicySpec()
        self.interval_s = interval_s
        self._gateways = gateways if callable(gateways) else (lambda: gateways)
        self._add_node = add_node
        self._remove_node = remove_node
        self._clock = clock
        self._controllers: Dict[str, PolicyController] = {}
        self._churn = _NodeChurn()
        self._last_tick = -math.inf
        self.actions: List[Dict[str, Any]] = []
        self.ticks = 0
        self.peak_invokers = 0
        self.peak_nodes = 0

    # -- bookkeeping ----------------------------------------------------

    @property
    def scale_actions(self) -> int:
        return len(self.actions)

    def _log(self, now: float, kind: str, **detail: Any) -> None:
        self.actions.append({"t": round(now, 4), "kind": kind, **detail})

    # -- the loop -------------------------------------------------------

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Run one control tick if an interval has elapsed."""
        if now is None:
            now = self._clock()
        if now - self._last_tick < self.interval_s:
            return False
        self._last_tick = now
        self.tick(now)
        return True

    def tick(self, now: float) -> None:
        spec = self.spec
        gws = dict(self._gateways())
        snaps = {nid: gw.load_snapshot() for nid, gw in gws.items()}
        self.ticks += 1
        total_invokers = 0
        fleet_maxed = bool(gws)
        for nid in sorted(gws):
            gw, snap = gws[nid], snaps[nid]
            ctl = self._controllers.setdefault(nid, PolicyController(spec))
            invokers = max(1, snap.invokers)
            target = ctl.decide(snap, invokers, now)
            if target != invokers:
                gw.scale_to(target)
                if spec.warm_pool_per_invoker is not None:
                    gw.warm_pool = max(1, target * spec.warm_pool_per_invoker)
                ctl.note_action(now, scaled_up=target > invokers)
                self._log(
                    now,
                    "scale_up" if target > invokers else "scale_down",
                    node=nid,
                    invokers=(invokers, target),
                    queue=snap.queue_depth,
                    inflight=snap.inflight,
                )
            total_invokers += target
            if target < spec.max_invokers or snap.queue_depth == 0:
                fleet_maxed = False
        self.peak_invokers = max(self.peak_invokers, total_invokers)
        self.peak_nodes = max(self.peak_nodes, len(gws))
        if spec.max_nodes is not None:
            self._node_actuators(now, gws, snaps, fleet_maxed)

    def _node_actuators(
        self,
        now: float,
        gws: Mapping[str, Gateway],
        snaps: Mapping[str, LoadSnapshot],
        fleet_maxed: bool,
    ) -> None:
        spec = self.spec
        churn = self._churn
        # Join: every gateway pinned at max with a standing queue.
        if fleet_maxed and self._add_node is not None and len(gws) < spec.max_nodes:
            churn.hot_ticks += 1
            if churn.hot_ticks >= spec.node_up_patience:
                churn.hot_ticks = 0
                node_id = self._add_node()
                self._log(now, "add_node", node=node_id, nodes=len(gws) + 1)
                self.peak_nodes = max(self.peak_nodes, len(gws) + 1)
        else:
            churn.hot_ticks = 0
        # Leave: one candidate, idle for node_down_patience straight ticks.
        if self._remove_node is None or len(gws) <= spec.min_nodes:
            churn.idle_ticks.clear()
            return
        candidate = pick_removal_candidate(snaps, spec.protected_nodes)
        for nid in list(churn.idle_ticks):
            if nid != candidate:
                del churn.idle_ticks[nid]
        if candidate is None:
            return
        churn.idle_ticks[candidate] = churn.idle_ticks.get(candidate, 0) + 1
        if churn.idle_ticks[candidate] < spec.node_down_patience:
            return
        del churn.idle_ticks[candidate]
        try:
            self._remove_node(candidate)
        except RuntimeError as exc:
            # Router re-checked and found in-flight work: stand down.
            self._log(now, "remove_node_refused", node=candidate, error=str(exc))
            return
        self._controllers.pop(candidate, None)
        self._log(now, "remove_node", node=candidate, nodes=len(gws) - 1)


def _spec_with(spec: Optional[PolicySpec], **overrides: Any) -> PolicySpec:
    """Helper for façades: spec-or-default plus keyword overrides."""
    base = spec or PolicySpec()
    return replace(base, **overrides) if overrides else base
