"""Provider Groups: N compatible providers behind one logical bind target.

The paper's broker binds each task to a single concrete provider.  At
multi-tenant scale the natural unit is a *pool* of equivalent providers
(e.g. four regional CaaS endpoints of the same cloud): the binding policy
should see ONE logical name, while the broker balances load across members,
tracks per-member health with a circuit breaker, and transparently fails
work over when a member dies (see docs/ARCHITECTURE.md for where the group
layer slots into the submit path, and EXPERIMENTS.md §Perf for measured
failover overhead).

Semantics:

  * A group aggregates registered providers of the SAME platform (cloud or
    hpc).  The group exposes a synthetic ``spec`` whose capacity is the
    element-wise max over members, so eligibility checks
    (``Policy._eligible``) work unchanged on groups.
  * Policies bind tasks to the group *name*; the member is resolved at
    dispatch time by the group's balancing strategy.  ``Task.group`` records
    the logical binding, ``Task.provider`` the concrete member.
  * Each member carries a ``CircuitBreaker`` (fault.py).  ``ProviderDown``
    trips it immediately; ordinary task failures open it after
    ``failure_threshold`` consecutive errors; a timed half-open probe closes
    it again once the member recovers.
  * When every member's breaker is open the group raises
    ``GroupExhausted`` (a ``ProviderDown`` subtype), and the broker falls
    back to its normal cross-provider re-binding.

Strategies (pluggable, mirroring POLICIES in policy.py):

  round_robin   - cycle through available members.
  least_loaded  - member with the fewest outstanding tasks.
  weighted      - capacity-proportional: argmin outstanding/weight, weight =
                  member cpu+accel capacity (bigger pools absorb more load).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.fault import BreakerState, CircuitBreaker
from repro_torch.core.managers.compute import ProviderDown
from repro_torch.core.provider import ProviderHandle, ProviderSpec, ValidationError
from repro_torch.core.task import Resources
from repro_torch.runtime.tracing import Trace


class GroupExhausted(ProviderDown):
    """Every member breaker is open: the logical provider is down."""


@dataclass
class GroupMember:
    """One provider inside a group: identity + weight + health + load."""

    name: str
    weight: float = 1.0
    slots: int = 1  # concurrent task slots (spec concurrency x nodes)
    breaker: CircuitBreaker = field(default_factory=CircuitBreaker)
    outstanding: int = 0  # tasks dispatched, not yet completed/failed
    dispatched: int = 0
    completed: int = 0
    failed: int = 0


# ---------------------------------------------------------------------------
# Balancing strategies
# ---------------------------------------------------------------------------


class GroupStrategy:
    name = "base"

    def pick(self, members: list[GroupMember]) -> GroupMember:
        raise NotImplementedError


class RoundRobinStrategy(GroupStrategy):
    name = "round_robin"

    def __init__(self):
        self._n = 0

    def pick(self, members: list[GroupMember]) -> GroupMember:
        choice = members[self._n % len(members)]
        self._n += 1
        return choice


class LeastLoadedStrategy(GroupStrategy):
    name = "least_loaded"

    def pick(self, members: list[GroupMember]) -> GroupMember:
        return min(members, key=lambda m: (m.outstanding, m.dispatched))


class WeightedStrategy(GroupStrategy):
    """Capacity-proportional: fill members so load/weight stays balanced."""

    name = "weighted"

    def pick(self, members: list[GroupMember]) -> GroupMember:
        return min(members, key=lambda m: (m.outstanding + 1) / max(m.weight, 1e-9))


STRATEGIES = {
    s.name: s for s in (RoundRobinStrategy, LeastLoadedStrategy, WeightedStrategy)
}


def make_strategy(name: str) -> GroupStrategy:
    try:
        return STRATEGIES[name]()
    except KeyError:
        raise ValidationError(
            f"unknown group strategy {name!r}; choose from {sorted(STRATEGIES)}"
        ) from None


# ---------------------------------------------------------------------------
# The group
# ---------------------------------------------------------------------------


class ProviderGroup:
    """A load-balanced, failover-aware pool of providers.

    Duck-types the slice of ``ProviderHandle`` that binding policies use
    (``.name`` and ``.spec.capacity()``), so a group can stand anywhere a
    provider can in the bind path.
    """

    def __init__(
        self,
        name: str,
        handles: list[ProviderHandle],
        strategy: str = "round_robin",
        failure_threshold: int = 3,
        reset_timeout_s: float = 30.0,
        min_healthy: int = 1,
    ):
        if not handles:
            raise ValidationError(f"group {name!r}: needs at least one member")
        platforms = {h.spec.platform for h in handles}
        if len(platforms) > 1:
            raise ValidationError(
                f"group {name!r}: members span incompatible platforms {sorted(platforms)}"
            )
        names = [h.name for h in handles]
        if len(set(names)) != len(names):
            raise ValidationError(f"group {name!r}: duplicate members {names}")
        self.name = name
        self.min_healthy = min_healthy
        self.strategy = make_strategy(strategy)
        self.trace = Trace()
        self._lock = threading.Lock()
        self._members: dict[str, GroupMember] = {}
        # broker wiring (attach_runtime): the capacity ledger receives O(1)
        # member events; on_topology_change invalidates the proxy's cached
        # bind-target list on breaker transitions
        self._ledger = None
        self._on_topology_change = None
        self._events = None  # broker-owned EventBus (attach_runtime)
        # breaker config is remembered so members that JOIN a live group
        # (elastic scale-out, core/autoscaler.py) get identical protection
        self._failure_threshold = failure_threshold
        self._reset_timeout_s = reset_timeout_s
        for h in handles:
            self._members[h.name] = self._make_member(h)
        # synthetic spec: element-wise max member capacity, so a task fits
        # the group iff it fits the largest member
        self.spec = ProviderSpec(
            name=name,
            platform=handles[0].spec.platform,
            connector=handles[0].spec.connector,
            node_capacity=Resources(
                cpus=max(h.spec.capacity().cpus for h in handles),
                accels=max(h.spec.capacity().accels for h in handles),
                memory_mb=max(h.spec.capacity().memory_mb for h in handles),
            ),
            n_nodes=1,
        )
        self.trace.add("group_created")

    def _make_member(self, h: ProviderHandle) -> GroupMember:
        cap = h.spec.capacity()
        return GroupMember(
            name=h.name,
            weight=float(cap.cpus + cap.accels),
            slots=max(1, h.spec.concurrency * h.spec.n_nodes),
            breaker=CircuitBreaker(
                failure_threshold=self._failure_threshold,
                reset_timeout_s=self._reset_timeout_s,
            ),
        )

    # -- broker wiring (capacity ledger, core/ledger.py) -----------------
    def attach_runtime(self, ledger, on_topology_change=None, events=None) -> None:
        """Wire the broker's CapacityLedger (and the proxy's bind-target
        cache invalidation) into this group's member events: dispatch/
        completion load deltas, membership churn, and every breaker
        transition become O(1) ledger updates, replacing the per-read
        member scans the broker used to do.  ``events`` additionally puts
        every member counter change and breaker transition on the broker's
        event bus (core/events.py), making stats() a log-derived view."""
        with self._lock:
            self._ledger = ledger
            self._on_topology_change = on_topology_change
            self._events = events
            members = list(self._members.values())
        for m in members:
            self._wire_member(m)

    def _wire_member(self, m: GroupMember) -> None:
        ledger = self._ledger
        if ledger is not None:
            ledger.upsert_member(
                m.name, m.slots, counted=m.breaker.state != BreakerState.OPEN
            )

        def _on_transition(old, new, name=m.name):
            if self._ledger is not None:
                self._ledger.set_counted(name, new != BreakerState.OPEN)
            if self._events is not None:
                self._events.emit(
                    "breaker.transition", member=name, old=old.value, new=new.value
                )
            cb = self._on_topology_change
            if cb is not None:
                cb()

        m.breaker.on_transition = _on_transition

    def _ledger_load(self, name: str, delta: int) -> None:
        if self._ledger is not None:
            self._ledger.load_delta(name, delta)

    # -- membership ------------------------------------------------------
    @property
    def member_names(self) -> list[str]:
        with self._lock:  # remove_member may pop concurrently
            return list(self._members)

    def member(self, name: str) -> GroupMember:
        return self._members[name]

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def available_members(self) -> list[GroupMember]:
        """Members whose breaker would admit traffic (non-mutating peek)."""
        with self._lock:
            members = list(self._members.values())
        return [m for m in members if m.breaker.available()]

    def routable(self) -> bool:
        """Is the group a valid bind target right now?"""
        return len(self.available_members()) >= max(1, self.min_healthy)

    def idle_slots(self) -> int:
        """Free concurrent-execution slots across breaker-available members.

        A *hint* for the streaming dispatcher's backfill sizing (how much
        ready work the pool can absorb right now), not an admission limit —
        members queue excess work internally."""
        with self._lock:
            members = list(self._members.values())
        return sum(
            max(0, m.slots - m.outstanding) for m in members if m.breaker.available()
        )

    # -- dispatch-time member resolution ---------------------------------
    def select(self, exclude: Optional[str] = None) -> str:
        """Resolve the member that receives the next pod.

        ``exclude`` skips a member that just failed the caller (retry must
        not land on the same member).  Raises GroupExhausted when no member
        admits traffic.
        """
        with self._lock:
            # peek with available() and gate only the chosen member with
            # allow(): calling allow() on every candidate would consume an
            # un-dispatched half-open probe ticket and strand that member
            candidates = [
                m
                for m in self._members.values()
                if m.name != exclude and m.breaker.available()
            ]
            while candidates:
                choice = self.strategy.pick(candidates)
                if choice.breaker.allow():
                    return choice.name
                candidates.remove(choice)  # lost the probe race: try others
            raise GroupExhausted(self.name)

    def note_dispatch(self, member: str, n_tasks: int) -> None:
        with self._lock:
            m = self._members[member]
            m.outstanding += n_tasks
            m.dispatched += n_tasks
            self._ledger_load(member, n_tasks)
            if self._events is not None:
                self._events.emit(
                    "group.dispatch", group=self.name, member=member, n=n_tasks
                )

    # -- health feedback -------------------------------------------------
    def record_success(self, member: str) -> None:
        m = self._members.get(member)
        if m is None:
            return
        with self._lock:
            m.outstanding = max(0, m.outstanding - 1)
            m.completed += 1
            self._ledger_load(member, -1)
            if self._events is not None:
                self._events.emit(
                    "group.complete", group=self.name, member=member, failed=False
                )
        m.breaker.record_success()

    def record_failure(self, member: str) -> None:
        """Counter + breaker feedback for one failed task.  Hard outage
        signals go through mark_down (via Hydra._handle_member_down), which
        solely owns the OPEN transition."""
        m = self._members.get(member)
        if m is None:
            return
        with self._lock:
            m.outstanding = max(0, m.outstanding - 1)
            m.failed += 1
            self._ledger_load(member, -1)
            if self._events is not None:
                self._events.emit(
                    "group.complete", group=self.name, member=member, failed=True
                )
        m.breaker.record_failure()

    def record_skip(self, member: str) -> None:
        """A dispatched task was skipped (finished elsewhere first): release
        its load slot and any probe ticket it carried, without touching
        completion counters or the breaker's failure accounting."""
        m = self._members.get(member)
        if m is None:
            return
        with self._lock:
            m.outstanding = max(0, m.outstanding - 1)
            self._ledger_load(member, -1)
            if self._events is not None:
                self._events.emit("group.skip", group=self.name, member=member)
        m.breaker.release_probe()

    def record_straggler(self, member: str) -> None:
        """Watchdog verdict: a soft failure against the member's breaker."""
        m = self._members.get(member)
        if m is not None:
            m.breaker.record_failure()

    def mark_down(self, member: str) -> None:
        """Hard down signal (ProviderDown): open the breaker immediately."""
        m = self._members.get(member)
        if m is None:
            return
        was = m.breaker.state
        m.breaker.trip()
        with self._lock:
            # a down member holds no dispatchable work: its orphans are being
            # reassigned or failing, and a stale outstanding count would make
            # load-based strategies shun the member forever after recovery
            m.outstanding = 0
            if self._ledger is not None:
                self._ledger.load_reset(member)
        if was != BreakerState.OPEN:
            self.trace.add(f"breaker_open:{member}")

    def add_member(self, handle: ProviderHandle) -> GroupMember:
        """Dynamic member join on a LIVE group (elastic scale-out): the new
        member enters rotation with a fresh breaker and inherits the group's
        breaker config.  The synthetic spec grows element-wise so tasks that
        fit the new (possibly larger) member become eligible mid-run."""
        if handle.spec.platform != self.spec.platform:
            raise ValidationError(
                f"group {self.name!r}: member {handle.name!r} platform "
                f"{handle.spec.platform!r} != group platform {self.spec.platform!r}"
            )
        with self._lock:
            if handle.name in self._members:
                raise ValidationError(
                    f"group {self.name!r}: member {handle.name!r} already present"
                )
            member = self._make_member(handle)
            self._members[handle.name] = member
            cap, have = handle.spec.capacity(), self.spec.node_capacity
            self.spec.node_capacity = Resources(
                cpus=max(have.cpus, cap.cpus),
                accels=max(have.accels, cap.accels),
                memory_mb=max(have.memory_mb, cap.memory_mb),
            )
        self._wire_member(member)  # converts its ledger row to a member row
        if self._events is not None:
            self._events.emit(
                "group.member_join",
                group=self.name,
                member=handle.name,
                slots=member.slots,
            )
        self.trace.add(f"member_joined:{handle.name}")
        return member

    def remove_member(self, name: str) -> None:
        """Permanently drop a member (elastic removal): it leaves rotation
        for good — no half-open probes to a provider that no longer exists."""
        with self._lock:
            gone = self._members.pop(name, None) is not None
        if gone and self._ledger is not None:
            self._ledger.remove(name)
        if gone and self._events is not None:
            self._events.emit("group.member_leave", group=self.name, member=name)
        self.trace.add(f"member_removed:{name}")

    def breaker_state(self, member: str) -> BreakerState:
        return self._members[member].breaker.state

    # -- metrics ---------------------------------------------------------
    def stats(self) -> list[dict]:
        """One metrics row per member (group-aware metrics, broker.py).
        The dispatched/completed/failed counters come straight from the
        member accumulators (they double as HYDRA_EVENTS_CHECK ground
        truth); the bus folds the same group.* events into its member-keyed
        view, and strict mode asserts the two agree."""
        with self._lock:
            return [
                {
                    "group": self.name,
                    "member": m.name,
                    "breaker": m.breaker.state.value,
                    "trips": m.breaker.trips,
                    "weight": m.weight,
                    "slots": m.slots,
                    "outstanding": m.outstanding,
                    "dispatched": m.dispatched,
                    "completed": m.completed,
                    "failed": m.failed,
                }
                for m in self._members.values()
            ]
