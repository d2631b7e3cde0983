"""CapacityLedger: O(1) broker-side capacity counters (§Perf, scheduler core).

The paper's headline claim is near-constant broker overhead as tasks and
platforms scale (§5.4, §6).  Before this module the broker recomputed its
supply/demand picture by *scanning*: ``idle_slots()``/``total_slots()``
walked every bind target per micro-batch, and ``backlog()`` re-counted every
task of every live submission per autoscaler tick (behind a 50 ms cache) —
so dispatch cost grew with tasks x providers, the opposite of the paper's
result.

The ledger inverts that: a small counter set updated O(1) on the events that
actually change capacity, read O(1) by the dispatcher/autoscaler hot paths:

  event                                   counters touched
  -----------------------------------     -------------------------------
  provider register / deregister          total, idle
  provider blacklist (outage)             total, idle, outstanding
  group member join / leave               total, idle
  member breaker transition (fault.py)    total, idle  (counted flag)
  task dispatch / finish / skip           idle          (outstanding)
  acquisition begin / complete / abort    incoming
  task enters a submission                backlog
  task future resolves                    backlog

One row per *concrete* provider (direct or group member).  A row is
``counted`` — contributing to supply — while its health signal says traffic
may flow: ``handle.healthy`` for direct providers, ``breaker.state != OPEN``
for group members (the breaker's timed OPEN -> HALF_OPEN reopening is an
*event* too: it happens inside ``allow()``, never by mere passage of time,
which is what makes supply exactly event-countable).

Backlog counts *distinct unresolved tasks that have entered a submission*:
resolution (the task future settling) is the O(1) observable completion
event.  A retry-pending FAILED task therefore stays in the backlog until it
finally resolves — it is still owed work — where the old scan dropped and
re-added it around each retry.

Honesty harness: with ``strict`` enabled (``HYDRA_LEDGER_CHECK=1``;
tests/conftest.py turns it on for the whole tier-1 suite) every read
cross-checks the counters against a from-scratch recompute supplied by the
broker.  Because events land a few instructions apart from the state they
mirror, a strict check retries briefly before declaring divergence: a *race*
heals within microseconds, a *leak* never does.  Divergence raises
``LedgerDivergence`` and is re-raised from ``Hydra.shutdown()`` so a
swallowed hot-loop check still fails the suite.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


class LedgerDivergence(AssertionError):
    """The O(1) counters disagree with a from-scratch recompute: an event
    source is missing or double-firing.  Always a broker bug."""


@dataclass
class _Row:
    slots: int
    outstanding: int = 0
    counted: bool = True

    @property
    def idle(self) -> int:
        return max(0, self.slots - self.outstanding) if self.counted else 0

    @property
    def total(self) -> int:
        return self.slots if self.counted else 0


class CapacityLedger:
    """Event-maintained capacity counters.  All mutators are O(1); all reads
    are O(1) (plus the strict-mode cross-check, which is O(state) and only
    enabled under tests)."""

    def __init__(self, strict: bool = False):
        self._lock = threading.Lock()
        self._rows: dict[str, _Row] = {}
        self._incoming: dict[str, int] = {}  # pending acquisition -> slots
        self._idle = 0
        self._total = 0
        self._incoming_slots = 0
        self._backlog = 0
        self.strict = strict
        self.divergences = 0
        self.last_divergence: Optional[str] = None
        self._recompute: Optional[Callable[[], dict]] = None
        self._on_capacity_gain: Optional[Callable[[], None]] = None

    def attach(
        self,
        recompute: Optional[Callable[[], dict]] = None,
        on_capacity_gain: Optional[Callable[[], None]] = None,
    ) -> None:
        """``recompute`` rebuilds the counter set from scratch (the strict
        cross-check's ground truth); ``on_capacity_gain`` fires — outside the
        ledger lock — whenever idle supply grows, so the dispatcher can wake
        on completions/arrivals instead of polling on a real-time timeout."""
        self._recompute = recompute
        self._on_capacity_gain = on_capacity_gain

    # -- event mutators (all O(1)) --------------------------------------
    def _apply(self, fn) -> None:
        """Run ``fn`` under the lock; fire the capacity-gain callback after
        releasing it when idle supply grew."""
        with self._lock:
            before = self._idle + self._incoming_slots
            fn()
            gained = (self._idle + self._incoming_slots) > before
        if gained and self._on_capacity_gain is not None:
            self._on_capacity_gain()

    def _set_row(self, name: str, row: Optional[_Row]) -> None:
        # callers hold self._lock
        old = self._rows.pop(name, None)
        if old is not None:
            self._idle -= old.idle
            self._total -= old.total
        if row is not None:
            self._rows[name] = row
            self._idle += row.idle
            self._total += row.total

    def upsert_direct(self, name: str, slots: int) -> None:
        """An ungrouped provider registered (or re-registered)."""
        self._apply(lambda: self._set_row(name, _Row(slots=max(1, slots))))

    def upsert_member(self, name: str, slots: int, counted: bool = True) -> None:
        """A provider became (or joined as) a group member: its row restarts
        with the group's per-member load accounting (outstanding = 0)."""
        self._apply(
            lambda: self._set_row(name, _Row(slots=max(1, slots), counted=counted))
        )

    def remove(self, name: str) -> None:
        """Provider/member deregistered: its supply is gone.  Idempotent —
        removal paths (outage, scale-in, rollback) may overlap."""
        self._apply(lambda: self._set_row(name, None))

    def deactivate(self, name: str) -> None:
        """Blacklist/outage: the row stays (the name is still registered)
        but contributes nothing, and a dead provider owes no dispatchable
        work (outstanding resets with it)."""

        def _do():
            row = self._rows.get(name)
            if row is None:
                return
            self._idle -= row.idle
            self._total -= row.total
            row.counted = False
            row.outstanding = 0

        self._apply(_do)

    def set_counted(self, name: str, counted: bool) -> None:
        """Breaker transition (group member health): slots enter/leave the
        supply side.  Fired by the member's CircuitBreaker ``on_transition``
        hook, so the timed OPEN -> HALF_OPEN reopening is still an event."""

        def _do():
            row = self._rows.get(name)
            if row is None or row.counted == counted:
                return
            self._idle -= row.idle
            self._total -= row.total
            row.counted = counted
            self._idle += row.idle
            self._total += row.total

        self._apply(_do)

    def load_delta(self, name: str, delta: int) -> None:
        """Outstanding-task accounting (dispatch +n / completion -1), with
        the same clamp-at-zero the broker and groups apply.  The hottest
        event (twice per task): hand-inlined, no closure."""
        cb = None
        with self._lock:
            row = self._rows.get(name)
            if row is None:
                return
            before = row.idle
            row.outstanding = max(0, row.outstanding + delta)
            gained = row.idle - before
            self._idle += gained
            if gained > 0:
                cb = self._on_capacity_gain
        if cb is not None:
            cb()

    def load_reset(self, name: str) -> None:
        """A downed member's orphans are being reassigned: it owes nothing."""

        def _do():
            row = self._rows.get(name)
            if row is None:
                return
            self._idle -= row.idle
            row.outstanding = 0
            self._idle += row.idle

        self._apply(_do)

    def begin_incoming(self, name: str, slots: int) -> None:
        def _do():
            old = self._incoming.pop(name, 0)
            self._incoming[name] = max(1, slots)
            self._incoming_slots += max(1, slots) - old

        self._apply(_do)

    def end_incoming(self, name: str) -> None:
        """Acquisition completed or aborted.  Idempotent."""

        def _do():
            self._incoming_slots -= self._incoming.pop(name, 0)

        self._apply(_do)

    def task_entered(self, n: int = 1) -> None:
        with self._lock:
            self._backlog += n

    def task_resolved(self, n: int = 1) -> None:
        with self._lock:
            self._backlog = max(0, self._backlog - n)

    # -- O(1) reads ------------------------------------------------------
    def idle_slots(self) -> int:
        self._maybe_check()
        with self._lock:
            return self._idle

    def total_slots(self) -> int:
        self._maybe_check()
        with self._lock:
            return self._total

    def incoming_slots(self) -> int:
        self._maybe_check()
        with self._lock:
            return self._incoming_slots

    def backlog(self) -> int:
        self._maybe_check()
        with self._lock:
            return self._backlog

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "idle_slots": self._idle,
                "total_slots": self._total,
                "incoming_slots": self._incoming_slots,
                "backlog": self._backlog,
            }

    def stats(self) -> dict:
        out = self.snapshot()
        out["strict"] = self.strict
        out["divergences"] = self.divergences
        return out

    # -- the honesty harness ---------------------------------------------
    def _maybe_check(self) -> None:
        if self.strict and self._recompute is not None:
            self.check()

    def check(self, retries: int = 30, retry_sleep_s: float = 0.002) -> None:
        """Cross-check counters against a from-scratch recompute.

        Events land a few instructions after the state they mirror (a
        completion decrements the group's member counter, then the ledger),
        so a transient mismatch under concurrency is expected and heals in
        microseconds; only a *persistent* mismatch — a leaked or double
        event — is divergence.  The recompute runs OUTSIDE the ledger lock:
        it takes broker/proxy/group locks, and taking those under the ledger
        lock would invert the broker -> ledger lock order."""
        last = None
        for _ in range(max(1, retries)):
            expect = self._recompute()
            got = self.snapshot()
            diffs = {
                k: {"ledger": got[k], "recomputed": expect[k]}
                for k in expect
                if got[k] != expect[k]
            }
            if not diffs:
                return
            last = diffs
            time.sleep(retry_sleep_s)
        self.divergences += 1
        self.last_divergence = repr(last)
        raise LedgerDivergence(f"capacity ledger diverged from recompute: {last}")
