"""Clock abstraction: wall time for production, virtual time for tests.

Every timestamp and every timed wait in the broker core goes through the
*active clock* (``get_clock()``):

  * ``runtime/tracing.now`` stamps trace events,
  * ``core/fault.py`` breaker reset windows and the straggler watchdog tick,
  * the managers' modeled latencies (submit round-trips, env bring-up,
    HPC queue waits) and ``sleep`` tasks,
  * the streaming dispatcher's micro-batch window (``core/dispatcher.py``).

``WallClock`` is the default: ``time.perf_counter`` + ``time.sleep``.

``VirtualClock`` decouples scheduler time from wall time so that DAG
scheduling scenarios with thousands of multi-second sleep tasks run in
(real) milliseconds, deterministically enough for property tests: virtual
time only moves when the auto-advancer jumps it to the earliest pending
deadline, so every sleeper wakes at *exactly* its requested deadline and
trace timestamps are exact virtual instants rather than noisy wall times.

Threading model: sleepers park on one condition variable keyed by a heap of
deadlines.  A daemon auto-advancer polls (real time); once the pending
deadline set has been stable for ``stability_polls`` consecutive polls --
giving in-flight threads a grace window to reach their ``sleep()`` call --
it jumps ``now`` to the earliest deadline and wakes everyone.  Tests that
want full manual control pass ``auto_advance=False`` and call ``advance``.
"""
from __future__ import annotations

import heapq
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional


class ScheduledCall:
    """Handle for a ``Clock.call_later`` registration: cancellable once."""

    def __init__(self, deadline: float, fn: Callable[[], None]):
        self.deadline = deadline
        self._fn: Optional[Callable[[], None]] = fn
        self._lock = threading.Lock()

    def cancel(self) -> bool:
        """Prevent the callback from firing; True iff it had not fired yet."""
        with self._lock:
            fired = self._fn is None
            self._fn = None
            return not fired

    @property
    def active(self) -> bool:
        with self._lock:
            return self._fn is not None

    def _fire(self) -> None:
        with self._lock:
            fn, self._fn = self._fn, None
        if fn is not None:
            fn()


class Clock:
    """Interface: the broker core only ever uses these five methods."""

    name = "base"

    def now(self) -> float:
        raise NotImplementedError

    def stamp(self) -> float:
        """Lock-free best-effort ``now()`` for high-rate telemetry stamps
        (the event bus calls this adjacent to every hot-path counter).  May
        trail an in-flight advance by one tick; never goes backwards within
        a thread.  Defaults to ``now()`` — clocks whose ``now()`` takes a
        lock should override with an unsynchronized read."""
        return self.now()

    def sleep(self, duration: float) -> None:
        raise NotImplementedError

    def wait_event(self, event: threading.Event, timeout: Optional[float] = None) -> bool:
        """``event.wait(timeout)`` with the timeout measured on THIS clock."""
        raise NotImplementedError

    def call_later(self, delay: float, fn: Callable[[], None]) -> ScheduledCall:
        """Schedule ``fn()`` to run once, ``delay`` clock-seconds from now
        (the autoscaler's acquisition-completion path).  The callback runs on
        a clock-owned thread and must not ``sleep()`` on this same clock."""
        raise NotImplementedError

    @contextmanager
    def hold(self):
        """Scoped advancement barrier: while held, a virtual clock will not
        auto-advance (no-op on wall clocks).  The streaming dispatcher holds
        the clock while draining/dispatching a batch so virtual time cannot
        jump while readiness events are mid-flight between threads.  Never
        ``sleep()`` on the same clock inside a hold — the advancer only
        honours holds for a bounded number of polls (liveness valve), so a
        sleep-under-hold degrades to slow ticks instead of deadlock."""
        yield

    def close(self) -> None:
        pass


class WallClock(Clock):
    name = "wall"

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, duration: float) -> None:
        if duration > 0:
            time.sleep(duration)

    def wait_event(self, event: threading.Event, timeout: Optional[float] = None) -> bool:
        return event.wait(timeout)

    def call_later(self, delay: float, fn: Callable[[], None]) -> ScheduledCall:
        call = ScheduledCall(self.now() + max(0.0, delay), fn)
        timer = threading.Timer(max(0.0, delay), call._fire)
        timer.daemon = True
        timer.start()
        return call


class VirtualClock(Clock):
    name = "virtual"

    def __init__(
        self,
        start: float = 0.0,
        auto_advance: bool = True,
        poll_s: float = 0.0005,
        stability_polls: int = 2,
    ):
        self._now = float(start)
        self._cond = threading.Condition()
        self._sleepers: list[float] = []  # heap of pending virtual deadlines
        self._timers: list[tuple[float, int, ScheduledCall]] = []  # call_later heap
        self._timer_seq = 0
        self._holds = 0  # active hold() scopes: advancement barrier
        self._closed = False
        self._poll_s = poll_s
        self._stability_polls = max(1, stability_polls)
        self._stop = threading.Event()
        self._advancer: Optional[threading.Thread] = None
        self.advances = 0  # ticks performed (observability/tests)
        if auto_advance:
            self._advancer = threading.Thread(
                target=self._advance_loop, daemon=True, name="virtual-clock"
            )
            self._advancer.start()

    # -- reading / driving time ----------------------------------------
    def now(self) -> float:
        with self._cond:
            return self._now

    def stamp(self) -> float:
        # GIL-atomic float read; racing an advance yields the pre-advance
        # instant, which is a valid (momentarily stale) observation — and
        # skipping the cond keeps emit() off the clock's contended lock
        return self._now

    def advance(self, dt: float) -> float:
        """Manually move time forward and wake any due sleepers/timers."""
        with self._cond:
            self._now += max(0.0, dt)
            due = self._pop_due_timers()
            self._cond.notify_all()
            t = self._now
        for call in due:
            call._fire()
        return t

    def advance_to(self, t: float) -> float:
        with self._cond:
            self._now = max(self._now, t)
            due = self._pop_due_timers()
            self._cond.notify_all()
            t = self._now
        for call in due:
            call._fire()
        return t

    def pending_deadlines(self) -> int:
        with self._cond:
            self._purge_cancelled()
            # cancelled timers below the heap head are lazily deleted and
            # will never fire: they are not *pending* (scenario residue
            # checks read this after shutdown)
            live = sum(1 for _, _, call in self._timers if call.active)
            return len(self._sleepers) + live

    # -- delayed callbacks -------------------------------------------------
    def call_later(self, delay: float, fn: Callable[[], None]) -> ScheduledCall:
        """Register a virtual-deadline callback: fired by advance()/the
        auto-advancer once virtual time reaches it.  The deadline counts as a
        pending deadline, so the advancer will jump to it when it is next."""
        with self._cond:
            call = ScheduledCall(self._now + max(0.0, delay), fn)
            if self._closed:
                call.cancel()  # a closed clock never fires
                return call
            if call.deadline <= self._now:
                due = [call]
            else:
                self._timer_seq += 1
                heapq.heappush(self._timers, (call.deadline, self._timer_seq, call))
                due = []
            self._cond.notify_all()
        for c in due:
            c._fire()
        return call

    def _pop_due_timers(self) -> list[ScheduledCall]:
        # callers hold self._cond
        due = []
        while self._timers and self._timers[0][0] <= self._now:
            due.append(heapq.heappop(self._timers)[2])
        return due

    def _purge_cancelled(self) -> None:
        # callers hold self._cond: drop cancelled timers from the heap head
        # so they cannot attract an advancer jump to a dead deadline
        while self._timers and not self._timers[0][2].active:
            heapq.heappop(self._timers)

    def _earliest_deadline(self) -> Optional[float]:
        # callers hold self._cond
        self._purge_cancelled()
        heads = []
        if self._sleepers:
            heads.append(self._sleepers[0])
        if self._timers:
            heads.append(self._timers[0][0])
        return min(heads) if heads else None

    # -- virtual waiting -------------------------------------------------
    def sleep(self, duration: float) -> None:
        if duration <= 0:
            return
        with self._cond:
            if self._closed:
                return
            deadline = self._now + duration
            heapq.heappush(self._sleepers, deadline)
            while self._now < deadline and not self._closed:
                # the real-time timeout is a liveness guard only; wakeups
                # come from advance()/the auto-advancer notifying the cond
                self._cond.wait(timeout=0.05)
            self._drop_passed()

    def wait_event(self, event: threading.Event, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            return event.wait()
        with self._cond:
            deadline = self._now + timeout
            heapq.heappush(self._sleepers, deadline)
            try:
                while True:
                    if event.is_set():
                        return True
                    if self._now >= deadline or self._closed:
                        return event.is_set()
                    self._cond.wait(timeout=0.01)
            finally:
                # withdraw our deadline if time never reached it (event won)
                if deadline in self._sleepers:
                    self._sleepers.remove(deadline)
                    heapq.heapify(self._sleepers)
                self._drop_passed()

    def _drop_passed(self) -> None:
        # callers hold self._cond
        while self._sleepers and self._sleepers[0] <= self._now:
            heapq.heappop(self._sleepers)

    @contextmanager
    def hold(self):
        with self._cond:
            self._holds += 1
        try:
            yield
        finally:
            with self._cond:
                self._holds = max(0, self._holds - 1)

    # -- auto-advancer ---------------------------------------------------
    def _advance_loop(self) -> None:
        stable = 0
        held_polls = 0
        last_sig: Optional[tuple] = None
        while not self._stop.wait(self._poll_s):
            fire: list[ScheduledCall] = []
            with self._cond:
                self._drop_passed()
                earliest = self._earliest_deadline()
                if earliest is None:
                    stable, last_sig = 0, None
                    continue
                if self._holds > 0 and held_polls < 100:
                    # a dispatch round is mid-flight: defer the tick
                    # (bounded: ~100 polls, the sleep-under-hold valve)
                    held_polls += 1
                    stable, last_sig = 0, None
                    continue
                held_polls = 0
                sig = (len(self._sleepers), len(self._timers), earliest)
                stable = stable + 1 if sig == last_sig else 1
                last_sig = sig
                if stable >= self._stability_polls:
                    self._now = max(self._now, earliest)
                    self.advances += 1
                    stable, last_sig = 0, None
                    self._drop_passed()
                    fire = self._pop_due_timers()
                    self._cond.notify_all()
            for call in fire:  # outside the cond: callbacks may re-enter the clock
                call._fire()

    def close(self) -> None:
        """Stop the advancer and release every parked sleeper immediately.
        Unfired call_later registrations are dropped, not fired: the clock's
        owner is tearing the world down."""
        self._stop.set()
        with self._cond:
            self._closed = True
            if self._sleepers:
                self._now = max(self._now, max(self._sleepers))
                self._sleepers.clear()
            for _, _, call in self._timers:
                call.cancel()
            self._timers.clear()
            self._cond.notify_all()
        if self._advancer is not None:
            self._advancer.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Active-clock registry
# ---------------------------------------------------------------------------

_active: Clock = WallClock()
_registry_lock = threading.Lock()


def get_clock() -> Clock:
    return _active


def set_clock(clock: Clock) -> Clock:
    """Install ``clock`` as the process-wide active clock; returns the old one."""
    global _active
    with _registry_lock:
        previous = _active
        _active = clock
        return previous


def now() -> float:
    return _active.now()


def guard_wait(
    event: threading.Event,
    timeout: Optional[float] = None,
    in_flight: Optional[Callable[[], bool]] = None,
) -> bool:
    """Completion-event wait with a *guard* timeout (Submission.wait,
    WorkflowManager.run): returns when the event fires, or when the timeout
    elapses on EITHER the active clock or real time, whichever comes first.

    Unlike ``Clock.wait_event`` this does not eagerly register the deadline
    as a virtual sleeper: a guard must not invite the auto-advancer to jump
    to the timeout while real (non-sleeping) work is still executing.  The
    real-time bound is what keeps a frozen virtual clock from turning a
    guard into an infinite hang.

    Idle valve: when nothing at all is in flight on a virtual clock (no
    pending sleeper/timer deadlines and virtual time not moving for a short
    real-time grace window), no event source can exist that the guard would
    be shielding — so the remaining timeout IS registered as a sleeper and
    the guard elapses at the *virtual* deadline instead of burning the full
    real-time budget (``Submission.wait(timeout=...)`` with no tasks in
    flight used to block for ``timeout`` real seconds).

    ``in_flight`` refines the valve for callers that can SEE their work:
    while it returns True (e.g. a task is executing pure-CPU compute that
    never touches the clock), the valve stays closed even though the clock
    looks idle, so real work cannot be cut short by a phantom virtual
    timeout."""
    clock = get_clock()
    if timeout is None or isinstance(clock, WallClock):
        return clock.wait_event(event, timeout)
    v_deadline = clock.now() + timeout
    r_deadline = time.monotonic() + timeout
    idle_polls = 0
    last_v = clock.now()
    # the valve needs an auto-advancer to serve the registered deadline: on a
    # manually-driven clock it would trade a bounded wait for a hang
    auto = getattr(clock, "_advancer", None) is not None
    pending = getattr(clock, "pending_deadlines", None) if auto else None
    while True:
        if event.is_set():
            return True
        v_now = clock.now()
        if v_now >= v_deadline or time.monotonic() >= r_deadline:
            return event.is_set()
        if pending is not None:
            if v_now == last_v and pending() == 0 and not (in_flight and in_flight()):
                idle_polls += 1
            else:
                idle_polls = 0
            last_v = v_now
            if idle_polls >= 5:  # ~100ms real grace: in-flight threads have
                # reached their sleep() by now, or there are none
                clock.wait_event(event, max(0.0, v_deadline - v_now))
                return event.is_set()
        event.wait(0.02)


@contextmanager
def use_clock(clock: Clock):
    """Scoped clock swap (tests): restores the previous clock on exit."""
    previous = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(previous)


@contextmanager
def virtual_time(start: float = 0.0, auto_advance: bool = True, **kw):
    """Scoped VirtualClock that is closed (all sleepers released) on exit."""
    clock = VirtualClock(start=start, auto_advance=auto_advance, **kw)
    try:
        with use_clock(clock):
            yield clock
    finally:
        clock.close()
