"""Fault tolerance: retry/re-bind on task failure, provider blacklisting on
outage, straggler mitigation via speculative duplicate dispatch, and the
per-member circuit breaker used by provider groups (core/group.py).

The paper's Hydra ensures graceful teardown on failure; at 1000+ node scale
the broker additionally has to *survive* provider loss.  Policy here:

  task failure     -> reset FAILED -> BOUND, re-bind to another healthy
                      provider (never the one that just failed it), resubmit;
                      give up after task.max_retries and surface the error.
  provider outage  -> blacklist the provider, fail-fast its in-flight tasks,
                      re-bind + resubmit everything non-final it owned.
  grouped member   -> the member's circuit breaker opens (immediately on
                      ProviderDown, after `failure_threshold` consecutive
                      errors otherwise); orphans fail over to surviving group
                      members without touching the caller's binding policy;
                      after `reset_timeout_s` a single half-open probe is let
                      through and either closes or re-opens the breaker.
  straggler        -> a watchdog compares running tasks against
                      factor * median(completed runtimes); slow tasks get a
                      speculative clone on another provider; first completion
                      wins (the Task state machine makes the loser a no-op).
                      A straggler on a grouped member also counts as a soft
                      failure against that member's breaker.
"""
from __future__ import annotations

import statistics
import threading
from enum import Enum
from typing import Callable, Optional

from repro_torch.core.task import Task
from repro_torch.runtime.clock import get_clock
from repro_torch.runtime.tracing import now


class BreakerState(str, Enum):
    CLOSED = "CLOSED"  # healthy: traffic flows
    OPEN = "OPEN"  # tripped: no traffic until reset timeout elapses
    HALF_OPEN = "HALF_OPEN"  # probing: exactly one request allowed through


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a timed half-open probe.

    State machine:
      CLOSED   --(failures >= failure_threshold, or trip())-->  OPEN
      OPEN     --(reset_timeout_s elapsed; next allow())----->  HALF_OPEN
      HALF_OPEN --(record_success x success_threshold)------->  CLOSED
      HALF_OPEN --(record_failure)-------------------------->  OPEN

    ``allow()`` is the dispatch gate: it returns True when traffic may be
    sent, and performs the OPEN -> HALF_OPEN transition itself so that the
    caller that wins the race becomes the probe.  While HALF_OPEN, only the
    probe is in flight; everyone else is rejected until it resolves.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout_s: float = 30.0,
        success_threshold: int = 1,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.success_threshold = success_threshold
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.half_open_successes = 0
        self.opened_at: Optional[float] = None
        self.trips = 0  # times the breaker opened (metrics)
        self._probe_inflight = False
        self._lock = threading.Lock()
        # state-transition listener (core/group.py wires this to the
        # broker's CapacityLedger): every transition — including the timed
        # OPEN -> HALF_OPEN reopening, which happens inside allow(), never by
        # mere passage of time — is thereby an O(1) capacity event.  Called
        # under the breaker lock; listeners must not re-enter the breaker.
        self.on_transition: Optional[Callable[[BreakerState, BreakerState], None]] = None

    def _set_state(self, new: BreakerState) -> None:
        # callers hold self._lock
        old, self.state = self.state, new
        if old != new and self.on_transition is not None:
            self.on_transition(old, new)

    # -- gates -----------------------------------------------------------
    def allow(self) -> bool:
        """May traffic be dispatched right now?  (Mutates OPEN -> HALF_OPEN.)"""
        with self._lock:
            if self.state == BreakerState.CLOSED:
                return True
            if self.state == BreakerState.OPEN:
                if self.opened_at is not None and now() - self.opened_at >= self.reset_timeout_s:
                    self._set_state(BreakerState.HALF_OPEN)
                    self.half_open_successes = 0
                    self._probe_inflight = True
                    return True  # this caller is the probe
                return False
            # HALF_OPEN: single probe at a time
            if not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def available(self) -> bool:
        """Non-mutating peek: would allow() plausibly return True?"""
        with self._lock:
            if self.state == BreakerState.CLOSED:
                return True
            if self.state == BreakerState.OPEN:
                return self.opened_at is not None and now() - self.opened_at >= self.reset_timeout_s
            return not self._probe_inflight

    # -- outcome feedback ------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            if self.state == BreakerState.HALF_OPEN:
                self._probe_inflight = False
                self.half_open_successes += 1
                if self.half_open_successes >= self.success_threshold:
                    self._set_state(BreakerState.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state == BreakerState.HALF_OPEN:
                self._reopen()
            elif self.state == BreakerState.CLOSED and self.consecutive_failures >= self.failure_threshold:
                self._reopen()

    def release_probe(self) -> None:
        """The dispatched probe never actually ran (its task finished
        elsewhere first): return the ticket so the next allow() can probe,
        instead of stranding the breaker HALF_OPEN forever."""
        with self._lock:
            if self.state == BreakerState.HALF_OPEN:
                self._probe_inflight = False

    def trip(self) -> None:
        """Open immediately (hard signal: ProviderDown / watchdog verdict)."""
        with self._lock:
            if self.state != BreakerState.OPEN:
                self._reopen()
            else:
                self.opened_at = now()  # re-stamp: extend the open window

    def _reopen(self) -> None:
        # callers hold self._lock
        self._set_state(BreakerState.OPEN)
        self.opened_at = now()
        self.trips += 1
        self._probe_inflight = False
        self.half_open_successes = 0


class StragglerWatchdog:
    def __init__(
        self,
        running: Callable[[], list[Task]],
        duplicate: Callable[[Task], None],
        factor: float = 3.0,
        min_samples: int = 5,
        interval_s: float = 0.05,
        min_runtime_s: float = 0.02,
    ):
        self.running = running
        self.duplicate = duplicate
        self.factor = factor
        self.min_samples = min_samples
        self.interval_s = interval_s
        self.min_runtime_s = min_runtime_s
        self.completed_runtimes: list[float] = []
        self.duplicated: set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="straggler-watchdog")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def observe_completion(self, runtime_s: float):
        with self._lock:
            self.completed_runtimes.append(runtime_s)

    def _loop(self):
        # clock-aware tick: under a VirtualClock the watchdog scans on
        # virtual intervals, so straggler thresholds fire deterministically
        while not get_clock().wait_event(self._stop, self.interval_s):
            with self._lock:
                if len(self.completed_runtimes) < self.min_samples:
                    continue
                med = statistics.median(self.completed_runtimes)
            threshold = max(self.factor * med, self.min_runtime_s)
            t_now = now()
            for task in self.running():
                if task.uid in self.duplicated or task.final:
                    continue
                t0 = task.trace.first("exec_start")
                if t0 is not None and (t_now - t0) > threshold:
                    with self._lock:
                        if task.uid in self.duplicated:
                            continue
                        self.duplicated.add(task.uid)
                    task.trace.add("straggler_detected")
                    self.duplicate(task)


def clone_for_speculation(task: Task) -> Task:
    """A shadow task whose completion completes the original."""
    shadow = Task(
        kind=task.kind,
        fn=task.fn,
        resources=task.resources,
        arch=task.arch,
        shape=task.shape,
        step_kind=task.step_kind,
        duration=0.0,  # re-execution of a straggling sleep is instant by design
        payload=task.payload,
        max_retries=0,
        # declared I/O rides along: when the shadow wins, the manager's
        # on_task_finishing hook must register the outputs (at the shadow's
        # site) BEFORE forward() resolves the original and unleashes its
        # dependents — the original's own stage-out may still be minutes out
        inputs=task.inputs,
        outputs=task.outputs,
    )
    shadow.trace.add("speculative_clone_of:" + task.uid)

    def forward(fut):
        if fut.cancelled():
            return
        exc = fut.exception()
        if exc is None and not task.final:
            task.trace.add("speculative_win")
            task.mark_done(fut.result())

    shadow.add_done_callback(forward)
    return shadow
