"""Event tracing + the paper's four metrics (OVH, TH, TPT, TTX).

Definitions (Hydra paper §5):
  OVH - time Hydra spends preparing the workload for execution and
        communicating with the platform middleware to initiate execution
        (bind + partition + serialize + submit phases).
  TH  - broker throughput: tasks *processed* per second (not executed).
  TPT - task total processing time on the platform: execute the tasks AND
        prepare/shut down the task execution environments.
  TTX - total time the platform takes to execute all submitted tasks.

Every Task/Pod/Provider carries a trace: a list of (event, t) stamped by the
*active clock* (runtime/clock.py) — ``time.perf_counter`` under the default
WallClock, exact virtual instants under a VirtualClock.  Metrics are derived
purely from traces, so they are platform- and workload-agnostic, exactly as
in the paper, and scheduler tests can replay 10k-task scenarios in virtual
time without distorting a single metric formula.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, Optional

from repro_torch.runtime.clock import now


@dataclass
class Trace:
    events: list[tuple[str, float]] = field(default_factory=list)

    def add(self, event: str, t: Optional[float] = None) -> float:
        t = now() if t is None else t
        self.events.append((event, t))
        return t

    def first(self, event: str) -> Optional[float]:
        for e, t in self.events:
            if e == event:
                return t
        return None

    def last(self, event: str) -> Optional[float]:
        out = None
        for e, t in self.events:
            if e == event:
                out = t
        return out

    def span(self, start: str, end: str) -> Optional[float]:
        t0, t1 = self.first(start), self.last(end)
        if t0 is None or t1 is None:
            return None
        return t1 - t0


# ---------------------------------------------------------------------------
# Metric aggregation
# ---------------------------------------------------------------------------

# Broker-side (OVH) phases, in order.
OVH_PHASES = [
    ("bind_start", "bind_done"),
    ("partition_start", "partition_done"),
    ("serialize_start", "serialize_done"),
    ("submit_start", "submit_done"),
]


@dataclass
class Metrics:
    ovh: float  # broker overhead (s)
    th: float  # broker throughput (tasks/s)
    tpt: float  # platform processing time (s), incl. env setup/teardown
    ttx: float  # platform execution time (s)
    n_tasks: int
    n_pods: int
    phases: dict[str, float] = field(default_factory=dict)

    def row(self) -> dict:
        return {
            "ovh_s": round(self.ovh, 6),
            "th_tasks_per_s": round(self.th, 2),
            "tpt_s": round(self.tpt, 6),
            "ttx_s": round(self.ttx, 6),
            "n_tasks": self.n_tasks,
            "n_pods": self.n_pods,
            **{f"phase_{k}_s": round(v, 6) for k, v in self.phases.items()},
        }

    def otel(self) -> dict:
        """The same row under the OTel-style metric names the event bus
        uses (core/events.py, docs/OBSERVABILITY.md), so run-level metrics
        and log-derived counters share one namespace in exported JSON."""
        return {
            "hydra.run.ovh_s": round(self.ovh, 6),
            "hydra.run.th_tasks_per_s": round(self.th, 2),
            "hydra.run.tpt_s": round(self.tpt, 6),
            "hydra.run.ttx_s": round(self.ttx, 6),
            "hydra.run.n_tasks": self.n_tasks,
            "hydra.run.n_pods": self.n_pods,
            **{
                f"hydra.run.phase.{k}_s": round(v, 6)
                for k, v in self.phases.items()
            },
        }


def compute_metrics(run_trace: Trace, tasks: Iterable, pods: Iterable) -> Metrics:
    """Derive the paper's metrics from the broker run trace + task traces."""
    tasks, pods = list(tasks), list(pods)
    phases = {}
    ovh = 0.0
    for start, end in OVH_PHASES:
        d = run_trace.span(start, end)
        if d is not None:
            phases[start.rsplit("_", 1)[0]] = d
            ovh += d

    # TH: tasks processed by the broker / broker processing window
    t0 = run_trace.first("bind_start")
    t1 = run_trace.last("submit_done")
    th = len(tasks) / (t1 - t0) if (t0 is not None and t1 is not None and t1 > t0) else 0.0

    # TPT: platform window incl. env setup/teardown (pod env_up .. env_down)
    env_up = [t for p in pods if (t := p.trace.first("env_setup_start")) is not None]
    env_dn = [t for p in pods if (t := p.trace.last("env_teardown_done")) is not None]
    tpt = (max(env_dn) - min(env_up)) if env_up and env_dn else 0.0

    # TTX: first task exec start .. last task exec done
    starts = [t for task in tasks if (t := task.trace.first("exec_start")) is not None]
    ends = [t for task in tasks if (t := task.trace.last("exec_done")) is not None]
    ttx = (max(ends) - min(starts)) if starts and ends else 0.0

    return Metrics(ovh, th, tpt, ttx, len(tasks), len(pods), phases)


class Counter:
    """Thread-safe monotonically increasing id generator."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._n = 0
        self._lock = threading.Lock()

    def next(self) -> str:
        with self._lock:
            self._n += 1
            return f"{self.prefix}.{self._n:06d}"
