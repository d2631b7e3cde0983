"""Scenario runner + structured report + invariant checker.

Counterpart of ``repro/scenarios/runner.py``.  ``build_broker`` and
``run_scenario`` take the broker's ``device``: ``"cuda"`` by default, where
the serve lane's kernel payloads run the hand-written kernels, or ``"cpu"``,
where they run the plain versions.  Without a CUDA device a ``"cuda"`` run
raises (``Hydra`` refuses it) and never carries on on the CPU.

``run_scenario`` builds a fresh broker fleet inside its own VirtualClock,
feeds it the spec's traffic through the streaming WorkflowManager, arms the
ChaosEngine (or not: the no-chaos twin), and emits a ``ScenarioReport`` —
one structured, JSON-serializable record of what happened: task outcomes,
makespan, the injected event log, recovery timing, staging/stream/scale
stats, and the post-shutdown residue checks (stranded blocked tasks, live
retry timers, pending clock deadlines, strict-ledger divergence).

``check_invariants`` is the system-level contract from the ISSUE: zero
failed tasks under adversity, bounded makespan inflation vs the twin, a
clean strict ledger, and nothing stranded after ``shutdown()``.  It returns
a list of violation strings — empty means the system held.

Determinism: ``ScenarioReport.fingerprint()`` hashes the stable identity of
a run — the spec name/seed, task totals and outcomes, and the chaos event
schedule as (t, kind, target) triples.  Identical seed => identical
fingerprint.  (Victim sets of preempt kills and raw makespans can shift
with thread interleaving; they are reported but deliberately OUTSIDE the
fingerprint.)"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.autoscaler import ProviderPool
from repro_torch.core.broker import Hydra
from repro_torch.core.chaos import ChaosEngine
from repro_torch.core.events import EventsDivergence
from repro_torch.core.ledger import LedgerDivergence
from repro_torch.core.managers.workflow import WorkflowManager
from repro_torch.runtime.clock import virtual_time

from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.scenarios.traffic import build_traffic

FAULT_KINDS = ("site_outage", "link_window", "quarantine_storm", "preempt_kill")
RECOVERY_MARKERS = (
    "rebound:",  # cross-provider re-bind (broker fault path)
    "failover:",  # in-group transparent failover
    "rebind_via_gate",  # input-carrying orphan re-entering the staging gate
    "regate:",  # parked task whose reserved placement target died
    "preempted",  # chaos preempt-kill victim
)


@dataclass
class ScenarioReport:
    name: str
    seed: int
    chaos_enabled: bool
    n_workflows: int = 0
    n_tasks: int = 0
    failed_tasks: int = 0
    unresolved_tasks: int = 0
    failed_workflows: int = 0
    makespan_s: float = 0.0
    first_fault_s: Optional[float] = None
    recovery_s: Optional[float] = None
    recovered_tasks: int = 0
    preempted_tasks: int = 0
    events: list = field(default_factory=list)
    event_schedule: list = field(default_factory=list)  # (t, kind, target)
    staging: dict = field(default_factory=dict)
    stream: dict = field(default_factory=dict)
    scale: dict = field(default_factory=dict)
    kernel: dict = field(default_factory=dict)  # kernel.tune/exec rollup
    chaos_stats: dict = field(default_factory=dict)
    ledger_error: Optional[str] = None
    events_error: Optional[str] = None  # strict event-view divergence
    n_bus_events: int = 0  # broker event-log length (core/events.py)
    events_path: Optional[str] = None  # JSONL dump, when recording was asked
    stranded_blocked: int = 0
    stranded_retry_timers: int = 0
    pending_deadlines: int = 0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "chaos_enabled": self.chaos_enabled,
            "n_workflows": self.n_workflows,
            "n_tasks": self.n_tasks,
            "failed_tasks": self.failed_tasks,
            "unresolved_tasks": self.unresolved_tasks,
            "failed_workflows": self.failed_workflows,
            "makespan_s": round(self.makespan_s, 3),
            "first_fault_s": self.first_fault_s,
            "recovery_s": self.recovery_s,
            "recovered_tasks": self.recovered_tasks,
            "preempted_tasks": self.preempted_tasks,
            "events": self.events,
            "event_schedule": self.event_schedule,
            "staging": self.staging,
            "stream": self.stream,
            "scale": self.scale,
            "kernel": self.kernel,
            "chaos_stats": self.chaos_stats,
            "ledger_error": self.ledger_error,
            "events_error": self.events_error,
            "n_bus_events": self.n_bus_events,
            "events_path": self.events_path,
            "stranded_blocked": self.stranded_blocked,
            "stranded_retry_timers": self.stranded_retry_timers,
            "pending_deadlines": self.pending_deadlines,
            "fingerprint": self.fingerprint(),
        }

    def fingerprint(self) -> str:
        """Stable identity of the run (see module docstring)."""
        ident = {
            "name": self.name,
            "seed": self.seed,
            "chaos_enabled": self.chaos_enabled,
            "n_workflows": self.n_workflows,
            "n_tasks": self.n_tasks,
            "failed_tasks": self.failed_tasks,
            "unresolved_tasks": self.unresolved_tasks,
            "schedule": [
                (round(t, 6), kind, target)
                for t, kind, target in self.event_schedule
            ],
        }
        blob = json.dumps(ident, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def build_broker(spec: ScenarioSpec, device: str = "cuda") -> Hydra:
    """The spec's fleet as a live broker on ``device`` (call inside an
    active clock)."""
    h = Hydra(
        policy=spec.policy,
        pod_store="memory",
        streaming=True,
        batch_window=spec.batch_window,
        tasks_per_pod=spec.tasks_per_pod,
        staging_seed=spec.seed,
        site_capacity_mb=spec.site_capacity_mb,
        # write-through stage-out: a whole-site outage must not take an
        # intermediate dataset's last copy with it (core/staging.py)
        staging_mirror_outputs=True,
        # multi-tenant front door: weighted-fair lanes + SLO classes
        tenants=[t.to_core() for t in spec.tenants] or None,
        device=device,
    )
    for p in spec.providers:
        h.register_provider(p.to_core())
    if spec.checkpoint_interval_s is not None:
        h.enable_task_checkpoints(interval_s=spec.checkpoint_interval_s)
    if spec.kernel_autotune:
        # modeled timer: scenario determinism must not hinge on wall-clock
        # sweeps, and the roofline pick is what the dry-run report predicts
        h.enable_kernel_autotune(timer="model", seed=spec.seed)
    if spec.elastic:
        pool = ProviderPool([e.to_core() for e in spec.elastic], seed=spec.seed)
        planner = None
        if spec.market_slo_s is not None:
            from repro_torch.core.market import MarketPlanner

            planner = MarketPlanner(slo_target_s=spec.market_slo_s, seed=spec.seed)
        h.autoscale(pool, tick_s=1.0, planner=planner)
    return h


def run_scenario(
    spec: ScenarioSpec,
    chaos: bool = True,
    record_events: Optional[str] = None,
    device: str = "cuda",
) -> ScenarioReport:
    """Execute one spec under a fresh VirtualClock; return the report.

    ``chaos=False`` is the no-chaos twin: identical fleet, traffic, and
    seeds, zero injected events — the makespan baseline the inflation
    invariant compares against.

    ``record_events`` dumps the broker's full event log (core/events.py)
    to that JSONL path once the run quiesces; replay it with
    ``python -m repro_torch.core.events replay <path>`` (docs/OBSERVABILITY.md).

    ``device`` is the broker's (see build_broker)."""
    report = ScenarioReport(name=spec.name, seed=spec.seed, chaos_enabled=chaos)
    with virtual_time() as clock:
        h = build_broker(spec, device)
        if h.autotuner is not None and spec.traffic.serve_kernels:
            # pre-tune the serve lane's kernels at their payload shapes:
            # winners land as pinned ``tune:`` datasets in this registry
            # and one kernel.tune event each on this broker's bus
            from repro_torch.kernels.registry import get_kernel

            for kname in spec.traffic.serve_kernels:
                h.autotuner.tune(kname, get_kernel(kname).tiny_shape, "float32")
        wfs = build_traffic(h.staging.registry, spec.traffic, prefix=spec.name)
        tasks = [t for wf in wfs for t in wf.tasks]
        report.n_workflows = len(wfs)
        report.n_tasks = len(tasks)
        engine: Optional[ChaosEngine] = None
        if chaos and spec.chaos:
            engine = ChaosEngine(
                h, [c.to_core() for c in spec.chaos], seed=spec.seed
            )
        t0 = clock.now()
        if engine is not None:
            engine.arm()
        WorkflowManager(h).run(wfs, wait=True, timeout=spec.timeout_s)
        report.makespan_s = clock.now() - t0

        # -- task outcomes ---------------------------------------------
        for t in tasks:
            if not t.done():
                report.unresolved_tasks += 1
            elif t.cancelled() or t.exception() is not None:
                report.failed_tasks += 1
        report.failed_workflows = sum(1 for wf in wfs if wf.failed)

        # -- chaos timeline + recovery ---------------------------------
        if engine is not None:
            engine.stop()
            report.events = list(engine.log)
            report.event_schedule = engine.planned()
            report.chaos_stats = engine.stats()
            report.preempted_tasks = len(engine.preempted_uids)
            faults = [e["t"] for e in engine.log if e["kind"] in FAULT_KINDS]
            if faults:
                report.first_fault_s = min(faults) - t0
                last_recovered = None
                for t in tasks:
                    touched = any(
                        ev.startswith(RECOVERY_MARKERS)
                        for ev, _ in t.trace.events
                    )
                    if not touched:
                        continue
                    done_at = t.trace.last("exec_done")
                    if done_at is None:
                        continue
                    report.recovered_tasks += 1
                    if last_recovered is None or done_at > last_recovered:
                        last_recovered = done_at
                if last_recovered is not None:
                    report.recovery_s = max(
                        0.0, last_recovered - min(faults)
                    )

        # -- subsystem stats + post-shutdown residue -------------------
        report.staging = h.staging_stats()
        report.stream = h.stream_stats()
        scale = h.scale_stats()
        scale.pop("pending_acquisitions", None)  # not JSON-stable
        report.scale = scale
        report.kernel = {
            "execs": h.kernel_execs,
            "execs_by": dict(h.kernel_execs_by),
            "reps": h.kernel_reps,
            "seconds": round(h.kernel_seconds, 6),
            "tunes": h.autotuner.tunes if h.autotuner is not None else 0,
        }
        report.n_bus_events = len(h.events)
        if record_events is not None:
            h.events.dump_jsonl(record_events)
            report.events_path = record_events
        try:
            h.shutdown(wait=True)
        except LedgerDivergence as exc:
            report.ledger_error = str(exc)
        except EventsDivergence as exc:
            report.events_error = str(exc)
        d = h._dispatcher
        if d is not None:
            report.stranded_blocked = d.stalled_on_staging()
            report.stranded_retry_timers = len(d._retry_timers)
        pending = getattr(clock, "pending_deadlines", None)
        if pending is not None:
            report.pending_deadlines = pending()
    return report


def check_invariants(
    chaos_report: ScenarioReport,
    baseline_report: Optional[ScenarioReport],
    spec: ScenarioSpec,
) -> list[str]:
    """System-level contract under adversity; [] means the system held."""
    violations: list[str] = []
    for rep in (chaos_report, baseline_report):
        if rep is None:
            continue
        tag = "chaos" if rep.chaos_enabled else "baseline"
        if rep.failed_tasks:
            violations.append(f"{tag}: {rep.failed_tasks} task(s) failed")
        if rep.unresolved_tasks:
            violations.append(
                f"{tag}: {rep.unresolved_tasks} task future(s) never resolved"
            )
        if rep.failed_workflows:
            violations.append(f"{tag}: {rep.failed_workflows} workflow(s) failed")
        if rep.ledger_error:
            violations.append(f"{tag}: strict ledger diverged: {rep.ledger_error}")
        if rep.stranded_blocked:
            violations.append(
                f"{tag}: {rep.stranded_blocked} task(s) stranded in the "
                "staging-blocked set after shutdown"
            )
        if rep.stranded_retry_timers:
            violations.append(
                f"{tag}: {rep.stranded_retry_timers} live retry timer(s) "
                "after shutdown"
            )
        if rep.pending_deadlines:
            violations.append(
                f"{tag}: {rep.pending_deadlines} clock deadline(s) still "
                "pending after shutdown"
            )
    if baseline_report is not None and baseline_report.makespan_s > 0:
        inflation = chaos_report.makespan_s / baseline_report.makespan_s
        if inflation > spec.max_makespan_inflation:
            violations.append(
                f"makespan inflation {inflation:.3f}x exceeds the spec bound "
                f"{spec.max_makespan_inflation}x "
                f"({chaos_report.makespan_s:.1f}s vs "
                f"{baseline_report.makespan_s:.1f}s)"
            )
    return violations


def makespan_inflation(
    chaos_report: ScenarioReport, baseline_report: ScenarioReport
) -> float:
    if baseline_report.makespan_s <= 0:
        return float("inf")
    return chaos_report.makespan_s / baseline_report.makespan_s
