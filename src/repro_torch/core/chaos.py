"""Chaos engine: seeded, clock-scheduled, *correlated* fault injection.

Counterpart of ``repro/core/chaos.py``, copied with its imports rewritten.

The hybrid-cloud literature (PAPERS.md) treats correlated site/link failure
as the norm for cloud+HPC fleets, not the exception: a zone outage takes a
provider, its scratch storage, and its group siblings down *together*; a
WAN event partitions a whole platform pair at once; a provisioning-API
brownout quarantines every launch of a template.  This module injects those
coupled events against a live ``Hydra`` broker, scheduled entirely on the
``Clock`` abstraction — so under a ``VirtualClock`` an adversarial run is
deterministic and takes real milliseconds — and records what it did in an
append-only log the scenario layer (repro/scenarios) folds into its report.

Event types and their injection points:

  SiteOutage        Hydra.remove_provider(drain=False) per victim — hard
                    outage: manager fails in-flight work, staging drops the
                    site's replicas and re-routes/fails its transfers, the
                    orphan sweep re-binds survivors.  A group target takes
                    every member AND the group's logical staging site down
                    together; the autoscaler is told so dead elastic names
                    stop occupying pool headroom.
  LinkWindow        TransferEngine.link_override for a platform pair (both
                    directions by default) for ``duration_s``: factor > 0
                    degrades bandwidth, factor <= 0 partitions the pair.
                    Active transfers on the pair are restarted under the new
                    model (resample_link) at open AND close.
  QuarantineStorm   ProviderPool.force_quarantine(template): the scale-out
                    loop stops buying the template until the window closes
                    (rehabilitate) — a provisioning-API brownout.
  PreemptKill       task.mark_failed(Preempted) on up to ``count`` RUNNING
                    tasks with retry budget left; the executing manager
                    notices the FAILED state when the work function returns
                    and routes the task through the normal retry machinery.
                    With a TaskCheckpointer attached (core/broker.py
                    ``enable_task_checkpoints``), checkpointable victims
                    instead RESUME from their captured ``progress_frac`` on
                    a surviving provider without charging ``max_retries`` —
                    the storm becomes a priced, recoverable regime
                    (core/market.py) rather than a retry-budget drain.

Every event carries ``at_s`` relative to ``arm()`` time.  The engine never
raises out of a clock callback: injection errors are captured in the log
(``"error"`` entries) so one failed injection cannot wedge the clock thread
that fires every other deadline in the run.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Optional, Union

from repro_torch.core.managers.compute import Preempted
from repro_torch.core.staging import FALLBACK_LINK, LinkModel
from repro_torch.runtime.clock import ScheduledCall, get_clock

PARTITION_BANDWIDTH_MBPS = 1e-6  # effectively unroutable, never div-by-zero


@dataclass(frozen=True)
class SiteOutage:
    """Whole-site loss: provider (or group: all members) + its staging site."""

    at_s: float
    site: str
    kind: str = field(default="site_outage", init=False)

    @property
    def target(self) -> str:
        return self.site


@dataclass(frozen=True)
class LinkWindow:
    """Degradation (factor > 0 scales bandwidth) or partition (factor <= 0)
    of one platform pair for ``duration_s`` seconds."""

    at_s: float
    duration_s: float
    src_platform: str
    dst_platform: str
    factor: float = 0.0  # <= 0: partition
    bidirectional: bool = True
    kind: str = field(default="link_window", init=False)

    @property
    def target(self) -> str:
        arrow = "<->" if self.bidirectional else "->"
        return f"{self.src_platform}{arrow}{self.dst_platform}"


@dataclass(frozen=True)
class QuarantineStorm:
    """Provisioning-API brownout for one launch template."""

    at_s: float
    template: str
    duration_s: float = 0.0  # 0: stays until a real arrival resets it
    kind: str = field(default="quarantine_storm", init=False)

    @property
    def target(self) -> str:
        return self.template


@dataclass(frozen=True)
class PreemptKill:
    """Kill up to ``count`` RUNNING tasks (spot reclaim / walltime kill)."""

    at_s: float
    count: int = 1
    provider: Optional[str] = None  # None: fleet-wide
    kind: str = field(default="preempt_kill", init=False)

    @property
    def target(self) -> str:
        return self.provider or "*"


ChaosEvent = Union[SiteOutage, LinkWindow, QuarantineStorm, PreemptKill]


class ChaosEngine:
    """Schedules a seeded list of ChaosEvents against one broker.

    ``arm()`` books every event as a ``Clock.call_later`` deadline up front
    — which is also what makes a LinkWindow partition safe under a
    VirtualClock auto-advancer: the window-close deadline is always pending
    and *earlier* than any partition-priced transfer completion, so the
    advancer can never leap the run over the recovery.  ``stop()`` cancels
    outstanding deadlines and closes any link window still open, restoring
    the saved models."""

    def __init__(self, broker, events: list[ChaosEvent], seed: int = 0):
        self.broker = broker
        self.events = sorted(events, key=lambda e: (e.at_s, e.kind, e.target))
        self.rng = random.Random(seed)
        self.log: list[dict] = []
        self._lock = threading.RLock()
        self._calls: list[ScheduledCall] = []
        self._saved_links: dict[tuple[str, str], LinkModel] = {}
        self._open_windows = 0
        self._armed = False
        # per-kind injection counters (scenario reports)
        self.injected: dict[str, int] = {}
        self.preempted_uids: list[str] = []

    # -- scheduling ----------------------------------------------------
    def planned(self) -> list[tuple[float, str, str]]:
        """The deterministic event schedule: (at_s, kind, target)."""
        return [(e.at_s, e.kind, e.target) for e in self.events]

    def arm(self) -> "ChaosEngine":
        """Book every event on the active clock, relative to now."""
        with self._lock:
            if self._armed:
                raise RuntimeError("chaos engine already armed")
            self._armed = True
            clock = get_clock()
            for ev in self.events:
                self._calls.append(
                    clock.call_later(max(0.0, ev.at_s), lambda e=ev: self._fire(e))
                )
        return self

    def stop(self) -> None:
        """Cancel pending events; close any still-open link window."""
        with self._lock:
            calls, self._calls = self._calls, []
            for call in calls:
                call.cancel()
            saved, self._saved_links = dict(self._saved_links), {}
            self._open_windows = 0
        engine = self.broker.staging.engine
        for key, model in saved.items():
            engine.link_override(key, model)
            engine.resample_link(key)

    def _fire(self, ev: ChaosEvent) -> None:
        """Runs on a clock thread: must never raise (see module docstring)."""
        handler = {
            "site_outage": self._site_outage,
            "link_window": self._open_link_window,
            "quarantine_storm": self._quarantine_storm,
            "preempt_kill": self._preempt_kill,
        }[ev.kind]
        try:
            detail = handler(ev)
        except Exception as exc:  # noqa: BLE001 - log, never wedge the clock
            self._record(ev.kind, ev.target, {"error": repr(exc)})
        else:
            self._record(ev.kind, ev.target, detail)

    def _record(self, kind: str, target: str, detail: dict) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1
            self.broker.events.emit("chaos.inject", kind=kind, target=target)
            self.log.append(
                {
                    "t": round(get_clock().now(), 6),
                    "kind": kind,
                    "target": target,
                    "detail": detail,
                }
            )

    # -- handlers ------------------------------------------------------
    def _site_outage(self, ev: SiteOutage) -> dict:
        b = self.broker
        if b.proxy.is_group(ev.site):
            # correlated: the whole zone goes — every member, then the
            # group-local store the survivors would otherwise still read
            victims = list(b.proxy.get_group(ev.site).member_names())
        else:
            victims = [ev.site]
        removed = []
        for name in victims:
            try:
                b.remove_provider(name, drain=False, deregister=False)
            except KeyError:
                continue  # already gone (raced an elastic release)
            removed.append(name)
            if b.autoscaler is not None:
                b.autoscaler.note_provider_lost(name)
        if b.proxy.is_group(ev.site):
            b.staging.site_down(ev.site)
            b.data.deregister_site(ev.site)
        return {"removed": removed}

    def _degraded_model(self, base: LinkModel, factor: float) -> LinkModel:
        if factor <= 0:  # partition: unroutable, not divide-by-zero
            return LinkModel(
                bandwidth_mbps=PARTITION_BANDWIDTH_MBPS,
                latency_s=base.latency_s,
                jitter=0.0,
            )
        return LinkModel(
            bandwidth_mbps=base.bandwidth_mbps * factor,
            latency_s=base.latency_s,
            jitter=base.jitter,
        )

    def _link_keys(self, ev: LinkWindow) -> list[tuple[str, str]]:
        keys = [(ev.src_platform, ev.dst_platform)]
        if ev.bidirectional and ev.src_platform != ev.dst_platform:
            keys.append((ev.dst_platform, ev.src_platform))
        return keys

    def _open_link_window(self, ev: LinkWindow) -> dict:
        engine = self.broker.staging.engine
        restarted = 0
        with self._lock:
            self._open_windows += 1
            for key in self._link_keys(ev):
                prev = engine.link_override(
                    key, self._degraded_model(engine.links.get(key, FALLBACK_LINK), ev.factor)
                )
                # nested/overlapping windows: keep the ORIGINAL model, so the
                # last close restores reality and not an earlier degradation
                self._saved_links.setdefault(key, prev)
            self._calls.append(
                get_clock().call_later(
                    ev.duration_s, lambda e=ev: self._close_link_window(e)
                )
            )
        for key in self._link_keys(ev):
            restarted += engine.resample_link(key)
        return {
            "factor": ev.factor,
            "duration_s": ev.duration_s,
            "restarted_transfers": restarted,
        }

    def _close_link_window(self, ev: LinkWindow) -> None:
        engine = self.broker.staging.engine
        restarted = 0
        with self._lock:
            self._open_windows = max(0, self._open_windows - 1)
            restore = {}
            if self._open_windows == 0:
                # last window out restores every saved pair (overlapping
                # windows over the same pair share one saved original)
                restore, self._saved_links = dict(self._saved_links), {}
            else:
                for key in self._link_keys(ev):
                    if key in self._saved_links:
                        restore[key] = self._saved_links.pop(key)
        for key, model in restore.items():
            engine.link_override(key, model)
            restarted += engine.resample_link(key)
        self._record(
            "link_restore", ev.target, {"restarted_transfers": restarted}
        )

    def _quarantine_storm(self, ev: QuarantineStorm) -> dict:
        scaler = self.broker.autoscaler
        if scaler is None:
            return {"skipped": "no autoscaler attached"}
        scaler.pool.force_quarantine(ev.template)
        if ev.duration_s > 0:
            with self._lock:
                self._calls.append(
                    get_clock().call_later(
                        ev.duration_s, lambda e=ev: self._end_quarantine(e)
                    )
                )
        return {"duration_s": ev.duration_s}

    def _end_quarantine(self, ev: QuarantineStorm) -> None:
        scaler = self.broker.autoscaler
        if scaler is not None:
            scaler.pool.rehabilitate(ev.template)
        self._record("quarantine_lift", ev.template, {})

    def _preempt_kill(self, ev: PreemptKill) -> dict:
        # only victims with retry budget left: chaos verifies resilience, it
        # must not manufacture a terminal failure the invariants then flag
        victims = [
            t
            for t in self.broker._running_tasks()
            if t.retries < t.max_retries
            and (ev.provider is None or t.provider == ev.provider)
        ]
        victims.sort(key=lambda t: t.uid)  # stable pool for the seeded draw
        if len(victims) > ev.count:
            victims = self.rng.sample(victims, ev.count)
        killed = []
        for t in victims:
            if t.mark_failed(Preempted(t.provider or "?")):
                t.trace.add("preempted")
                killed.append(t.uid)
        with self._lock:
            self.preempted_uids.extend(killed)
        return {"requested": ev.count, "killed": len(killed)}

    # -- metrics -------------------------------------------------------
    def stats(self) -> dict:
        """Injection counts are the log-derived view over chaos.inject
        events (the legacy dict stays as HYDRA_EVENTS_CHECK ground truth);
        the rest are live gauges of this engine's plan state."""
        injected = {
            k: int(n)
            for k, n in sorted(
                self.broker.events.view.keyed_get("hydra.chaos.injected").items()
            )
        }
        with self._lock:
            return {
                "events_planned": len(self.events),
                "injected": injected,
                "preempted": len(self.preempted_uids),
                "open_link_windows": self._open_windows,
                "log_entries": len(self.log),
            }
