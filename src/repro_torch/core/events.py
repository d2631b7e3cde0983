"""Event-sourced control plane: one append-only, clock-stamped event log.

Every observable state change in the broker — provider lifecycle, breaker
transitions, dispatch/completion/skip, elastic acquisition, staging
transfers, admission decisions, chaos injections — is emitted as a
structured :class:`Event` onto a single :class:`EventBus`.  The legacy
per-subsystem stats dicts (``stream_stats``, ``scale_stats``,
``staging_stats``, ``group_rows``, ``admission.stats``) are *derived
views* over this log: the bus folds each event into a
:class:`MetricsView` at emit time, and the dict-shaped accessors read
the view (or, during migration, the legacy accumulators that the view
must agree with).

Design rules, mirroring :mod:`repro_torch.core.ledger`:

* **Append is O(1)** — one lock acquire, one timestamp, one list append,
  one reducer step.  The dispatch hot path emits per *batch*, never per
  task, so exp9/exp11 throughput is unaffected beyond noise.
* **Reduce-on-emit** — the view is folded under the bus lock in
  sequence order.  Replaying the serialized log folds the same values in
  the same order, so every float in the derived metrics reconstructs
  bit-for-bit (Python floats round-trip exactly through ``json``).
* **Strict mode** — ``HYDRA_EVENTS_CHECK=1`` (the events twin of
  ``HYDRA_LEDGER_CHECK``) cross-checks the derived view against the
  legacy accumulators with a short retry loop; a persistent mismatch
  raises :class:`EventsDivergence` and is re-raised from
  ``Hydra.shutdown()`` so CI cannot miss it.

Record and replay::

    HYDRA_EVENTS_LOG=/tmp/run.jsonl python -m benchmarks.exp10_scenario
    python -m repro_torch.core.events replay /tmp/run.jsonl

The JSONL header line embeds the live derived-metrics snapshot taken at
dump time; ``replay`` recomputes the metrics from the event records and
verifies they match the header bit-for-bit.

Env knobs (see docs/OBSERVABILITY.md):

* ``HYDRA_EVENTS_CHECK`` — non-empty/non-zero enables strict cross-checks.
* ``HYDRA_EVENTS_LOG``   — path prefix: each broker dumps its stream at
  shutdown (first broker writes the path verbatim, later ones ``.2``,
  ``.3``, ...).
* ``HYDRA_EVENTS_BUFFER`` — max retained events (0 = unbounded).  Views
  stay exact either way (they are reduced incrementally); only the
  replayable tail is capped, and dumps of a truncated log say so.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    NamedTuple,
    Optional,
    TextIO,
    Tuple,
)

from repro_torch.runtime.clock import get_clock

__all__ = [
    "EVENTS",
    "Event",
    "EventBus",
    "EventSpec",
    "EventsDivergence",
    "MetricsView",
    "replay_jsonl",
]

JSONL_VERSION = 1


class EventsDivergence(AssertionError):
    """Raised when the log-derived view disagrees with a legacy accumulator.

    Subclasses ``AssertionError`` so strict mode fails tests loudly, same
    as :class:`repro_torch.core.ledger.LedgerDivergence`.
    """


# ---------------------------------------------------------------------------
# Taxonomy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EventSpec:
    """One row of the event taxonomy (mirrored in docs/OBSERVABILITY.md)."""

    name: str
    fields: Tuple[str, ...]
    site: str  # emitting call site, "module.func"
    metrics: Tuple[str, ...]  # OTel-style derived metric names
    doc: str


def _spec(name: str, fields: str, site: str, metrics: str, doc: str) -> EventSpec:
    return EventSpec(
        name=name,
        fields=tuple(f for f in fields.split() if f),
        site=site,
        metrics=tuple(m for m in metrics.split() if m),
        doc=doc,
    )


#: The full event taxonomy: name -> spec.  ``tools/docs_check.py`` keeps
#: this table and the one in docs/OBSERVABILITY.md in lockstep.
EVENTS: Dict[str, EventSpec] = {
    s.name: s
    for s in (
        # -- provider lifecycle (broker.py) --------------------------------
        _spec(
            "provider.register",
            "provider slots group",
            "broker.register_provider",
            "hydra.provider.registered",
            "A provider (direct or group member) became dispatchable.",
        ),
        _spec(
            "provider.deregister",
            "provider reason",
            "broker.remove_provider",
            "hydra.provider.deregistered",
            "A provider was removed (drain, outage, or registration rollback).",
        ),
        _spec(
            "provider.blacklist",
            "provider",
            "broker._handle_provider_down",
            "hydra.provider.blacklisted",
            "A provider was marked unhealthy and excluded from placement.",
        ),
        # -- circuit breaker (group.py) ------------------------------------
        _spec(
            "breaker.transition",
            "member old new",
            "group._wire_member",
            "hydra.breaker.transitions",
            "A member circuit breaker moved between closed/open/half_open.",
        ),
        # -- dispatch (dispatcher.py) --------------------------------------
        _spec(
            "dispatch.batch",
            "n",
            "dispatcher._dispatch",
            "hydra.dispatch.batches hydra.dispatch.tasks",
            "One placed batch left the dispatcher (n = tasks in the batch).",
        ),
        _spec(
            "dispatch.retry",
            "",
            "dispatcher._retry",
            "hydra.dispatch.retry_backoffs",
            "Dispatch found no eligible provider and backed off.",
        ),
        _spec(
            "dispatch.loop_error",
            "",
            "dispatcher._loop",
            "hydra.dispatch.loop_errors",
            "The dispatch loop swallowed an unexpected exception.",
        ),
        # -- task terminal states (broker.py / group.py) -------------------
        _spec(
            "task.complete",
            "provider failed",
            "broker._on_task_done",
            "hydra.tasks.completed hydra.tasks.failed",
            "An ungrouped task reached a terminal done/failed state.",
        ),
        _spec(
            "task.skip",
            "provider",
            "broker._on_task_skipped",
            "hydra.tasks.skipped",
            "An ungrouped task was skipped (dependency failure upstream).",
        ),
        _spec(
            "group.dispatch",
            "group member n",
            "group.note_dispatch",
            "hydra.group.dispatched",
            "A batch of n tasks was handed to a group member.",
        ),
        _spec(
            "group.complete",
            "group member failed",
            "group.record_success/record_failure",
            "hydra.group.completed hydra.group.failed "
            "hydra.tasks.completed hydra.tasks.failed",
            "A grouped task reached a terminal done/failed state.",
        ),
        _spec(
            "group.skip",
            "group member",
            "group.record_skip",
            "hydra.group.skips hydra.tasks.skipped",
            "A grouped task was skipped after dispatch.",
        ),
        _spec(
            "group.member_join",
            "group member slots",
            "group.add_member",
            "hydra.group.member_joins",
            "A member joined a provider group (registration or hot-add).",
        ),
        _spec(
            "group.member_leave",
            "group member",
            "group.remove_member",
            "hydra.group.member_leaves",
            "A member left a provider group.",
        ),
        # -- backlog (broker.py) -------------------------------------------
        _spec(
            "backlog.enter",
            "n",
            "broker._submit_pipeline",
            "hydra.tasks.entered",
            "n tasks entered the broker backlog (post-admission).",
        ),
        _spec(
            "backlog.resolve",
            "",
            "broker._on_task_resolved",
            "hydra.tasks.resolved",
            "One backlog task resolved (done, failed, or canceled).",
        ),
        # -- elastic acquisition (autoscaler.py) ---------------------------
        _spec(
            "scale.tick",
            "pressure",
            "autoscaler._tick",
            "hydra.scale.ticks",
            "One autoscaler control-loop evaluation.",
        ),
        _spec(
            "acquire.begin",
            "instance platform",
            "autoscaler._acquire",
            "hydra.scale.acquisitions",
            "An instance acquisition was requested from a platform.",
        ),
        _spec(
            "acquire.complete",
            "instance",
            "autoscaler._arrive",
            "hydra.scale.arrivals",
            "An acquired instance arrived and registered.",
        ),
        _spec(
            "acquire.abort",
            "instance",
            "autoscaler._abort",
            "hydra.scale.aborts",
            "An in-flight acquisition was aborted before arrival.",
        ),
        _spec(
            "scale.release",
            "instance",
            "autoscaler._release",
            "hydra.scale.releases",
            "An idle elastic instance was released back to its platform.",
        ),
        # -- admission (admission.py) --------------------------------------
        _spec(
            "admission.accept",
            "tenant n",
            "admission.admit",
            "hydra.admission.admitted",
            "n tasks from one submission cleared the front door.",
        ),
        _spec(
            "admission.reject",
            "tenant reason",
            "admission._reject",
            "hydra.admission.rejected",
            "A submission was rejected (keyed by tenant:reason).",
        ),
        # -- staging: service level (staging.py) ---------------------------
        _spec(
            "stage.in",
            "task site missing",
            "staging.stage_task",
            "hydra.staging.stage_ins",
            "A task needed inputs pulled to its execution site.",
        ),
        _spec(
            "stage.wait",
            "task wait_s",
            "staging.stage_task.finish",
            "hydra.staging.transfer_wait_s",
            "A staged task waited wait_s (virtual) for its inputs.",
        ),
        _spec(
            "stage.out",
            "dataset site mb",
            "staging.task_completed",
            "hydra.staging.stage_outs",
            "A produced output was registered at its site.",
        ),
        _spec(
            "stage.drop",
            "dataset site",
            "staging.task_completed",
            "hydra.staging.stage_out_drops",
            "A produced output was dropped (site lost before stage-out).",
        ),
        _spec(
            "stage.mirror",
            "dataset mb",
            "staging.task_completed",
            "hydra.staging.mirrored_mb",
            "An output was mirrored to the durable store.",
        ),
        _spec(
            "stage.evacuate",
            "site mb",
            "staging.evacuate",
            "hydra.staging.evacuated_mb",
            "Replicas were evacuated off a draining site.",
        ),
        # -- staging: transfer engine (staging.py) -------------------------
        _spec(
            "transfer.hit",
            "dataset site",
            "staging.TransferEngine.fetch",
            "hydra.staging.cache_hits",
            "A fetch was satisfied by an already-resident replica.",
        ),
        _spec(
            "transfer.cold",
            "dataset dst",
            "staging.TransferEngine.fetch",
            "hydra.staging.cold_reads",
            "A fetch fell back to the durable store (no warm replica).",
        ),
        _spec(
            "transfer.start",
            "dataset src dst wait_s",
            "staging.TransferEngine._start",
            "hydra.staging.queue_wait_s",
            "A transfer left the queue after waiting wait_s (virtual).",
        ),
        _spec(
            "transfer.done",
            "dataset src dst mb",
            "staging.TransferEngine._complete",
            "hydra.staging.transfers hydra.staging.mb_moved",
            "A transfer finished and the replica landed at dst.",
        ),
        _spec(
            "transfer.fail",
            "dataset dst",
            "staging.TransferEngine._complete/site_down",
            "hydra.staging.transfer_failures",
            "A transfer failed (link fault, lost site, or unknown dataset).",
        ),
        _spec(
            "transfer.reroute",
            "dataset src dst",
            "staging.TransferEngine.site_down",
            "hydra.staging.reroutes",
            "An in-flight transfer was rerouted around a dead endpoint.",
        ),
        _spec(
            "replica.evict",
            "dataset site",
            "staging.ReplicaRegistry.place_replica",
            "hydra.staging.evictions",
            "An LRU replica was evicted to make room at a site.",
        ),
        # -- market (market.py) --------------------------------------------
        _spec(
            "market.plan",
            "demand chosen",
            "market.MarketPlanner.plan",
            "hydra.market.plans",
            "The bid loop produced a platform mix for the current demand.",
        ),
        _spec(
            "market.bid",
            "template price eff_slots",
            "market.MarketPlanner.plan",
            "hydra.market.bids",
            "One template was selected in a plan (keyed by template).",
        ),
        _spec(
            "market.price",
            "template price",
            "market.MarketPlanner.set_price",
            "hydra.market.reprices",
            "A template was repriced mid-run (spot market movement).",
        ),
        _spec(
            "market.spend",
            "instance node_s dollars",
            "market.MarketPlanner.settle",
            "hydra.cost_node_seconds hydra.cost_dollars",
            "An instance's occupancy was settled into the cost ledger.",
        ),
        # -- checkpoint/restore (ckpt/checkpoint.py) -----------------------
        _spec(
            "ckpt.save",
            "task dataset progress",
            "checkpoint.TaskCheckpointer.on_preempt",
            "hydra.ckpt.saves",
            "A preempted task's progress was captured as a replicated dataset.",
        ),
        _spec(
            "ckpt.resume",
            "task progress lost_s done_s",
            "checkpoint.TaskCheckpointer.on_preempt",
            "hydra.ckpt.resumes hydra.ckpt.reexecuted_s hydra.ckpt.preempted_work_s",
            "A preempted task will resume from its checkpoint, not from zero.",
        ),
        # -- kernels (kernels/autotune.py + broker) ------------------------
        _spec(
            "kernel.tune",
            "kernel sig config swept exhaustive",
            "autotune.Autotuner.tune",
            "hydra.kernel.tunes hydra.kernel.swept_configs",
            "A cache-miss sweep chose a tuned config (cache hits never re-emit).",
        ),
        _spec(
            "kernel.exec",
            "kernel reps kernel_s",
            "broker.Hydra._on_task_done",
            "hydra.kernel.execs hydra.kernel.reps hydra.kernel.seconds",
            "A kernel-payload task completed real Pallas work (keyed by kernel).",
        ),
        # -- chaos (chaos.py) ----------------------------------------------
        _spec(
            "chaos.inject",
            "kind target",
            "chaos.ChaosEngine._record",
            "hydra.chaos.injected",
            "A chaos fault (or its restore twin) was injected (keyed by kind).",
        ),
    )
}


# ---------------------------------------------------------------------------
# Events and the derived view
# ---------------------------------------------------------------------------


class Event(NamedTuple):
    """One immutable log record: sequence number, virtual time, name, attrs.

    A NamedTuple, not a dataclass: ``emit`` sits adjacent to every hot-path
    counter increment, and tuple construction is ~3x cheaper than a frozen
    dataclass ``__init__`` (which pays ``object.__setattr__`` per field).
    """

    seq: int
    t: float
    name: str
    attrs: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(
            {"seq": self.seq, "t": self.t, "name": self.name, "attrs": self.attrs},
            sort_keys=True,
            separators=(",", ":"),
        )


def _canonical_key(e: Event) -> Tuple[float, str, str]:
    return (e.t, e.name, json.dumps(e.attrs, sort_keys=True))


class MetricsView:
    """Derived metrics folded from the event log.

    Two shapes, both commutative in the integer case and order-exact in
    the float case (the bus folds in seq order, replay folds in the same
    order):

    * ``counters``: OTel metric name -> number.
    * ``keyed``:    OTel metric name -> {attribute key: number}, for
      metrics broken out by member / tenant:reason / chaos kind.
    """

    __slots__ = ("counters", "keyed", "unknown")

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.keyed: Dict[str, Dict[str, float]] = {}
        self.unknown = 0

    # -- folding -----------------------------------------------------------

    def _bump(self, metric: str, by: float = 1) -> None:
        self.counters[metric] = self.counters.get(metric, 0) + by

    def _bump_keyed(self, metric: str, key: str, by: float = 1) -> None:
        d = self.keyed.setdefault(metric, {})
        d[key] = d.get(key, 0) + by

    def apply(self, name: str, attrs: Dict[str, Any]) -> None:
        fn = _REDUCERS.get(name)
        if fn is None:
            self.unknown += 1
            return
        fn(self, attrs)

    # -- reading -----------------------------------------------------------

    def get(self, metric: str, default: float = 0) -> float:
        return self.counters.get(metric, default)

    def keyed_get(self, metric: str) -> Dict[str, float]:
        return dict(self.keyed.get(metric, {}))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot of every derived metric."""
        return {
            "counters": dict(sorted(self.counters.items())),
            "keyed": {m: dict(sorted(d.items())) for m, d in sorted(self.keyed.items())},
        }

    def flat(self) -> Dict[str, float]:
        """Flattened ``metric`` / ``metric:key`` -> value mapping."""
        out: Dict[str, float] = dict(self.counters)
        for metric, d in self.keyed.items():
            for key, val in d.items():
                out[f"{metric}:{key}"] = val
        return out


def _r_provider_register(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.provider.registered")


def _r_provider_deregister(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.provider.deregistered")


def _r_provider_blacklist(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.provider.blacklisted")


def _r_breaker_transition(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.breaker.transitions")
    v._bump_keyed("hydra.breaker.transitions", f"{a['old']}->{a['new']}")


def _r_dispatch_batch(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.dispatch.batches")
    v._bump("hydra.dispatch.tasks", a["n"])


def _r_dispatch_retry(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.dispatch.retry_backoffs")


def _r_dispatch_loop_error(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.dispatch.loop_errors")


def _r_task_complete(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.tasks.failed" if a.get("failed") else "hydra.tasks.completed")


def _r_task_skip(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.tasks.skipped")


def _r_group_dispatch(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump_keyed("hydra.group.dispatched", a["member"], a["n"])


def _r_group_complete(v: MetricsView, a: Dict[str, Any]) -> None:
    if a.get("failed"):
        v._bump_keyed("hydra.group.failed", a["member"])
        v._bump("hydra.tasks.failed")
    else:
        v._bump_keyed("hydra.group.completed", a["member"])
        v._bump("hydra.tasks.completed")


def _r_group_skip(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump_keyed("hydra.group.skips", a["member"])
    v._bump("hydra.tasks.skipped")


def _r_group_member_join(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.group.member_joins")


def _r_group_member_leave(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.group.member_leaves")


def _r_backlog_enter(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.tasks.entered", a["n"])


def _r_backlog_resolve(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.tasks.resolved")


def _r_scale_tick(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.scale.ticks")


def _r_acquire_begin(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.scale.acquisitions")


def _r_acquire_complete(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.scale.arrivals")


def _r_acquire_abort(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.scale.aborts")


def _r_scale_release(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.scale.releases")


def _r_admission_accept(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.admission.admitted", a["n"])


def _r_admission_reject(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump_keyed("hydra.admission.rejected", f"{a['tenant']}:{a['reason']}")


def _r_stage_in(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.stage_ins")


def _r_stage_wait(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.transfer_wait_s", a["wait_s"])


def _r_stage_out(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.stage_outs")


def _r_stage_drop(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.stage_out_drops")


def _r_stage_mirror(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.mirrored_mb", a["mb"])


def _r_stage_evacuate(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.evacuated_mb", a["mb"])


def _r_transfer_hit(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.cache_hits")


def _r_transfer_cold(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.cold_reads")


def _r_transfer_start(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.queue_wait_s", a["wait_s"])


def _r_transfer_done(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.transfers")
    v._bump("hydra.staging.mb_moved", a["mb"])


def _r_transfer_fail(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.transfer_failures")


def _r_transfer_reroute(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.reroutes")


def _r_replica_evict(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.staging.evictions")


def _r_market_plan(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.market.plans")


def _r_market_bid(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.market.bids")
    v._bump_keyed("hydra.market.bids", a["template"])


def _r_market_price(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.market.reprices")


def _r_market_spend(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.cost_node_seconds", a["node_s"])
    v._bump("hydra.cost_dollars", a["dollars"])


def _r_ckpt_save(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.ckpt.saves")


def _r_ckpt_resume(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.ckpt.resumes")
    v._bump("hydra.ckpt.reexecuted_s", a["lost_s"])
    v._bump("hydra.ckpt.preempted_work_s", a["done_s"])


def _r_kernel_tune(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.kernel.tunes")
    v._bump("hydra.kernel.swept_configs", a["swept"])


def _r_kernel_exec(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump("hydra.kernel.execs")
    v._bump_keyed("hydra.kernel.execs", a["kernel"])
    v._bump("hydra.kernel.reps", a["reps"])
    v._bump("hydra.kernel.seconds", a["kernel_s"])


def _r_chaos_inject(v: MetricsView, a: Dict[str, Any]) -> None:
    v._bump_keyed("hydra.chaos.injected", a["kind"])


_REDUCERS: Dict[str, Callable[[MetricsView, Dict[str, Any]], None]] = {
    "provider.register": _r_provider_register,
    "provider.deregister": _r_provider_deregister,
    "provider.blacklist": _r_provider_blacklist,
    "breaker.transition": _r_breaker_transition,
    "dispatch.batch": _r_dispatch_batch,
    "dispatch.retry": _r_dispatch_retry,
    "dispatch.loop_error": _r_dispatch_loop_error,
    "task.complete": _r_task_complete,
    "task.skip": _r_task_skip,
    "group.dispatch": _r_group_dispatch,
    "group.complete": _r_group_complete,
    "group.skip": _r_group_skip,
    "group.member_join": _r_group_member_join,
    "group.member_leave": _r_group_member_leave,
    "backlog.enter": _r_backlog_enter,
    "backlog.resolve": _r_backlog_resolve,
    "scale.tick": _r_scale_tick,
    "acquire.begin": _r_acquire_begin,
    "acquire.complete": _r_acquire_complete,
    "acquire.abort": _r_acquire_abort,
    "scale.release": _r_scale_release,
    "admission.accept": _r_admission_accept,
    "admission.reject": _r_admission_reject,
    "stage.in": _r_stage_in,
    "stage.wait": _r_stage_wait,
    "stage.out": _r_stage_out,
    "stage.drop": _r_stage_drop,
    "stage.mirror": _r_stage_mirror,
    "stage.evacuate": _r_stage_evacuate,
    "transfer.hit": _r_transfer_hit,
    "transfer.cold": _r_transfer_cold,
    "transfer.start": _r_transfer_start,
    "transfer.done": _r_transfer_done,
    "transfer.fail": _r_transfer_fail,
    "transfer.reroute": _r_transfer_reroute,
    "replica.evict": _r_replica_evict,
    "market.plan": _r_market_plan,
    "market.bid": _r_market_bid,
    "market.price": _r_market_price,
    "market.spend": _r_market_spend,
    "ckpt.save": _r_ckpt_save,
    "ckpt.resume": _r_ckpt_resume,
    "kernel.tune": _r_kernel_tune,
    "kernel.exec": _r_kernel_exec,
    "chaos.inject": _r_chaos_inject,
}

assert set(_REDUCERS) == set(EVENTS), "taxonomy and reducers out of sync"


# ---------------------------------------------------------------------------
# The bus
# ---------------------------------------------------------------------------

_log_path_counter = itertools.count(1)


def next_log_path(base: str) -> str:
    """Resolve the dump path for the next broker under HYDRA_EVENTS_LOG.

    The first broker in the process writes ``base`` verbatim; later ones
    get ``base.2``, ``base.3``, ... so concurrent brokers (e.g. the
    chaos run and its fault-free twin) never clobber each other.
    """
    n = next(_log_path_counter)
    return base if n == 1 else f"{base}.{n}"


class EventBus:
    """Append-only broker event log with an incrementally-folded view.

    ``emit`` is the only write path: it stamps the event with the active
    clock (virtual under ``virtual_time()``), appends it, and folds it
    into :attr:`view` — all under one lock, so view state is always a
    prefix-fold of the log in sequence order.
    """

    def __init__(self, strict: Optional[bool] = None, buffer: Optional[int] = None):
        if strict is None:
            strict = os.environ.get("HYDRA_EVENTS_CHECK", "") not in ("", "0")
        if buffer is None:
            try:
                buffer = int(os.environ.get("HYDRA_EVENTS_BUFFER", "0"))
            except ValueError:
                buffer = 0
        self.strict = bool(strict)
        self.buffer = max(0, buffer)
        self.view = MetricsView()
        # raw (seq, t, name, attrs) tuples; rehydrated as Event on read
        self._events: List[Tuple[int, float, str, Dict[str, Any]]] = []
        self._seq = 0
        self._dropped = 0
        self._lock = threading.Lock()
        self._recompute: Optional[Callable[[], Dict[str, float]]] = None
        self.divergences = 0
        self.last_divergence: Optional[str] = None

    # -- write path --------------------------------------------------------

    def emit(self, name: str, **attrs: Any) -> None:
        """Append one event and fold it into the derived view. O(1).

        Hot path: this call sits adjacent to every instrumented counter
        increment (~3 emits per dispatched task on the staged fast path),
        so the reducer is resolved before the lock, the fold is inlined
        (skipping ``MetricsView.apply``'s extra dispatch hop), and records
        are appended as plain tuples — ``Event`` is a NamedTuple precisely
        so the read paths can rehydrate ``Event(*raw)`` for free while the
        write path skips NamedTuple ``__new__``.  Timestamps come from
        ``Clock.stamp()`` (lock-free) rather than ``now()``: three emits
        per task contending on the VirtualClock condition was the single
        largest bus cost on the dispatch hot path.
        """
        t = get_clock().stamp()
        fn = _REDUCERS.get(name)
        events = self._events
        view = self.view
        with self._lock:
            self._seq += 1
            events.append((self._seq, t, name, attrs))
            if self.buffer and len(events) > self.buffer:
                del events[0]
                self._dropped += 1
            if fn is None:
                view.unknown += 1
            else:
                fn(view, attrs)

    # -- read path ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        return self._dropped

    def events(self) -> List[Event]:
        with self._lock:
            raw = list(self._events)
        return [Event(*e) for e in raw]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self.view.snapshot()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "n_events": self._seq,
                "retained": len(self._events),
                "dropped": self._dropped,
                "strict": self.strict,
                "divergences": self.divergences,
            }

    # -- serialization -----------------------------------------------------

    def dump_jsonl(self, path_or_file) -> Dict[str, Any]:
        """Serialize the retained log (seq order) plus a header snapshot.

        The header line carries the derived-metrics snapshot taken
        atomically with the event copy, so ``replay`` can verify the
        reconstruction bit-for-bit.  Returns the header dict.
        """
        with self._lock:
            raw = list(self._events)
            header = {
                "hydra_events_version": JSONL_VERSION,
                "n_events": self._seq,
                "retained": len(raw),
                "dropped": self._dropped,
                "snapshot": self.view.snapshot(),
            }
        events = [Event(*e) for e in raw]
        if hasattr(path_or_file, "write"):
            self._write_stream(path_or_file, header, events)
        else:
            with open(path_or_file, "w", encoding="utf-8") as fh:
                self._write_stream(fh, header, events)
        return header

    @staticmethod
    def _write_stream(fh: TextIO, header: Dict[str, Any], events: List[Event]) -> None:
        fh.write(json.dumps(header, sort_keys=True, separators=(",", ":")) + "\n")
        for e in events:
            fh.write(e.to_json() + "\n")

    def canonical_jsonl(self) -> str:
        """Interleaving-independent serialization for cross-run comparison.

        Drops ``seq`` (assigned in arrival order, which thread scheduling
        may permute between identically-seeded runs) and sorts records by
        (t, name, attrs).  Two runs of a deterministic workload produce
        byte-identical canonical streams.
        """
        with self._lock:
            raw = list(self._events)
        rows = sorted((Event(*e) for e in raw), key=_canonical_key)
        return "".join(
            json.dumps(
                {"t": e.t, "name": e.name, "attrs": e.attrs},
                sort_keys=True,
                separators=(",", ":"),
            )
            + "\n"
            for e in rows
        )

    # -- strict cross-check (HYDRA_EVENTS_CHECK=1) -------------------------

    def attach(self, recompute: Callable[[], Dict[str, float]]) -> None:
        """Install the legacy-accumulator recompute used by :meth:`check`.

        ``recompute`` returns a flat mapping ``metric`` / ``metric:key``
        -> value built from the legacy counters; only keys it returns are
        compared, so subsystems that are not wired (no autoscaler, no
        groups) simply contribute nothing.
        """
        self._recompute = recompute

    def _diff(self) -> Dict[str, Tuple[float, float]]:
        if self._recompute is None:
            return {}
        legacy = self._recompute()  # outside the bus lock: lock-order discipline
        with self._lock:
            derived = self.view.flat()
        out = {}
        for key, want in legacy.items():
            got = derived.get(key, 0)
            if got != want:
                out[key] = (want, got)
        return out

    def check(self, retries: int = 30, retry_sleep_s: float = 0.002) -> None:
        """Compare the derived view against the legacy accumulators.

        Emission happens adjacent to (not atomically with) each legacy
        increment, so a reader can land between the two; the retry loop
        absorbs those transients exactly like the ledger's.  A mismatch
        that survives the retries is recorded and raised.
        """
        if self._recompute is None:
            return
        diff = self._diff()
        for _ in range(retries):
            if not diff:
                return
            time.sleep(retry_sleep_s)
            diff = self._diff()
        msg = "derived view diverged from legacy accumulators: " + ", ".join(
            f"{k}: legacy={want!r} derived={got!r}"
            for k, (want, got) in sorted(diff.items())
        )
        self.divergences += 1
        self.last_divergence = msg
        raise EventsDivergence(msg)

    def maybe_check(self) -> None:
        """Strict-mode hook for the stats accessors: check, record, re-raise."""
        if not self.strict:
            return
        self.check()


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def replay_jsonl(lines: Iterable[str]) -> Tuple[MetricsView, Dict[str, Any]]:
    """Fold a serialized event stream back into a fresh MetricsView.

    Returns ``(view, header)`` where ``header`` is the dump-time metadata
    (empty dict if the stream has no header line).  Records are folded in
    file order, which ``dump_jsonl`` guarantees is sequence order, so
    every derived float reconstructs bit-for-bit.
    """
    view = MetricsView()
    header: Dict[str, Any] = {}
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if i == 0 and "hydra_events_version" in rec:
            header = rec
            continue
        view.apply(rec["name"], rec.get("attrs", {}))
    return view, header


def verify_replay(path: str) -> Tuple[bool, Dict[str, Any], Dict[str, Any]]:
    """Replay ``path`` and compare against its embedded header snapshot.

    Returns ``(ok, replayed_snapshot, header)``.  ``ok`` is False when
    the recomputed metrics differ from the dump-time snapshot (stream
    mutated or truncated) or when the header is missing/incomplete.
    """
    with open(path, encoding="utf-8") as fh:
        view, header = replay_jsonl(fh)
    replayed = view.snapshot()
    want = header.get("snapshot")
    ok = bool(header) and not header.get("dropped") and replayed == want
    return ok, replayed, header


def _diff_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    fa = dict(a.get("counters", {}))
    for m, d in a.get("keyed", {}).items():
        fa.update({f"{m}:{k}": val for k, val in d.items()})
    fb = dict(b.get("counters", {}))
    for m, d in b.get("keyed", {}).items():
        fb.update({f"{m}:{k}": val for k, val in d.items()})
    out = []
    for key in sorted(set(fa) | set(fb)):
        va, vb = fa.get(key, 0), fb.get(key, 0)
        if va != vb:
            out.append(f"{key}: {va!r} != {vb!r}")
    return out


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.core.events {replay,diff,taxonomy}
# ---------------------------------------------------------------------------


def _cmd_replay(args: argparse.Namespace) -> int:
    ok, replayed, header = verify_replay(args.log)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(replayed, fh, indent=2, sort_keys=True)
            fh.write("\n")
    n = header.get("retained", "?")
    if not header:
        print(f"replay: {args.log}: no header line — cannot self-verify", file=sys.stderr)
        return 2
    if header.get("dropped"):
        print(
            f"replay: {args.log}: {header['dropped']} events dropped by "
            "HYDRA_EVENTS_BUFFER — log is partial, snapshot not reconstructible",
            file=sys.stderr,
        )
        return 2
    if ok:
        print(f"replay: {args.log}: {n} events -> derived metrics bit-identical to snapshot")
        return 0
    print(f"replay: {args.log}: DIVERGED from dump-time snapshot:", file=sys.stderr)
    for line in _diff_snapshots(header.get("snapshot", {}), replayed):
        print(f"  {line}", file=sys.stderr)
    return 1


def _cmd_diff(args: argparse.Namespace) -> int:
    snaps = []
    for path in (args.a, args.b):
        with open(path, encoding="utf-8") as fh:
            view, _header = replay_jsonl(fh)
        snaps.append(view.snapshot())
    lines = _diff_snapshots(snaps[0], snaps[1])
    if not lines:
        print(f"diff: {args.a} and {args.b} derive identical metrics")
        return 0
    print(f"diff: {len(lines)} metrics differ ({args.a} vs {args.b}):")
    for line in lines:
        print(f"  {line}")
    return 1


def _cmd_taxonomy(_args: argparse.Namespace) -> int:
    for name in sorted(EVENTS):
        spec = EVENTS[name]
        fields = " ".join(spec.fields) or "-"
        print(f"{name:22s} fields=[{fields}] site={spec.site} -> {' '.join(spec.metrics)}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.core.events",
        description="Replay and inspect Hydra broker event logs (JSONL).",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_replay = sub.add_parser("replay", help="replay a log; verify metrics vs its snapshot")
    p_replay.add_argument("log", help="JSONL event log (from HYDRA_EVENTS_LOG or dump_jsonl)")
    p_replay.add_argument("--json", help="write the replayed metrics snapshot to this path")
    p_replay.set_defaults(fn=_cmd_replay)
    p_diff = sub.add_parser("diff", help="diff the derived metrics of two logs")
    p_diff.add_argument("a")
    p_diff.add_argument("b")
    p_diff.set_defaults(fn=_cmd_diff)
    p_tax = sub.add_parser("taxonomy", help="print the event taxonomy")
    p_tax.set_defaults(fn=_cmd_taxonomy)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess in tests
    raise SystemExit(main())
