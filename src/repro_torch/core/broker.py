"""Hydra: the broker facade (paper §3).

    hydra = Hydra(policy="round_robin", pod_store="memory", partitioning="mcpp", device="cuda")
    hydra.register_provider(ProviderSpec(name="jet2", platform="cloud", ...))
    hydra.register_provider(ProviderSpec(name="bridges2", platform="hpc", connector="pilot"))
    sub = hydra.submit(tasks)
    sub.wait()
    print(sub.metrics().row())
    hydra.shutdown()

Responsibilities (mirroring the paper's Service Proxy):
  * bind tasks to providers — or to ProviderGroups, logical load-balanced
    pools whose concrete member is resolved at dispatch time — via the
    configured policy,
  * partition per-provider workloads into pods (SCPP/MCPP/binpack),
  * serialize pods via the configured store (disk = faithful baseline,
    memory = the paper's named optimization),
  * bulk-submit pods to each provider's manager CONCURRENTLY,
  * monitor execution, drive retries / re-binding / blacklisting /
    per-member circuit breakers / transparent in-group failover /
    speculative straggler copies, and
  * compute OVH / TH / TPT / TTX from the traces (plus per-member group
    rows via ``group_rows()``).
"""
from __future__ import annotations

import os
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor, wait as futures_wait
from typing import Optional

from repro_torch.core.admission import AdmissionController, TenantSpec
from repro_torch.core.dispatcher import StreamingDispatcher
from repro_torch.core.events import EventBus, EventsDivergence, next_log_path
from repro_torch.core.fault import BreakerState, StragglerWatchdog, clone_for_speculation
from repro_torch.core.group import GroupExhausted, ProviderGroup
from repro_torch.core.ledger import CapacityLedger, LedgerDivergence
from repro_torch.core.managers.compute import CaaSManager, ProviderDown
from repro_torch.core.managers.data import DataManager
from repro_torch.core.managers.pilot import PilotManager
from repro_torch.core.partition import partition
from repro_torch.core.pod import Pod, make_store
from repro_torch.core.policy import Policy, make_policy
from repro_torch.core.provider import ProviderHandle, ProviderProxy, ProviderSpec, resolve_device
from repro_torch.core.staging import LinkModel, StagingService
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.clock import guard_wait
from repro_torch.runtime.tracing import Metrics, Trace, compute_metrics, now


class Submission:
    """Handle for one submit() call: tasks + pods + the broker run trace."""

    def __init__(self, tasks: list[Task], broker: "Hydra"):
        self.tasks = tasks
        self.pods: list[Pod] = []
        self.run_trace = Trace()
        self.dispatch_started = False  # pods handed to providers (rollback gate)
        self.batch_id: Optional[str] = None  # set for dispatcher micro-batches
        self._broker = broker
        self._all_done: Optional[threading.Event] = None  # lazy, built once
        self._wait_lock = threading.Lock()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every task's future resolves.  Completion callbacks
        count down into one event (registered ONCE per submission, so a
        polling ``while not sub.wait(1): ...`` loop does not accumulate
        callbacks); the timeout is a *guard* measured on both the active
        clock and real time (runtime/clock.guard_wait), so a virtual-clock
        run neither hangs forever on a frozen clock nor times out spuriously
        while real work is still executing."""
        with self._wait_lock:
            if self._all_done is None:
                self._all_done = threading.Event()
                unresolved = [t for t in self.tasks if not t.done()]
                if not unresolved:
                    self._all_done.set()
                else:
                    left = {"n": len(unresolved)}
                    lock = threading.Lock()
                    all_done = self._all_done

                    def _one_done(_fut):
                        with lock:
                            left["n"] -= 1
                            if left["n"] == 0:
                                all_done.set()

                    for t in unresolved:  # fires immediately if already resolved
                        t.add_done_callback(_one_done)

        def _in_flight() -> bool:
            # tasks on their way to / executing on a provider: the guard's
            # virtual-idle valve must stay closed while pure-CPU work (which
            # never touches the clock) is still running (runtime/clock.py)
            return any(
                t.tstate in (TaskState.PARTITIONED, TaskState.SUBMITTED, TaskState.RUNNING)
                for t in self.tasks
            )

        return guard_wait(self._all_done, timeout, in_flight=_in_flight)

    def metrics(self) -> Metrics:
        return compute_metrics(self.run_trace, self.tasks, self.pods)

    @property
    def states(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for t in self.tasks:
            out[t.tstate.value] = out.get(t.tstate.value, 0) + 1
        return out


class Hydra:
    def __init__(
        self,
        policy: str = "round_robin",
        pod_store: str = "memory",
        partitioning: str = "mcpp",
        tasks_per_pod: int = 64,
        workdir: Optional[str] = None,
        enable_straggler_mitigation: bool = False,
        straggler_factor: float = 3.0,
        fail_fast: bool = False,
        streaming: bool = False,
        batch_window: float = 0.002,
        max_batch: int = 256,
        staging_seed: int = 0,
        site_capacity_mb: Optional[float] = None,
        staging_links: Optional[dict[tuple[str, str], LinkModel]] = None,
        staging_max_per_link: int = 2,
        staging_mirror_outputs: bool = False,
        tenants: Optional[list[TenantSpec]] = None,
        device: str = "cuda",
    ):
        # providers' device pools are cut from this device kind; a CUDA
        # broker without a CUDA device raises before anything is built
        device = resolve_device(device)
        self.workdir = workdir or tempfile.mkdtemp(prefix="hydra_")
        os.makedirs(self.workdir, exist_ok=True)
        self.proxy = ProviderProxy(device)
        self.policy: Policy = make_policy(policy)
        self.policy.attach_proxy(self.proxy)  # O(1) eligibility index keying
        # the O(1) capacity counter set (core/ledger.py): every supply/demand
        # read the dispatcher and autoscaler make per tick used to be a scan
        # over bind targets / live submissions; now it is a counter read,
        # maintained by the events below (register/remove, breaker
        # transitions, dispatch/completion load deltas, acquisitions, task
        # entry/resolution).  HYDRA_LEDGER_CHECK=1 (tests/conftest.py) makes
        # every read cross-check against a from-scratch recompute.
        self.ledger = CapacityLedger(
            strict=os.environ.get("HYDRA_LEDGER_CHECK", "") not in ("", "0")
        )
        self.ledger.attach(
            recompute=self._ledger_recompute, on_capacity_gain=self._notify_capacity
        )
        # the event-sourced control plane (core/events.py): every counter the
        # legacy stats dicts accumulate is also emitted as a structured event
        # onto this bus, and the stats accessors are derived views over the
        # log.  HYDRA_EVENTS_CHECK=1 (tests/conftest.py) cross-checks view vs
        # legacy on every stats read and at shutdown; HYDRA_EVENTS_LOG dumps
        # the replayable JSONL stream at shutdown (docs/OBSERVABILITY.md).
        self.events = EventBus()
        self.events.attach(self._events_recompute)
        self.store = make_store(pod_store, self.workdir)
        self.partitioning = partitioning
        self.tasks_per_pod = tasks_per_pod
        self.fail_fast = fail_fast
        self.n_submits = 0  # full bind/partition/serialize/dispatch rounds
        self.n_pods_total = 0  # cumulative: survives submission pruning
        self.streaming = streaming
        self._batch_window = batch_window
        self._max_batch = max_batch
        # multi-tenant front door (core/admission.py): rate limits, bounded
        # queues, and the fair-share weights the dispatcher's lane drain
        # reads.  None (no tenant config) means NO admission anywhere — the
        # pre-front-door fast path, bit-identical behavior and cost.
        self.admission: Optional[AdmissionController] = (
            AdmissionController(tenants) if tenants else None
        )
        if self.admission is not None:
            self.admission.attach_events(self.events)
        self._dispatcher: Optional[StreamingDispatcher] = None
        self.data = DataManager(os.path.join(self.workdir, "data"))
        # data-aware staging (core/staging.py): dataset registry + modeled
        # transfer engine.  Physical DataManager verbs update the logical
        # replica map; binding policies read it for data-gravity placement.
        self.staging = StagingService(
            seed=staging_seed,
            default_capacity_mb=site_capacity_mb,
            links=staging_links,
            max_per_link=staging_max_per_link,
            mirror_outputs=staging_mirror_outputs,
        )
        self.data.attach_registry(self.staging.registry)
        self.staging.attach_events(self.events)
        self.policy.attach_staging(self.staging)
        self._managers: dict[str, object] = {}
        self._lock = threading.RLock()
        self._fault_lock = threading.RLock()  # serializes orphan collection/rebind
        self._claimed: set[str] = set()  # task uids currently being re-bound
        self._dispatch_workers = 8
        self._dispatch = ThreadPoolExecutor(
            max_workers=self._dispatch_workers, thread_name_prefix="hydra-dispatch"
        )
        self._submissions: list[Submission] = []
        # elastic acquisition state (core/autoscaler.py): providers that have
        # been *requested* but are still inside their modeled startup/queue
        # latency.  The dispatcher reads incoming_slots() so it neither fails
        # momentarily-unplaceable tasks nor under-sizes batches while
        # capacity is on its way.
        self._pending_acquisitions: dict[str, dict] = {}
        # metrics retired from pruned submissions (phase_totals): pruning
        # bounds broker memory by LIVE work, this keeps the run totals
        self._retired_phases: dict[str, float] = {}
        self._retired = {"n_submissions": 0, "n_tasks": 0, "ovh_s": 0.0}
        self.autoscaler = None  # attached via autoscale()
        self.checkpointer = None  # attached via enable_task_checkpoints()
        self.autotuner = None  # attached via enable_kernel_autotune()
        # kernel-payload legacy accumulators (HYDRA_EVENTS_CHECK ground
        # truth for kernel.exec): bumped under _kernel_lock adjacent to the
        # emit so the log fold replays float additions in the same order
        self._kernel_lock = threading.Lock()
        self.kernel_execs = 0
        self.kernel_execs_by: dict[str, int] = {}
        self.kernel_reps = 0
        self.kernel_seconds = 0.0
        self.watchdog: Optional[StragglerWatchdog] = None
        if enable_straggler_mitigation:
            self.watchdog = StragglerWatchdog(
                running=self._running_tasks,
                duplicate=self._speculate,
                factor=straggler_factor,
            )
            self.watchdog.start()
        if streaming:
            self.dispatcher()

    # ------------------------------------------------------------------
    # Streaming dispatch (core/dispatcher.py): the ready-queue loop that
    # micro-batches tasks across workflows and late-binds at dispatch time
    # ------------------------------------------------------------------
    def dispatcher(self) -> StreamingDispatcher:
        """The broker's long-lived streaming loop (started on first use).
        Lazy start does NOT flip ``self.streaming``: mode is an explicit
        constructor choice, so one caller using dispatch() cannot silently
        switch other WorkflowManagers sharing this broker into streaming."""
        with self._lock:
            if self._dispatcher is None:
                self._dispatcher = StreamingDispatcher(
                    self,
                    batch_window=self._batch_window,
                    max_batch=self._max_batch,
                ).start()
            return self._dispatcher

    def configure_tenants(self, tenants: list[TenantSpec]) -> AdmissionController:
        """Attach (or extend) the front door after construction.  Useful for
        tests and for brokers built by generic factories; prefer the
        ``tenants=`` constructor argument in application code."""
        if self.admission is None:
            self.admission = AdmissionController(tenants)
            self.admission.attach_events(self.events)
        else:
            for spec in tenants:
                self.admission.add_tenant(spec)
        return self.admission

    def enable_task_checkpoints(
        self, interval_s: float = 5.0, size_mb: float = 64.0
    ):
        """Attach a TaskCheckpointer (ckpt/checkpoint.py): preempt-killed
        tasks resume from their captured ``progress_frac`` on a surviving
        provider — through the staging gate, since the checkpoint is a
        replicated dataset — instead of restarting from zero, and resumes
        never charge ``max_retries``.  Lazy import: the ckpt module pulls
        numpy and torch, which the broker core must not pay for
        unconditionally."""
        from repro_torch.ckpt.checkpoint import TaskCheckpointer

        if self.checkpointer is not None:
            raise RuntimeError("a task checkpointer is already attached")
        self.checkpointer = TaskCheckpointer(
            self.staging.registry, self.events, interval_s=interval_s, size_mb=size_mb
        )
        return self.checkpointer

    def enable_kernel_autotune(
        self, *, timer: str = "wall", reps: int = 3, seed: int = 0
    ):
        """Attach a kernel Autotuner (kernels/autotune.py) for this broker's
        device: sweeps land as pinned replicated datasets in this broker's
        staging registry, keyed ``tune:<kernel>:<device type>:<shape>``, and
        cache misses emit ``kernel.tune`` on this broker's bus.  The tuner
        is also installed process-global so kernels/ops.py entry points
        (and kernel-payload tasks) consult it under ``HYDRA_AUTOTUNE=1``.
        Lazy import: the kernels package pulls the CUDA launchers, which the
        broker core must not pay for unconditionally."""
        from repro_torch.kernels.autotune import Autotuner, set_autotuner

        if self.autotuner is not None:
            raise RuntimeError("a kernel autotuner is already attached")
        self.autotuner = Autotuner(
            registry=self.staging.registry, events=self.events,
            timer=timer, reps=reps, seed=seed, device=self.proxy.device,
        )
        set_autotuner(self.autotuner)
        return self.autotuner

    def dispatch(self, tasks: list[Task]) -> None:
        """Feed ready tasks into the streaming dispatcher's queue, through
        the front door when one is configured: a rejected submission raises
        ``AdmissionError`` (typed backpressure) *before* anything enqueues —
        all-or-nothing, so a caller never has to hunt down a half-admitted
        batch.  Internal requeues (retries, staging re-gates, failover,
        speculation) carry ``task.admitted`` and are never re-charged."""
        if self.admission is not None:
            self.admission.admit(tasks)
        self.dispatcher().enqueue(tasks)

    def idle_slots(self) -> int:
        """Free execution slots across healthy bind targets: the streaming
        dispatcher's backfill hint.  Group members report slots minus
        outstanding load; ungrouped providers report slots minus the
        broker-tracked outstanding count, so a saturated provider genuinely
        reads as 0 free slots — which is what lets the elastic throttle hold
        work back for capacity that is still coming up instead of burying
        the busy provider's internal queue.  An O(1) CapacityLedger read:
        the per-call bind-target walk is gone (core/ledger.py)."""
        return self.ledger.idle_slots()

    def _provider_load(self, name: str, delta: int) -> None:
        """Outstanding-task accounting for ungrouped providers.  Serialized
        per handle, not broker-wide: this runs twice per task from every
        manager thread, and funneling it through self._lock was a measured
        contention hot spot (§Perf exp9)."""
        try:
            handle = self.proxy.get(name)
        except KeyError:  # elastically deregistered: nothing to track
            return
        with handle.load_lock:
            handle.outstanding = max(0, handle.outstanding + delta)
            grouped = handle.group is not None
        if not grouped:
            # grouped members account their load through the group's ledger
            # events; a late completion from a pre-join dispatch must not
            # double-touch the (re-based) member row
            self.ledger.load_delta(name, delta)

    def total_slots(self) -> int:
        """Live execution slots across healthy bind targets (for groups:
        members whose breaker is not OPEN — a tripped member's slots are
        *gone* from supply, which is exactly the signal that makes the
        autoscaler replace broken capacity).  O(1) ledger read."""
        return self.ledger.total_slots()

    def probe_slots(self) -> int:
        """Time-aware capacity peek for the dispatcher's STALL path only.
        A group member whose breaker reset window has elapsed is invisible
        to the event-driven ledger until something dispatches to it —
        ``allow()`` performs the OPEN -> HALF_OPEN transition, and allow()
        only runs when a pod is routed.  If the elastic throttle trusted
        the ledger alone, a fully-tripped fleet at pool max would never
        receive the probe that recovers it (livelock).  O(members), called
        only when the ledger reads zero idle supply."""
        return sum(g.idle_slots() for g in self.proxy.groups())

    def backlog(self) -> int:
        """Unfinished tasks the brokered providers still owe (dispatched or
        queued inside managers).  Queue *pressure* is backlog + ready-queue
        depth against live + incoming slots: the ready queue alone empties
        fast into manager-internal queues, so it under-reports sustained
        overload.

        Called every autoscaler tick: an O(1) ledger counter — incremented
        when a task first enters a submission, decremented when its future
        resolves — replacing the per-tick scan of every live submission and
        its 50 ms staleness cache."""
        return self.ledger.backlog()

    # ------------------------------------------------------------------
    # Dispatcher reads, None-safe: the public face of the streaming queue.
    # The autoscaler (and any other consumer) goes through these instead of
    # reaching into ``broker._dispatcher`` — a broker without a dispatcher
    # (frontier mode, or pre-first-use) reads as an empty queue, and stats
    # code cannot couple itself to dispatcher internals.
    # ------------------------------------------------------------------
    def queue_depth(self) -> int:
        """Ready-queue depth across every lane (0 without a dispatcher)."""
        d = self._dispatcher
        return d.pending() if d is not None else 0

    def queue_depth_by_class(self) -> dict[str, int]:
        """Ready-queue depth per SLO class (empty without a dispatcher)."""
        d = self._dispatcher
        return d.pending_by_class() if d is not None else {}

    def staging_stalled(self) -> int:
        """Tasks parked on stage-in transfers (0 without a dispatcher)."""
        d = self._dispatcher
        return d.stalled_on_staging() if d is not None else 0

    def staging_stalled_in_backlog(self) -> int:
        """The parked subset the backlog counter ALSO holds (re-gated
        retries): what the autoscaler subtracts to avoid double counting."""
        d = self._dispatcher
        return d.stalled_in_backlog() if d is not None else 0

    def deferred_demand(self) -> float:
        """Staging-parked tasks as decayed demand (core/dispatcher.py)."""
        d = self._dispatcher
        return d.deferred_demand() if d is not None else 0.0

    # ------------------------------------------------------------------
    # CapacityLedger plumbing (core/ledger.py)
    # ------------------------------------------------------------------
    def _notify_capacity(self) -> None:
        """Idle supply grew (completion / breaker close / arrival): wake the
        dispatcher NOW instead of letting it poll out a real-time timeout."""
        d = self._dispatcher
        if d is not None:
            d.notify_capacity()

    def _on_task_resolved(self, _fut) -> None:
        self.ledger.task_resolved()
        self.events.emit("backlog.resolve")

    def _ledger_recompute(self) -> dict:
        """From-scratch ground truth for the strict cross-check: the same
        counters the ledger maintains incrementally, rebuilt by scanning.
        Runs WITHOUT the ledger lock (it takes broker/proxy/group locks)."""
        idle = total = 0
        for handle in self.proxy.all():
            if handle.group is not None:
                continue  # counted through its group's member row
            if not handle.healthy:
                continue
            slots = max(1, handle.spec.concurrency * handle.spec.n_nodes)
            total += slots
            idle += max(0, slots - handle.outstanding)
        for group in self.proxy.groups():
            for row in group.stats():
                if row["breaker"] == BreakerState.OPEN.value:
                    continue
                total += row["slots"]
                idle += max(0, row["slots"] - row["outstanding"])
        with self._lock:
            incoming = sum(p["slots"] for p in self._pending_acquisitions.values())
            subs = list(self._submissions)
        backlog = len(
            {
                t.uid
                for sub in subs
                for t in sub.tasks
                if t.in_submission and not t.done()
            }
        )
        return {
            "idle_slots": idle,
            "total_slots": total,
            "incoming_slots": incoming,
            "backlog": backlog,
        }

    def _events_recompute(self) -> dict:
        """Legacy-accumulator ground truth for HYDRA_EVENTS_CHECK: the flat
        ``metric`` / ``metric:key`` mapping the log-derived view must agree
        with.  Only wired subsystems contribute keys (no autoscaler ⇒ no
        scale.* comparison), mirroring _ledger_recompute's lock discipline:
        runs WITHOUT the bus lock."""
        out: dict = {}
        d = self._dispatcher
        if d is not None:
            out["hydra.dispatch.batches"] = d.batches
            out["hydra.dispatch.tasks"] = d.tasks_dispatched
            out["hydra.dispatch.retry_backoffs"] = d.retry_backoffs
            out["hydra.dispatch.loop_errors"] = d.loop_errors
        a = self.autoscaler
        if a is not None:
            out["hydra.scale.ticks"] = a.ticks
            out["hydra.scale.acquisitions"] = a.acquisitions
            out["hydra.scale.arrivals"] = a.arrivals
            out["hydra.scale.releases"] = a.releases
            out["hydra.scale.aborts"] = a.aborts
            mp = a.planner
            if mp is not None:
                out["hydra.market.plans"] = mp.plans
                out["hydra.market.bids"] = mp.bids
                for tmpl, n in list(mp.bids_by_template.items()):
                    out[f"hydra.market.bids:{tmpl}"] = n
                out["hydra.market.reprices"] = mp.reprices
                out["hydra.cost_node_seconds"] = mp.cost_node_seconds
                out["hydra.cost_dollars"] = mp.cost_dollars
        ck = self.checkpointer
        if ck is not None:
            out["hydra.ckpt.saves"] = ck.saves
            out["hydra.ckpt.resumes"] = ck.resumes
            out["hydra.ckpt.reexecuted_s"] = ck.reexecuted_s
            out["hydra.ckpt.preempted_work_s"] = ck.preempted_work_s
        at = self.autotuner
        if at is not None:
            out["hydra.kernel.tunes"] = at.tunes
            out["hydra.kernel.swept_configs"] = at.swept_configs
        # unconditional: zero-valued keys match an absent view metric, and
        # any broker can receive kernel-payload tasks without opting in
        out["hydra.kernel.execs"] = self.kernel_execs
        for kname, n in list(self.kernel_execs_by.items()):
            out[f"hydra.kernel.execs:{kname}"] = n
        out["hydra.kernel.reps"] = self.kernel_reps
        out["hydra.kernel.seconds"] = self.kernel_seconds
        adm = self.admission
        if adm is not None:
            out["hydra.admission.admitted"] = adm.admitted
            for (tenant, reason), n in list(adm.rejected.items()):
                out[f"hydra.admission.rejected:{tenant}:{reason}"] = n
        st, eng = self.staging, self.staging.engine
        out["hydra.staging.stage_ins"] = st.stage_ins
        out["hydra.staging.stage_outs"] = st.stage_outs
        out["hydra.staging.stage_out_drops"] = st.stage_out_drops
        out["hydra.staging.evacuated_mb"] = st.evacuated_mb
        out["hydra.staging.mirrored_mb"] = st.mirrored_mb
        out["hydra.staging.transfer_wait_s"] = st.transfer_wait_s
        out["hydra.staging.transfers"] = eng.completed
        out["hydra.staging.mb_moved"] = eng.mb_moved
        out["hydra.staging.cache_hits"] = eng.cache_hits
        out["hydra.staging.cold_reads"] = eng.cold_reads
        out["hydra.staging.reroutes"] = eng.reroutes
        out["hydra.staging.transfer_failures"] = eng.failures
        out["hydra.staging.queue_wait_s"] = eng.queue_wait_s
        out["hydra.staging.evictions"] = st.registry.evictions
        for g in self.proxy.groups():
            for row in g.stats():
                member = row["member"]
                if row["dispatched"]:
                    out[f"hydra.group.dispatched:{member}"] = row["dispatched"]
                if row["completed"]:
                    out[f"hydra.group.completed:{member}"] = row["completed"]
                if row["failed"]:
                    out[f"hydra.group.failed:{member}"] = row["failed"]
        return out

    def stream_stats(self) -> dict:
        """Dispatcher-side metrics + total pipeline rounds (exp6).  A
        derived view over the event log; the dict shape is the legacy
        adapter, strict mode cross-checks it against the log fold."""
        self.events.maybe_check()
        stats = self._dispatcher.stats() if self._dispatcher else {}
        with self._lock:
            stats["n_submits"] = self.n_submits
            stats["n_pods"] = self.n_pods_total  # cumulative, prune-proof
        return stats

    def staging_stats(self) -> dict:
        """The data-movement story (core/staging.py): bytes moved, replica
        hits vs cold reads, eviction/re-route counts, transfer wait —
        benchmarks/exp8_staging.py compares these across placement arms."""
        self.events.maybe_check()
        stats = self.staging.stats()
        stats["staging_blocked"] = self.staging_stalled()
        return stats

    def tenant_stats(self) -> dict:
        """Front-door snapshot: per-tenant held counts, admit/reject
        totals, and the per-class queue depths (empty when no front door)."""
        if self.admission is None:
            return {}
        self.events.maybe_check()
        stats = self.admission.stats()
        stats["queue_by_class"] = self.queue_depth_by_class()
        return stats

    def events_stats(self) -> dict:
        """Bus-level snapshot: event count, retained/dropped, strict-mode
        divergence count, plus the full derived-metrics snapshot."""
        stats = self.events.stats()
        stats["metrics"] = self.events.snapshot()
        return stats

    # ------------------------------------------------------------------
    # Elastic acquisition (core/autoscaler.py drives these)
    # ------------------------------------------------------------------
    def autoscale(self, pool, **kw):
        """Attach an Autoscaler watching this broker's queue pressure and
        elastically acquiring/releasing providers from ``pool`` (a
        ProviderPool of launchable specs).  Returns the started Autoscaler;
        shutdown() stops it with the rest of the broker."""
        from repro_torch.core.autoscaler import Autoscaler

        if self.autoscaler is not None:
            raise RuntimeError("an autoscaler is already attached")
        self.autoscaler = Autoscaler(self, pool, **kw).start()
        return self.autoscaler

    def begin_acquisition(self, spec: ProviderSpec, eta_s: float, group: Optional[str] = None):
        """Record a provider as in-flight (requested, not yet up)."""
        slots = max(1, spec.concurrency * spec.n_nodes)
        with self._lock:
            self._pending_acquisitions[spec.name] = {
                "platform": spec.platform,
                "slots": slots,
                "capacity": spec.capacity(),
                "eta_s": eta_s,
                "requested_at": now(),
                "group": group,
            }
            self.ledger.begin_incoming(spec.name, slots)

    def complete_acquisition(self, spec: ProviderSpec) -> Optional[ProviderHandle]:
        """The modeled acquisition latency elapsed: the provider is live.
        Registers it (joining its target group, if any) and clears the
        pending record.  A cancelled acquisition (record already gone) is a
        no-op so a release racing an arrival cannot register a zombie; a
        failed group join rolls the registration back entirely so a
        misconfigured launch spec cannot leak half-joined providers into
        the direct-binding pool."""
        with self._lock:
            info = self._pending_acquisitions.pop(spec.name, None)
            if info is not None:
                self.ledger.end_incoming(spec.name)
        if info is None:
            return None
        handle = self.register_provider(spec)
        group_name = info.get("group")
        if group_name is not None:
            try:
                group = self.proxy.get_group(group_name)
                group.add_member(handle)
                try:
                    self.proxy.attach_member(group_name, spec.name)
                except Exception:
                    group.remove_member(spec.name)
                    raise
            except Exception:
                self._rollback_registration(spec.name)
                raise
        return handle

    def _rollback_registration(self, name: str) -> None:
        with self._lock:
            mgr = self._managers.pop(name, None)
        if mgr is not None:
            mgr.shutdown(wait=False)
        self.ledger.remove(name)
        self.events.emit("provider.deregister", provider=name, reason="rollback")
        try:
            self.proxy.deregister(name)
        except KeyError:
            pass

    def abort_acquisition(self, name: str) -> bool:
        """Drop a pending acquisition (scale-in decided before arrival)."""
        with self._lock:
            dropped = self._pending_acquisitions.pop(name, None) is not None
            if dropped:
                self.ledger.end_incoming(name)
            return dropped

    def incoming_slots(self) -> int:
        """Execution slots currently inside their modeled acquisition
        latency: counted as supply by the dispatcher and the autoscaler so
        sustained pressure does not over-acquire.  O(1) ledger read."""
        return self.ledger.incoming_slots()

    def pending_acquisitions(self) -> list[dict]:
        with self._lock:
            return [dict(name=n, **p) for n, p in self._pending_acquisitions.items()]

    def incoming_could_fit(self, task: Task) -> bool:
        """Would any in-flight acquisition be able to run ``task``?  Gates
        the dispatcher's defer-instead-of-fail path: a task no arriving
        provider can fit must surface its NoEligibleProvider now, not after
        every acquisition has landed."""
        with self._lock:
            caps = [p["capacity"] for p in self._pending_acquisitions.values()]
        return any(task.resources.fits(cap) for cap in caps)

    def scale_stats(self) -> dict:
        """One snapshot of the elastic state: live/incoming capacity, queue
        pressure inputs, and the autoscaler's own counters when attached."""
        self.events.maybe_check()
        stats = {
            "n_providers": len(self.providers()),
            "idle_slots": self.idle_slots(),
            "incoming_slots": self.incoming_slots(),
            "pending_acquisitions": self.pending_acquisitions(),
            "queue_depth": self.queue_depth(),
        }
        if self.autoscaler is not None:
            stats["autoscaler"] = self.autoscaler.stats()
        return stats

    def _prune_finished_submissions(self) -> None:
        """Drop ANY submission whose tasks have all RESOLVED futures — after
        extracting its metrics row into the retired totals — so a long-lived
        broker's memory and every remaining full scan (orphan sweep, ledger
        cross-check) are bounded by LIVE work, not run history.  Resolution,
        not tstate-finality, is the gate: a retryable FAILED task is final
        by tstate but still owned by the orphan sweep (_collect_orphans),
        which scans these submissions to re-bind it.  Callers keep their own
        Submission handles (wait()/metrics() are self-contained), so pruning
        caller-created submissions is safe; run-level totals stay readable
        through phase_totals()."""
        retired: list[Submission] = []
        with self._lock:
            live = []
            for s in self._submissions:
                if all(t.done() for t in s.tasks):
                    retired.append(s)
                else:
                    live.append(s)
            self._submissions = live
        for s in retired:
            m = s.metrics()
            with self._lock:
                self._retired["n_submissions"] += 1
                self._retired["n_tasks"] += len(s.tasks)
                self._retired["ovh_s"] += m.ovh
                for k, v in m.phases.items():
                    self._retired_phases[k] = self._retired_phases.get(k, 0.0) + v

    def phase_totals(self) -> dict[str, float]:
        """Cumulative broker-side phase seconds (bind/partition/serialize/
        submit) across ALL submissions this broker ever ran — pruned ones
        contribute their retired totals, live ones are summed on the fly.
        The exp4 OVH instrumentation reads this instead of walking
        ``_submissions`` (which pruning now keeps bounded)."""
        with self._lock:
            totals = dict(self._retired_phases)
            subs = list(self._submissions)
        for s in subs:
            for k, v in s.metrics().phases.items():
                totals[k] = totals.get(k, 0.0) + v
        return totals

    def _running_tasks(self) -> list[Task]:
        with self._lock:
            return [
                t
                for sub in self._submissions
                for t in sub.tasks
                if t.tstate == TaskState.RUNNING
            ]

    # ------------------------------------------------------------------
    # Provider lifecycle (elastic: add/remove at runtime)
    # ------------------------------------------------------------------
    def register_provider(self, spec: ProviderSpec) -> ProviderHandle:
        handle = self.proxy.register(spec)
        mgr_cls = PilotManager if spec.connector == "pilot" else CaaSManager
        with self._lock:
            self._managers[spec.name] = mgr_cls(
                handle,
                on_task_done=self._on_task_done,
                on_task_skipped=self._on_task_skipped,
                on_task_finishing=self._on_task_finishing,
            )
        self.data.register_site(spec.name)
        self.staging.register_site(spec.name, platform=spec.platform)
        self.ledger.upsert_direct(spec.name, max(1, spec.concurrency * spec.n_nodes))
        self.events.emit(
            "provider.register",
            provider=spec.name,
            slots=max(1, spec.concurrency * spec.n_nodes),
            group=handle.group,
        )
        return handle

    def register_group(
        self,
        name: str,
        members: list,
        strategy: str = "round_robin",
        failure_threshold: int = 3,
        reset_timeout_s: float = 30.0,
        min_healthy: int = 1,
    ) -> ProviderGroup:
        """Pool providers behind one logical bind target (core/group.py).

        ``members`` mixes ProviderSpecs (registered on the fly) and names of
        already-registered providers.  Policies bind tasks to ``name``; the
        group resolves the concrete member at dispatch time and fails work
        over transparently when a member dies."""
        handles = []
        added: list[str] = []  # members registered here, for rollback
        try:
            for m in members:
                if isinstance(m, ProviderSpec):
                    handles.append(self.register_provider(m))
                    added.append(m.name)
                else:
                    handles.append(self.proxy.get(m))
            group = ProviderGroup(
                name,
                handles,
                strategy=strategy,
                failure_threshold=failure_threshold,
                reset_timeout_s=reset_timeout_s,
                min_healthy=min_healthy,
            )
            self.proxy.register_group(group)
            # capacity events flow through the group from here on: member
            # ledger rows replace the members' direct rows, and breaker
            # transitions invalidate the proxy's cached bind-target list
            group.attach_runtime(self.ledger, self.proxy.bump_version, events=self.events)
            # a group is ONE staging site: members share a group-local store
            # (the way the paper's platforms share a filesystem), so member
            # churn inside the group never moves bytes
            self.data.register_site(name)
            self.staging.register_site(name, platform=group.spec.platform)
            return group
        except Exception:
            # a failed group registration must not leak its on-the-fly
            # members into the direct-binding pool
            for member in added:
                with self._lock:
                    mgr = self._managers.pop(member, None)
                if mgr is not None:
                    mgr.shutdown(wait=False)
                self.ledger.remove(member)
                self.events.emit("provider.deregister", provider=member, reason="rollback")
                try:
                    self.proxy.deregister(member)
                except KeyError:
                    pass
            raise

    def remove_provider(self, name: str, drain: bool = True, deregister: bool = False):
        """Elastic scale-down: stop a provider; re-bind its unfinished tasks.
        ``deregister=True`` (the autoscaler's release path) also frees the
        name in the proxy and drops the policy's per-provider state, so a
        later acquisition may recycle the slot cleanly."""
        with self._lock:
            mgr = self._managers.pop(name)
            handle = self.proxy.get(name)
            handle.healthy = False
        with handle.load_lock:
            handle.outstanding = 0
        if handle.group is None:
            # grouped members leave supply via mark_down below (breaker trip
            # -> ledger set_counted), keeping the ledger keyed on the same
            # signal its cross-check recomputes from
            self.ledger.deactivate(name)
        self.proxy.bump_version()  # health flip: cached bind targets stale
        mgr.fail()  # reject anything in flight
        if drain:
            # graceful release: save any LAST-copy dataset to the shared
            # store before the scratch goes away — a routine scale-in must
            # never terminally fail downstream tasks over lost data
            self.staging.evacuate(name)
        # the site's scratch dies with the instance: drop its replicas,
        # re-route any transfer that was reading from (or writing to) it,
        # and close the physical namespace so the verbs can't strand data
        self.staging.site_down(name)
        self.data.deregister_site(name)
        if handle.group is not None:
            group = self.proxy.get_group(handle.group)
            group.mark_down(name)  # out of rotation before the orphan sweep
            with self._fault_lock:
                orphans = self._collect_orphans(name)
                self._redispatch_in_group(group, orphans, exclude=name)
            group.remove_member(name)  # permanent: no probes to a dead slot
            handle.group = None
        else:
            with self._fault_lock:
                orphans = self._collect_orphans(name)
                self._rebind_and_resubmit(orphans, exclude=name)
        mgr.shutdown(wait=drain)
        self.events.emit(
            "provider.deregister",
            provider=name,
            reason="release" if deregister else ("drain" if drain else "outage"),
        )
        if deregister:
            self.policy.forget(name)
            self.ledger.remove(name)
            try:
                self.proxy.deregister(name)
            except KeyError:
                pass

    def providers(self) -> list[str]:
        return [h.name for h in self.proxy.healthy()]

    def group(self, name: str) -> ProviderGroup:
        return self.proxy.get_group(name)

    def group_rows(self) -> list[dict]:
        """Group-aware metrics: one row per group member (breaker state,
        trips, dispatched/completed/failed/outstanding, weight)."""
        self.events.maybe_check()
        return [row for g in self.proxy.groups() for row in g.stats()]

    def manager(self, name: str):
        return self._managers[name]

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------
    def submit(
        self,
        tasks: list[Task],
        partitioning: Optional[str] = None,
        tasks_per_pod: Optional[int] = None,
        batch_id: Optional[str] = None,
    ) -> Submission:
        model = partitioning or self.partitioning
        tpp = tasks_per_pod or self.tasks_per_pod
        # classic (non-streaming) entry pays admission too; the streaming
        # dispatcher's micro-batches arrive already admitted (no-op here)
        if self.admission is not None:
            self.admission.admit(tasks)
        sub = Submission(tasks, self)
        with self._lock:
            self._submissions.append(sub)
            self.n_submits += 1
            prune_due = self.n_submits % 32 == 0
        if prune_due:
            self._prune_finished_submissions()
        try:
            return self._submit_pipeline(sub, tasks, model, tpp, batch_id)
        except BaseException:
            # a failed pipeline round (e.g. transient full outage seen by the
            # streaming dispatcher) must not leave a half-built submission in
            # the metrics/orphan-sweep lists: the caller owns the retry.
            # Once the dispatch phase started, pods may already be running on
            # providers — the submission must then STAY registered so the
            # orphan sweep can still find those tasks.
            with self._lock:
                if not sub.dispatch_started and sub in self._submissions:
                    self._submissions.remove(sub)
                    self.n_submits -= 1
            raise

    def _submit_pipeline(
        self,
        sub: Submission,
        tasks: list[Task],
        model: str,
        tpp: int,
        batch_id: Optional[str],
    ) -> Submission:
        rt = sub.run_trace
        sub.batch_id = batch_id

        # -- bind (late: provider/group health is read NOW, at dispatch) ---
        rt.add("bind_start")
        targets = self.proxy.bind_targets()
        if not targets:
            raise RuntimeError("no healthy providers registered")
        by_provider: dict[str, list[Task]] = {}
        names = self.policy.bind_bulk(tasks, targets)
        try:
            for t, name in zip(tasks, names):
                t.provider = name
                t.group = name if self.proxy.is_group(name) else None
                t.advance(TaskState.BOUND)
                by_provider.setdefault(name, []).append(t)
            rt.add("bind_done")

            # -- partition ---------------------------------------------------
            rt.add("partition_start")
            pods: list[Pod] = []
            for name, ts in by_provider.items():
                ppods = partition(ts, name, model=model, tasks_per_pod=tpp)
                for p in ppods:
                    p.batch_id = batch_id
                    for t in p.tasks:
                        t.advance(TaskState.PARTITIONED)
                pods.extend(ppods)
            sub.pods.extend(pods)
            with self._lock:
                self.n_pods_total += len(pods)
            rt.add("partition_done")

            # -- serialize ---------------------------------------------------
            rt.add("serialize_start")
            for p in pods:
                self.store.serialize(p)
            rt.add("serialize_done")
        except BaseException as e:
            # nothing reached a provider yet: fully reverse the batch's load
            # accounting (bind_bulk accounted for EVERY task, including ones
            # whose provider attribute was never updated) and mark the
            # exception so the dispatcher's retry does not release twice
            for t, name in zip(tasks, names):
                self.policy.unbind(t, name)
            try:
                e._hydra_load_released = True
            except AttributeError:  # exceptions with __slots__
                pass
            raise

        # -- bulk submit (concurrently across providers) -----------------------
        rt.add("submit_start")
        sub.dispatch_started = True
        entered = []
        for t in tasks:  # now visible to backlog() until resolution
            if not t.in_submission:
                t.in_submission = True
                entered.append(t)
        if entered:
            # count BEFORE registering the resolution callbacks: a task that
            # resolves instantly fires its callback inline, and the decrement
            # must never precede the increment.  Only first entries register
            # — a task re-entering through a later submission (rebind via the
            # staging gate) must not earn a second decrement.
            self.ledger.task_entered(len(entered))
            self.events.emit("backlog.enter", n=len(entered))
            for t in entered:
                t.add_done_callback(self._on_task_resolved)
        per_provider: dict[str, list[Pod]] = {}
        for p in pods:
            per_provider.setdefault(p.provider, []).append(p)
        # chunk the per-provider submissions over the dispatch workers: at
        # 256 providers one executor round-trip per provider dominated the
        # submit phase (§Perf exp9), and pod delivery inside a chunk is a
        # loop, not a hop
        items = list(per_provider.items())
        n_chunks = max(1, min(len(items), self._dispatch_workers))
        futs = [
            self._dispatch.submit(self._submit_chunk, items[i::n_chunks])
            for i in range(n_chunks)
        ]
        futures_wait(futs)
        for f in futs:
            exc = f.exception()
            if exc is not None and not isinstance(exc, ProviderDown):
                raise exc
        rt.add("submit_done")
        return sub

    def _submit_chunk(self, items: list[tuple[str, list[Pod]]]) -> None:
        """Deliver several providers' pods from one dispatch worker.  One
        provider's failure must not starve the rest of the chunk: ProviderDown
        is absorbed (the fault path already owns it, as before), the first
        unexpected error is re-raised after the chunk completes."""
        first_exc: Optional[BaseException] = None
        for name, pods in items:
            try:
                self._submit_to_provider(name, pods)
            except ProviderDown:
                continue
            except BaseException as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc

    def _submit_to_provider(self, name: str, pods: list[Pod]):
        if self.proxy.is_group(name):
            self._submit_to_group(self.proxy.get_group(name), pods)
            return
        self._provider_load(name, sum(len(p.tasks) for p in pods))
        try:
            self._managers[name].submit_pods(pods)
        except ProviderDown:
            self._handle_provider_down(name)
            raise

    # ------------------------------------------------------------------
    # Group dispatch: the group resolves the member per pod at dispatch
    # time; member loss is absorbed here (transparent failover) instead of
    # propagating to the caller's policy.
    # ------------------------------------------------------------------
    def _submit_to_group(self, group: ProviderGroup, pods: list[Pod], exclude: Optional[str] = None):
        # resolve the member per pod, then ONE bulk submit_pods per member:
        # per-pod submits would pay the modeled submit latency per pod
        # instead of per provider, inflating the group indirection cost
        by_member: dict[str, list[Pod]] = {}
        for pod in pods:
            try:
                member = group.select(exclude=exclude)
            except GroupExhausted:
                self._group_exhausted(group, pod.tasks)
                continue
            pod.provider = member
            for t in pod.tasks:
                t.provider = member
                t.group = group.name
                t.trace.add(f"dispatch:{group.name}->{member}")
            group.note_dispatch(member, len(pod.tasks))
            by_member.setdefault(member, []).append(pod)
        for member, member_pods in by_member.items():
            self._submit_member_pods(group, member, member_pods)

    def _submit_member_pods(self, group: ProviderGroup, member: str, pods: list[Pod]):
        mgr = self._managers.get(member)  # gone if elastically removed
        try:
            if mgr is None:
                raise ProviderDown(member)
            mgr.submit_pods(pods)
        except ProviderDown:
            self._handle_member_down(group, member)

    def _group_exhausted(self, group: ProviderGroup, tasks: list[Task]):
        """Every member breaker open: fall back to cross-provider re-bind."""
        with self._fault_lock:
            live = []
            with self._lock:
                for t in tasks:
                    if t.final or t.uid in self._claimed:
                        continue
                    self._claimed.add(t.uid)
                    live.append(t)
            for t in live:
                t.try_advance(TaskState.BOUND)
            self._rebind_and_resubmit(live, exclude=group.name)

    def _handle_member_down(self, group: ProviderGroup, member: str):
        """A group member died: open its breaker, fail its in-flight work
        over to surviving members without involving the binding policy."""
        group.mark_down(member)
        with self._lock:
            handle = self.proxy.get(member)
            handle.trace.add(f"breaker_open:{group.name}")
        with self._fault_lock:
            orphans = self._collect_orphans(member)
            self._redispatch_in_group(group, orphans, exclude=member)

    def _redispatch_in_group(self, group: ProviderGroup, tasks: list[Task], exclude: Optional[str] = None):
        """Re-bind claimed tasks to surviving group members; overflow (group
        exhausted) falls back to the policy re-bind path."""
        if not tasks:
            return
        by_member: dict[str, list[Task]] = {}
        fallback: list[Task] = []
        for t in tasks:
            try:
                member = group.select(exclude=exclude)
            except GroupExhausted:
                fallback.append(t)
                continue
            t.provider = member
            t.group = group.name
            t.trace.add(f"failover:{member}")
            by_member.setdefault(member, []).append(t)
        for member, ts in by_member.items():
            group.note_dispatch(member, len(ts))
            pods = partition(ts, member, model="mcpp", tasks_per_pod=self.tasks_per_pod)
            for p in pods:
                for t in p.tasks:
                    t.try_advance(TaskState.PARTITIONED)
                    self._release_claim(t)  # re-claimable if this member dies too
                self.store.serialize(p)
            self._dispatch.submit(self._submit_member_pods, group, member, pods)
        if fallback:
            self._rebind_and_resubmit(fallback, exclude=group.name)

    # ------------------------------------------------------------------
    # Completion / fault handling
    # ------------------------------------------------------------------
    def _on_task_done(self, task: Task, provider: str, failed: bool):
        # policies observe the *logical* bound name: member churn inside a
        # group must not leak into policy load/EWMA accounting
        logical = task.group or provider
        if task.group is None:
            self._provider_load(provider, -1)
        t0, t1 = task.trace.first("exec_start"), task.trace.last("exec_done")
        if t0 is not None and t1 is not None:
            self.policy.observe(logical, t1 - t0)
            if self.watchdog:
                self.watchdog.observe_completion(t1 - t0)
        else:
            self.policy.observe(logical, 1e-3)
        group: Optional[ProviderGroup] = None
        if task.group and self.proxy.is_group(task.group):
            group = self.proxy.get_group(task.group)
        exc = getattr(task, "last_error", None) if failed else None
        if group is not None:
            # grouped terminal states reach the bus via group.record_* so
            # the member-keyed view stays adjacent to the legacy counters
            if failed:
                group.record_failure(provider)
            else:
                group.record_success(provider)
        else:
            self.events.emit("task.complete", provider=provider, failed=failed)
        if not failed:
            if task.kind == "kernel" and task.kernel_stats is not None:
                ks = task.kernel_stats
                with self._kernel_lock:
                    self.kernel_execs += 1
                    self.kernel_execs_by[ks["kernel"]] = (
                        self.kernel_execs_by.get(ks["kernel"], 0) + 1
                    )
                    self.kernel_reps += ks["reps"]
                    self.kernel_seconds += ks["kernel_s"]
                    self.events.emit(
                        "kernel.exec",
                        kernel=ks["kernel"],
                        reps=ks["reps"],
                        kernel_s=ks["kernel_s"],
                    )
            return
        if isinstance(exc, ProviderDown):  # _handle_*_down owns the outage transition
            if group is not None:
                self._handle_member_down(group, provider)
            else:
                self._handle_provider_down(provider)
            return
        with self._fault_lock:
            if task.uid in self._claimed or task.tstate != TaskState.FAILED:
                return  # already claimed / re-bound / finished elsewhere
            if self._try_checkpoint_resume(task, exc):
                # preempt-kill on a checkpointable task: capture progress,
                # resume from progress_frac WITHOUT charging max_retries —
                # the re-entry goes through _rebind_and_resubmit, whose
                # staging gate stages the checkpoint dataset to the chosen
                # surviving site (checkpoints obey data gravity)
                self._rebind_and_resubmit([task], exclude=provider)
                return
            if task.retries < task.max_retries:
                self._claimed.add(task.uid)
                task.reset_for_retry()
            else:
                if self.fail_fast:
                    self._cancel_all_pending()
                return
            if group is not None:
                # transparent in-group retry, never the member that failed it
                self._redispatch_in_group(group, [task], exclude=provider)
            else:
                self._rebind_and_resubmit([task], exclude=provider)

    def _try_checkpoint_resume(self, task: Task, exc) -> bool:
        """If ``task`` was preempt-killed and a TaskCheckpointer is attached,
        capture its progress and reset it for resume (no retry charge).
        Caller holds _fault_lock; the task must be FAILED and unclaimed.
        Returns True iff the task is now claimed + BOUND for re-entry."""
        ck = self.checkpointer
        if ck is None or task.done():
            return False
        from repro_torch.core.managers.compute import Preempted

        if not isinstance(exc, Preempted) or not ck.eligible(task):
            return False
        self._claimed.add(task.uid)
        ck.on_preempt(task)
        task.reset_for_resume()
        return True

    def _on_task_finishing(self, task: Task, provider: str):
        """Stage-out, on the manager thread BEFORE the task's future
        resolves: resolution synchronously enqueues dependents, so a child
        could reach the staging gate ahead of its input's registration if
        outputs were registered any later.  Group-bound tasks write the
        group-local store (the logical site)."""
        if not (task.outputs or task.inputs):
            return
        try:
            self.staging.task_completed(task, task.group or provider)
        except Exception:
            task.trace.add("stage_out_error")  # never break completion

    def _on_task_skipped(self, task: Task, provider: str):
        """A manager skipped a task that went final elsewhere (speculation /
        failover race): release the member's load slot."""
        if task.group and self.proxy.is_group(task.group):
            self.proxy.get_group(task.group).record_skip(provider)
        elif task.group is None:
            self._provider_load(provider, -1)
            self.events.emit("task.skip", provider=provider)

    def _handle_provider_down(self, name: str):
        with self._lock:
            handle = self.proxy.get(name)
            flipped = handle.healthy
            if handle.healthy:
                handle.healthy = False
                handle.trace.add("blacklisted")
        if flipped:
            self.events.emit("provider.blacklist", provider=name)
        with handle.load_lock:
            handle.outstanding = 0  # a dead provider owes nothing dispatchable
        self.ledger.deactivate(name)
        self.proxy.bump_version()  # health flip: cached bind targets stale
        self.staging.site_down(name)
        self.data.deregister_site(name)
        if self.autoscaler is not None:
            # a blacklisted elastic instance must stop occupying pool
            # headroom, or broken capacity could never be replaced
            self.autoscaler.note_provider_lost(name)
        # always sweep for orphans: late ProviderDown failures arrive after
        # the initial blacklisting and still need re-binding
        with self._fault_lock:
            orphans = self._collect_orphans(name)
            self._rebind_and_resubmit(orphans, exclude=name)

    def _collect_orphans(self, provider: str) -> list[Task]:
        """Claim + reset every non-final task bound to a dead provider.
        Must be called under _fault_lock; claims prevent double re-binding."""
        with self._lock:
            orphans = [
                t
                for sub in self._submissions
                for t in sub.tasks
                if t.provider == provider
                and t.uid not in self._claimed
                # FAILED is a *final* state but retryable: include it here
                and (not t.final or t.tstate == TaskState.FAILED)
            ]
            self._claimed.update(t.uid for t in orphans)
        out = []
        ck = self.checkpointer
        for t in orphans:
            # force non-final tasks back to a BOUND-able state
            if t.tstate == TaskState.RUNNING:
                from repro_torch.core.managers.compute import Preempted, ProviderDown as PD

                if ck is not None and ck.eligible(t):
                    # the instance died under a RUNNING checkpointable task:
                    # that is a preemption, not the task's failure — capture
                    # progress and resume on a survivor without charging a
                    # retry (the shared-store checkpoint replica survives
                    # this site's death)
                    t.mark_failed(Preempted(provider))
                    if t.tstate == TaskState.FAILED and not t.done():
                        ck.on_preempt(t)
                        t.reset_for_resume()
                        out.append(t)
                        continue
                else:
                    t.mark_failed(PD(provider))
            if t.tstate == TaskState.FAILED:
                if t.retries >= t.max_retries:
                    self._release_claim(t)
                    continue
                t.reset_for_retry()
            elif t.tstate in (TaskState.SUBMITTED, TaskState.PARTITIONED):
                t.try_advance(TaskState.BOUND)
            elif t.tstate == TaskState.DONE:  # finished in the race window
                self._release_claim(t)
                continue
            out.append(t)
        return out

    def _release_claim(self, task: Task):
        with self._lock:
            self._claimed.discard(task.uid)

    def _rebind_and_resubmit(self, tasks: list[Task], exclude: Optional[str] = None):
        if not tasks:
            return
        if self._dispatcher is not None:
            # tasks with declared inputs must re-enter through the staging
            # gate: a direct resubmit would run them at a site their inputs
            # were never staged to (the dead site took its replicas down)
            gated = [t for t in tasks if t.inputs]
            if gated:
                for t in gated:
                    t.trace.add("rebind_via_gate")
                    self._release_claim(t)
                self._dispatcher.enqueue(gated)
                tasks = [t for t in tasks if not t.inputs]
                if not tasks:
                    return
        targets = [h for h in self.proxy.bind_targets() if h.name != exclude]
        if not targets:
            for t in tasks:
                if not t.done():
                    t.set_exception(RuntimeError("no healthy providers for retry"))
            return
        by_provider: dict[str, list[Task]] = {}
        for t in tasks:
            name = self.policy.bind(t, targets)
            t.provider = name
            t.group = name if self.proxy.is_group(name) else None
            t.trace.add(f"rebound:{name}")
            by_provider.setdefault(name, []).append(t)
        for name, ts in by_provider.items():
            pods = partition(ts, name, model="mcpp", tasks_per_pod=self.tasks_per_pod)
            for p in pods:
                for t in p.tasks:
                    # a task may have completed in the race window (authoritative
                    # completion); the pod runner skips final tasks
                    t.try_advance(TaskState.PARTITIONED)
                    self._release_claim(t)  # re-claimable if this provider dies too
                self.store.serialize(p)
            self._dispatch.submit(self._submit_to_provider, name, pods)

    def _speculate(self, task: Task):
        """Straggler: launch a speculative clone on a different provider.
        For group-bound tasks the clone stays inside the group (on another
        member) and the straggle counts against the member's breaker."""
        if task.group and self.proxy.is_group(task.group):
            group = self.proxy.get_group(task.group)
            group.record_straggler(task.provider)
            try:
                member = group.select(exclude=task.provider)
            except GroupExhausted:
                member = None
            if member is not None:
                shadow = clone_for_speculation(task)
                shadow.group = group.name
                shadow.provider = member
                shadow.advance(TaskState.BOUND)
                pods = partition([shadow], member, model="scpp")
                group.note_dispatch(member, 1)
                for p in pods:
                    shadow.advance(TaskState.PARTITIONED)
                    self.store.serialize(p)
                self._dispatch.submit(self._submit_member_pods, group, member, pods)
                return
        targets = [
            h
            for h in self.proxy.bind_targets()
            if h.name != task.provider and h.name != task.group
        ]
        if not targets:
            return
        shadow = clone_for_speculation(task)
        name = self.policy.bind(shadow, targets)
        shadow.provider = name
        shadow.group = name if self.proxy.is_group(name) else None
        if shadow.inputs and self._dispatcher is not None:
            # the clone carries the original's declared inputs, which live at
            # the straggling site — it must enter through the staging gate so
            # the bytes are staged (and charged) to the speculation target.
            # The reservation pins the gate to the exclude-aware choice made
            # above, or speculation could route right back to the straggler.
            shadow.reserved_provider = name
            shadow.trace.add("speculate_via_gate")
            self._dispatcher.enqueue([shadow])
            return
        shadow.advance(TaskState.BOUND)
        pods = partition([shadow], name, model="scpp")
        for p in pods:
            shadow.advance(TaskState.PARTITIONED)
            self.store.serialize(p)
        self._dispatch.submit(self._submit_to_provider, name, pods)

    def _cancel_all_pending(self):
        with self._lock:
            for sub in self._submissions:
                for t in sub.tasks:
                    if not t.final:
                        t.mark_canceled()

    # ------------------------------------------------------------------
    def shutdown(self, wait: bool = True):
        """Graceful teardown of every instantiated resource (paper §3.2)."""
        if self.autoscaler is not None:
            self.autoscaler.stop(wait=wait)
        if self._dispatcher is not None:
            self._dispatcher.stop(wait=wait)
        if self.watchdog:
            self.watchdog.stop()
        with self._lock:
            managers = list(self._managers.values())
        for m in managers:
            m.shutdown(wait=wait)
        self._dispatch.shutdown(wait=wait)
        self.staging.shutdown()
        self.store.cleanup()
        if self.autotuner is not None:
            # release the process-global slot iff it is still ours (a later
            # broker may have installed its own tuner in the meantime)
            from repro_torch.kernels.autotune import unset_autotuner

            unset_autotuner(self.autotuner)
        log_base = os.environ.get("HYDRA_EVENTS_LOG", "")
        if log_base:
            self.events.dump_jsonl(next_log_path(log_base))
        if self.ledger.strict and self.ledger.divergences:
            # a strict-mode divergence may have fired inside a loop that
            # swallows exceptions (the dispatcher's lifeline handler):
            # re-surface it here so the test suite cannot pass over it
            raise LedgerDivergence(
                f"capacity ledger diverged {self.ledger.divergences}x "
                f"during this broker's lifetime: {self.ledger.last_divergence}"
            )
        if self.events.strict:
            # the authoritative events cross-check runs here, at quiescence:
            # every derived metric must equal its legacy accumulator, and any
            # divergence recorded mid-run re-surfaces the same way the
            # ledger's does
            if self.events.divergences:
                raise EventsDivergence(
                    f"event views diverged {self.events.divergences}x during "
                    f"this broker's lifetime: {self.events.last_divergence}"
                )
            self.events.check()
