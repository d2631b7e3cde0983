"""Streaming DAG dispatcher: micro-batched, late-bound, backfilling.

Frontier-mode workflow execution (the paper's Argo analogue) turns *every*
readiness event into a fresh full-pipeline ``broker.submit()`` — one
bind/partition/serialize/dispatch round per micro-frontier, often a
single-task pod.  Per-submission overhead therefore grows with
DAG depth x instance count, the opposite of the paper's near-constant
broker-overhead claim (§5.4, §6).

The streaming dispatcher inverts that: ONE long-lived loop owns a
ready-queue fed by every running workflow, and

  * **micro-batches**: ready tasks arriving within ``batch_window`` (measured
    on the active clock, so virtual-time tests stay fast) coalesce into one
    submission of up to ``max_batch`` tasks — across ALL workflow instances,
    so 800 one-task frontiers become a handful of well-filled pods;
  * **late-binds**: the binding policy and the provider-group breaker state
    (core/group.py) are consulted when the batch *dispatches*, not when the
    DAG was built — a member that died a millisecond ago is already out of
    rotation;
  * **backfills**: batches are drained shallow-DAG-depth-first and sized
    against the pools' ``idle_slots()`` hint, so when the shallow frontier
    is too small to fill idle capacity, ready tasks from deeper workflows
    ride along instead of waiting for their instance's "turn".

``WorkflowManager`` (core/managers/workflow.py) shrinks to a dependency
tracker that feeds this queue.
"""
from __future__ import annotations

import heapq
import math
import threading
from typing import TYPE_CHECKING, Optional

from repro_torch.core.policy import NoEligibleProvider, apportion_budget
from repro_torch.core.staging import StagingError
from repro_torch.core.task import SLO_CLASSES, Task, TaskState
from repro_torch.runtime.clock import get_clock
from repro_torch.runtime.tracing import Counter, Trace

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.broker import Hydra

_batch_ids = Counter("batch")


class StreamingDispatcher:
    """The broker's long-lived ready-queue -> micro-batch -> submit loop."""

    def __init__(
        self,
        broker: "Hydra",
        batch_window: float = 0.002,
        max_batch: int = 256,
        min_batch: int = 32,
        max_consecutive_failures: int = 500,
    ):
        self.broker = broker
        self.batch_window = batch_window
        self.max_batch = max(1, max_batch)
        self.min_batch = max(1, min(min_batch, self.max_batch))
        # back-to-back dispatch failures (~10ms backoff each) before a
        # persistent outage is surfaced onto the tasks instead of retried
        self.max_consecutive_failures = max_consecutive_failures
        self.trace = Trace()
        # ready queue: per-(slo_class, tenant) LANES, each a heap keyed by
        # (depth, arrival) so the shallow-first drain stays O(log n) per
        # task.  The drain walks classes in strict SLO_CLASSES order —
        # every interactive lane empties before any batch lane sees budget
        # (queued batch backfill is preempted, not running work) — and
        # splits the budget among same-class lanes by tenant weight
        # (policy.apportion_budget, deficits carried in _lane_carry).  The
        # single-lane common case (no tenant config) pops directly, so the
        # exp9 hot path pays one dict lookup over the old flat heap.
        self._lanes: dict[tuple[str, str], list[tuple[int, int, Task]]] = {}
        self._lane_carry: dict[tuple[str, str], float] = {}
        self._npending = 0
        self._class_pending: dict[str, int] = {c: 0 for c in SLO_CLASSES}
        self._queued: set[str] = set()  # uids in the lanes (dedup guard)
        # tasks parked on stage-in (core/staging.py): OUT of the ready heap,
        # so pending()/queue_pressure() never count work that no amount of
        # new capacity could run — exactly what keeps the autoscaler from
        # buying providers for tasks that are waiting on bytes, not slots.
        # _blocked_at stamps the park time: deferred_demand() decays parked
        # tasks back into the autoscaler's demand signal (recently parked ~
        # transfers in flight ~ capacity needed soon; anciently stuck ~ 0).
        self._blocked: dict[str, Task] = {}
        self._blocked_at: dict[str, float] = {}
        # checkpoint resumes re-entering the gate (ckpt/checkpoint.py): the
        # resume carries its ckpt:<uid> dataset as an input, so it pays the
        # normal data-gravity placement + staging cost on the way back in
        self.resume_gated = 0
        self.max_staging_attempts = 3
        self._seq = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # staging-retry timers the dispatcher OWNS: stop() cancels them and
        # resolves their tasks, so shutdown can never race a late requeue
        # into a dead loop (and no task future is left dangling)
        self._timer_lock = threading.Lock()
        self._retry_timers: dict[object, Task] = {}
        # metrics: the streaming-vs-frontier story in benchmarks/exp6
        self.batches = 0
        self.tasks_dispatched = 0
        self.retry_backoffs = 0
        self.loop_errors = 0
        self._consecutive_failures = 0  # current retry streak (reset on success)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "StreamingDispatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hydra-stream"
            )
            self._thread.start()
            self.trace.add("dispatcher_started")
        return self

    def stop(self, wait: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        # sweep the staging-retry timer registry: a timer that has not fired
        # is cancelled and its task failed cleanly (an enqueue into a
        # stopping loop would strand the future unresolved forever); a timer
        # mid-fire re-checks _stop and fails its task itself
        with self._timer_lock:
            timers = list(self._retry_timers.items())
            self._retry_timers.clear()
        for timer, task in timers:
            timer.cancel()
            with self._lock:
                self._unpark_locked(task.uid)
            self._fail_task(
                task,
                StagingError(f"task {task.uid}: dispatcher stopped during staging retry"),
            )
        if wait and self._thread is not None:
            self._thread.join(timeout=5.0)
        self.trace.add("dispatcher_stopped")

    def notify_capacity(self) -> None:
        """Idle supply grew (completion, breaker close, provider arrival —
        the CapacityLedger's capacity-gain callback via the broker): wake
        the loop now instead of letting a poll timeout expire.  This is what
        removes the 20-50 ms real-time floor per saturated round that used
        to dominate virtual-clock runs."""
        self._wake.set()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive() and not self._stop.is_set()

    # -- the ready queue -------------------------------------------------
    def enqueue(self, tasks: list[Task]) -> None:
        """Feed ready tasks (deps satisfied) from any workflow or caller."""
        if not tasks:
            return
        with self._lock:
            added = False
            for t in tasks:
                if t.uid in self._queued:
                    continue
                self._queued.add(t.uid)
                lane = (t.slo_class, t.tenant)
                heapq.heappush(
                    self._lanes.setdefault(lane, []), (t.depth, self._seq, t)
                )
                self._seq += 1
                self._npending += 1
                self._class_pending[t.slo_class] += 1
                added = True
            if added:
                self._idle.clear()
        self._wake.set()

    def pending(self) -> int:
        with self._lock:
            return self._npending

    def pending_by_class(self) -> dict[str, int]:
        """Ready-queue depth per SLO class: the autoscaler's per-class
        pressure input, so interactive demand can buy capacity even while
        batch admission is throttled."""
        with self._lock:
            return dict(self._class_pending)

    def queue_pressure(self) -> float:
        """Demand over supply: ready-queue depth / (idle + incoming slots).
        THE autoscaler input (core/autoscaler.py): > 1 means the queue could
        not be absorbed even if every free and in-acquisition slot took one
        task; ~0 means the pool is idle.

        Zero-supply semantics are explicit: no pending work is 0.0 whatever
        the supply.  With pending work and no free slot, two states that the
        old ``pending / max(supply, 1)`` conflated are now distinguished:
        a *saturated-but-live* fleet (slots exist, all busy — in-flight work
        will free them) reads as the raw pending count (finite, maximally
        pressured), while a fleet with no live capacity at all (every
        breaker OPEN, nothing incoming) reads as ``inf`` — a sentinel the
        autoscaler maps through its probe-aware path (Autoscaler.pressure)
        instead of a raw count that merely *scaled* with backlog (100k tasks
        read as "pressure 100000", slamming the pool to max during a
        full-fleet outage that a single breaker probe would recover)."""
        pending = self.pending()
        if pending <= 0:
            return 0.0
        supply = self.broker.idle_slots() + self.broker.incoming_slots()
        if supply > 0:
            return pending / supply
        # supply==0 implies incoming==0 too, so total alone decides whether
        # any live slot could ever absorb this queue
        if self.broker.total_slots() > 0:
            return float(pending)
        return float("inf")

    def deferred_demand(self, tau_s: float = 60.0) -> float:
        """Staging-parked tasks as *decayed* autoscaler demand.

        A task parked on stage-in is not runnable — but its transfers are
        in flight and it will want a slot in seconds, which is exactly when
        an elastic pool that drained to zero during a link partition would
        make the whole herd wait out a re-acquisition ramp.  Count each
        parked task as ``exp(-age/tau)`` demand: freshly parked ~ 1 slot
        needed soon, stuck-for-minutes ~ 0 (no point buying capacity for
        bytes that are not arriving).  This replaces the at-scale preset's
        ``min_instances`` warm-floor workaround (scenarios/presets.py)."""
        now = get_clock().now()
        with self._lock:
            stamps = list(self._blocked_at.values())
        return sum(math.exp(-max(0.0, now - t0) / tau_s) for t0 in stamps)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no batch is in flight (tests)."""
        return self._idle.wait(timeout)

    # -- the loop --------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self.pending():
                with self._lock:
                    if not self._npending:  # recheck under the lock
                        self._wake.clear()
                        # drain()'s contract is "nothing left to dispatch":
                        # a task parked on stage-in is still owed a dispatch,
                        # so the queue is not idle while any task is blocked
                        if not self._blocked:
                            self._idle.set()
                # enqueue always signals _wake, so this wait is purely
                # event-driven; the timeout is a belt-and-braces valve, far
                # off the hot path (it used to be a 50 ms poll)
                self._wake.wait(timeout=0.5)
                continue
            # open the micro-batch window: readiness events from other
            # workflows coalesce here (clock-aware: virtual windows are free)
            clock = get_clock()
            if self.batch_window > 0:
                clock.sleep(self.batch_window)
            try:
                # hold the clock only across the drain: submit() may sleep
                # modeled provider latencies on this same clock, and hold()'s
                # contract forbids sleeping under a hold (deadlock valve)
                with clock.hold():
                    batch = self._take_batch()
                if batch:
                    self._dispatch(batch)
                elif self.pending():
                    # saturated under the elastic throttle.  Every capacity
                    # gain is an event now: completions and breaker closes
                    # signal through the CapacityLedger (notify_capacity),
                    # provider arrivals through Autoscaler._arrive.  Clear
                    # first, THEN re-read idle supply (O(1) ledger): a gain
                    # landing in the gap set _wake after our clear, so the
                    # wait below returns immediately instead of losing it.
                    self._wake.clear()
                    if self.broker.idle_slots() <= 0 and not self._stop.is_set():
                        self._wake.wait(0.25)
            except Exception:
                # the loop is the broker's lifeline: a raced completion or a
                # recovery-path error must never kill the dispatcher thread.
                # Back off so a persistent error cannot become a hot spin.
                self.loop_errors += 1
                self.broker.events.emit("dispatch.loop_error")
                self.trace.add("loop_error")
                self._stop.wait(0.05)

    def _take_batch(self) -> list[Task]:
        """Drain up to the batch budget: strict SLO-class priority, weighted
        fair share among same-class tenant lanes, shallow DAG depth first
        within a lane (backfill: deeper-workflow tasks fill whatever
        capacity the frontier leaves).

        With an autoscaler attached — or a tenant front door configured
        (core/admission.py) — the budget is capped at the pool's
        actually-free slots: work held back here is precisely the queue
        pressure that buys new providers, late binding hands it to arriving
        capacity instead of burying a busy provider's internal queue, and
        queued batch backfill stays HERE, preemptible by an interactive
        lane, rather than becoming un-reorderable manager-queue depth."""
        if self.broker.autoscaler is not None or self.broker.admission is not None:
            budget = min(self.max_batch, self.broker.idle_slots())
            if budget <= 0:
                # the ledger reads zero, but a breaker whose reset window
                # elapsed is only *probeable* — it re-enters the counted
                # supply when a dispatch triggers its OPEN -> HALF_OPEN
                # transition.  Peek time-aware capacity (cold path) so a
                # fully-tripped fleet at pool max still gets its probe.
                budget = min(self.max_batch, self.broker.probe_slots())
            if budget <= 0:
                return []
        else:
            budget = min(self.max_batch, max(self.broker.idle_slots(), self.min_batch))
        batch: list[Task] = []
        stale: list[Task] = []
        with self._lock:
            if len(self._lanes) == 1:
                # the no-tenant-config fast path: one lane == the old flat
                # heap, no apportionment arithmetic on the exp9 hot path
                self._pop_lane(next(iter(self._lanes)), budget, batch, stale)
            else:
                remaining = budget
                for slo_class in SLO_CLASSES:
                    if remaining <= 0:
                        break
                    keys = sorted(k for k in self._lanes if k[0] == slo_class)
                    if not keys:
                        continue
                    if len(keys) == 1:
                        remaining -= self._pop_lane(keys[0], remaining, batch, stale)
                        continue
                    demands = [len(self._lanes[k]) for k in keys]
                    weights = [self._tenant_weight(k[1]) for k in keys]
                    carry = [self._lane_carry.get(k, 0.0) for k in keys]
                    grants, new_carry = apportion_budget(
                        remaining, demands, weights, carry
                    )
                    for k, g, c in zip(keys, grants, new_carry):
                        self._lane_carry[k] = c  # _pop_lane drops it if emptied
                        remaining -= self._pop_lane(k, g, batch, stale)
        for t in stale:
            # a canceled task may still hold a staging-gate reservation:
            # dropping it without unbinding would leak policy load accounting
            # for the reserved provider forever (released outside the lock —
            # policy locks nest under the dispatcher's, never the reverse)
            self._release_reservation(t)
        return self._stage_gate(batch)

    def _pop_lane(
        self, key: tuple[str, str], k: int, batch: list[Task], stale: list[Task]
    ) -> int:
        """Pop up to ``k`` tasks from one lane, shallow-first (callers hold
        self._lock).  Returns the number popped (stale/canceled tasks count
        against the grant: their slot was budgeted this round either way)."""
        heap = self._lanes.get(key)
        popped = 0
        while heap and popped < k:
            _, _, t = heapq.heappop(heap)
            self._queued.discard(t.uid)
            self._npending -= 1
            self._class_pending[key[0]] -= 1
            popped += 1
            (stale if t.final else batch).append(t)
        if heap is not None and not heap:
            del self._lanes[key]
            self._lane_carry.pop(key, None)  # an empty lane banks no deficit
        return popped

    def _tenant_weight(self, tenant: str) -> float:
        admission = self.broker.admission
        return admission.weight(tenant) if admission is not None else 1.0

    # -- the staging gate (core/staging.py) ------------------------------
    def _stage_gate(self, batch: list[Task]) -> list[Task]:
        """Stage-in insertion point: a task whose declared inputs are missing
        at its placement site is parked while its transfers fly, and ONLY
        that task — the rest of the batch dispatches now, so transfers
        overlap with other tasks' compute.

        Placement is decided HERE, via the binding policy (a stateful
        reservation the later ``bind_bulk`` honors): staging to a predicted
        site and then binding elsewhere would ship bytes to the wrong
        platform.  Replica-resident tasks pay nothing and flow straight
        through; the data-gravity policy makes that the common case."""
        staging = getattr(self.broker, "staging", None)
        if staging is None or not any(t.inputs for t in batch):
            return batch
        with self.broker.policy.bulk_scope():
            return self._stage_gate_scoped(batch, staging)

    def _stage_gate_scoped(self, batch: list[Task], staging) -> list[Task]:
        # inside policy.bulk_scope(): every gate bind in this pass shares one
        # staging cost map per (inputs-signature, targets) — a batch of tasks
        # reading the same shard set prices its placements once (§Perf exp9)
        ready: list[Task] = []
        targets = None
        for t in batch:
            if not t.inputs:
                ready.append(t)
                continue
            if t.ckpt_dataset is not None and t.trace.last("resume_gated") is None:
                # first gate pass after a checkpoint resume: placement below
                # stages ckpt:<uid> to whatever surviving site the policy picks
                t.trace.add("resume_gated")
                with self._lock:
                    self.resume_gated += 1
            if targets is None:
                targets = self.broker.proxy.bind_targets()
            name = t.reserved_provider
            if name is not None and not any(p.name == name for p in targets):
                # the reserved target died (its replicas with it): release
                # the reservation and re-bind, instead of letting bind_bulk
                # silently re-choose a site the inputs never reached
                self._release_reservation(t)
                t.trace.add(f"regate:{name}")
                name = None
            if name is None:
                if not targets:
                    ready.append(t)  # full outage: the retry path owns it
                    continue
                try:
                    name = self.broker.policy.bind(t, targets)
                except NoEligibleProvider:
                    ready.append(t)  # surfaced by the dispatch error path
                    continue
                t.reserved_provider = name
            # an existing reservation with inputs missing at its site is
            # staged (again) to that SAME target: covers eviction between
            # staging and dispatch, and external reservers (speculation)
            # that want placement pinned away from a straggling provider.
            # Nothing staging-side may unwind into the dispatch loop: an
            # exception here would silently drop the whole popped batch.
            try:
                missing = staging.missing(t.inputs, name)
                if not missing:
                    staging.note_local(t.inputs, name)
                    ready.append(t)  # replica hit: free read, dispatch now
                    continue
                with self._lock:
                    self._park_locked(t)
                gen = t.staging_attempts  # pins callbacks to THIS round
                staging.stage_task(
                    t, name, lambda ok, t=t, g=gen: self._staged(t, ok, g)
                )
            except Exception:
                self.trace.add("stage_gate_error")
                with self._lock:  # the failure path assumes blocked membership
                    self._park_locked(t)
                self._staged(t, False, t.staging_attempts)
        return ready

    def _park_locked(self, t: Task) -> None:
        # callers hold self._lock.  A re-park of an already-parked task (the
        # gate's exception path) keeps the ORIGINAL stamp: the task has been
        # waiting since then, and deferred_demand should decay it as such.
        if t.uid not in self._blocked:
            self._blocked[t.uid] = t
            self._blocked_at[t.uid] = get_clock().now()

    def _unpark_locked(self, uid: str) -> None:
        self._blocked.pop(uid, None)
        self._blocked_at.pop(uid, None)

    def _staged(self, t: Task, ok: bool, gen: int) -> None:
        """Stage-in barrier resolved (may run on a clock thread).  ``gen``
        is the task's staging_attempts when this round's barrier was armed:
        a leftover waiter from a superseded round (e.g. a transfer that was
        still flying when the gate's exception path already failed and
        re-gated the task) must not act on the task's CURRENT round —
        every failure bumps staging_attempts, invalidating older gens."""
        if t.staging_attempts != gen:
            return  # stale callback from a superseded staging round
        if t.final:  # canceled while its bytes were in flight
            with self._lock:
                self._unpark_locked(t.uid)
            self._release_reservation(t)
            return
        if ok:
            # enqueue BEFORE leaving _blocked: in the opposite order the
            # loop could observe heap-empty + blocked-empty in the gap and
            # flash _idle (drain()/autoscaler demand would misread it)
            self.enqueue([t])  # reservation rides along to bind_bulk
            with self._lock:
                self._unpark_locked(t.uid)
            return
        # transfer failed (site died / dataset lost / input never declared):
        # release the gate's reservation and re-gate against the surviving
        # topology after a short backoff, so an instantly-failing stage
        # (unknown dataset) cannot burn every attempt in microseconds.  The
        # backoff must NOT block this thread (_staged runs on the virtual
        # clock's advancer thread or inline under the gate's clock.hold()),
        # and it is REAL time by design: a virtual deadline might never be
        # served on a manually-driven or closing clock.  The task stays in
        # _blocked until the re-enqueue, so drain()/stalled counts never see
        # a phantom idle window mid-retry.
        self._release_reservation(t)
        t.staging_attempts += 1
        if t.staging_attempts > self.max_staging_attempts or self._stop.is_set():
            # out of attempts — or the dispatcher is shutting down, where a
            # retry would enqueue into a loop that will never pop it and
            # leave the future unresolved forever
            with self._lock:
                self._unpark_locked(t.uid)
            self._fail_task(
                t, StagingError(f"task {t.uid}: staging failed for {t.inputs}")
            )
            return

        self._schedule_requeue(t)

    def _schedule_requeue(self, t: Task, delay_s: float = 0.01) -> None:
        """Re-gate ``t`` after a short REAL-time backoff, through a timer
        the dispatcher owns: the registry entry is claimed exactly once —
        by the firing timer or by stop()'s sweep — so a shutdown racing the
        backoff either cancels the requeue cleanly (failing the task, whose
        future must not dangle) or lets it land in a still-live loop."""

        def _requeue() -> None:
            with self._timer_lock:
                claimed = self._retry_timers.pop(timer, None)
            if claimed is None:
                return  # stop() swept this timer: it owns the task's fate
            if self._stop.is_set():
                with self._lock:
                    self._unpark_locked(t.uid)
                self._fail_task(
                    t, StagingError(f"task {t.uid}: dispatcher stopped during staging retry")
                )
                return
            # enqueue BEFORE leaving _blocked (same idle-flash ordering as
            # the staging success path)
            self.enqueue([t])
            with self._lock:
                self._unpark_locked(t.uid)
            if self._stop.is_set() and not t.done():
                # stop() raced past our registry claim (we popped ourselves
                # before its sweep, then it set _stop): the loop may already
                # have exited without popping this enqueue — resolve the
                # future rather than strand it
                self._fail_task(
                    t, StagingError(f"task {t.uid}: dispatcher stopped during staging retry")
                )

        timer = threading.Timer(delay_s, _requeue)
        timer.daemon = True
        with self._timer_lock:
            self._retry_timers[timer] = t
        timer.start()

    def _release_reservation(self, t: Task) -> None:
        if t.reserved_provider is not None:
            self.broker.policy.unbind(t, t.reserved_provider)
            t.reserved_provider = None

    def stalled_on_staging(self) -> int:
        with self._lock:
            return len(self._blocked)

    def stalled_in_backlog(self) -> int:
        """Staging-blocked tasks the broker's backlog() scan ALSO counts
        (re-gated retries from already-dispatched submissions): exactly the
        overlap the autoscaler must subtract so tasks stalled purely on
        staging never read as unmet demand."""
        with self._lock:
            return sum(1 for t in self._blocked.values() if t.in_submission)

    def _dispatch(self, batch: list[Task]) -> None:
        batch_id = _batch_ids.next()
        try:
            sub = self.broker.submit(
                batch,
                partitioning=self.broker.partitioning,
                tasks_per_pod=self.broker.tasks_per_pod,
                batch_id=batch_id,
            )
        except NoEligibleProvider:
            # late binding found an unplaceable task (bind_bulk validates
            # eligibility before any stateful binding, so no load accounting
            # leaked): fail only the offenders, stream the rest through
            placeable = []
            deferred = False
            targets = self.broker.proxy.bind_targets()
            if not targets:  # raced into a full outage: transient, not fatal
                self._retry(batch)
                return
            for t in batch:
                try:
                    self.broker.policy._eligible(t, targets)
                    placeable.append(t)
                except NoEligibleProvider as exc:
                    if self.broker.incoming_could_fit(t):
                        # capacity that can actually RUN this task is
                        # mid-acquisition (core/autoscaler.py): keep it
                        # queued instead of terminally failing it
                        placeable.append(t)
                        deferred = True
                    else:
                        self._fail_task(t, exc)  # surface the typed error
            self.retry_backoffs += 1
            self.broker.events.emit("dispatch.retry")
            if placeable:
                self.enqueue(placeable)
            if deferred:
                self._stop.wait(0.01)  # don't hot-spin while capacity boots
            return
        except Exception as exc:
            self._retry(batch, exc)
            return
        self.batches += 1
        self.tasks_dispatched += len(batch)
        # one event per BATCH, not per task: the log costs O(batches) on the
        # exp9/exp11 hot path while the view still derives the task total
        self.broker.events.emit("dispatch.batch", n=len(batch))
        self._consecutive_failures = 0
        self.trace.add(f"batch:{batch_id}:{len(batch)}:{len(sub.pods)}")

    def _retry(self, batch: list[Task], exc: Optional[BaseException] = None) -> None:
        """Transient dispatch failure (e.g. every provider momentarily
        unhealthy): requeue what is safe to re-bind, back off briefly.
        Tasks the failed round already handed to a provider (SUBMITTED /
        RUNNING) are NOT requeued — they either finish there or re-enter
        through the broker's fault machinery."""
        self.retry_backoffs += 1
        self.broker.events.emit("dispatch.retry")
        self._consecutive_failures += 1
        self.trace.add("dispatch_retry")
        # pipeline aborts before dispatch release the whole batch's load
        # accounting broker-side (exc carries the marker); only a failure
        # AFTER dispatch started leaves bound-but-undelivered tasks to us
        released = exc is not None and getattr(exc, "_hydra_load_released", False)
        requeueable = []
        for t in batch:
            if t.final or t.tstate not in (TaskState.NEW, TaskState.BOUND, TaskState.PARTITIONED):
                continue
            if not released and t.tstate != TaskState.NEW:
                # bound in the failed round but never reached a provider:
                # release the policy's load accounting before re-binding
                self.broker.policy.unbind(t)
            requeueable.append(t)
        if (
            self._consecutive_failures > self.max_consecutive_failures
            and exc is not None
            and self.broker.incoming_slots() == 0
        ):
            # a persistent outage (counter resets on any success): surface
            # instead of spinning forever — unless replacement capacity is
            # already mid-acquisition, in which case the outage is ending
            for t in requeueable:
                self._fail_task(t, exc)
            return
        self.enqueue(requeueable)
        self._stop.wait(0.01)

    def _fail_task(self, t: Task, exc: BaseException) -> None:
        """Terminal failure: move tstate to a final state FIRST (workflow
        completion checks ``all(t.final)``), then resolve the future."""
        self._release_reservation(t)
        t.try_advance(TaskState.CANCELED)
        try:
            if not t.done():
                t.set_exception(exc)
        except Exception:  # raced with a concurrent resolution: already final
            pass

    # -- metrics ---------------------------------------------------------
    def _finite_pressure(self) -> Optional[float]:
        """queue_pressure() for JSON consumers: the zero-supply ``inf``
        sentinel becomes None (no finite pressure is honest there)."""
        p = self.queue_pressure()
        return round(p, 3) if math.isfinite(p) else None

    def stats(self) -> dict:
        """Dict-shaped adapter over the broker's event log: the dispatch
        counters are the log-derived view (core/events.py), folded from
        dispatch.batch/retry/loop_error events emitted adjacent to the
        legacy accumulators (which stay as HYDRA_EVENTS_CHECK ground
        truth).  Queue depths and pressure are live gauges."""
        view = self.broker.events.view
        batches = int(view.get("hydra.dispatch.batches"))
        tasks = int(view.get("hydra.dispatch.tasks"))
        return {
            "batches": batches,
            "tasks_dispatched": tasks,
            "mean_batch_size": round(tasks / max(batches, 1), 2),
            "pending": self.pending(),
            "pending_by_class": self.pending_by_class(),
            "lanes": len(self._lanes),
            "staging_blocked": self.stalled_on_staging(),
            "resume_gated": self.resume_gated,
            "queue_pressure": self._finite_pressure(),
            "incoming_slots": self.broker.incoming_slots(),
            "retry_backoffs": int(view.get("hydra.dispatch.retry_backoffs")),
            "loop_errors": int(view.get("hydra.dispatch.loop_errors")),
            "batch_window_s": self.batch_window,
            "max_batch": self.max_batch,
        }
