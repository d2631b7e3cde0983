"""Elastic provider autoscaler: queue-pressure-driven acquisition/release.

Counterpart of ``repro/core/autoscaler.py``, copied with its imports rewritten.

The paper's headline capability is *concurrently acquiring* resources from
cloud and HPC platforms (§1, §4): a cloud VM arrives after a startup latency
of seconds, an HPC allocation after a batch-queue wait of minutes, and the
broker exploits whatever shows up first.  Up to now every provider had to be
registered up front and was held for the whole run; this module turns the
static pool into the elastic broker the paper describes.

The control loop (see docs/ARCHITECTURE.md for the full diagram):

  pressure signals  ->  hysteresis  ->  acquire / release
  ----------------      ----------      -----------------
  ready-queue depth     warmup_ticks    sample the platform's acquisition
  (dispatcher), task    consecutive     latency model (cloud startup vs HPC
  backlog vs live +     pressured /     queue wait) on the active Clock via
  incoming slots,       cooldown_ticks  call_later; scale-in drains through
  per-group breaker     idle ticks      remove_provider(drain=True) and
  state (tripped                        deregisters so names recycle.
  members leave the
  supply side)

Determinism: latency samples come from one seeded ``random.Random`` owned by
the ProviderPool, and every wait (ticks, acquisition latencies, drains) goes
through the active Clock — under a VirtualClock the whole scale-out/scale-in
life cycle runs in real milliseconds and is exactly reproducible
(tests/test_autoscaler.py, benchmarks/exp7_elastic.py).

Launchable templates must model acquisition latency HERE (LatencyModel), not
via ``ProviderSpec.queue_delay_s``: the spec-level delay models per-submit
waits on an already-standing allocation, while the pool's latency model is
paid once, at acquisition time.
"""
from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.core.provider import ProviderSpec, ValidationError
from repro_torch.runtime.clock import ScheduledCall, get_clock
from repro_torch.runtime.tracing import Trace


# ---------------------------------------------------------------------------
# Per-platform acquisition latency models
# ---------------------------------------------------------------------------


@dataclass
class LatencyModel:
    """Acquisition latency distribution for one platform kind.

    ``lognormal`` is the literature default for both cloud VM startup and
    HPC queue waits (long right tail); ``mean_s`` parameterizes the mean of
    the distribution itself (mu is derived), so swapping sigma does not move
    the expected latency.
    """

    distribution: str = "lognormal"  # "lognormal" | "uniform" | "fixed"
    mean_s: float = 45.0
    sigma: float = 0.25  # lognormal shape
    lo_s: float = 0.0  # uniform bounds
    hi_s: float = 0.0

    def sample(self, rng: random.Random) -> float:
        if self.distribution == "fixed":
            return max(0.0, self.mean_s)
        if self.distribution == "uniform":
            return rng.uniform(self.lo_s, max(self.lo_s, self.hi_s))
        if self.distribution == "lognormal":
            mu = math.log(max(self.mean_s, 1e-9)) - self.sigma**2 / 2.0
            return rng.lognormvariate(mu, self.sigma)
        raise ValidationError(f"unknown latency distribution {self.distribution!r}")

    @property
    def expected_s(self) -> float:
        if self.distribution == "uniform":
            return (self.lo_s + max(self.lo_s, self.hi_s)) / 2.0
        return self.mean_s


def cloud_startup(mean_s: float = 45.0, sigma: float = 0.25) -> LatencyModel:
    """Cloud VM/container bring-up: tens of seconds, mild spread."""
    return LatencyModel(distribution="lognormal", mean_s=mean_s, sigma=sigma)


def hpc_queue_wait(mean_s: float = 300.0, sigma: float = 0.5) -> LatencyModel:
    """HPC batch-queue wait: minutes, heavy right tail."""
    return LatencyModel(distribution="lognormal", mean_s=mean_s, sigma=sigma)


DEFAULT_LATENCY = {"cloud": cloud_startup, "hpc": hpc_queue_wait}


# ---------------------------------------------------------------------------
# The declarative pool of launchable providers
# ---------------------------------------------------------------------------


@dataclass
class LaunchSpec:
    """One launchable provider template + its elasticity bounds.

    ``template.name`` is the instance-name prefix: acquired instances are
    ``{name}-1``, ``{name}-2``, ... with a monotone counter, so a released
    slot is never re-registered under a stale name.  ``group`` names a live
    ProviderGroup every instance joins on arrival (dynamic membership).
    """

    template: ProviderSpec
    min_instances: int = 0
    max_instances: int = 4
    latency: Optional[LatencyModel] = None  # default: per template.platform
    group: Optional[str] = None
    # market knobs (core/market.py): dollars per slot-hour of occupancy, and
    # an optional PreemptionHazard (revocation-rate model).  0.0 / None keep
    # pre-market pools free and non-preemptible.
    price_per_slot_hour: float = 0.0
    hazard: Optional["object"] = None  # market.PreemptionHazard (no import cycle)

    def __post_init__(self):
        if (
            self.min_instances < 0
            or self.max_instances < 0
            or self.max_instances < self.min_instances
        ):
            raise ValidationError(
                f"launch spec {self.template.name!r}: need 0 <= min <= max, "
                f"got [{self.min_instances}, {self.max_instances}]"
            )
        if self.price_per_slot_hour < 0:
            raise ValidationError(
                f"launch spec {self.template.name!r}: negative "
                f"price_per_slot_hour {self.price_per_slot_hour}"
            )
        if self.latency is None:
            make = DEFAULT_LATENCY.get(self.template.platform)
            if make is None:
                raise ValidationError(
                    f"launch spec {self.template.name!r}: no default latency "
                    f"model for platform {self.template.platform!r}"
                )
            self.latency = make()

    @property
    def slots_per_instance(self) -> int:
        return max(1, self.template.concurrency * self.template.n_nodes)


@dataclass
class _SpecState:
    """Pool-internal bookkeeping for one LaunchSpec."""

    launch: LaunchSpec
    counter: int = 0
    pending: set = field(default_factory=set)  # instance names in flight
    live: list = field(default_factory=list)  # arrival order (scale-in = LIFO)
    failures: int = 0  # consecutive failed arrivals (quarantine gate)


class ProviderPool:
    """Declarative pool of launchable specs + instance bookkeeping.

    The pool owns the seeded RNG every latency sample draws from, which is
    what makes a whole elastic run reproducible from one integer seed.

    A spec whose arrivals keep failing (e.g. a misconfigured group target)
    is quarantined after ``MAX_CONSECUTIVE_FAILURES``: it leaves both the
    scale-out candidate list and the min-fill set, so one broken template
    cannot buy providers in an unbounded loop.
    """

    MAX_CONSECUTIVE_FAILURES = 3

    def __init__(self, specs: list[LaunchSpec], seed: int = 0):
        if not specs:
            raise ValidationError("provider pool: needs at least one launch spec")
        names = [s.template.name for s in specs]
        if len(set(names)) != len(names):
            raise ValidationError(f"provider pool: duplicate templates {names}")
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._states = {s.template.name: _SpecState(launch=s) for s in specs}
        self._arrival_seq = 0
        self._arrival_order: dict[str, int] = {}  # instance -> global seq

    @property
    def specs(self) -> list[LaunchSpec]:
        return [st.launch for st in self._states.values()]

    # -- scale-out side --------------------------------------------------
    def candidates(self) -> list[LaunchSpec]:
        """Launch specs with headroom, fastest expected acquisition first —
        under pressure the broker grabs cloud capacity (seconds) before
        committing to an HPC queue wait (minutes)."""
        with self._lock:
            open_ = [
                st.launch
                for st in self._states.values()
                if len(st.pending) + len(st.live) < st.launch.max_instances
                and st.failures < self.MAX_CONSECUTIVE_FAILURES
            ]
        return sorted(open_, key=lambda s: s.latency.expected_s)

    def below_min(self) -> list[LaunchSpec]:
        with self._lock:
            return [
                st.launch
                for st in self._states.values()
                if len(st.pending) + len(st.live) < st.launch.min_instances
                and st.failures < self.MAX_CONSECUTIVE_FAILURES
            ]

    def request_instance(self, launch: LaunchSpec) -> ProviderSpec:
        """Mint the next instance spec and mark it pending."""
        with self._lock:
            st = self._states[launch.template.name]
            st.counter += 1
            name = f"{launch.template.name}-{st.counter}"
            st.pending.add(name)
        return replace(launch.template, name=name)

    def note_live(self, launch: LaunchSpec, name: str) -> None:
        with self._lock:
            st = self._states[launch.template.name]
            st.pending.discard(name)
            st.live.append(name)
            st.failures = 0
            self._arrival_seq += 1
            self._arrival_order[name] = self._arrival_seq

    def note_failed(self, launch: LaunchSpec, name: str) -> None:
        """An arrival failed to register: count toward quarantine."""
        with self._lock:
            self._states[launch.template.name].failures += 1
            self._forget(launch, name)

    def note_gone(self, launch: LaunchSpec, name: str) -> None:
        """Aborted acquisition or completed release."""
        with self._lock:
            self._forget(launch, name)

    # -- quarantine controls (chaos injection / operator override) -------
    def force_quarantine(self, template: str) -> None:
        """Declare a template's arrivals doomed (provisioning-API outage):
        push its consecutive-failure counter straight to the quarantine
        gate, so the scale-out loop stops buying it.  A later successful
        arrival (note_live) or an explicit rehabilitate() re-opens it."""
        with self._lock:
            self._states[template].failures = self.MAX_CONSECUTIVE_FAILURES

    def rehabilitate(self, template: str) -> None:
        """Lift a quarantine (the provisioning outage window closed)."""
        with self._lock:
            self._states[template].failures = 0

    def quarantined(self) -> list[str]:
        with self._lock:
            return sorted(
                name
                for name, st in self._states.items()
                if st.failures >= self.MAX_CONSECUTIVE_FAILURES
            )

    def _forget(self, launch: LaunchSpec, name: str) -> None:
        # callers hold self._lock
        st = self._states[launch.template.name]
        st.pending.discard(name)
        if name in st.live:
            st.live.remove(name)
        self._arrival_order.pop(name, None)

    # -- scale-in side ---------------------------------------------------
    def releasable(self) -> Optional[tuple[LaunchSpec, str]]:
        """Globally-youngest live instance above its spec's min bound (LIFO
        keeps the longest-warmed instances, which have the most policy/EWMA
        history — and never drains an old HPC allocation while a seconds-old
        cloud VM survives).  LIVE instances alone must exceed the min:
        pending acquisitions may still fail or be withdrawn, and min is a
        standing-capacity promise, not a bookkeeping one."""
        with self._lock:
            best: Optional[tuple[LaunchSpec, str]] = None
            best_seq = -1
            for st in self._states.values():
                if len(st.live) > st.launch.min_instances:
                    name = st.live[-1]
                    seq = self._arrival_order.get(name, 0)
                    if seq > best_seq:
                        best, best_seq = (st.launch, name), seq
            return best

    def abortable(self) -> Optional[tuple[LaunchSpec, str]]:
        """A pending acquisition that may be withdrawn (above min)."""
        with self._lock:
            for st in self._states.values():
                if len(st.live) + len(st.pending) > st.launch.min_instances and st.pending:
                    return (st.launch, next(iter(st.pending)))
            return None

    def counts(self) -> dict:
        with self._lock:
            return {
                name: {"live": len(st.live), "pending": len(st.pending)}
                for name, st in self._states.items()
            }

    def live_instances(self) -> list[str]:
        with self._lock:
            return [n for st in self._states.values() for n in st.live]


# ---------------------------------------------------------------------------
# The control loop
# ---------------------------------------------------------------------------


class Autoscaler:
    """Watches broker queue pressure through the Clock abstraction and
    elastically acquires/releases providers from a ProviderPool.

    Pressure := (ready-queue depth + task backlog) / (live + incoming slots).
    Hysteresis: ``warmup_ticks`` consecutive pressured ticks before an
    acquisition, ``cooldown_ticks`` consecutive idle ticks before a release —
    so a single bursty tick neither buys a VM nor kills one mid-drain.
    """

    def __init__(
        self,
        broker,
        pool: ProviderPool,
        tick_s: float = 1.0,
        scale_out_pressure: float = 1.5,
        scale_in_pressure: float = 0.05,
        warmup_ticks: int = 3,
        cooldown_ticks: int = 5,
        max_concurrent_acquisitions: int = 4,
        interactive_scale_out_pressure: Optional[float] = None,
        planner=None,
    ):
        self.broker = broker
        self.pool = pool
        # market planner (core/market.py): when attached, it picks WHICH
        # template to acquire (cheapest feasible mix instead of fastest
        # arrival) and settles per-instance spend on release/loss
        self.planner = planner
        if planner is not None:
            planner.bind(self)
        self.tick_s = tick_s
        self.scale_out_pressure = scale_out_pressure
        self.scale_in_pressure = scale_in_pressure
        # per-class scale-out (the front door's third leg): when set,
        # interactive-lane pressure ALONE can open the scale-out gate at
        # this (typically lower) threshold — so a throttled batch tenant
        # cannot mask interactive demand behind a small aggregate number,
        # and the fleet grows for the latency-sensitive class first
        self.interactive_scale_out_pressure = interactive_scale_out_pressure
        self.warmup_ticks = max(1, warmup_ticks)
        self.cooldown_ticks = max(1, cooldown_ticks)
        self.max_concurrent_acquisitions = max(1, max_concurrent_acquisitions)
        self.trace = Trace()
        self._lock = threading.Lock()
        self._timers: dict[str, ScheduledCall] = {}  # instance -> arrival timer
        self._instance_launch: dict[str, LaunchSpec] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ledger: one row per instance life cycle (exp7's cost curves)
        self.ledger: dict[str, dict] = {}
        # metrics
        self.ticks = 0
        self.acquisitions = 0
        self.arrivals = 0
        self.releases = 0
        self.aborts = 0
        self.last_pressure = 0.0
        self._hot = 0  # consecutive pressured ticks
        self._cold = 0  # consecutive idle ticks

    # -- lifecycle -------------------------------------------------------
    def _validate_pool(self) -> None:
        """Fail fast on misconfigured launch specs: a group target that does
        not exist or spans platforms would otherwise only surface as rolled
        back arrivals, one modeled latency at a time."""
        for launch in self.pool.specs:
            if launch.group is None:
                continue
            group = self.broker.proxy.get_group(launch.group)  # KeyError if absent
            if group.spec.platform != launch.template.platform:
                raise ValidationError(
                    f"launch spec {launch.template.name!r}: platform "
                    f"{launch.template.platform!r} cannot join group "
                    f"{launch.group!r} ({group.spec.platform!r})"
                )

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._validate_pool()
            self._fill_to_min()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hydra-autoscaler"
            )
            self._thread.start()
            self.trace.add("autoscaler_started")
        return self

    def stop(self, wait: bool = True) -> None:
        # join the control thread FIRST: a tick in progress could otherwise
        # start a fresh acquisition after the sweep below, leaving an
        # orphaned pending record and an armed timer behind
        self._stop.set()
        if wait and self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            timers = list(self._timers.items())
            self._timers.clear()
        for name, call in timers:  # withdraw in-flight acquisitions
            call.cancel()
            if not self.broker.abort_acquisition(name):
                continue  # already arrived (LIVE): bookkeeping must stand
            launch = self._instance_launch.pop(name, None)
            if launch is not None:
                self.pool.note_gone(launch, name)
        if self.planner is not None:
            # close the books: still-live instances accrued spend up to now
            with self._lock:
                live = list(self._instance_launch.items())
            for name, launch in live:
                row = self.ledger.get(name)
                if row is not None and row.get("arrived_at") is not None:
                    self.planner.settle(launch, name, row)
        self.trace.add("autoscaler_stopped")

    def _loop(self) -> None:
        while not get_clock().wait_event(self._stop, self.tick_s):
            try:
                self._tick()
            except Exception:
                # the loop is the pool's lifeline: a raced removal or a
                # recovery-path error must never kill the control thread
                self.trace.add("tick_error")

    # -- the decision tick ------------------------------------------------
    def _demand(self) -> float:
        """Runnable demand: ready-queue depth + backlog, minus tasks stalled
        purely on staging (core/staging.py), PLUS a decayed count of tasks
        parked at the staging gate.  A task waiting on bytes is not a task a
        new provider could run *right now* — the dispatcher parks first-time
        stage-ins outside the ready heap (so queue_depth() never sees them),
        and ``staging_stalled_in_backlog()`` subtracts the re-gated retries
        the backlog counter still holds.  But those parked tasks WILL become
        runnable the moment their transfers land, and pretending they don't
        exist made a data-heavy burst invisible: the fleet stayed cold until
        the bytes arrived, then every transfer completed into an undersized
        pool.  ``deferred_demand()`` counts each parked task as
        exp(-age/tau) — full weight when freshly parked (transfer about to
        finish soon), decaying toward zero for tasks stuck behind slow or
        broken links that no amount of compute would help.  Every input here
        is O(1) or O(parked), so the tick stays cheap at 256 providers."""
        queued = self.broker.queue_depth()
        stalled = self.broker.staging_stalled_in_backlog()
        deferred = self.broker.deferred_demand()
        return queued + max(0, self.broker.backlog() - stalled) + deferred

    def pressure(self) -> float:
        """Demand per available slot.  Zero-supply semantics (see
        Dispatcher.queue_pressure): no demand -> 0.0 regardless of supply;
        demand with zero live+incoming slots first consults probe_slots()
        (capacity a probe could still reach, e.g. half-open breakers), and
        if there is truly nothing, returns +inf — an entirely tripped fleet
        facing a deep queue is the MOST pressured state, not the least.
        The old ``demand / max(supply, 1)`` degenerated to the raw pending
        count at supply==0, which merely *scaled* with the backlog instead
        of slamming the scale-out gate."""
        demand = self._demand()
        if demand <= 0:
            return 0.0
        supply = self.broker.total_slots() + self.broker.incoming_slots()
        if supply <= 0:
            supply = self.broker.probe_slots()
        if supply <= 0:
            return float("inf")
        return demand / supply

    def interactive_pressure(self) -> float:
        """Interactive-lane depth per available slot (same zero-supply
        semantics as pressure()).  Only meaningful with the multi-tenant
        front door attached; 0.0 otherwise."""
        depth = self.broker.queue_depth_by_class().get("interactive", 0)
        if depth <= 0:
            return 0.0
        supply = self.broker.total_slots() + self.broker.incoming_slots()
        if supply <= 0:
            supply = self.broker.probe_slots()
        if supply <= 0:
            return float("inf")
        return depth / supply

    def _tick(self) -> None:
        self.ticks += 1
        p = self.pressure()
        self.last_pressure = p
        self.broker.events.emit(
            "scale.tick", pressure=p if math.isfinite(p) else None
        )
        if self.planner is not None:
            # the bid loop: re-rank the platform mix every tick so price or
            # hazard movement re-routes the NEXT acquisition immediately
            self.planner.replan(self._demand())
        if self.interactive_scale_out_pressure is not None and p < self.scale_out_pressure:
            # the per-class gate: interactive depth alone can force the
            # scale-out path even when aggregate pressure looks tame
            if self.interactive_pressure() >= self.interactive_scale_out_pressure:
                p = self.scale_out_pressure
        if p >= self.scale_out_pressure:
            self._hot += 1
            self._cold = 0
            if self._hot >= self.warmup_ticks:
                self._scale_out()
                self._hot = 0
        elif p <= self.scale_in_pressure:
            self._cold += 1
            self._hot = 0
            if self._cold >= self.cooldown_ticks:
                self._scale_in()
                self._cold = 0
        else:
            self._hot = 0
            self._cold = 0
        self._fill_to_min()

    def _scale_out(self) -> None:
        """Acquire enough instances to absorb the current deficit, bounded
        by per-spec max and the concurrent-acquisition cap.  candidates()
        re-ranks each round, so the fastest-arriving platform with headroom
        keeps winning until the deficit is covered."""
        deficit = self._demand() - (
            self.broker.total_slots() + self.broker.incoming_slots()
        )
        while (
            deficit > 0
            and not self._stop.is_set()
            and len(self.broker.pending_acquisitions()) < self.max_concurrent_acquisitions
        ):
            candidates = self.pool.candidates()
            if not candidates:
                return
            if self.planner is not None:
                launch = self.planner.choose(candidates, deficit)
                if launch is None:  # nothing feasible under the SLO budget
                    return
            else:
                launch = candidates[0]
            self._acquire(launch)
            deficit -= launch.slots_per_instance

    def _scale_in(self) -> None:
        """Withdraw a not-yet-arrived acquisition first (free), else drain
        and release the youngest live instance above its min bound."""
        pending = self.pool.abortable()
        if pending is not None:
            launch, name = pending
            self._abort(launch, name)
            return
        live = self.pool.releasable()
        if live is not None:
            launch, name = live
            self._release(launch, name)

    # -- acquisition -------------------------------------------------------
    def _fill_to_min(self) -> None:
        for launch in self.pool.below_min():
            st_min = launch.min_instances
            while not self._stop.is_set():
                counts = self.pool.counts()[launch.template.name]
                if counts["live"] + counts["pending"] >= st_min:
                    break
                self._acquire(launch)

    def _acquire(self, launch: LaunchSpec) -> str:
        clock = get_clock()
        eta = launch.latency.sample(self.pool.rng)
        spec = self.pool.request_instance(launch)
        self.broker.begin_acquisition(spec, eta, group=launch.group)
        with self._lock:
            self._instance_launch[spec.name] = launch
            self.ledger[spec.name] = {
                "platform": spec.platform,
                "requested_at": clock.now(),
                "eta_s": eta,
                "arrived_at": None,
                "released_at": None,
            }
        self.acquisitions += 1
        self.broker.events.emit(
            "acquire.begin", instance=spec.name, platform=spec.platform
        )
        self.trace.add(f"acquire:{spec.name}:eta={eta:.1f}")
        call = clock.call_later(eta, lambda: self._arrive(launch, spec))
        with self._lock:
            if spec.name not in self._instance_launch:  # stopped mid-register
                call.cancel()
            elif call.active:
                # an already-fired call (eta ~0, or the clock jumped inside
                # call_later) must NOT be kept: stop()'s sweep would misread
                # the LIVE instance as a withdrawable pending acquisition
                self._timers[spec.name] = call
        return spec.name

    def _arrive(self, launch: LaunchSpec, spec: ProviderSpec) -> None:
        """Acquisition latency elapsed (runs on a clock thread)."""
        with self._lock:
            self._timers.pop(spec.name, None)
        try:
            handle = self.broker.complete_acquisition(spec)
        except Exception:
            self.trace.add(f"acquire_failed:{spec.name}")
            self.pool.note_failed(launch, spec.name)  # counts toward quarantine
            self.broker.abort_acquisition(spec.name)
            return
        if handle is None:  # aborted while the timer was in flight
            self.pool.note_gone(launch, spec.name)
            return
        self.pool.note_live(launch, spec.name)
        with self._lock:
            row = self.ledger.get(spec.name)
            if row is not None:
                row["arrived_at"] = get_clock().now()
        self.arrivals += 1
        self.broker.events.emit("acquire.complete", instance=spec.name)
        self.trace.add(f"arrived:{spec.name}")
        # new capacity: wake the dispatcher so backfill sees it NOW
        self.broker._notify_capacity()

    def note_provider_lost(self, name: str) -> None:
        """The broker blacklisted one of our instances (hard outage,
        Hydra._handle_provider_down).  Without this hook the dead name would
        occupy max_instances headroom forever and broken capacity could
        never be replaced under pressure.  Grouped members are NOT routed
        here: their breaker may half-open and recover."""
        with self._lock:
            launch = self._instance_launch.pop(name, None)
            call = self._timers.pop(name, None)
            row = self.ledger.get(name)
            if row is not None and row["released_at"] is None:
                row["released_at"] = get_clock().now()
        if launch is None:
            return
        if call is not None:
            call.cancel()
        self.broker.abort_acquisition(name)
        self.pool.note_gone(launch, name)
        if self.planner is not None and row is not None:
            self.planner.settle(launch, name, row)
        self.trace.add(f"lost:{name}")

    # -- release -----------------------------------------------------------
    def _abort(self, launch: LaunchSpec, name: str) -> None:
        with self._lock:
            call = self._timers.get(name)
        if call is not None:
            call.cancel()
        if not self.broker.abort_acquisition(name):
            return  # lost the race to _arrive: the instance is LIVE, keep it
        with self._lock:
            self._timers.pop(name, None)
            self._instance_launch.pop(name, None)
        self.aborts += 1
        self.broker.events.emit("acquire.abort", instance=name)
        self.trace.add(f"abort:{name}")
        self.pool.note_gone(launch, name)

    def _release(self, launch: LaunchSpec, name: str) -> None:
        """Scale-in through the drain path: unfinished tasks re-bind to the
        surviving pool before the manager shuts down."""
        with self._lock:
            self._instance_launch.pop(name, None)
        self.trace.add(f"release:{name}")
        try:
            self.broker.remove_provider(name, drain=True, deregister=True)
        except KeyError:
            pass  # raced with an outage-path removal: already gone
        self.pool.note_gone(launch, name)
        with self._lock:
            row = self.ledger.get(name)
            if row is not None:
                row["released_at"] = get_clock().now()
        if self.planner is not None and row is not None:
            self.planner.settle(launch, name, row)
        self.releases += 1
        self.broker.events.emit("scale.release", instance=name)

    # -- metrics -----------------------------------------------------------
    def node_seconds(self, until: Optional[float] = None) -> float:
        """Total provider-seconds held (the cost side of exp7's
        over-provisioning-vs-queue-wait curve)."""
        end = until if until is not None else get_clock().now()
        total = 0.0
        with self._lock:
            rows = list(self.ledger.values())
        for row in rows:
            if row["arrived_at"] is None:
                continue
            total += max(0.0, (row["released_at"] or end) - row["arrived_at"])
        return total

    def stats(self) -> dict:
        """Dict-shaped adapter: the decision counters are the log-derived
        view over scale.*/acquire.* events (core/events.py); the legacy
        accumulators stay as HYDRA_EVENTS_CHECK ground truth.  Pressure
        and pool state are live gauges."""
        view = self.broker.events.view
        return {
            "ticks": int(view.get("hydra.scale.ticks")),
            "acquisitions": int(view.get("hydra.scale.acquisitions")),
            "arrivals": int(view.get("hydra.scale.arrivals")),
            "releases": int(view.get("hydra.scale.releases")),
            "aborts": int(view.get("hydra.scale.aborts")),
            # JSON-safe: the +inf zero-supply sentinel serializes as null
            "last_pressure": (
                round(self.last_pressure, 3)
                if math.isfinite(self.last_pressure)
                else None
            ),
            "staging_stalled": self.broker.staging_stalled(),
            "deferred_demand": round(self.broker.deferred_demand(), 3),
            "hot_ticks": self._hot,
            "cold_ticks": self._cold,
            "pool": self.pool.counts(),
        }
