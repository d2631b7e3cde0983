"""Data-aware staging subsystem (paper §3.1: data operations are first-class).

Cross-platform staging is a dominant cost when workloads span commercial
cloud, science cloud, and HPC: StreamFlow showed locality-aware placement
across hybrid topologies materially changes makespan, and the hybrid-cloud
literature identifies *data gravity* as the main coupling constraint between
cloud and HPC tiers.  This module makes those dynamics reproducible:

  DatasetRegistry   named, sized artifacts with per-site replica tracking
                    and capacity-bounded LRU eviction (a replica is never
                    evicted if it is pinned or the dataset's last copy).
  TransferEngine    per-platform-pair bandwidth/latency models (seeded
                    distributions, like the autoscaler's LatencyModel),
                    driven entirely by ``Clock.call_later`` so a run is
                    deterministic under VirtualClock.  Each directed
                    site-pair link has a concurrency limit; excess transfers
                    queue FIFO.  In-flight transfers de-duplicate (a second
                    request for the same (dataset, destination) piggybacks),
                    and a source-site death re-routes the transfer to a
                    surviving replica instead of failing it.  A cold read is
                    priced with the backlog queued on its link (``wait_s``),
                    both when a source is picked and when a policy asks what
                    a site costs: without it every task reading into a site
                    whose one cheap link is hundreds of seconds deep is
                    charged the idle link's time, and placement piles onto
                    that queue (the reference prices the idle link only).
  StagingService    the broker-facing facade: per-task stage-in barriers
                    (``stage_task``), data-gravity scoring for the binding
                    policies (``transfer_cost_s``), stage-out on completion
                    (``task_completed``), and ``stats()``.

Sites are *bind-target* names: every registered provider is a site, every
provider group is one logical site (its members share a group-local store,
the way the paper's platforms share a filesystem), and ``shared`` is the
cross-site object store the DataManager already models.  Replica reads are
free; cold reads are charged the modeled transfer time — which is exactly
the asymmetry the data-gravity policy (core/policy.py) folds into placement.
"""
from __future__ import annotations

import math
import random
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from repro_torch.runtime.clock import ScheduledCall, get_clock
from repro_torch.runtime.tracing import Counter, Trace

SHARED_SITE = "shared"

_DEFAULT_CAP = object()  # sentinel: "use the registry's default capacity"


class StagingError(RuntimeError):
    pass


class UnknownDataset(StagingError):
    pass


class UnknownSite(StagingError):
    pass


class DatasetLost(StagingError):
    """Every replica of a dataset is gone: no source to transfer from."""


# ---------------------------------------------------------------------------
# Dataset registry: replicas + capacity-bounded LRU eviction
# ---------------------------------------------------------------------------


@dataclass
class Dataset:
    """A named, sized artifact.  ``pinned`` replicas are never evicted
    (source data that exists outside the brokered fleet)."""

    name: str
    size_mb: float
    pinned: bool = False


@dataclass
class _Site:
    name: str
    platform: str
    capacity_mb: Optional[float] = None  # None = unbounded
    replicas: dict = field(default_factory=dict)  # dataset name -> lru tick
    used_mb: float = 0.0


class DatasetRegistry:
    """Which dataset lives where, with per-site capacity + LRU eviction.

    The LRU clock is a logical counter (not wall time), so eviction order is
    identical under WallClock and VirtualClock and across reruns."""

    def __init__(self, default_capacity_mb: Optional[float] = None):
        self.default_capacity_mb = default_capacity_mb
        self._datasets: dict[str, Dataset] = {}
        self._sites: dict[str, _Site] = {}
        self._tick = 0
        self._lock = threading.RLock()
        self.evictions = 0
        self._events = None  # broker-owned EventBus (StagingService.attach_events)
        self.register_site(SHARED_SITE, platform=SHARED_SITE, capacity_mb=None)

    # -- sites ---------------------------------------------------------
    def register_site(
        self,
        name: str,
        platform: str = "cloud",
        capacity_mb=_DEFAULT_CAP,
    ) -> None:
        if capacity_mb is _DEFAULT_CAP:
            capacity_mb = self.default_capacity_mb
        with self._lock:
            if name not in self._sites:
                self._sites[name] = _Site(name, platform, capacity_mb)

    def platform_of(self, site: str) -> str:
        with self._lock:
            s = self._sites.get(site)
            if s is None:
                raise UnknownSite(f"unknown staging site {site!r}")
            return s.platform

    def used_mb(self, site: str) -> float:
        with self._lock:
            s = self._sites.get(site)
            return 0.0 if s is None else s.used_mb

    # -- datasets ------------------------------------------------------
    def add(
        self,
        name: str,
        size_mb: float,
        sites: Iterable[str] = (),
        pinned: bool = False,
    ) -> Dataset:
        """Declare (or re-declare) a dataset; optionally place replicas."""
        with self._lock:
            ds = self._datasets.get(name)
            if ds is None:
                ds = Dataset(name, float(size_mb), pinned)
                self._datasets[name] = ds
            else:  # re-generated output (retry): the new size is authoritative
                delta = float(size_mb) - ds.size_mb
                if delta:
                    # resize existing replicas in place, or a later drop/evict
                    # would subtract the NEW size from accounting done at the
                    # OLD size and corrupt every capacity check at the site
                    for s in self._sites.values():
                        if name in s.replicas:
                            s.used_mb += delta
                ds.size_mb = float(size_mb)
                ds.pinned = ds.pinned or pinned
        for site in sites:
            self.place_replica(name, site)
        return ds

    def get(self, name: str) -> Dataset:
        with self._lock:
            ds = self._datasets.get(name)
            if ds is None:
                raise UnknownDataset(f"unknown dataset {name!r}")
            return ds

    def known(self, name: str) -> bool:
        with self._lock:
            return name in self._datasets

    def locate(self, name: str) -> list[str]:
        with self._lock:
            return sorted(
                s.name for s in self._sites.values() if name in s.replicas
            )

    def resident(self, name: str, site: str) -> bool:
        with self._lock:
            s = self._sites.get(site)
            return s is not None and name in s.replicas

    def touch(self, name: str, site: str) -> None:
        """Mark a replica recently used (a read keeps hot data resident)."""
        with self._lock:
            s = self._sites.get(site)
            if s is not None and name in s.replicas:
                self._tick += 1
                s.replicas[name] = self._tick

    # -- placement / eviction ------------------------------------------
    def place_replica(self, name: str, site: str) -> list[str]:
        """Add a replica at ``site``, LRU-evicting colder replicas if the
        site is over capacity.  Never evicts a pinned replica or a dataset's
        last copy; raises StagingError if the dataset cannot fit even after
        evicting everything evictable."""
        with self._lock:
            ds = self.get(name)
            s = self._sites.get(site)
            if s is None:
                raise UnknownSite(f"unknown staging site {site!r}")
            if name in s.replicas:
                self._tick += 1
                s.replicas[name] = self._tick
                return []
            evicted: list[str] = []
            if s.capacity_mb is not None and ds.size_mb > s.capacity_mb:
                raise StagingError(
                    f"dataset {name!r} ({ds.size_mb} MB) exceeds site "
                    f"{site!r} capacity ({s.capacity_mb} MB)"
                )
            if s.capacity_mb is not None:
                while s.used_mb + ds.size_mb > s.capacity_mb:
                    victim = self._lru_victim(s)
                    if victim is None:
                        raise StagingError(
                            f"site {site!r} cannot fit {name!r}: "
                            f"{s.used_mb:.0f}/{s.capacity_mb:.0f} MB held by "
                            "pinned or last-copy replicas"
                        )
                    del s.replicas[victim]
                    s.used_mb -= self._datasets[victim].size_mb
                    self.evictions += 1
                    if self._events is not None:
                        self._events.emit("replica.evict", dataset=victim, site=site)
                    evicted.append(victim)
            self._tick += 1
            s.replicas[name] = self._tick
            s.used_mb += ds.size_mb
            return evicted

    def _lru_victim(self, s: _Site) -> Optional[str]:
        # callers hold self._lock
        best, best_tick = None, None
        for name, tick in s.replicas.items():
            ds = self._datasets[name]
            if ds.pinned:
                continue
            if len(self.locate(name)) <= 1:  # last copy: data loss, never
                continue
            if best_tick is None or tick < best_tick:
                best, best_tick = name, tick
        return best

    def drop_replica(self, name: str, site: str) -> None:
        with self._lock:
            s = self._sites.get(site)
            if s is not None and name in s.replicas:
                del s.replicas[name]
                s.used_mb -= self._datasets[name].size_mb

    def drop_site(self, site: str) -> list[str]:
        """A site died: every replica it held is gone.  Returns the datasets
        that lost their LAST replica (now unreachable anywhere)."""
        with self._lock:
            s = self._sites.pop(site, None)
            if s is None:
                return []
            lost = [n for n in s.replicas if not self.locate(n)]
            return lost

    def replicas_at(self, site: str) -> list[str]:
        with self._lock:
            s = self._sites.get(site)
            return sorted(s.replicas) if s is not None else []

    # -- byte accounting for placement ---------------------------------
    def missing(self, names: Iterable[str], site: str) -> list[str]:
        with self._lock:
            s = self._sites.get(site)
            have = s.replicas if s is not None else {}
            return [n for n in names if n not in have]

    def missing_mb(self, names: Iterable[str], site: str) -> float:
        with self._lock:
            return sum(self.get(n).size_mb for n in self.missing(names, site))

    def resident_mb(self, names: Iterable[str], site: str) -> float:
        with self._lock:
            s = self._sites.get(site)
            if s is None:
                return 0.0
            return sum(
                self.get(n).size_mb for n in names if n in s.replicas
            )


# ---------------------------------------------------------------------------
# Link models: per-platform-pair bandwidth/latency distributions
# ---------------------------------------------------------------------------


@dataclass
class LinkModel:
    """One directed platform-pair link.  Bandwidth is lognormal around
    ``bandwidth_mbps`` (sigma = ``jitter``), mirroring the autoscaler's
    LatencyModel parameterization: the mean is preserved when jitter moves."""

    bandwidth_mbps: float = 100.0  # MB/s
    latency_s: float = 0.05
    jitter: float = 0.15  # lognormal sigma; 0 = fixed bandwidth

    def sample_duration_s(self, rng: random.Random, size_mb: float) -> float:
        bw = self.bandwidth_mbps
        if self.jitter > 0:
            mu = math.log(max(bw, 1e-9)) - self.jitter**2 / 2.0
            bw = rng.lognormvariate(mu, self.jitter)
        return self.latency_s + size_mb / max(bw, 1e-6)

    def expected_s(self, size_mb: float) -> float:
        return self.latency_s + size_mb / max(self.bandwidth_mbps, 1e-6)


# Paper-shaped defaults (Table 1 platforms): intra-cloud links are fast,
# cloud<->HPC crossings are the narrow waist, the shared object store sits
# between, and HPC<->HPC rides the science DTN backbone.
DEFAULT_LINKS: dict[tuple[str, str], LinkModel] = {
    ("cloud", "cloud"): LinkModel(bandwidth_mbps=120.0, latency_s=0.05),
    ("cloud", "hpc"): LinkModel(bandwidth_mbps=40.0, latency_s=0.2),
    ("hpc", "cloud"): LinkModel(bandwidth_mbps=40.0, latency_s=0.2),
    ("hpc", "hpc"): LinkModel(bandwidth_mbps=200.0, latency_s=0.1),
    ("cloud", SHARED_SITE): LinkModel(bandwidth_mbps=100.0, latency_s=0.05),
    (SHARED_SITE, "cloud"): LinkModel(bandwidth_mbps=100.0, latency_s=0.05),
    ("hpc", SHARED_SITE): LinkModel(bandwidth_mbps=60.0, latency_s=0.1),
    (SHARED_SITE, "hpc"): LinkModel(bandwidth_mbps=60.0, latency_s=0.1),
}
FALLBACK_LINK = LinkModel(bandwidth_mbps=80.0, latency_s=0.1)


# ---------------------------------------------------------------------------
# Transfer engine: clock-driven, link-limited, re-routable
# ---------------------------------------------------------------------------

_transfer_ids = Counter("xfer")

QUEUED, ACTIVE, DONE, FAILED = "QUEUED", "ACTIVE", "DONE", "FAILED"


class Transfer:
    def __init__(self, dataset: str, size_mb: float, src: str, dst: str):
        self.uid = _transfer_ids.next()
        self.dataset = dataset
        self.size_mb = size_mb
        self.src = src
        self.dst = dst
        self.state = QUEUED
        self.queued_at = get_clock().now()
        self.started_at: Optional[float] = None
        self.eta: Optional[float] = None  # modeled completion once ACTIVE
        self.done_at: Optional[float] = None
        self.reroutes = 0
        # bumped on every (re)start: a completion timer that fired for an
        # earlier start (and lost the lock race to a site_down re-route)
        # must not complete the restarted transfer at the stale deadline
        self.epoch = 0
        self.waiters: list[Callable[[bool], None]] = []
        self.call: Optional[ScheduledCall] = None

    @property
    def link(self) -> tuple[str, str]:
        return (self.src, self.dst)


class TransferEngine:
    """Executes dataset transfers on the active Clock.

    Every wait is a ``Clock.call_later`` deadline, so under a VirtualClock
    the auto-advancer jumps straight to transfer completions and a whole
    staging-heavy run takes real milliseconds.  Durations are sampled from
    one seeded RNG in start order: identical request sequences with the same
    seed produce an identical transfer schedule."""

    def __init__(
        self,
        registry: DatasetRegistry,
        seed: int = 0,
        links: Optional[dict[tuple[str, str], LinkModel]] = None,
        max_per_link: int = 2,
    ):
        self.registry = registry
        self.rng = random.Random(seed)
        self.links = dict(DEFAULT_LINKS)
        if links:
            self.links.update(links)
        self.max_per_link = max(1, max_per_link)
        self.trace = Trace()
        self._lock = threading.RLock()
        self._active: dict[tuple[str, str], list[Transfer]] = {}
        self._queued: dict[tuple[str, str], deque] = {}
        self._queued_mb: dict[tuple[str, str], float] = {}  # bytes behind each link
        self._inflight: dict[tuple[str, str], Transfer] = {}  # (ds, dst)
        self.log: list[dict] = []  # completed-transfer schedule (determinism tests)
        # stats
        self.mb_moved = 0.0
        self.cache_hits = 0
        self.cold_reads = 0
        self.completed = 0
        self.failures = 0
        self.reroutes = 0
        self.queue_wait_s = 0.0
        self._events = None  # broker-owned EventBus (StagingService.attach_events)

    def _emit(self, name: str, **attrs) -> None:
        # callers hold self._lock, keeping each legacy increment and its
        # event adjacent so float folds match the accumulators bit-for-bit
        if self._events is not None:
            self._events.emit(name, **attrs)

    # -- link lookup ---------------------------------------------------
    def link_model(self, src_site: str, dst_site: str) -> LinkModel:
        key = (self.registry.platform_of(src_site), self.registry.platform_of(dst_site))
        return self.links.get(key, FALLBACK_LINK)

    def expected_transfer_s(self, name: str, dst: str) -> float:
        """Cheapest modeled time to materialize ``name`` at ``dst`` (0 if
        already resident): the cold-read charge gravity-aware policies use,
        the link's queued backlog included.  A read that would piggyback on
        an in-flight transfer costs what that transfer has left."""
        if self.registry.resident(name, dst):
            return 0.0
        with self._lock:
            tr = self._inflight.get((name, dst))
            if tr is not None:
                if tr.state == ACTIVE:
                    return max(0.0, tr.eta - get_clock().now())
                return self.wait_s(tr.src, dst) + self.link_model(tr.src, dst).expected_s(tr.size_mb)
            src, cost = self._best_source_cost(name, dst)
        return float("inf") if src is None else cost

    def wait_s(self, src: str, dst: str) -> float:
        """Modeled seconds a transfer queued now on the ``src -> dst`` link
        waits for a slot: the work left on the link's active transfers plus
        the expected time of those queued behind them, shared by its slots."""
        with self._lock:
            link = (src, dst)
            active = self._active.get(link)
            if not active or len(active) < self.max_per_link:
                return 0.0
            now = get_clock().now()
            model = self.link_model(src, dst)
            work = sum(max(0.0, tr.eta - now) for tr in active)
            queue = self._queued.get(link)
            if queue:
                work += len(queue) * model.latency_s
                work += self._queued_mb.get(link, 0.0) / max(model.bandwidth_mbps, 1e-6)
            return work / self.max_per_link

    def _best_source_cost(self, name: str, dst: str) -> tuple[Optional[str], float]:
        # callers hold self._lock
        ds = self.registry.get(name)
        best, best_cost = None, float("inf")
        for site in self.registry.locate(name):
            if site == dst:
                return site, 0.0
            cost = self.wait_s(site, dst) + self.link_model(site, dst).expected_s(ds.size_mb)
            if best is None or cost < best_cost:
                best, best_cost = site, cost
        return best, best_cost

    def _best_source(self, name: str, dst: str) -> Optional[str]:
        # callers hold self._lock
        return self._best_source_cost(name, dst)[0]

    def _push_queued(self, tr: Transfer) -> None:
        # callers hold self._lock
        self._queued.setdefault(tr.link, deque()).append(tr)
        self._queued_mb[tr.link] = self._queued_mb.get(tr.link, 0.0) + tr.size_mb

    def _pop_queued(self, link: tuple[str, str], tr: Optional[Transfer] = None) -> Transfer:
        # callers hold self._lock: the head of the link's queue, or ``tr``
        queue = self._queued[link]
        if tr is None:
            tr = queue.popleft()
        else:
            queue.remove(tr)
        left = self._queued_mb[link] - tr.size_mb
        self._queued_mb[link] = left if queue else 0.0
        return tr

    def note_hit(self, name: str, site: str) -> None:
        """Replica-hit accounting (the counter is shared with fetch()'s
        transfer threads, so the increment must take the engine lock)."""
        with self._lock:
            self.cache_hits += 1
            self._emit("transfer.hit", dataset=name, site=site)
        self.registry.touch(name, site)

    # -- the fetch API -------------------------------------------------
    def fetch(self, name: str, dst: str, on_done: Callable[[bool], None]) -> None:
        """Materialize dataset ``name`` at site ``dst``; ``on_done(ok)``
        fires when it is resident (immediately on a replica hit) or when the
        transfer is abandoned (dataset lost everywhere)."""
        fire: Optional[bool] = None
        with self._lock:
            if self.registry.resident(name, dst):
                self.cache_hits += 1
                self._emit("transfer.hit", dataset=name, site=dst)
                self.registry.touch(name, dst)
                fire = True
            elif not self.registry.known(name):
                # an input that was never declared (typo, or a producer that
                # never registered its output): a failure the CALLER must
                # surface on the task — never an exception that could unwind
                # the dispatcher loop mid-batch
                self.failures += 1
                self._emit("transfer.fail", dataset=name, dst=dst)
                fire = False
            else:
                inflight = self._inflight.get((name, dst))
                if inflight is not None:
                    inflight.waiters.append(on_done)
                else:
                    ds = self.registry.get(name)
                    src = self._best_source(name, dst)
                    if src is None:
                        self.failures += 1
                        self._emit("transfer.fail", dataset=name, dst=dst)
                        fire = False
                    else:
                        self.cold_reads += 1
                        self._emit("transfer.cold", dataset=name, dst=dst)
                        tr = Transfer(name, ds.size_mb, src, dst)
                        tr.waiters.append(on_done)
                        self._inflight[(name, dst)] = tr
                        self._enqueue(tr)
        if fire is not None:
            on_done(fire)

    def _enqueue(self, tr: Transfer) -> None:
        # callers hold self._lock
        active = self._active.setdefault(tr.link, [])
        if len(active) < self.max_per_link:
            self._start(tr)
        else:
            self._push_queued(tr)

    def _start(self, tr: Transfer) -> None:
        # callers hold self._lock; sampling order == start order (seeded)
        clock = get_clock()
        duration = self.link_model(tr.src, tr.dst).sample_duration_s(
            self.rng, tr.size_mb
        )
        tr.state = ACTIVE
        tr.started_at = clock.now()
        tr.eta = tr.started_at + duration
        tr.epoch += 1
        epoch = tr.epoch
        self.queue_wait_s += max(0.0, tr.started_at - tr.queued_at)
        self._emit(
            "transfer.start",
            dataset=tr.dataset,
            src=tr.src,
            dst=tr.dst,
            wait_s=max(0.0, tr.started_at - tr.queued_at),
        )
        self._active.setdefault(tr.link, []).append(tr)
        self.trace.add(f"start:{tr.dataset}:{tr.src}->{tr.dst}:{duration:.3f}s")
        tr.call = clock.call_later(duration, lambda: self._complete(tr, epoch))

    def _complete(self, tr: Transfer, epoch: int) -> None:
        """Transfer deadline elapsed (runs on a clock thread)."""
        waiters: list[Callable[[bool], None]] = []
        ok = True
        with self._lock:
            # state check alone is not enough: a timer that already _fire()d
            # (cancel() came too late) can block on this lock while site_down
            # re-routes and RESTARTS the transfer — the epoch pins this
            # completion to the start that scheduled it
            if tr.state != ACTIVE or tr.epoch != epoch:
                return
            self._detach(tr)
            tr.state = DONE
            tr.done_at = get_clock().now()
            try:
                self.registry.place_replica(tr.dataset, tr.dst)
            except StagingError:
                # destination vanished or cannot fit even after eviction
                tr.state = FAILED
                self.failures += 1
                self._emit("transfer.fail", dataset=tr.dataset, dst=tr.dst)
                ok = False
            else:
                self.mb_moved += tr.size_mb
                self.completed += 1
                self._emit(
                    "transfer.done",
                    dataset=tr.dataset,
                    src=tr.src,
                    dst=tr.dst,
                    mb=tr.size_mb,
                )
                self.log.append(
                    {
                        "dataset": tr.dataset,
                        "src": tr.src,
                        "dst": tr.dst,
                        "mb": tr.size_mb,
                        "t": tr.done_at,
                    }
                )
            self._inflight.pop((tr.dataset, tr.dst), None)
            waiters, tr.waiters = tr.waiters, []
            self.trace.add(f"done:{tr.dataset}:{tr.src}->{tr.dst}")
        for cb in waiters:
            cb(ok)

    def _detach(self, tr: Transfer) -> None:
        # callers hold self._lock: remove from active, start next queued
        active = self._active.get(tr.link, [])
        if tr in active:
            active.remove(tr)
        queue = self._queued.get(tr.link)
        while queue and len(active) < self.max_per_link:
            self._start(self._pop_queued(tr.link))

    # -- fault handling ------------------------------------------------
    def site_down(self, site: str) -> list[str]:
        """A site died.  Its replicas are dropped; transfers sourced from it
        re-route to a surviving replica (full restart — partial transfers
        are not resumable across sources); transfers *to* it fail their
        waiters so the owning task can re-gate to a new placement.  Returns
        datasets that lost their last replica."""
        failed: list[Transfer] = []
        with self._lock:
            lost = self.registry.drop_site(site)
            affected = [
                tr
                for trs in list(self._active.values())
                for tr in trs
                if tr.src == site or tr.dst == site
            ]
            for queue in self._queued.values():
                affected.extend(
                    tr for tr in list(queue) if tr.src == site or tr.dst == site
                )
            for tr in affected:
                if tr.call is not None:
                    tr.call.cancel()
                tr.state = QUEUED
                active = self._active.get(tr.link, [])
                if tr in active:
                    active.remove(tr)
                queue = self._queued.get(tr.link)
                if queue and tr in queue:
                    self._pop_queued(tr.link, tr)
                if tr.dst == site or tr.dataset in lost:
                    tr.state = FAILED
                    self.failures += 1
                    self._emit("transfer.fail", dataset=tr.dataset, dst=tr.dst)
                    self._inflight.pop((tr.dataset, tr.dst), None)
                    failed.append(tr)
                    continue
                # source died mid-flight: restart from the next-best replica
                new_src = self._best_source(tr.dataset, tr.dst)
                if new_src is None:
                    tr.state = FAILED
                    self.failures += 1
                    self._emit("transfer.fail", dataset=tr.dataset, dst=tr.dst)
                    self._inflight.pop((tr.dataset, tr.dst), None)
                    failed.append(tr)
                    continue
                tr.src = new_src
                tr.reroutes += 1
                self.reroutes += 1
                self._emit(
                    "transfer.reroute", dataset=tr.dataset, src=new_src, dst=tr.dst
                )
                # a restart queues anew: without this, the next _start would
                # re-count the original queue wait PLUS the whole aborted
                # active period as queue wait
                tr.queued_at = get_clock().now()
                self.trace.add(f"reroute:{tr.dataset}:{new_src}->{tr.dst}")
                self._enqueue(tr)
            # freed link slots: pull whatever queued behind the dead site
            for link, active in list(self._active.items()):
                queue = self._queued.get(link)
                while queue and len(active) < self.max_per_link:
                    self._start(self._pop_queued(link))
        for tr in failed:
            waiters, tr.waiters = tr.waiters, []
            for cb in waiters:
                cb(False)
        return lost

    def link_override(self, key: tuple[str, str], model: LinkModel) -> LinkModel:
        """Swap the LinkModel for one directed platform pair (chaos windows:
        degradation / partition).  Returns the model previously in effect so
        the caller can restore it when the window closes."""
        with self._lock:
            prev = self.links.get(key, FALLBACK_LINK)
            self.links[key] = model
            return prev

    def resample_link(self, key: tuple[str, str]) -> int:
        """Re-plan every ACTIVE transfer riding the platform pair ``key``:
        cancel its completion deadline and restart it so the duration is
        re-sampled under the CURRENT link model.  Like a site_down re-route,
        a restart is from scratch (partial progress is not resumable across
        a link renegotiation) and queues anew for its link slot.  The epoch
        bump in _start invalidates any stale completion timer that already
        fired and is waiting on the lock.  Returns the restart count."""
        with self._lock:
            affected = []
            for trs in list(self._active.values()):
                for tr in trs:
                    try:
                        k = (
                            self.registry.platform_of(tr.src),
                            self.registry.platform_of(tr.dst),
                        )
                    except UnknownSite:
                        continue  # endpoint died concurrently: site_down owns it
                    if k == key:
                        affected.append(tr)
            for tr in affected:
                if tr.call is not None:
                    tr.call.cancel()
                active = self._active.get(tr.link, [])
                if tr in active:
                    active.remove(tr)
                tr.state = QUEUED
                tr.queued_at = get_clock().now()
                self.trace.add(f"resample:{tr.dataset}:{tr.src}->{tr.dst}")
                self._enqueue(tr)
            return len(affected)

    def active_transfers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._active.values())

    def queued_transfers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._queued.values())

    def shutdown(self) -> None:
        """Cancel everything in flight and FAIL its waiters: a waiter left
        unfired would strand its task in the dispatcher's blocked set (and
        its Future unresolved) forever."""
        waiters: list[Callable[[bool], None]] = []
        with self._lock:
            pending = [tr for trs in self._active.values() for tr in trs]
            pending += [tr for q in self._queued.values() for tr in q]
            for tr in pending:
                if tr.call is not None:
                    tr.call.cancel()
                tr.state = FAILED
                w, tr.waiters = tr.waiters, []
                waiters.extend(w)
            self._active.clear()
            self._queued.clear()
            self._queued_mb.clear()
            self._inflight.clear()
        for cb in waiters:
            cb(False)


# ---------------------------------------------------------------------------
# StagingService: the broker-facing facade
# ---------------------------------------------------------------------------


class StagingService:
    """Registry + engine + per-task stage-in barriers + stage-out.

    One per broker.  The streaming dispatcher calls ``stage_task`` before
    dispatching a task whose declared inputs are missing at its placement
    site; binding policies call ``transfer_cost_s`` to fold data locality
    into placement; the broker calls ``task_completed`` to register outputs
    (stage-out) and ``site_down`` when a provider dies."""

    def __init__(
        self,
        seed: int = 0,
        default_capacity_mb: Optional[float] = None,
        links: Optional[dict[tuple[str, str], LinkModel]] = None,
        max_per_link: int = 2,
        mirror_outputs: bool = False,
    ):
        self.registry = DatasetRegistry(default_capacity_mb=default_capacity_mb)
        self.engine = TransferEngine(
            self.registry, seed=seed, links=links, max_per_link=max_per_link
        )
        # write-through stage-out: every declared output also lands a replica
        # in the shared object store, so a later WHOLE-SITE outage (chaos)
        # cannot take an intermediate dataset's last copy with it.  Like the
        # drain path's evacuate(), the copy is not time-modeled; the bytes
        # are reported separately (``mirrored_mb``).
        self.mirror_outputs = mirror_outputs
        self._lock = threading.Lock()
        self.stage_ins = 0
        self.stage_outs = 0
        self.stage_out_drops = 0  # outputs that could not fit their site
        self.evacuated_mb = 0.0  # last-copy bytes saved by graceful drains
        self.mirrored_mb = 0.0  # write-through stage-out copies (chaos durability)
        self.transfer_wait_s = 0.0  # total task-observed stage-in wait
        self._events = None  # broker-owned EventBus (attach_events)

    def attach_events(self, bus) -> None:
        """Wire the broker's event bus through the whole staging stack:
        service-level stage-in/out accounting, engine transfer lifecycle,
        and registry evictions all become structured events
        (core/events.py), with every emission adjacent to its legacy
        counter so HYDRA_EVENTS_CHECK can hold them bit-equal."""
        self._events = bus
        self.engine._events = bus
        self.registry._events = bus

    def _emit(self, name: str, **attrs) -> None:
        # callers hold self._lock (same adjacency rule as the engine's)
        if self._events is not None:
            self._events.emit(name, **attrs)

    # -- site lifecycle ------------------------------------------------
    def register_site(
        self, name: str, platform: str = "cloud", capacity_mb=_DEFAULT_CAP
    ) -> None:
        self.registry.register_site(name, platform, capacity_mb)

    def site_down(self, name: str) -> list[str]:
        return self.engine.site_down(name)

    def evacuate(self, site: str) -> float:
        """Graceful drain (elastic scale-in, NOT an outage): any dataset
        whose only replica lives on the departing site is copied into the
        shared store first, so a routine voluntary release can never
        terminally fail downstream tasks over data loss.  The drain path is
        not time-modeled, so neither is the evacuation copy; the bytes are
        reported separately (``evacuated_mb``)."""
        moved = 0.0
        for name in self.registry.replicas_at(site):
            if self.registry.locate(name) == [site]:  # last copy: save it
                try:
                    self.registry.place_replica(name, SHARED_SITE)
                except StagingError:
                    continue
                moved += self.registry.get(name).size_mb
        if moved:
            with self._lock:
                self.evacuated_mb += moved
                self._emit("stage.evacuate", site=site, mb=moved)
        return moved

    # -- placement scoring ---------------------------------------------
    def missing(self, names: Iterable[str], site: str) -> list[str]:
        return self.registry.missing(names, site)

    def transfer_cost_s(self, names: Iterable[str], site: str) -> float:
        """Modeled seconds to materialize every missing input at ``site``
        (replica reads are free; unknown datasets charge nothing — they are
        declared at the producer's completion, which gates dispatch anyway).
        Transfers ride separate links concurrently, so the cost of a set is
        its slowest member, not the sum.  One semantics, one implementation:
        this is the single-site view of ``transfer_cost_many``."""
        return self.transfer_cost_many(names, (site,))[site]

    def transfer_cost_many(self, names: Iterable[str], sites: Iterable[str]) -> dict[str, float]:
        """``transfer_cost_s`` for one input set across MANY candidate sites
        in a single pass: the per-dataset source/size lookups are shared
        across sites instead of re-resolved per (task, target), which is
        what lets the gravity policy price a whole bind batch without
        re-querying the registry per task (§Perf, exp9)."""
        known = [n for n in names if self.registry.known(n)]
        costs: dict[str, float] = {}
        for site in sites:
            worst = 0.0
            for n in known:
                cost = self.engine.expected_transfer_s(n, site)
                if cost == float("inf"):
                    continue  # lost dataset: surfaces at stage time, not bind time
                worst = max(worst, cost)
            costs[site] = worst
        return costs

    def note_local(self, names: Iterable[str], site: str) -> None:
        """Every input already resident (the gate's fast path): count the
        replica hits and keep their LRU state warm."""
        for n in names:
            if self.registry.resident(n, site):
                self.engine.note_hit(n, site)

    # -- stage-in ------------------------------------------------------
    def stage_task(self, task, site: str, on_ready: Callable[[bool], None]) -> None:
        """Materialize every input of ``task`` at ``site``; ``on_ready(ok)``
        fires once when all transfers land (or once on the first failure).
        Transfers for distinct inputs run concurrently (per-link limits
        permitting) and overlap with other tasks' compute."""
        names = list(task.inputs)
        missing = self.registry.missing(names, site)
        self.note_local((n for n in names if n not in missing), site)
        if not missing:
            on_ready(True)
            return
        clock = get_clock()
        t0 = clock.now()
        state = {"left": len(missing), "failed": False, "done": False}
        lock = threading.Lock()
        with self._lock:
            self.stage_ins += 1
            self._emit("stage.in", task=task.uid, site=site, missing=len(missing))
        task.trace.add(f"stage_in_start:{site}:{len(missing)}")

        def finish(ok: bool) -> None:
            with self._lock:
                wait = max(0.0, clock.now() - t0)
                self.transfer_wait_s += wait
                self._emit("stage.wait", task=task.uid, wait_s=wait)
            task.trace.add("stage_in_done" if ok else "stage_in_failed")
            on_ready(ok)

        def one_done(ok: bool) -> None:
            with lock:
                if state["done"]:
                    return
                if not ok:
                    state["done"] = True
                    state["failed"] = True
                else:
                    state["left"] -= 1
                    if state["left"] > 0:
                        return
                    state["done"] = True
            finish(not state["failed"])

        for n in missing:
            with lock:
                if state["done"]:  # a synchronous failure already resolved
                    break  # the barrier: don't launch orphan transfers
            self.engine.fetch(n, site, one_done)

    # -- stage-out -----------------------------------------------------
    def task_completed(self, task, site: str) -> None:
        """Register the task's declared outputs as replicas at the site that
        ran it, and keep its inputs' LRU state warm there."""
        for name in task.inputs:
            self.registry.touch(name, site)
        for name, size_mb in task.outputs.items():
            self.registry.add(name, size_mb)
            try:
                self.registry.place_replica(name, site)
            except StagingError:
                # scratch full of pinned/last-copy data: the output spills to
                # the shared store instead of silently vanishing
                with self._lock:
                    self.stage_out_drops += 1
                    self._emit("stage.drop", dataset=name, site=site)
                self.registry.place_replica(name, SHARED_SITE)
            if self.mirror_outputs and not self.registry.resident(name, SHARED_SITE):
                try:
                    self.registry.place_replica(name, SHARED_SITE)
                except StagingError:
                    pass  # shared store full of pinned data: best-effort
                else:
                    with self._lock:
                        mb = self.registry.get(name).size_mb
                        self.mirrored_mb += mb
                        self._emit("stage.mirror", dataset=name, mb=mb)
            with self._lock:
                self.stage_outs += 1
                self._emit("stage.out", dataset=name, site=site, mb=size_mb)
        if task.outputs:
            task.trace.add(f"stage_out:{site}:{len(task.outputs)}")

    # -- metrics -------------------------------------------------------
    def stats(self) -> dict:
        """Engine + stage-in/out counters.  Parked-task counts live with the
        dispatcher (the single owner of the blocked set): see
        ``Hydra.staging_stats()``, which merges in ``staging_blocked``.

        With an event bus attached, every accumulated counter here is the
        log-derived view (core/events.py); the legacy accumulators stay as
        the HYDRA_EVENTS_CHECK ground truth.  Emission order matches
        accumulation order (both under the engine/service locks), so even
        the float sums are bit-identical.  active/queued transfers are live
        gauges, never folds."""
        e = self.engine
        if self._events is not None:
            v = self._events.view
            counters = {
                "mb_moved": round(v.get("hydra.staging.mb_moved"), 3),
                "transfers": int(v.get("hydra.staging.transfers")),
                "cache_hits": int(v.get("hydra.staging.cache_hits")),
                "cold_reads": int(v.get("hydra.staging.cold_reads")),
                "reroutes": int(v.get("hydra.staging.reroutes")),
                "transfer_failures": int(v.get("hydra.staging.transfer_failures")),
                "evictions": int(v.get("hydra.staging.evictions")),
                "queue_wait_s": round(v.get("hydra.staging.queue_wait_s"), 3),
                "transfer_wait_s": round(v.get("hydra.staging.transfer_wait_s"), 3),
                "stage_ins": int(v.get("hydra.staging.stage_ins")),
                "stage_outs": int(v.get("hydra.staging.stage_outs")),
                "stage_out_drops": int(v.get("hydra.staging.stage_out_drops")),
                "evacuated_mb": round(v.get("hydra.staging.evacuated_mb"), 3),
                "mirrored_mb": round(v.get("hydra.staging.mirrored_mb"), 3),
            }
        else:
            with self._lock:
                wait = self.transfer_wait_s
                outs, drops = self.stage_outs, self.stage_out_drops
                evac, mirrored = self.evacuated_mb, self.mirrored_mb
            counters = {
                "mb_moved": round(e.mb_moved, 3),
                "transfers": e.completed,
                "cache_hits": e.cache_hits,
                "cold_reads": e.cold_reads,
                "reroutes": e.reroutes,
                "transfer_failures": e.failures,
                "evictions": self.registry.evictions,
                "queue_wait_s": round(e.queue_wait_s, 3),
                "transfer_wait_s": round(wait, 3),
                "stage_ins": self.stage_ins,
                "stage_outs": outs,
                "stage_out_drops": drops,
                "evacuated_mb": round(evac, 3),
                "mirrored_mb": round(mirrored, 3),
            }
        counters["active_transfers"] = e.active_transfers()
        counters["queued_transfers"] = e.queued_transfers()
        return counters

    def shutdown(self) -> None:
        self.engine.shutdown()
