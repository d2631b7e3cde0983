"""Binding policies: which provider runs which task (paper §1: "user-specified
brokering policies determine whether tasks ... execute on cloud or HPC").

The paper's released Hydra binds statically before execution; *adaptive*
runtime re-binding is its stated future work ("dynamic and adaptive binding
of tasks to resources at runtime", §6) and is implemented here as
``AdaptivePolicy`` (beyond-paper, measured in EXPERIMENTS.md §Perf).

Policies bind to *targets*, which are either concrete ``ProviderHandle``s or
logical ``ProviderGroup``s (core/group.py) — both expose ``.name`` and
``.spec.capacity()``, which is all a policy may rely on.  When a task is
bound to a group, the group resolves the concrete member at dispatch time;
runtime feedback (``observe``) arrives keyed by the *logical* bound name, so
a policy's load/EWMA accounting never sees intra-group member churn.

Hot-path complexity (§Perf, the exp9 scheduler core):

  * **Indexed eligibility** — when bound to the proxy's versioned bind-target
    cache (``attach_proxy``), ``_eligible`` is a dict lookup per capacity
    signature instead of a per-task scan; the index drops whole on any
    topology change (register/deregister/health/breaker events bump the
    proxy version).  Eligible sets built this way are ``EligibleTargets``
    lists tagged with their (version, signature) key.
  * **Lazy-rekeyed placement heaps** — the stateful policies
    (``LoadAwarePolicy``/``AdaptivePolicy``/``DataGravityPolicy``) keep one
    min-heap per eligible-set key, so ``_choose`` is O(log n) instead of
    ``min()`` over every provider under the lock.  Heap entries are score
    snapshots; every score change pushes a fresh entry (per-name version
    numbers invalidate the old ones) and any remaining staleness — e.g. the
    fleet-average EWMA prior drifting under a no-history provider — is
    repaired at pop time by re-keying the top entry with its true score.
  * **Batched data costs** — within one ``bind_bulk`` the gravity policy
    resolves staging costs once per (inputs-signature, targets) via
    ``StagingService.transfer_cost_many`` instead of per task per target.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

from repro_torch.core.task import Task


class NoEligibleProvider(RuntimeError):
    """No registered target can fit the task's resource requirements.

    A typed subclass so callers that bind *batches* late (the streaming
    dispatcher in core/dispatcher.py) can fail exactly the offending task
    and keep dispatching the rest of the batch, instead of aborting the
    whole submission on one oversized task."""

    def __init__(self, task: Task):
        self.task = task
        super().__init__(
            f"no provider can fit task {task.uid} requiring {vars(task.resources)}"
        )


def apportion_budget(
    budget: int,
    demands: list[int],
    weights: list[float],
    carry: Optional[list[float]] = None,
) -> tuple[list[int], list[float]]:
    """Split an integer batch budget across lanes in proportion to weight —
    the dispatcher's lane-aware backfill sizing (core/dispatcher.py).

    Weighted largest-remainder apportionment with carried deficits: each
    lane's ideal share is ``budget * w_i / W`` plus whatever fraction it was
    shorted last round, so over consecutive rounds every nonzero-weight lane
    with standing demand converges on its exact proportional share — a
    weight-1 lane next to a weight-100 lane is *slowed*, never starved
    (tests/test_tenants.py proves this as a property).  Surplus from lanes
    whose demand is smaller than their share re-apportions to the rest;
    zero-weight lanes only see budget no weighted lane wants.

    Returns ``(grants, new_carry)``; grants[i] <= demands[i] and
    sum(grants) <= budget always hold.  ``new_carry`` is the deficit to pass
    back next round — callers reset a lane's carry when it empties.
    """
    n = len(demands)
    assert len(weights) == n
    new_carry = [0.0] * n if carry is None else [max(0.0, c) for c in carry]
    grants = [0] * n
    remaining = max(0, int(budget))
    while remaining > 0:
        active = [i for i in range(n) if demands[i] > grants[i] and weights[i] > 0]
        if not active:
            # only weightless lanes still have demand: plain round-robin
            idle = [i for i in range(n) if demands[i] > grants[i]]
            if not idle:
                break
            for i in idle:
                if remaining <= 0:
                    break
                grants[i] += 1
                remaining -= 1
            continue
        total_w = sum(weights[i] for i in active)
        round_budget = remaining
        allotted = 0
        for i in active:
            share = round_budget * weights[i] / total_w + new_carry[i]
            whole = min(int(share), demands[i] - grants[i], remaining - allotted)
            grants[i] += whole
            allotted += whole
            if demands[i] > grants[i]:
                # shorted (by rounding, its demand cap, or budget exhaustion):
                # carry the deficit so next round repays it first.  Bounded
                # by the round budget, so a long-starved lane cannot bank an
                # unbounded claim and then monopolize a whole batch.
                new_carry[i] = min(float(round_budget), share - whole)
            else:
                new_carry[i] = 0.0  # satisfied: a drained lane banks nothing
        remaining -= allotted
        if remaining > 0 and allotted == 0:
            # every share rounded to zero (tiny budget, many lanes): the
            # largest accumulated deficit wins one slot — this is what makes
            # starvation impossible even at budget == 1
            best = max(active, key=lambda i: (new_carry[i], weights[i]))
            grants[best] += 1
            new_carry[best] = max(0.0, new_carry[best] - 1.0)
            remaining -= 1
    return grants, new_carry


class EligibleTargets(list):
    """An eligibility-validated target list tagged with the (topology
    version, capacity signature) it was computed for — the key stateful
    policies hang their placement heaps on.  Treated as immutable."""

    __slots__ = ("key",)

    def __init__(self, items, key=None):
        super().__init__(items)
        self.key = key


class Policy:
    name = "base"
    # data-aware placement (core/staging.py): when a StagingService is
    # attached, ``data_cost_s`` charges cold reads their modeled transfer
    # time; replica reads are free.  Policies that fold this into _choose
    # become locality-aware; the rest stay locality-blind (the exp8 control).
    staging = None

    def __init__(self):
        self._proxy = None  # versioned bind-target source (attach_proxy)
        self._elig_ver: Optional[int] = None
        self._elig_cache: dict[tuple, EligibleTargets] = {}
        self._elig_lock = threading.Lock()
        # per-THREAD bulk data-cost scope: the dispatcher's staging-gate
        # pass and a concurrent fault-path bind_bulk must not share (or
        # clear) each other's batch cache
        self._bulk_local = threading.local()

    def attach_staging(self, staging) -> None:
        self.staging = staging

    def attach_proxy(self, proxy) -> None:
        """Wire the ProviderProxy whose versioned bind-target cache keys the
        eligibility index; without it every _eligible call scans."""
        self._proxy = proxy

    def data_cost_s(self, task: Task, name: str) -> float:
        """Modeled seconds to materialize the task's missing input bytes at
        target ``name``'s site (0 when staging is off or inputs resident)."""
        if self.staging is None or not task.inputs:
            return 0.0
        return self.staging.transfer_cost_s(task.inputs, name)

    @contextmanager
    def bulk_scope(self):
        """Scope several sequential ``bind`` calls into one batch for the
        data-cost cache (the dispatcher's staging gate binds input-carrying
        tasks one by one — with this scope a gate pass over a batch reading
        the same shard set prices its placements ONCE, exactly like
        bind_bulk does).  The scope is thread-local: concurrent binders
        each get their own."""
        self._bulk_local.cache = {}
        try:
            yield
        finally:
            self._bulk_local.cache = None

    def data_costs(self, task: Task, ok: list) -> dict[str, float]:
        """Per-target stage-in cost for the task's inputs, resolved in ONE
        staging query — and cached per (inputs-signature, targets) for the
        duration of a bind_bulk, so a batch of tasks reading the same shard
        set prices its placements once instead of tasks x targets times."""
        if self.staging is None or not task.inputs:
            return {}
        sig = tuple(sorted(task.inputs))
        names = tuple(p.name for p in ok)
        cache = getattr(self._bulk_local, "cache", None)
        if cache is not None:
            hit = cache.get((sig, names))
            if hit is not None:
                return hit
        costs = self.staging.transfer_cost_many(sig, names)
        if cache is not None:
            cache[(sig, names)] = costs
        return costs

    def bind(self, task: Task, providers: list) -> str:
        """providers: bind targets — ProviderHandle or ProviderGroup."""
        return self._choose(task, self._eligible(task, providers))

    def _choose(self, task: Task, ok: list) -> str:
        """Pick among pre-validated eligible targets (policy-specific)."""
        raise NotImplementedError

    def bind_bulk(self, tasks: list[Task], providers: list) -> list[str]:
        """Vectorized binding (§Perf): one eligibility pass per distinct
        (resources, pin) signature instead of a per-task scan; policies may
        override.

        Atomic with respect to stateful policies: eligibility is validated
        for the WHOLE batch before any _choose mutates load accounting, so a
        NoEligibleProvider raise leaves outstanding/EWMA state untouched and
        the caller can safely re-bind the placeable remainder.

        A task carrying a staging-gate reservation (``reserved_provider``,
        core/dispatcher.py) is routed back to the target the gate already
        bound — and accounted — it to: its inputs were staged to that site on
        that promise.  A reservation whose target has since died is released
        (``unbind``) and the task re-chooses normally."""
        sig_cache: dict = {}
        eligible = []
        for t in tasks:
            sig = (t.pinned_provider, t.resources.cpus, t.resources.accels, t.resources.memory_mb)
            ok = sig_cache.get(sig)
            if ok is None:
                ok = self._eligible(t, providers)
                sig_cache[sig] = ok
            eligible.append(ok)
        names = []
        fresh_scope = getattr(self._bulk_local, "cache", None) is None
        if fresh_scope:
            self._bulk_local.cache = {}
        try:
            for t, ok in zip(tasks, eligible):
                reserved, t.reserved_provider = t.reserved_provider, None
                if reserved is not None:
                    if any(p.name == reserved for p in ok):
                        # load already accounted at reservation time: no _choose
                        names.append(reserved)
                        continue
                    self.unbind(t, reserved)  # target gone: release, re-choose
                names.append(self._choose(t, ok))
        finally:
            if fresh_scope:
                self._bulk_local.cache = None
        return names

    def observe(self, provider: str, runtime_s: float) -> None:
        """Runtime feedback hook (used by adaptive policies).  ``provider``
        is the logical bound name: a group name for group-bound tasks."""

    def unbind(self, task: Task, name: Optional[str] = None) -> None:
        """Undo load accounting for a task that was bound but never made it
        to a provider (pipeline aborts and the streaming dispatcher's retry
        path re-bind such tasks: without this hook stateful policies would
        double-count).  ``name`` overrides the bound name for tasks whose
        provider attribute was never updated (mid-bind aborts)."""

    def forget(self, name: str) -> None:
        """Drop all accumulated state for a released provider (elastic
        scale-in).  Without this, a re-acquired instance under a recycled
        name would inherit the dead instance's load/EWMA history."""

    def _eligible(self, task: Task, providers: list) -> list:
        """Targets that can fit the task (a pin may name a group too).

        O(1) amortized when ``providers`` is the proxy's current cached
        bind-target list: results are indexed per capacity signature and the
        whole index drops on any topology-version bump.  Filtered lists
        (rebind-with-exclude, speculation) fall back to the scan."""
        if task.pinned_provider:
            pin = [p for p in providers if p.name == task.pinned_provider]
            if pin:
                return pin
        res = task.resources
        ver = self._proxy.targets_version(providers) if self._proxy is not None else None
        if ver is None:
            ok = [p for p in providers if res.fits(p.spec.capacity())]
            if not ok:
                raise NoEligibleProvider(task)
            return ok
        sig = (res.cpus, res.accels, res.memory_mb)
        with self._elig_lock:
            if ver != self._elig_ver:  # topology moved: the whole index is stale
                self._elig_cache = {}
                self._elig_ver = ver
            ok = self._elig_cache.get(sig)
        if ok is None:
            ok = EligibleTargets(
                (p for p in providers if res.fits(p.spec.capacity())),
                key=(ver, sig),
            )
            with self._elig_lock:
                # install only if the index still belongs to OUR version: a
                # concurrent topology bump may have rotated the cache while
                # we built, and a stale-era list must not survive into the
                # new version's index
                if self._elig_ver == ver:
                    self._elig_cache[sig] = ok
        if not ok:
            raise NoEligibleProvider(task)
        return ok


class RoundRobinPolicy(Policy):
    name = "round_robin"

    def __init__(self):
        super().__init__()
        self._n = 0
        self._lock = threading.Lock()

    def _choose(self, task: Task, ok: list) -> str:
        with self._lock:
            choice = ok[self._n % len(ok)]
            self._n += 1
        return choice.name


class CapabilityPolicy(Policy):
    """Pick the provider with the most spare capability for the task class:
    accelerator tasks -> accel-richest pool; cpu tasks -> cpu-richest pool.
    The argmax is cached per (eligible-set key, task class): capacities only
    change with the topology version, which rotates the key."""

    name = "capability"

    def __init__(self):
        super().__init__()
        self._best: dict[tuple, str] = {}

    def _choose(self, task: Task, ok: list) -> str:
        accel = task.resources.accels > 0
        key = getattr(ok, "key", None)
        if key is not None:
            hit = self._best.get((key, accel))
            if hit is not None:
                return hit
        if accel:
            name = max(ok, key=lambda p: p.spec.capacity().accels).name
        else:
            name = max(ok, key=lambda p: p.spec.capacity().cpus).name
        if key is not None:
            if len(self._best) > 1024:  # old topology versions: let them go
                self._best = {}
            self._best[(key, accel)] = name
        return name


class _HeapPolicy(Policy):
    """Shared lazy-rekeyed-heap machinery for load/EWMA-scored policies.

    One min-heap per eligible-set key (``EligibleTargets.key``).  Entries
    are ``(score, seq, name, ver)`` snapshots; ``self._ver[name]`` advances
    on every score change and every placement, invalidating older entries.
    ``_rescore`` pushes a fresh entry into each heap whose eligible set
    contains the name (the number of live heaps is the number of distinct
    capacity signatures in flight — typically one).  A top entry whose
    snapshot no longer equals the true score is re-keyed in place
    (``heapreplace``) rather than trusted, which is what keeps prior-drift
    staleness from mis-placing work.  All methods expect self._lock held."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._ver: dict[str, int] = defaultdict(int)
        self._heaps: dict[tuple, list] = {}
        self._heap_members: dict[tuple, frozenset] = {}
        self._seq = itertools.count()

    def _score(self, name: str) -> float:
        raise NotImplementedError

    def _rescore(self, name: str) -> None:
        self._ver[name] += 1
        if not self._heaps:
            return
        score, ver = self._score(name), self._ver[name]
        for key, members in self._heap_members.items():
            if name not in members:
                continue
            heap = self._heaps[key]
            if len(heap) > 64 + 8 * len(members):
                # a heap nobody pops (dormant capacity signature) would
                # otherwise accumulate one stale snapshot per event forever:
                # rebuild in place from current scores, bounding every heap
                # at O(members)
                heap[:] = [
                    (self._score(m), next(self._seq), m, self._ver[m])
                    for m in members
                ]
                heapq.heapify(heap)
            else:
                heapq.heappush(heap, (score, next(self._seq), name, ver))

    def _drop(self, name: str) -> None:
        """forget(): invalidate without re-seeding (the name is leaving)."""
        self._ver[name] += 1

    def _heap_for(self, ok: list) -> Optional[list]:
        key = getattr(ok, "key", None)
        if key is None:
            return None
        heap = self._heaps.get(key)
        if heap is None:
            stale = [k for k in self._heaps if k[0] != key[0]]
            for k in stale:  # dead topology versions stop receiving pushes
                del self._heaps[k]
                del self._heap_members[k]
            heap = [
                (self._score(p.name), next(self._seq), p.name, self._ver[p.name])
                for p in ok
            ]
            heapq.heapify(heap)
            self._heaps[key] = heap
            self._heap_members[key] = frozenset(p.name for p in ok)
        return heap

    def _pick_min(self, ok: list) -> str:
        """Argmin-score target in O(log n) via the eligible set's heap;
        falls back to a scan for untagged lists.  Callers hold self._lock
        and still own the post-placement bookkeeping for the winner."""
        heap = self._heap_for(ok)
        if heap is not None:
            while heap:
                score, _, name, ver = heap[0]
                if ver != self._ver[name]:
                    heapq.heappop(heap)  # superseded snapshot
                    continue
                true = self._score(name)
                if true != score:
                    # lazy rekey: correct the snapshot in place and re-sort
                    heapq.heapreplace(heap, (true, next(self._seq), name, ver))
                    continue
                return name
            # heap drained (every member forgotten mid-flight): fall through
        return min(ok, key=lambda p: self._score(p.name)).name


class LoadAwarePolicy(_HeapPolicy):
    """Least-outstanding-tasks binding (queue-depth balancing)."""

    name = "load_aware"

    def __init__(self):
        super().__init__()
        self.outstanding: dict[str, int] = defaultdict(int)

    def _score(self, name: str) -> float:
        return self.outstanding[name]

    def _choose(self, task: Task, ok: list) -> str:
        with self._lock:
            name = self._pick_min(ok)
            self.outstanding[name] += 1
            self._rescore(name)
            return name

    def observe(self, provider: str, runtime_s: float) -> None:
        with self._lock:
            self.outstanding[provider] = max(0, self.outstanding[provider] - 1)
            self._rescore(provider)

    def unbind(self, task: Task, name: Optional[str] = None) -> None:
        name = name or task.group or task.provider
        if name:
            with self._lock:
                self.outstanding[name] = max(0, self.outstanding[name] - 1)
                self._rescore(name)

    def forget(self, name: str) -> None:
        with self._lock:
            self.outstanding.pop(name, None)
            self._drop(name)


class AdaptivePolicy(_HeapPolicy):
    """Throughput-weighted binding (beyond-paper: the paper's future work).

    Keeps an EWMA of per-provider task service time and routes proportionally
    more work to faster providers, while still balancing outstanding load.
    """

    name = "adaptive"

    def __init__(self, alpha: float = 0.2):
        super().__init__()
        self.alpha = alpha
        self.ewma: dict[str, float] = {}
        self.outstanding: dict[str, int] = defaultdict(int)
        self._ewma_sum = 0.0  # running aggregate: O(1) fleet prior

    def _fleet_prior(self) -> float:
        """Neutral EWMA prior for providers with no history yet (callers
        hold self._lock): a member that appeared mid-run (elastic scale-out)
        is assumed as fast as the current fleet average, not 1000x faster —
        an optimistic default would flood brand-new capacity before its
        first completion.  Maintained as a running sum so reading it is O(1)
        on the per-task path."""
        n = len(self.ewma)
        return (self._ewma_sum / n) if n else 1e-3

    def _expected_finish_s(self, name: str, prior: float) -> float:
        """Expected finish time ~ (queue + 1) x service time (callers hold
        self._lock).  Shared by the adaptive and data-gravity policies so
        the queueing model cannot silently diverge between them."""
        svc = max(self.ewma.get(name, prior), 1e-6)
        return (self.outstanding[name] + 1) * svc

    def _score(self, name: str) -> float:
        return self._expected_finish_s(name, self._fleet_prior())

    def _choose(self, task: Task, ok: list) -> str:
        with self._lock:
            name = self._pick_min(ok)
            self.outstanding[name] += 1
            self._rescore(name)
            return name

    def observe(self, provider: str, runtime_s: float) -> None:
        with self._lock:
            cur = self.ewma.get(provider)
            new = runtime_s if cur is None else (1 - self.alpha) * cur + self.alpha * runtime_s
            self.ewma[provider] = new
            self._ewma_sum += new - (cur or 0.0)
            self.outstanding[provider] = max(0, self.outstanding[provider] - 1)
            self._rescore(provider)

    def unbind(self, task: Task, name: Optional[str] = None) -> None:
        """Load release only — no EWMA update: the task never ran."""
        name = name or task.group or task.provider
        if name:
            with self._lock:
                self.outstanding[name] = max(0, self.outstanding[name] - 1)
                self._rescore(name)

    def forget(self, name: str) -> None:
        with self._lock:
            gone = self.ewma.pop(name, None)
            if gone is not None:
                self._ewma_sum -= gone
            self.outstanding.pop(name, None)
            self._drop(name)


class DataGravityPolicy(AdaptivePolicy):
    """Locality-aware binding (beyond-paper; StreamFlow-style): expected
    completion = modeled stage-in time for the task's missing input bytes
    (core/staging.py: replica reads free, cold reads charged the link model)
    + the adaptive queue/service-time estimate.  Placement therefore prefers
    providers already holding — or co-located with — a task's inputs, and
    only pays a cross-site transfer when the data-local queue is long enough
    to make shipping bytes cheaper than waiting.

    Tasks without declared inputs have a zero data term everywhere and ride
    the adaptive heap; tasks with inputs scan the (typically small) eligible
    set against a data-cost map resolved once per (inputs-signature,
    targets) per bind_bulk (``Policy.data_costs``)."""

    name = "data_gravity"

    def _choose(self, task: Task, ok: list) -> str:
        if not task.inputs:
            return super()._choose(task, ok)
        # staging reads (registry/engine locks) happen OUTSIDE the policy
        # lock: staging never calls back into policies, but keeping the
        # ordering one-way makes that invariant structural
        data_cost = self.data_costs(task, ok)
        with self._lock:
            prior = self._fleet_prior()
            choice = min(
                ok,
                key=lambda p: (
                    data_cost.get(p.name, 0.0) + self._expected_finish_s(p.name, prior),
                    p.name,
                ),
            )
            self.outstanding[choice.name] += 1
            self._rescore(choice.name)
            return choice.name


POLICIES = {
    p.name: p
    for p in (
        RoundRobinPolicy,
        CapabilityPolicy,
        LoadAwarePolicy,
        AdaptivePolicy,
        DataGravityPolicy,
    )
}


def make_policy(name: str) -> Policy:
    return POLICIES[name]()
