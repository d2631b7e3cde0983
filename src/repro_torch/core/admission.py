"""Multi-tenant admission control: the broker's serving front door.

Everything upstream of the ready heap used to be unbounded: any caller could
``dispatch()`` 100k tasks and the dispatcher would happily heap them all,
starving every other submitter and hiding the overload until makespans blew
up.  This module puts a *front door* between submitters and the ready queue
(ROADMAP: "millions of users needs a tenant layer above the ready heap"):

  * **Token-bucket rate limits** — each tenant refills at ``rate`` tasks/s
    (measured on the active Clock, so virtual-time tests are deterministic)
    up to a ``burst`` cap; an admit that outruns the bucket is rejected with
    a typed ``AdmissionError(reason="rate_limited")``.
  * **Bounded queues** — each tenant may hold at most ``max_queued``
    admitted-but-unfinished tasks; beyond that the front door rejects with
    ``reason="queue_full"`` instead of growing the ready heap without bound.
    Backpressure is the submitter's signal to slow down, exactly like a
    429 from a serving stack.
  * **Weights** — the dispatcher's weighted-fair drain
    (core/dispatcher.py, policy.apportion_budget) reads each tenant's
    ``weight`` to split the batch budget among same-class lanes.

Admission is *per submission entry*, not per internal hop: retries, staging
re-gates, failovers and speculative clones all carry tasks that were already
admitted (``task.admitted``) and pass through untouched — the front door
meters what enters the system, never what the system is already obliged to
finish.  Release is idempotent and automatic: a held slot is freed when the
task's future resolves (the controller registers one done-callback at admit
time), so rejected-then-retried submitters see the queue drain as work
completes, whatever path the work took.

An unconfigured tenant gets ``DEFAULT_TENANT_SPEC`` semantics: unlimited
rate, unbounded queue, weight 1.0 — so a broker constructed without a
tenant map behaves exactly as before this module existed.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.task import Task
from repro_torch.runtime.clock import get_clock


class AdmissionError(RuntimeError):
    """Typed backpressure: the front door rejected a submission.

    ``reason`` is ``"rate_limited"`` (token bucket empty) or ``"queue_full"``
    (per-tenant bound hit); ``retry_after_s`` is a refill-based hint for
    rate-limited rejections (None when the queue is the binding constraint —
    the submitter should wait for completions, not a timer).
    """

    def __init__(self, tenant: str, reason: str, detail: str, retry_after_s: Optional[float] = None):
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(f"tenant {tenant!r} {reason}: {detail}")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's front-door contract.

    ``rate`` is tasks/second (None = unlimited), ``burst`` the bucket depth
    (defaults to ``rate`` when unset, min 1), ``max_queued`` the bound on
    admitted-but-unfinished tasks (None = unbounded), ``weight`` the share
    of the dispatcher's batch budget among same-class lanes.
    """

    name: str
    rate: Optional[float] = None
    burst: Optional[float] = None
    max_queued: Optional[int] = None
    weight: float = 1.0

    def __post_init__(self):
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"tenant {self.name!r}: rate must be > 0 or None")
        if self.max_queued is not None and self.max_queued <= 0:
            raise ValueError(f"tenant {self.name!r}: max_queued must be > 0 or None")
        if self.weight < 0:
            raise ValueError(f"tenant {self.name!r}: weight must be >= 0")


DEFAULT_TENANT_SPEC = TenantSpec(name="default")


class TokenBucket:
    """Clock-driven token bucket: ``rate`` tokens/s up to ``burst``.

    Refill is computed lazily from elapsed clock time at each take(), so the
    bucket needs no timer thread and is exact under VirtualClock.
    """

    def __init__(self, rate: float, burst: float):
        assert rate > 0 and burst >= 1
        self.rate = rate
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = get_clock().now()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        # callers hold self._lock.  A clock that jumped backward (fresh
        # VirtualClock after a wall-clock construction) must not freeze the
        # bucket, so negative elapsed re-bases instead of subtracting.
        elapsed = now - self._last
        if elapsed > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._last = now

    def take(self, n: int = 1) -> bool:
        """Consume ``n`` tokens if available; False (and no change) if not."""
        now = get_clock().now()
        with self._lock:
            self._refill(now)
            if self._tokens + 1e-9 < n:
                return False
            self._tokens -= n
            return True

    def put(self, n: int) -> None:
        """Refund ``n`` tokens (an admit rolled back), capped at burst."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n)

    def available(self) -> float:
        now = get_clock().now()
        with self._lock:
            self._refill(now)
            return self._tokens

    def wait_hint_s(self, n: int = 1) -> float:
        """Seconds until ``n`` tokens will have refilled (retry-after)."""
        return max(0.0, (n - self.available()) / self.rate)


class AdmissionController:
    """Per-tenant token buckets + bounded queues + weight lookups.

    ``admit()`` is all-or-nothing across the whole call: a partially
    admitted workflow would deadlock on its rejected half, so either every
    task in the list enters or none do — a rejection refunds everything the
    same call already charged (tokens and queue slots alike).
    """

    def __init__(self, tenants: Optional[list[TenantSpec]] = None):
        self._lock = threading.Lock()
        self._specs: dict[str, TenantSpec] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._held: dict[str, int] = {}  # tenant -> admitted, unreleased tasks
        # counters for stats()/benchmarks: rejections by (tenant, reason).
        # With an event bus attached these become the strict-mode ground
        # truth; stats() itself reads the log-derived view (core/events.py)
        self.admitted = 0
        self.rejected: dict[tuple[str, str], int] = {}
        self._events = None  # broker-owned EventBus, via attach_events()
        for spec in tenants or []:
            self.add_tenant(spec)

    def attach_events(self, bus) -> None:
        """Wire the broker's event bus: admission decisions become
        admission.accept / admission.reject events and stats() turns into
        a derived view over the log."""
        self._events = bus

    def add_tenant(self, spec: TenantSpec) -> None:
        with self._lock:
            self._specs[spec.name] = spec
            if spec.rate is not None:
                burst = spec.burst if spec.burst is not None else spec.rate
                self._buckets[spec.name] = TokenBucket(spec.rate, max(1.0, burst))
            else:
                self._buckets.pop(spec.name, None)

    def spec(self, tenant: str) -> TenantSpec:
        with self._lock:
            return self._specs.get(tenant, DEFAULT_TENANT_SPEC)

    def weight(self, tenant: str) -> float:
        return self.spec(tenant).weight

    # -- the gate ---------------------------------------------------------
    def admit(self, tasks: list[Task]) -> None:
        """Charge each task against its tenant's bucket and queue bound.
        Raises AdmissionError on the first tenant that cannot take its whole
        group, refunding anything the call already charged.  Already-admitted
        tasks (internal requeues) pass through untouched."""
        fresh = [t for t in tasks if not t.admitted]
        if not fresh:
            return
        by_tenant: dict[str, list[Task]] = {}
        for t in fresh:
            by_tenant.setdefault(t.tenant, []).append(t)
        # phase 1 — charge every tenant's bucket and queue bound; a rejection
        # refunds the groups charged before it and raises with nothing held
        charged: list[tuple[str, int, Optional[TokenBucket]]] = []
        for tenant, group in by_tenant.items():
            n = len(group)
            with self._lock:
                spec = self._specs.get(tenant, DEFAULT_TENANT_SPEC)
                bucket = self._buckets.get(tenant)
                held = self._held.get(tenant, 0)
                queue_full = spec.max_queued is not None and held + n > spec.max_queued
                if not queue_full:
                    self._held[tenant] = held + n
            if not queue_full and bucket is not None and not bucket.take(n):
                with self._lock:
                    self._held[tenant] -= n
                self._reject(
                    charged,
                    tenant,
                    "rate_limited",
                    f"{n} task(s) exceed the available {bucket.available():.1f} tokens",
                    retry_after_s=bucket.wait_hint_s(n),
                )
            if queue_full:
                self._reject(
                    charged,
                    tenant,
                    "queue_full",
                    f"{held} queued + {n} submitted > max_queued {spec.max_queued}",
                )
            charged.append((tenant, n, bucket))
        # phase 2 — commit: nothing below can fail, so the release callback
        # is registered only for tasks that actually hold a slot
        with self._lock:
            self.admitted += len(fresh)
            if self._events is not None:
                for tenant, group in by_tenant.items():
                    self._events.emit("admission.accept", tenant=tenant, n=len(group))
        for tenant, group in by_tenant.items():
            for t in group:
                t.admitted = True
                t.admission_held = True
                # release on resolution, whatever path the task took to get
                # there (completion, retry exhaustion, cancel-while-queued)
                t.add_done_callback(self._release_cb)

    def _reject(
        self,
        charged: list[tuple[str, int, Optional["TokenBucket"]]],
        tenant: str,
        reason: str,
        detail: str,
        retry_after_s: Optional[float] = None,
    ) -> None:
        """Refund everything this admit() call charged, then raise."""
        with self._lock:
            for other, n, bucket in charged:
                self._held[other] = max(0, self._held.get(other, 0) - n)
            self.rejected[(tenant, reason)] = self.rejected.get((tenant, reason), 0) + 1
            if self._events is not None:
                self._events.emit("admission.reject", tenant=tenant, reason=reason)
        for _, n, bucket in charged:
            if bucket is not None:
                bucket.put(n)
        raise AdmissionError(tenant, reason, detail, retry_after_s=retry_after_s)

    def _release_cb(self, fut) -> None:
        self.release(fut)

    def release(self, task: Task) -> None:
        """Free the task's queue slot (idempotent: pop + done-callback may
        both fire; the flag flip under the lock picks exactly one winner)."""
        with self._lock:
            if not getattr(task, "admission_held", False):
                return
            task.admission_held = False
            tenant = task.tenant
            self._held[tenant] = max(0, self._held.get(tenant, 0) - 1)

    def held(self, tenant: str) -> int:
        with self._lock:
            return self._held.get(tenant, 0)

    def stats(self) -> dict:
        """Dict-shaped adapter.  The admit/reject totals are the log-derived
        view when a bus is attached (emission is adjacent to the legacy
        increments, under this controller's lock, so the two never drift);
        held/tenants are live gauges, not log folds."""
        if self._events is not None:
            view = self._events.view
            admitted = int(view.get("hydra.admission.admitted"))
            rejected = {
                k: int(v)
                for k, v in sorted(view.keyed_get("hydra.admission.rejected").items())
            }
        else:
            with self._lock:
                admitted = self.admitted
                rejected = {
                    f"{tenant}:{reason}": n
                    for (tenant, reason), n in sorted(self.rejected.items())
                }
        with self._lock:
            return {
                "tenants": sorted(self._specs),
                "held": dict(self._held),
                "admitted": admitted,
                "rejected": rejected,
            }
