"""Cost- and preemption-aware market planner (paper §1, §4: concurrent

Counterpart of ``repro/core/market.py``, copied with its imports rewritten.
brokering across commercial cloud, private cloud, and HPC).

The platforms Hydra brokers differ in more than acquisition latency (the
autoscaler's LatencyModel): they differ in *price* and *revocation risk*.
Spot instances are cheap but preemptible; on-demand VMs are expensive and
stable; HPC batch slots are free-ish but walltime-killed.  This module
turns the autoscaler's "fastest arrival first" acquisition policy into a
market: a bid/choose loop that, given the same demand signals the pressure
tick already computes, selects the cheapest *feasible* platform mix.

  PreemptionHazard  seeded revocation model for one platform tier: an
                    expected revocation rate per instance-hour.  Feeds both
                    planning (expected-preemption-loss discounts a spot
                    slot's effective throughput) and chaos-style storm
                    sampling (``sample_kills``).
  MarketPlanner     attached via ``Autoscaler(..., planner=...)`` (or
                    ``Hydra.autoscale(pool, planner=...)``).  Each pressure
                    tick it re-ranks the launchable templates by price per
                    *effective* slot-hour — a greedy knapsack over
                    effective throughput = slots x (1 - expected loss) —
                    and each acquisition takes the cheapest feasible bid.
                    Prices may move mid-run (``set_price``), and the ranking
                    re-forms on the next tick: the bid loop re-bids
                    continuously.  Per-instance spend settles on release /
                    loss / shutdown into ``market.spend`` events, making
                    dollars a first-class derived metric
                    (``hydra.cost_node_seconds``, ``hydra.cost_dollars``).

Feasibility is the SLO leg: with ``slo_target_s`` set, a template whose
expected acquisition latency would eat the makespan budget (an HPC queue
wait of minutes against a seconds-scale target) is excluded no matter how
cheap it is.  Determinism: ranking is a pure sort with a total tie-break
(template name last), prices/hazards change only via explicit calls, and
the bid log is stamped on the active Clock — same seed, same schedule.
"""
from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.autoscaler import LaunchSpec
from repro_torch.runtime.clock import get_clock


@dataclass(frozen=True)
class PreemptionHazard:
    """Revocation model for one platform tier.

    ``rate_per_hour`` is the expected number of revocations per
    instance-hour of occupancy (a Poisson intensity): ~0 for on-demand,
    O(1) for aggressive spot tiers, in between for HPC-within-walltime.
    """

    rate_per_hour: float = 0.0

    def expected_loss_frac(self, recovery_cost_s: float) -> float:
        """Fraction of an instance's throughput lost to revocations: each
        expected kill costs ``recovery_cost_s`` of re-execution + re-binding
        per hour of occupancy.  Capped below 1 so a hazardous-but-priced
        slot never ranks as literally worthless."""
        return min(0.9, max(0.0, self.rate_per_hour * recovery_cost_s / 3600.0))

    def survival_p(self, window_s: float) -> float:
        """P(an instance lives through ``window_s`` without revocation)."""
        return math.exp(-self.rate_per_hour * max(0.0, window_s) / 3600.0)

    def sample_kills(
        self, rng: random.Random, instances: list[str], window_s: float
    ) -> list[str]:
        """Seeded storm sampling: which of ``instances`` get revoked within
        ``window_s``.  Iterates in the given order, so the same rng state
        and instance list reproduce the same victim set."""
        p = 1.0 - self.survival_p(window_s)
        return [name for name in instances if rng.random() < p]


# Default tiers (spot >> HPC-within-walltime >> on-demand), used when a
# LaunchSpec carries a price but no explicit hazard.
SPOT_HAZARD = PreemptionHazard(rate_per_hour=6.0)
HPC_WALLTIME_HAZARD = PreemptionHazard(rate_per_hour=0.5)
ON_DEMAND_HAZARD = PreemptionHazard(rate_per_hour=0.05)

_DEFAULT_HAZARD = {"cloud": ON_DEMAND_HAZARD, "hpc": HPC_WALLTIME_HAZARD}


class MarketPlanner:
    """The bid/choose loop.  One per Autoscaler; see the module docstring.

    Legacy accumulators (``plans``, ``bids``, ``cost_dollars``, ...) are
    maintained adjacent to each ``market.*`` emit under the planner lock,
    so ``HYDRA_EVENTS_CHECK=1`` can cross-check the log-derived view
    bit-for-bit (floats sum in emit order on both sides).
    """

    def __init__(
        self,
        slo_target_s: Optional[float] = None,
        recovery_cost_s: float = 60.0,
        seed: int = 0,
    ):
        self.slo_target_s = slo_target_s
        self.recovery_cost_s = recovery_cost_s
        self.rng = random.Random(seed)  # reserved for stochastic bid policies
        self._lock = threading.RLock()
        self.scaler = None
        self._events = None
        self._prices: dict[str, float] = {}  # live overrides, template -> $/slot-hr
        self._settled: set[str] = set()
        self._last_plan: Optional[tuple] = None
        # (t, template, price, eff_slots): the reproducible bid schedule
        self.bid_log: list[tuple] = []
        # legacy accumulators (HYDRA_EVENTS_CHECK ground truth)
        self.plans = 0
        self.bids = 0
        self.bids_by_template: dict[str, int] = {}
        self.reprices = 0
        self.cost_node_seconds = 0.0
        self.cost_dollars = 0.0

    # -- wiring ----------------------------------------------------------
    def bind(self, scaler) -> None:
        """Called by Autoscaler.__init__ when attached via ``planner=``."""
        if self.scaler is not None and self.scaler is not scaler:
            raise RuntimeError("market planner is already bound to an autoscaler")
        self.scaler = scaler
        self._events = scaler.broker.events

    # -- pricing / hazards ----------------------------------------------
    def price_of(self, launch: LaunchSpec) -> float:
        with self._lock:
            return self._prices.get(
                launch.template.name, launch.price_per_slot_hour
            )

    def hazard_of(self, launch: LaunchSpec) -> PreemptionHazard:
        if launch.hazard is not None:
            return launch.hazard
        return _DEFAULT_HAZARD.get(launch.template.platform, ON_DEMAND_HAZARD)

    def set_price(self, template: str, price: float) -> None:
        """Spot market moved: the next tick's replan re-ranks around it."""
        if price < 0:
            raise ValueError(f"negative price {price} for template {template!r}")
        with self._lock:
            self._prices[template] = price
            if self._events is None:
                return  # pre-bind configuration, not market movement
            self.reprices += 1
            self._events.emit("market.price", template=template, price=price)

    # -- the knapsack ----------------------------------------------------
    def effective_slots(self, launch: LaunchSpec) -> float:
        """Slots discounted by expected preemption loss: what a knapsack
        over throughput actually buys."""
        loss = self.hazard_of(launch).expected_loss_frac(self.recovery_cost_s)
        return launch.slots_per_instance * (1.0 - loss)

    def feasible(self, launch: LaunchSpec) -> bool:
        """SLO leg: an acquisition whose expected latency eats the makespan
        budget is not a bid, however cheap."""
        return (
            self.slo_target_s is None
            or launch.latency.expected_s <= self.slo_target_s
        )

    def _rank(self, candidates: list[LaunchSpec]) -> list[LaunchSpec]:
        def key(launch: LaunchSpec):
            eff = max(self.effective_slots(launch), 1e-9)
            return (
                self.price_of(launch) / eff,  # $ per effective slot-hour
                self.hazard_of(launch).rate_per_hour,
                launch.latency.expected_s,
                launch.template.name,  # total order: deterministic schedule
            )

        return sorted((c for c in candidates if self.feasible(c)), key=key)

    def replan(self, demand_slots: float) -> None:
        """The per-tick bid loop: re-rank the pool's open templates and
        record a ``market.plan`` whenever the mix changes (including the
        first tick)."""
        if self.scaler is None:
            return
        ranked = self._rank(self.scaler.pool.candidates())
        chosen = tuple(launch.template.name for launch in ranked)
        with self._lock:
            if chosen == self._last_plan:
                return
            self._last_plan = chosen
            self.plans += 1
            self._events.emit(
                "market.plan", demand=float(demand_slots), chosen=",".join(chosen)
            )

    def choose(
        self, candidates: list[LaunchSpec], deficit: float
    ) -> Optional[LaunchSpec]:
        """One acquisition's bid: the cheapest feasible candidate, greedily
        (the scale-out loop calls again while the deficit persists, which
        is the knapsack fill).  None when nothing is feasible."""
        ranked = self._rank(candidates)
        if not ranked:
            return None
        launch = ranked[0]
        name = launch.template.name
        with self._lock:
            price = self._prices.get(name, launch.price_per_slot_hour)
            eff = self.effective_slots(launch)
            self.bids += 1
            self.bids_by_template[name] = self.bids_by_template.get(name, 0) + 1
            self.bid_log.append((get_clock().now(), name, price, eff))
            self._events.emit(
                "market.bid", template=name, price=price, eff_slots=eff
            )
        return launch

    # -- settlement ------------------------------------------------------
    def settle(self, launch: LaunchSpec, name: str, row: dict) -> None:
        """Fold one instance's occupancy into the cost ledger (idempotent:
        release, loss, and shutdown paths may all reach the same row)."""
        arrived = row.get("arrived_at")
        if arrived is None:
            return  # never lived: no occupancy, no spend
        end = row.get("released_at")
        if end is None:
            end = get_clock().now()
        node_s = max(0.0, end - arrived)
        with self._lock:
            if name in self._settled:
                return
            self._settled.add(name)
            dollars = (
                node_s / 3600.0 * self.price_of(launch) * launch.slots_per_instance
            )
            self.cost_node_seconds += node_s
            self.cost_dollars += dollars
            self._events.emit(
                "market.spend", instance=name, node_s=node_s, dollars=dollars
            )

    # -- reporting -------------------------------------------------------
    def cost_report(self) -> dict:
        """Settled spend + the bid schedule summary (exp13's cost tables).
        Deterministic for a seeded virtual-clock run."""
        with self._lock:
            return {
                "node_seconds": self.cost_node_seconds,
                "dollars": self.cost_dollars,
                "settled_instances": len(self._settled),
                "plans": self.plans,
                "bids": self.bids,
                "bids_by_template": dict(self.bids_by_template),
            }

    def stats(self) -> dict:
        """Log-derived view adapter (the legacy accumulators stay as
        HYDRA_EVENTS_CHECK ground truth)."""
        if self._events is None:
            return {"plans": 0, "bids": 0, "reprices": 0, "cost_dollars": 0.0}
        self._events.maybe_check()
        view = self._events.view
        return {
            "plans": int(view.get("hydra.market.plans")),
            "bids": int(view.get("hydra.market.bids")),
            "reprices": int(view.get("hydra.market.reprices")),
            "cost_node_seconds": view.get("hydra.cost_node_seconds"),
            "cost_dollars": view.get("hydra.cost_dollars"),
        }
