"""Declarative scenario specs: plain dataclasses, fully JSON round-trippable.

Counterpart of ``repro/scenarios/spec.py``, copied with its imports
rewritten; a spec's dict form is the same in both packages.

A spec is *data* — fleet shape, traffic mix, chaos schedule, invariant
bounds — so a scenario can live in version control, ship to nightly CI, and
be rebuilt bit-identically from its dict form.  ``to_core`` methods turn
declarations into the live core objects (ProviderSpec / LaunchSpec / chaos
events) at run time, inside the runner's active clock.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

from repro_torch.core.autoscaler import LatencyModel, LaunchSpec
from repro_torch.core.chaos import (
    ChaosEvent,
    LinkWindow,
    PreemptKill,
    QuarantineStorm,
    SiteOutage,
)
from repro_torch.core.admission import TenantSpec
from repro_torch.core.provider import ProviderSpec


@dataclass
class TenantDecl:
    """One tenant at the broker's front door (core/admission.py): fair-share
    weight plus optional rate limit and queue bound.  ``None`` for rate /
    max_queued means unlimited — scenario presets declare weights only, so
    the bulk up-front workflow admission is never rejected and fairness
    still shapes the drain order."""

    name: str
    weight: float = 1.0
    rate: Optional[float] = None  # admissions/s (token-bucket refill)
    burst: Optional[float] = None  # bucket depth (default: rate)
    max_queued: Optional[int] = None  # bound on admitted-but-unfinished

    def to_core(self) -> TenantSpec:
        return TenantSpec(
            name=self.name,
            rate=self.rate,
            burst=self.burst,
            max_queued=self.max_queued,
            weight=self.weight,
        )


@dataclass
class ProviderDecl:
    """One statically-registered provider (the paper's standing platforms)."""

    name: str
    platform: str = "cloud"
    connector: str = "caas"  # "caas" | "pilot"
    concurrency: int = 8
    n_nodes: int = 1

    def to_core(self) -> ProviderSpec:
        return ProviderSpec(
            name=self.name,
            platform=self.platform,
            connector=self.connector,
            concurrency=self.concurrency,
            n_nodes=self.n_nodes,
        )


@dataclass
class ElasticDecl:
    """One launchable template for the autoscaler's ProviderPool.  The
    latency is FIXED by default: scenario determinism should hinge on the
    seeded chaos/transfer draws, not on acquisition-latency sampling."""

    template: str
    platform: str = "cloud"
    connector: str = "caas"
    concurrency: int = 8
    min_instances: int = 0
    max_instances: int = 4
    latency_s: float = 15.0
    # market knobs (core/market.py): a price makes the template biddable by
    # the MarketPlanner; an explicit hazard rate models spot-style reclaim
    # pressure (None = the platform default in market._DEFAULT_HAZARD)
    price_per_slot_hour: float = 0.0
    hazard_rate_per_hour: Optional[float] = None

    def to_core(self) -> LaunchSpec:
        hazard = None
        if self.hazard_rate_per_hour is not None:
            from repro_torch.core.market import PreemptionHazard

            hazard = PreemptionHazard(rate_per_hour=self.hazard_rate_per_hour)
        return LaunchSpec(
            template=ProviderSpec(
                name=self.template,
                platform=self.platform,
                connector=self.connector,
                concurrency=self.concurrency,
            ),
            min_instances=self.min_instances,
            max_instances=self.max_instances,
            latency=LatencyModel(distribution="fixed", mean_s=self.latency_s),
            price_per_slot_hour=self.price_per_slot_hour,
            hazard=hazard,
        )


@dataclass
class TrafficSpec:
    """The heterogeneous mix (paper §2): a FACTS sea-rise ensemble plus
    training and serving traffic shapes sharing the same fleet."""

    facts_members: int = 0
    # per-stage modeled runtimes (pre, fit, proj, post), seconds
    facts_durations: tuple = (2.0, 1.0, 3.0, 0.5)
    train_jobs: int = 0
    train_blocks: int = 3  # checkpoint-delimited step blocks per job
    train_block_s: float = 6.0
    serve_waves: int = 0
    serve_tasks_per_wave: int = 8
    serve_task_s: float = 0.5
    # real compute on the wire: a non-empty tuple switches the serve lane
    # from modeled sleeps to ``kind="kernel"`` payloads cycling through
    # these kernels/registry.py names (tiny shapes, so waves stay cheap)
    serve_kernels: tuple = ()
    serve_kernel_reps: int = 1


@dataclass
class ChaosDecl:
    """One declarative chaos event; ``to_core`` maps it onto the typed
    event dataclasses in core/chaos.py."""

    kind: str  # site_outage | link_window | quarantine_storm | preempt_kill
    at_s: float
    site: Optional[str] = None
    duration_s: float = 0.0
    src_platform: str = "cloud"
    dst_platform: str = "hpc"
    factor: float = 0.0
    bidirectional: bool = True
    template: Optional[str] = None
    count: int = 1
    provider: Optional[str] = None

    def to_core(self) -> ChaosEvent:
        if self.kind == "site_outage":
            return SiteOutage(at_s=self.at_s, site=self.site)
        if self.kind == "link_window":
            return LinkWindow(
                at_s=self.at_s,
                duration_s=self.duration_s,
                src_platform=self.src_platform,
                dst_platform=self.dst_platform,
                factor=self.factor,
                bidirectional=self.bidirectional,
            )
        if self.kind == "quarantine_storm":
            return QuarantineStorm(
                at_s=self.at_s, template=self.template, duration_s=self.duration_s
            )
        if self.kind == "preempt_kill":
            return PreemptKill(
                at_s=self.at_s, count=self.count, provider=self.provider
            )
        raise ValueError(f"unknown chaos event kind {self.kind!r}")


@dataclass
class ScenarioSpec:
    name: str
    seed: int = 0
    policy: str = "data_gravity"
    providers: list[ProviderDecl] = field(default_factory=list)
    elastic: list[ElasticDecl] = field(default_factory=list)
    traffic: TrafficSpec = field(default_factory=TrafficSpec)
    tenants: list[TenantDecl] = field(default_factory=list)
    chaos: list[ChaosDecl] = field(default_factory=list)
    # broker shape
    tasks_per_pod: int = 16
    batch_window: float = 0.001
    site_capacity_mb: Optional[float] = None
    # market scheduler + task checkpoints (core/market.py, ckpt/checkpoint.py):
    # a makespan/SLO target arms a MarketPlanner over the elastic templates;
    # a checkpoint interval attaches a TaskCheckpointer so preempt-killed
    # tasks resume from progress_frac instead of restarting
    market_slo_s: Optional[float] = None
    checkpoint_interval_s: Optional[float] = None
    # kernel autotuner (kernels/autotune.py): attach a modeled-timer tuner
    # to the broker so serve-lane kernels are pre-tuned at run start —
    # winners land as pinned datasets and kernel.tune events on the bus
    kernel_autotune: bool = False
    # invariant bounds
    max_makespan_inflation: float = 1.5
    timeout_s: float = 3600.0

    # -- (de)serialization ---------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        d["providers"] = [ProviderDecl(**p) for p in d.get("providers", [])]
        d["elastic"] = [ElasticDecl(**e) for e in d.get("elastic", [])]
        d["tenants"] = [
            t if isinstance(t, TenantDecl) else TenantDecl(**t)
            for t in d.get("tenants", [])
        ]
        traffic = d.get("traffic", {})
        if isinstance(traffic, dict):
            traffic = dict(traffic)
            if "facts_durations" in traffic:
                traffic["facts_durations"] = tuple(traffic["facts_durations"])
            if "serve_kernels" in traffic:
                traffic["serve_kernels"] = tuple(traffic["serve_kernels"])
            d["traffic"] = TrafficSpec(**traffic)
        d["chaos"] = [
            c if isinstance(c, ChaosDecl) else ChaosDecl(**c)
            for c in d.get("chaos", [])
        ]
        return cls(**d)
