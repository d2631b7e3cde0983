"""Canonical scenario specs.

Counterpart of ``repro/scenarios/presets.py``, copied with its imports
rewritten: the same specs, so both packages run the same scenarios.

``searise_at_scale`` is the acceptance scenario from the ISSUE: a ≥1k-member
FACTS sea-rise ensemble mixed with training and serving traffic on a
cloud+HPC fleet with an elastic burst pool, hit mid-run by four correlated
fault events — a whole-site outage, a provisioning quarantine storm, a
cloud<->HPC link partition, and a preempt-kill wave.  ``searise_smoke`` is
the same story at unit-test scale; ``searise_full`` is the nightly shape.

All runtimes are modeled (sleep tasks), all footprints are real (FACTS
stage sizes, checkpoint/corpus/snapshot bytes), so any scale runs in real
seconds under VirtualClock."""
from __future__ import annotations

from repro_torch.scenarios.spec import (
    ChaosDecl,
    ElasticDecl,
    ProviderDecl,
    ScenarioSpec,
    TenantDecl,
    TrafficSpec,
)

# fair-share weights only (no rate limits: preset traffic is admitted in one
# up-front bulk call per run, which a rate limit would reject).  ``serve`` is
# the interactive tenant — its lane preempts queued batch work regardless of
# weight; the weights shape the batch-lane split between facts and train.
_TENANTS = [
    TenantDecl(name="serve", weight=2.0),
    TenantDecl(name="facts", weight=2.0),
    TenantDecl(name="train", weight=1.0),
]


def _fleet(concurrency: int, burst_max: int, burst_latency_s: float):
    providers = [
        ProviderDecl(name="jet2", platform="cloud", concurrency=concurrency),
        ProviderDecl(name="chi", platform="cloud", concurrency=concurrency),
        ProviderDecl(name="aws", platform="cloud", concurrency=concurrency),
        ProviderDecl(
            name="bridges2",
            platform="hpc",
            connector="pilot",
            concurrency=concurrency,
        ),
    ]
    elastic = [
        ElasticDecl(
            template="burst",
            platform="cloud",
            concurrency=concurrency,
            max_instances=burst_max,
            latency_s=burst_latency_s,
        )
    ]
    return providers, elastic


def searise_smoke(seed: int = 0) -> ScenarioSpec:
    """Unit-test / bench-smoke scale: same fleet + event shapes, ~200 task-s."""
    providers, elastic = _fleet(concurrency=4, burst_max=2, burst_latency_s=8.0)
    return ScenarioSpec(
        name="searise-smoke",
        seed=seed,
        providers=providers,
        elastic=elastic,
        tenants=list(_TENANTS),
        traffic=TrafficSpec(
            facts_members=24,
            train_jobs=2,
            train_blocks=3,
            train_block_s=6.0,
            serve_waves=2,
            serve_tasks_per_wave=8,
            serve_task_s=0.5,
        ),
        # events land AFTER the cold-staging ramp (~20 virtual s: every
        # member's first task waits on the 2 GB forcing pull) so they hit
        # running tasks and in-flight transfers, not an idle fleet
        chaos=[
            ChaosDecl(kind="site_outage", at_s=25.0, site="jet2"),
            ChaosDecl(kind="quarantine_storm", at_s=26.0, template="burst", duration_s=15.0),
            ChaosDecl(
                kind="link_window",
                at_s=28.0,
                duration_s=8.0,
                src_platform="cloud",
                dst_platform="hpc",
                factor=0.0,  # partition
            ),
            ChaosDecl(kind="preempt_kill", at_s=32.0, count=4),
        ],
        # a permanent 1-of-4 site loss is a 25% capacity cut at this tiny
        # scale; the ISSUE's 1.5x bound is defined on searise_at_scale,
        # where the staging-bound ensemble absorbs it
        max_makespan_inflation=2.0,
    )


def searise_kernels(seed: int = 0) -> ScenarioSpec:
    """searise_smoke with REAL compute on the wire: the serve lane carries
    ``kind="kernel"`` payloads cycling through all four kernels at
    their tiny shapes, the broker pre-tunes them with the modeled-timer
    autotuner, and task checkpoints are armed so a preempt-killed kernel
    task resumes from its completed-rep boundary.  Same correlated fault
    schedule as the smoke preset — the acceptance run for "a scenario with
    kernel-payload tasks completes with zero failed tasks under chaos"."""
    spec = searise_smoke(seed)
    spec.name = "searise-kernels"
    spec.traffic.serve_kernels = (
        "flash_attention",
        "selective_scan",
        "rglru_scan",
        "moe_gmm",
    )
    spec.traffic.serve_kernel_reps = 2
    spec.kernel_autotune = True
    spec.checkpoint_interval_s = 2.0
    return spec


def searise_at_scale(seed: int = 0) -> ScenarioSpec:
    """The ISSUE's acceptance scenario: 1024 FACTS members + train/serve
    traffic, four correlated fault events including a whole-site outage and
    a cloud<->HPC partition, zero failed tasks, inflation <= 1.5x.

    No warm elastic floor: tasks parked on stage-in now register as decayed
    deferred demand (Dispatcher.deferred_demand), so the autoscaler holds
    burst capacity through a link partition on the signal itself instead of
    the old ``min_instances=2`` workaround."""
    providers, elastic = _fleet(concurrency=8, burst_max=4, burst_latency_s=15.0)
    return ScenarioSpec(
        name="searise-at-scale",
        seed=seed,
        providers=providers,
        elastic=elastic,
        tenants=list(_TENANTS),
        traffic=TrafficSpec(
            facts_members=1024,
            train_jobs=6,
            train_blocks=3,
            train_block_s=6.0,
            serve_waves=4,
            serve_tasks_per_wave=16,
            serve_task_s=0.5,
        ),
        chaos=[
            ChaosDecl(kind="site_outage", at_s=40.0, site="jet2"),
            ChaosDecl(kind="quarantine_storm", at_s=45.0, template="burst", duration_s=60.0),
            ChaosDecl(
                kind="link_window",
                at_s=60.0,
                duration_s=30.0,
                src_platform="cloud",
                dst_platform="hpc",
                factor=0.0,  # partition
            ),
            ChaosDecl(kind="preempt_kill", at_s=80.0, count=12),
        ],
    )


def searise_full(seed: int = 0) -> ScenarioSpec:
    """Nightly scale: a 2k-member ensemble and a longer fault sequence."""
    spec = searise_at_scale(seed)
    spec.name = "searise-full"
    spec.traffic.facts_members = 2048
    spec.traffic.train_jobs = 8
    spec.traffic.serve_waves = 8
    spec.chaos = spec.chaos + [
        ChaosDecl(
            kind="link_window",
            at_s=120.0,
            duration_s=20.0,
            src_platform="cloud",
            dst_platform="cloud",
            factor=0.1,  # degradation, not partition
        ),
        ChaosDecl(kind="preempt_kill", at_s=140.0, count=16),
    ]
    return spec
