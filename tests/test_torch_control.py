"""The port's control plane for elastic, costed and faulty fleets, against the
reference: core/autoscaler.py, core/market.py, core/chaos.py and
core/managers/workflow.py.

These modules are framework-free copies, so every seeded draw and every
decision must be equal: the latency draws, the provider pool's instance
names and bounds, the market's rankings, bids and hazard draws, and each
preset's chaos schedule.  The chaos engine is also fired on a manual clock
(``auto_advance=False``) against a port broker and a reference broker of the
same fleet, and must log the same events at the same times.  Last, a
workflow DAG runs through the port's broker in dependency order and the
broker's autoscaler attaches, scales and stops.
"""
from __future__ import annotations

import random
import threading

import pytest

from repro.core import Hydra as JHydra
from repro.core import ProviderSpec as JProviderSpec
from repro.core import autoscaler as jas
from repro.core import chaos as jchaos
from repro.core import market as jmarket
from repro.runtime.clock import virtual_time as jvirtual_time
from repro.scenarios import presets as jpresets
from repro_torch.core import Hydra, ProviderSpec, Task, TaskState
from repro_torch.core import autoscaler as tas
from repro_torch.core import chaos as tchaos
from repro_torch.core import market as tmarket
from repro_torch.core.managers.workflow import Workflow, WorkflowManager
from repro_torch.core.provider import ValidationError
from repro_torch.runtime.clock import virtual_time
from repro_torch.scenarios import presets as tpresets

from conftest import wait_until

PRESETS = ("searise_smoke", "searise_kernels", "searise_at_scale", "searise_full")


def _both(fn):
    """``fn(module set)`` for the reference and for the port."""
    ref = fn(jas, jmarket, jchaos, JProviderSpec)
    port = fn(tas, tmarket, tchaos, ProviderSpec)
    return ref, port


# ---------------------------------------------------------------------------
# autoscaler: latency draws, launch specs, the pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "model",
    [
        {"distribution": "lognormal", "mean_s": 45.0, "sigma": 0.25},
        {"distribution": "lognormal", "mean_s": 300.0, "sigma": 0.5},
        {"distribution": "uniform", "lo_s": 5.0, "hi_s": 30.0},
        {"distribution": "fixed", "mean_s": 15.0},
    ],
)
def test_latency_draws_equal_the_reference(model):
    def draws(asc, *_):
        m = asc.LatencyModel(**model)
        rng = random.Random(11)
        return [m.sample(rng) for _ in range(32)], m.expected_s

    ref, port = _both(draws)
    assert port == ref


def test_launch_spec_defaults_and_validation_equal_the_reference():
    def specs(asc, _m, _c, PS):
        out = []
        for platform in ("cloud", "hpc"):
            ls = asc.LaunchSpec(template=PS(name=f"t-{platform}", platform=platform, concurrency=3, n_nodes=2))
            out.append((ls.latency, ls.slots_per_instance))
        for bad in ({"min_instances": 3, "max_instances": 1}, {"price_per_slot_hour": -1.0}):
            try:
                asc.LaunchSpec(template=PS(name="bad"), **bad)
            except Exception as exc:  # noqa: BLE001 - compared by type name
                out.append(type(exc).__name__)
        return [repr(x) for x in out]

    ref, port = _both(specs)
    assert port == ref
    assert port[-2:] == ["'ValidationError'"] * 2
    with pytest.raises(ValidationError):
        tas.ProviderPool([])


def test_provider_pool_names_and_bounds_equal_the_reference():
    def script(asc, _m, _c, PS):
        cloud = asc.LaunchSpec(
            template=PS(name="burst", platform="cloud", concurrency=4),
            min_instances=1, max_instances=3,
            latency=asc.LatencyModel(distribution="fixed", mean_s=15.0),
        )
        hpc = asc.LaunchSpec(
            template=PS(name="queue", platform="hpc", connector="pilot"),
            max_instances=2, latency=asc.hpc_queue_wait(mean_s=600.0),
        )
        pool = asc.ProviderPool([hpc, cloud], seed=5)
        trail = []

        def snap(tag):
            rel, ab = pool.releasable(), pool.abortable()
            trail.append((
                tag,
                [s.template.name for s in pool.candidates()],
                [s.template.name for s in pool.below_min()],
                pool.counts(),
                pool.live_instances(),
                rel and rel[1],
                ab and ab[1],
                pool.quarantined(),
            ))

        snap("empty")
        names = [pool.request_instance(cloud).name for _ in range(3)]
        snap("three pending")
        pool.note_live(cloud, names[0])
        pool.note_live(cloud, names[2])
        pool.note_gone(cloud, names[1])
        snap("two live")
        pool.note_live(hpc, pool.request_instance(hpc).name)
        pool.note_failed(hpc, pool.request_instance(hpc).name)
        snap("hpc failure")
        pool.force_quarantine("burst")
        snap("quarantined")
        pool.rehabilitate("burst")
        trail.append(("again", pool.request_instance(cloud).name, [cloud.latency.sample(pool.rng) for _ in range(3)]))
        return trail

    ref, port = _both(script)
    assert port == ref


# ---------------------------------------------------------------------------
# market: hazards, rankings, bids
# ---------------------------------------------------------------------------


def test_preemption_hazard_draws_equal_the_reference():
    def draws(_a, mk, *_):
        h = mk.PreemptionHazard(rate_per_hour=6.0)
        rng = random.Random(3)
        names = [f"spot-{i}" for i in range(40)]
        return (
            [h.sample_kills(rng, names, w) for w in (60.0, 600.0, 3600.0)],
            h.survival_p(900.0),
            h.expected_loss_frac(60.0),
            [mk._DEFAULT_HAZARD[p].rate_per_hour for p in ("cloud", "hpc")],
        )

    ref, port = _both(draws)
    assert port == ref


class _FakeScaler:
    """What MarketPlanner.bind reads: the broker's event bus and a pool."""

    def __init__(self, events, pool):
        self.broker = type("B", (), {"events": events})()
        self.pool = pool


def test_market_rankings_and_bids_equal_the_reference():
    from repro.core.events import EventBus as JEventBus
    from repro_torch.core.events import EventBus

    def plan(asc, mk, _c, PS, bus_cls, clock):
        def spec(name, platform, price, latency_s, hazard=None, conc=4):
            return asc.LaunchSpec(
                template=PS(name=name, platform=platform, concurrency=conc),
                max_instances=4, price_per_slot_hour=price,
                latency=asc.LatencyModel(distribution="fixed", mean_s=latency_s),
                hazard=None if hazard is None else mk.PreemptionHazard(rate_per_hour=hazard),
            )

        specs = [
            spec("spot", "cloud", 0.9, 30.0, hazard=6.0),
            spec("ondemand", "cloud", 3.0, 45.0),
            spec("hpc", "hpc", 1.5, 600.0),
            spec("cheap-slow", "cloud", 0.5, 1200.0, conc=8),
        ]
        out = []
        with clock(auto_advance=False) as clk:
            for slo in (None, 900.0):
                pool = asc.ProviderPool(specs, seed=1)
                bus = bus_cls(strict=False)
                planner = mk.MarketPlanner(slo_target_s=slo, recovery_cost_s=120.0, seed=1)
                planner.bind(_FakeScaler(bus, pool))
                out.append([s.template.name for s in planner._rank(pool.candidates())])
                out.append([round(planner.effective_slots(s), 9) for s in specs])
                planner.replan(12.0)
                planner.set_price("spot", 4.0)
                clk.advance(5.0)
                for _ in range(3):
                    chosen = planner.choose(pool.candidates(), 8.0)
                    out.append(chosen and chosen.template.name)
                planner.replan(12.0)
                out.append((planner.bid_log, planner.plans, planner.bids, dict(planner.bids_by_template), planner.reprices))
                out.append([(e.name, e.attrs) for e in bus.events()])
        return out

    ref = plan(jas, jmarket, jchaos, JProviderSpec, JEventBus, jvirtual_time)
    port = plan(tas, tmarket, tchaos, ProviderSpec, EventBus, virtual_time)
    assert port == ref


# ---------------------------------------------------------------------------
# chaos: schedules, and the engine fired on a manual clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_chaos_schedule_of_each_preset_equals_the_reference(preset):
    def planned(pmod, chaos_mod):
        spec = getattr(pmod, preset)(seed=4)
        return chaos_mod.ChaosEngine(None, [c.to_core() for c in spec.chaos], seed=spec.seed).planned()

    ref, port = planned(jpresets, jchaos), planned(tpresets, tchaos)
    assert port == ref and len(port) >= 4


def _fire_chaos(hydra_cls, spec_cls, asc, chaos_mod, clock, **kw):
    """A fleet with no work, an autoscaler over a burst template, and one
    event of each kind, fired by advancing a manual clock."""
    with clock(auto_advance=False) as clk:
        h = hydra_cls(pod_store="memory", streaming=True, **kw)
        h.register_provider(spec_cls(name="a", platform="cloud"))
        h.register_provider(spec_cls(name="b", platform="cloud"))
        h.register_provider(spec_cls(name="c", platform="hpc", connector="pilot"))
        pool = asc.ProviderPool(
            [asc.LaunchSpec(template=spec_cls(name="burst", platform="cloud"), max_instances=2,
                            latency=asc.LatencyModel(distribution="fixed", mean_s=15.0))],
            seed=2,
        )
        scaler = h.autoscale(pool, tick_s=1.0)
        events = [
            chaos_mod.SiteOutage(at_s=5.0, site="a"),
            chaos_mod.LinkWindow(at_s=6.0, duration_s=3.0, src_platform="cloud", dst_platform="hpc", factor=0.0),
            chaos_mod.QuarantineStorm(at_s=7.0, template="burst", duration_s=4.0),
            chaos_mod.PreemptKill(at_s=8.0, count=2),
        ]
        engine = chaos_mod.ChaosEngine(h, events, seed=9).arm()
        seen = []
        for _ in range(14):
            clk.advance(1.0)
            seen.append((scaler.pool.quarantined(), sorted(p.name for p in h.proxy.healthy())))
        engine.stop()
        log = [(e["t"], e["kind"], e["target"], e["detail"]) for e in engine.log]
        stats = engine.stats()
        h.shutdown(wait=True)
    return log, stats, seen


def test_chaos_engine_on_a_manual_clock_logs_what_the_reference_logs(tmp_path):
    ref = _fire_chaos(JHydra, JProviderSpec, jas, jchaos, jvirtual_time, workdir=str(tmp_path / "ref"))
    port = _fire_chaos(Hydra, ProviderSpec, tas, tchaos, virtual_time, workdir=str(tmp_path / "port"), device="cpu")
    assert port == ref
    log, stats, seen = port
    assert [k for _, k, _, _ in log] == ["site_outage", "link_window", "quarantine_storm", "preempt_kill", "link_restore", "quarantine_lift"]
    assert stats["injected"] == {k: 1 for k in ("link_restore", "link_window", "preempt_kill", "quarantine_lift", "quarantine_storm", "site_outage")}
    assert seen[7][0] == ["burst"] and seen[-1][0] == []
    assert "a" not in seen[-1][1]


# ---------------------------------------------------------------------------
# workflows and the broker's autoscaler
# ---------------------------------------------------------------------------


def test_workflow_dag_completes_in_dependency_order(tmp_path):
    h = Hydra(device="cpu", pod_store="memory", streaming=True, batch_window=0.0, workdir=str(tmp_path))
    h.register_provider(ProviderSpec(name="cloud", concurrency=4))
    order, lock = [], threading.Lock()

    def step(name):
        def fn():
            with lock:
                order.append(name)
            return name

        return fn

    wfs = []
    for i in range(3):
        wf = Workflow(f"diamond.{i}")
        top = wf.add(Task(kind="callable", fn=step(f"{i}.top")))
        left = wf.add(Task(kind="callable", fn=step(f"{i}.left")), deps=[top])
        right = wf.add(Task(kind="callable", fn=step(f"{i}.right")), deps=[top])
        wf.add(Task(kind="callable", fn=step(f"{i}.bottom")), deps=[left, right])
        wfs.append(wf)
    WorkflowManager(h).run(wfs, wait=True, timeout=60.0)
    assert all(wf.done and not wf.failed for wf in wfs)
    assert all(t.tstate == TaskState.DONE for wf in wfs for t in wf.tasks)
    for i in range(3):
        pos = {n: order.index(f"{i}.{n}") for n in ("top", "left", "right", "bottom")}
        assert pos["top"] < pos["left"] < pos["bottom"] and pos["top"] < pos["right"] < pos["bottom"]
    cyclic = Workflow("cyclic")
    a = Task(kind="noop")
    b = cyclic.add(Task(kind="noop"), deps=[a])
    with pytest.raises(ValueError, match="cycle"):
        cyclic.add(a, deps=[b])
    h.shutdown(wait=True)


def test_broker_autoscaler_acquires_under_pressure_and_stops_with_the_broker(tmp_path):
    with virtual_time():
        h = Hydra(device="cpu", streaming=True, pod_store="memory", batch_window=0.002, max_batch=64, workdir=str(tmp_path))
        h.register_provider(ProviderSpec(name="seed", platform="cloud", concurrency=2))
        pool = tas.ProviderPool(
            [tas.LaunchSpec(template=ProviderSpec(name="jet2", platform="cloud", concurrency=4), max_instances=4,
                            latency=tas.cloud_startup(mean_s=20.0))],
            seed=7,
        )
        scaler = h.autoscale(pool, tick_s=1.0, warmup_ticks=2, cooldown_ticks=3)
        with pytest.raises(RuntimeError, match="already attached"):
            h.autoscale(pool)
        tasks = [Task(kind="sleep", duration=4.0) for _ in range(48)]
        h.dispatch(tasks)
        assert wait_until(lambda: all(t.done() for t in tasks), timeout=30.0)
        assert all(t.tstate == TaskState.DONE and t.exception() is None for t in tasks)
        assert scaler.arrivals >= 2
        assert {t.provider for t in tasks} - {"seed"}
        stats = h.scale_stats()
        assert stats["autoscaler"]["arrivals"] == scaler.arrivals
        assert h.events.view.get("hydra.scale.arrivals") == scaler.arrivals
        h.shutdown(wait=True)
        assert scaler._thread is None or not scaler._thread.is_alive()
