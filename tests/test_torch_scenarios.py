"""The port's scenario harness (repro_torch/scenarios) against the reference.

Every preset's spec must serialize to the same JSON in both packages.  Two
scenarios then run through the port on the CPU (``device="cpu"``), each as
the chaos run and its no-chaos twin: ``searise_smoke`` (modeled work only)
and the shrunken ``searise_kernels`` of tests/test_kernel_tasks.py:179-190,
whose serve lane runs all four kernels with task checkpoints and the
autotuner on.  Both must hold every invariant with zero failed tasks.

Their fingerprints are held against the reference's ``ScenarioReport``
computed from the reference's own traffic builder and chaos schedule, for a
run with every task resolved -- not against a reference run: the
reference's same-seed event stream and its kernel-chaos exec counts are not
ground truth on this tree (ROADMAP.md, queue 3), and its scenario tests
fail in some runs.  Each spec's (virtual) timeout is cut to 120 s, so a
hang fails instead of stalling the suite.
"""
from __future__ import annotations

import json

import pytest
import torch

from repro.core.chaos import ChaosEngine as JChaosEngine
from repro.core.staging import DatasetRegistry as JDatasetRegistry
from repro.scenarios import presets as jpresets
from repro.scenarios.runner import ScenarioReport as JScenarioReport
from repro.scenarios.traffic import build_traffic as jbuild_traffic
from repro_torch.kernels import ops
from repro_torch.kernels import registry as kreg
from repro_torch.scenarios import ScenarioSpec, check_invariants, presets, run_scenario

torch.set_num_threads(1)

PRESETS = ("searise_smoke", "searise_kernels", "searise_at_scale", "searise_full")
TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _strict_checks(monkeypatch):
    monkeypatch.setenv("HYDRA_EVENTS_CHECK", "1")
    monkeypatch.setenv("HYDRA_LEDGER_CHECK", "1")


def _shrunken_kernels_spec(pmod, seed: int = 0):
    """tests/test_kernel_tasks.py:179-190: searise_kernels at tier-1 size."""
    spec = pmod.searise_kernels(seed)
    spec.traffic.facts_members = 6
    spec.traffic.train_jobs = 1
    spec.traffic.serve_waves = 1
    spec.traffic.serve_tasks_per_wave = 4
    spec.traffic.serve_kernel_reps = 1
    spec.timeout_s = TIMEOUT_S
    return spec


def _smoke_spec(pmod, seed: int = 0):
    spec = pmod.searise_smoke(seed)
    spec.timeout_s = TIMEOUT_S
    return spec


def _reference_fingerprint(jspec, chaos: bool) -> tuple:
    """The reference's fingerprint and schedule of a run of ``jspec`` in
    which every task resolved and none failed."""
    wfs = jbuild_traffic(JDatasetRegistry(), jspec.traffic, prefix=jspec.name)
    rep = JScenarioReport(name=jspec.name, seed=jspec.seed, chaos_enabled=chaos)
    rep.n_workflows = len(wfs)
    rep.n_tasks = sum(len(wf.tasks) for wf in wfs)
    if chaos:
        rep.event_schedule = JChaosEngine(None, [c.to_core() for c in jspec.chaos], seed=jspec.seed).planned()
    return rep.fingerprint(), rep.event_schedule, rep.n_tasks


@pytest.mark.parametrize("preset", PRESETS)
def test_spec_json_is_the_references(preset):
    port, ref = getattr(presets, preset)(seed=3), getattr(jpresets, preset)(seed=3)
    blob = json.dumps(port.to_dict(), sort_keys=True)
    assert blob == json.dumps(ref.to_dict(), sort_keys=True)
    assert json.dumps(ScenarioSpec.from_dict(json.loads(blob)).to_dict(), sort_keys=True) == blob


@pytest.mark.parametrize("make_spec", [_smoke_spec, _shrunken_kernels_spec], ids=["smoke", "kernels"])
def test_scenario_holds_its_invariants_on_the_cpu_like_the_reference(make_spec):
    spec, jspec = make_spec(presets), make_spec(jpresets)
    before = ops.launch_counts()
    chaos = run_scenario(spec, chaos=True, device="cpu")
    base = run_scenario(spec, chaos=False, device="cpu")
    assert check_invariants(chaos, base, spec) == []
    for report in (chaos, base):
        want_fp, want_schedule, n_tasks = _reference_fingerprint(jspec, report.chaos_enabled)
        assert report.n_tasks == n_tasks
        assert report.failed_tasks == 0 and report.unresolved_tasks == 0
        assert report.ledger_error is None and report.events_error is None
        assert [tuple(e) for e in report.event_schedule] == [tuple(e) for e in want_schedule]
        assert report.fingerprint() == want_fp
    kernels = tuple(spec.traffic.serve_kernels)
    for report in (chaos, base):
        k = report.kernel
        if not kernels:
            assert k["execs"] == 0 and k["tunes"] == 0
            continue
        assert k["tunes"] == len(kernels)  # pre-tuned once each, on the CPU
        n = spec.traffic.serve_waves * spec.traffic.serve_tasks_per_wave
        assert k["execs"] >= n and set(k["execs_by"]) == set(kernels)
        assert k["reps"] >= n * spec.traffic.serve_kernel_reps and k["seconds"] > 0
    assert chaos.chaos_stats["injected"]
    assert ops.launch_counts() == before  # CPU providers ran the plain versions


def test_scenario_on_the_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_scenario(_smoke_spec(presets), chaos=False)


def test_build_broker_attaches_what_the_spec_asks_for_on_its_device():
    from repro_torch.core.broker import Hydra
    from repro_torch.runtime.clock import virtual_time
    from repro_torch.scenarios.runner import build_broker

    spec = _shrunken_kernels_spec(presets)
    with virtual_time():
        h = build_broker(spec, device="cpu")
        assert isinstance(h, Hydra) and h.checkpointer is not None and h.autoscaler is not None
        assert h.autotuner is not None and h.autotuner.timer == "model"
        for name in spec.traffic.serve_kernels:
            r = h.autotuner.tune(name, kreg.get_kernel(name).tiny_shape, "float32")
            assert r.key.startswith(f"tune:{name}:cpu:")
            assert h.staging.registry.get(r.key).pinned
        h.shutdown(wait=True)
