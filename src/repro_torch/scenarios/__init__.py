"""Scenario harness: declarative fleet + traffic + chaos specs, a runner
that executes them under the active Clock, and an invariant checker that
turns "the pieces each work" into "the *system* works under adversity".

    from repro_torch.scenarios import presets, run_scenario, check_invariants

    spec = presets.searise_smoke()
    chaos_rep = run_scenario(spec, chaos=True)
    base_rep = run_scenario(spec, chaos=False)   # the no-chaos twin
    assert not check_invariants(chaos_rep, base_rep, spec)

Counterpart of ``repro/scenarios``.  The broker runs on the card by default;
pass ``device="cpu"`` to ``run_scenario`` to run it on the CPU.
"""
from repro_torch.scenarios.runner import (
    ScenarioReport,
    check_invariants,
    run_scenario,
)
from repro_torch.scenarios.spec import (
    ChaosDecl,
    ElasticDecl,
    ProviderDecl,
    ScenarioSpec,
    TrafficSpec,
)
from repro_torch.scenarios import presets

__all__ = [
    "ChaosDecl",
    "ElasticDecl",
    "ProviderDecl",
    "ScenarioReport",
    "ScenarioSpec",
    "TrafficSpec",
    "check_invariants",
    "presets",
    "run_scenario",
]
