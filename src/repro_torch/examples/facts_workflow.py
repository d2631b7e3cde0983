"""FACTS sea-level workflow at scale (paper Experiment 4, scaled down).

Counterpart of ``examples/facts_workflow.py``.  Runs on a CUDA device unless
the caller asks for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.facts_workflow [n_instances] [--device cpu]

Runs N concurrent 4-stage FACTS workflow instances (pre-processing ->
fitting -> projecting -> post-processing) across a cloud pool and an HPC
pilot, the fit and project stages on the device, then prints the
ensemble's end-of-century sea-level-rise quantiles.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import Hydra, ProviderSpec, WorkflowManager
from repro_torch.facts.workflow import make_workflow, result_of


def main(n_instances: int = 16, n_samples: int = 500, device: str = "cuda") -> dict:
    """Run the instances; every workflow must end done and none failed.
    Returns the wall seconds, each instance's p50 and the stream stats."""
    # streaming=True: readiness events from all instances coalesce in the
    # broker's micro-batching dispatcher instead of one submit() per frontier
    hydra = Hydra(policy="load_aware", pod_store="memory", streaming=True, device=device)
    hydra.register_provider(ProviderSpec(name="jet2", platform="cloud", concurrency=4))
    hydra.register_provider(ProviderSpec(name="aws", platform="cloud", concurrency=4))
    hydra.register_provider(ProviderSpec(name="bridges2", platform="hpc", connector="pilot", concurrency=8))

    try:
        wfm = WorkflowManager(hydra)
        workflows = [make_workflow(hydra.data, i, n_samples=n_samples, device=device) for i in range(n_instances)]

        t0 = time.perf_counter()
        wfm.run(workflows)
        ttx = time.perf_counter() - t0

        if not all(w.done and not w.failed for w in workflows):
            raise AssertionError(f"workflows not done or failed: {[w.name for w in workflows if not w.done or w.failed]}")
        p50s = [result_of(hydra.data, i)["quantiles"]["p50"] for i in range(n_instances)]
        print(f"{n_instances} FACTS instances in {ttx:.2f}s "
              f"({4*n_instances} tasks, {4*n_instances/ttx:.1f} tasks/s)")
        print(f"median 2100 rise across sites: {np.median(p50s):.0f} mm "
              f"(site spread {np.min(p50s):.0f}..{np.max(p50s):.0f} mm)")
        stats = hydra.stream_stats()
        print(f"streaming: {stats['batches']} micro-batches, "
              f"{stats['n_submits']} pipeline rounds, {stats['n_pods']} pods")
    finally:
        hydra.shutdown()
    print("OK")
    return {"wall_s": ttx, "p50s": p50s, "stream_stats": stats}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_instances", nargs="?", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n_instances, device=args.device)
