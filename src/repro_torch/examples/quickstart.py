"""Quickstart: broker a heterogeneous workload across cloud + HPC pools.

Counterpart of ``examples/quickstart.py``.  Runs on a CUDA device unless the
caller asks for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Shows the four public API classes from the paper (Provider via ProviderSpec,
Service via the broker's managers, Resource, Task), SCPP-vs-MCPP
partitioning, and the OVH/TH/TPT/TTX metrics.  The compute task trains the
reduced llama3-8b one step on the broker's device (the flash attention
kernel and its backward on the card).
"""
from __future__ import annotations

import argparse

from repro_torch.core import Hydra, ProviderSpec, Resources, Task


def main(device: str = "cuda", n_noops: int = 500, n_sleeps: int = 50) -> dict:
    """Run the workload; returns the submission's states, metrics and the
    train task's result."""
    # 1. Start the broker (Service Proxy + Provider Proxy inside).
    hydra = Hydra(policy="load_aware", pod_store="memory", partitioning="mcpp", tasks_per_pod=32, device=device)

    # 2. Register providers: two cloud pools + one HPC pilot pool.
    hydra.register_provider(ProviderSpec(name="jet2", platform="cloud", concurrency=4))
    hydra.register_provider(ProviderSpec(name="aws", platform="cloud", concurrency=4))
    hydra.register_provider(ProviderSpec(name="bridges2", platform="hpc", connector="pilot", concurrency=8))

    # 3. A heterogeneous workload: noops (overhead probes), sleeps (work), a
    #    python callable, and a train-step "container" task.
    tasks = (
        [Task(kind="noop") for _ in range(n_noops)]
        + [Task(kind="sleep", duration=0.005) for _ in range(n_sleeps)]
        + [Task(kind="callable", fn=lambda: sum(range(1000)))]
        + [Task(kind="compute", arch="llama3-8b", step_kind="train", resources=Resources(cpus=2, accels=1))]
    )

    # 4. Submit (bind -> partition -> serialize -> bulk dispatch), then wait.
    try:
        sub = hydra.submit(tasks)
        sub.wait(timeout=300)

        # 5. The paper's metrics, derived from traces.
        m = sub.metrics()
        print(f"states       : {sub.states}")
        print(f"OVH          : {m.ovh*1e3:.1f} ms  (phases: { {k: round(v*1e3,1) for k,v in m.phases.items()} } ms)")
        print(f"TH           : {m.th:,.0f} tasks/s")
        print(f"TPT          : {m.tpt*1e3:.1f} ms")
        print(f"TTX          : {m.ttx*1e3:.1f} ms")
        train_result = tasks[-1].result()
        print(f"train metrics: {train_result}")
    finally:
        hydra.shutdown()
    print("OK")
    return {"states": dict(sub.states), "metrics": m, "train": train_result}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
