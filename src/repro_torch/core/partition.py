"""Workload partitioning: tasks -> pods (paper §3.2, §5 SCPP/MCPP).

  SCPP (single container per pod)   - one task per pod; tasks run with their
        own resources.  Higher per-pod serialization cost (the paper measures
        ~46% extra OVH / ~44% lower TH vs MCPP).
  MCPP (multiple containers per pod) - tasks packed into pods that fit the
        provider's per-node capacity; co-scheduled tasks share pod resources.

``binpack`` is the heterogeneity-aware variant (first-fit-decreasing on task
cpu requirements) used for Exp 3B-style mixed workloads.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.pod import Pod
from repro_torch.core.task import Resources, Task


def partition(
    tasks: list[Task],
    provider: str,
    model: str = "mcpp",
    pod_capacity: Optional[Resources] = None,
    tasks_per_pod: int = 64,
) -> list[Pod]:
    if model == "scpp":
        return [Pod(provider, [t], "scpp") for t in tasks]
    if model == "mcpp":
        pods = []
        for i in range(0, len(tasks), tasks_per_pod):
            pods.append(Pod(provider, tasks[i : i + tasks_per_pod], "mcpp"))
        return pods
    if model == "binpack":
        cap = pod_capacity or Resources(cpus=16, accels=8, memory_mb=1 << 15)
        return _binpack(tasks, provider, cap)
    raise ValueError(model)


def _binpack(tasks: list[Task], provider: str, cap: Resources) -> list[Pod]:
    """First-fit-decreasing on (cpus, accels, memory)."""
    order = sorted(tasks, key=lambda t: (t.resources.cpus, t.resources.accels, t.resources.memory_mb), reverse=True)
    bins: list[tuple[Resources, list[Task]]] = []
    for t in order:
        placed = False
        for free, members in bins:
            if t.resources.fits(free):
                free.cpus -= t.resources.cpus
                free.accels -= t.resources.accels
                free.memory_mb -= t.resources.memory_mb
                members.append(t)
                placed = True
                break
        if not placed:
            if not t.resources.fits(cap):
                raise ValueError(
                    f"task {t.uid} requires {vars(t.resources)} exceeding pod capacity {vars(cap)}"
                )
            free = Resources(
                cap.cpus - t.resources.cpus, cap.accels - t.resources.accels, cap.memory_mb - t.resources.memory_mb
            )
            bins.append((free, [t]))
    return [Pod(provider, members, "binpack") for _, members in bins]
