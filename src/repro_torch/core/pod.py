"""Pod: a dispatch group of tasks submitted to a provider in one bulk call.

The paper's CaaS Manager partitions a workload into pods and *serializes each
pod* before submission.  The published implementation writes pods to disk
(identified in §5.1/§6 as Hydra's throughput bottleneck, ~46% extra OVH with
SCPP); in-memory pod construction is the paper's named future-work fix.  Both
stores are implemented here so the benchmark suite can measure the exact
trade-off (EXPERIMENTS.md §Perf):

  DiskPodStore    - faithful baseline: one JSON file per pod, fsync'd.
  MemoryPodStore  - optimized: pods serialized to bytes in memory.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.core.task import Task, describe
from repro_torch.runtime.tracing import Counter, Trace

_ids = Counter("pod")


class Pod:
    def __init__(self, provider: str, tasks: list[Task], model: str):
        self.uid = _ids.next()
        self.provider = provider
        self.tasks = tasks
        self.model = model  # "mcpp" | "scpp"
        self.trace = Trace()
        self.serialized: Optional[bytes] = None
        self.path: Optional[str] = None
        # micro-batch provenance: which streaming-dispatcher batch coalesced
        # this pod (None for classic frontier-mode submissions)
        self.batch_id: Optional[str] = None
        for t in tasks:
            t.pod_uid = self.uid

    @property
    def size(self) -> int:
        return len(self.tasks)

    def describe(self) -> dict:
        return {
            "uid": self.uid,
            "provider": self.provider,
            "model": self.model,
            "batch_id": self.batch_id,
            "tasks": [describe(t) for t in self.tasks],
        }


class PodStore:
    def serialize(self, pod: Pod) -> None:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass


class MemoryPodStore(PodStore):
    """Optimized: build + serialize pods in memory (paper future work)."""

    def serialize(self, pod: Pod) -> None:
        pod.serialized = json.dumps(pod.describe()).encode()


class DiskPodStore(PodStore):
    """Faithful baseline: write each pod descriptor to its own file."""

    def __init__(self, workdir: str, fsync: bool = True):
        self.workdir = workdir
        self.fsync = fsync
        os.makedirs(workdir, exist_ok=True)

    def serialize(self, pod: Pod) -> None:
        payload = json.dumps(pod.describe(), indent=2).encode()
        path = os.path.join(self.workdir, f"{pod.uid}.json")
        with open(path, "wb") as f:
            f.write(payload)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        pod.path = path
        # faithful: the submission path re-reads the descriptor from disk
        with open(path, "rb") as f:
            pod.serialized = f.read()

    def cleanup(self) -> None:
        for name in os.listdir(self.workdir):
            if name.endswith(".json"):
                try:
                    os.unlink(os.path.join(self.workdir, name))
                except OSError:
                    pass


def make_store(kind: str, workdir: str) -> PodStore:
    if kind == "disk":
        return DiskPodStore(os.path.join(workdir, "pods"))
    if kind == "memory":
        return MemoryPodStore()
    raise ValueError(kind)
