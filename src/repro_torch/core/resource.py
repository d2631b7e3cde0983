"""Resource request API (paper §3.2: the ``Resource`` class).

Users describe *what they want from a provider* - service type, amount of
resources, provider-specific properties - without touching provider APIs.
The Service Proxy turns an accepted ResourceRequest into live services.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.task import Resources


@dataclass
class ResourceRequest:
    provider: str
    service: str = "caas"  # "caas" | "pilot"
    n_nodes: int = 1
    vm_cpus: int = 16
    vm_memory_mb: int = 1 << 16
    accels_per_node: int = 8
    walltime_s: float = 3600.0  # pilot lease length
    properties: dict = field(default_factory=dict)  # provider-specific extras

    def capacity(self) -> Resources:
        return Resources(
            cpus=self.vm_cpus * self.n_nodes,
            accels=self.accels_per_node * self.n_nodes,
            memory_mb=self.vm_memory_mb * self.n_nodes,
        )
