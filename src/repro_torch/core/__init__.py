"""Hydra broker core: the paper's contribution as a composable module.

Exports what the PyTorch port carries so far; the autoscaler, market, chaos
and workflow modules come in later slices (ROADMAP.md)."""
from repro_torch.core.admission import AdmissionController, AdmissionError, TenantSpec
from repro_torch.core.broker import Hydra, Submission
from repro_torch.core.dispatcher import StreamingDispatcher
from repro_torch.core.fault import BreakerState, CircuitBreaker
from repro_torch.core.group import GroupExhausted, GroupMember, ProviderGroup
from repro_torch.core.managers.compute import Preempted, ProviderDown
from repro_torch.core.policy import NoEligibleProvider
from repro_torch.core.provider import ProviderProxy, ProviderSpec
from repro_torch.core.resource import ResourceRequest
from repro_torch.core.staging import (
    DatasetRegistry,
    LinkModel,
    StagingError,
    StagingService,
    TransferEngine,
)
from repro_torch.core.task import Resources, Task, TaskState

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "TenantSpec",
    "BreakerState",
    "CircuitBreaker",
    "Preempted",
    "ProviderDown",
    "GroupExhausted",
    "GroupMember",
    "Hydra",
    "NoEligibleProvider",
    "ProviderGroup",
    "StreamingDispatcher",
    "Submission",
    "ProviderProxy",
    "ProviderSpec",
    "DatasetRegistry",
    "LinkModel",
    "StagingError",
    "StagingService",
    "TransferEngine",
    "ResourceRequest",
    "Resources",
    "Task",
    "TaskState",
]
