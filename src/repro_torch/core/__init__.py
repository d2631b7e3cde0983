"""Hydra broker core: the paper's contribution as a composable module.

Counterpart of ``repro/core``, with the same exports.  ``Hydra`` runs on the
card by default (``device="cuda"``).  Every task kind runs: ``kind="compute"``
tasks run a model's train step (the default ``step_kind``) or prefill
(``core/managers/compute.py``) for every family (dense, moe, ssm, hybrid,
audio and vlm), on the card as on the CPU."""
from repro_torch.core.admission import AdmissionController, AdmissionError, TenantSpec
from repro_torch.core.autoscaler import (
    Autoscaler,
    LatencyModel,
    LaunchSpec,
    ProviderPool,
    cloud_startup,
    hpc_queue_wait,
)
from repro_torch.core.broker import Hydra, Submission
from repro_torch.core.chaos import (
    ChaosEngine,
    LinkWindow,
    PreemptKill,
    QuarantineStorm,
    SiteOutage,
)
from repro_torch.core.dispatcher import StreamingDispatcher
from repro_torch.core.fault import BreakerState, CircuitBreaker
from repro_torch.core.group import GroupExhausted, GroupMember, ProviderGroup
from repro_torch.core.managers.compute import Preempted, ProviderDown
from repro_torch.core.market import MarketPlanner, PreemptionHazard
from repro_torch.core.managers.workflow import Workflow, WorkflowManager
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
    "Autoscaler",
    "BreakerState",
    "ChaosEngine",
    "CircuitBreaker",
    "LinkWindow",
    "PreemptKill",
    "Preempted",
    "ProviderDown",
    "QuarantineStorm",
    "SiteOutage",
    "LatencyModel",
    "LaunchSpec",
    "MarketPlanner",
    "PreemptionHazard",
    "ProviderPool",
    "cloud_startup",
    "hpc_queue_wait",
    "GroupExhausted",
    "GroupMember",
    "Hydra",
    "NoEligibleProvider",
    "ProviderGroup",
    "StreamingDispatcher",
    "Submission",
    "Workflow",
    "WorkflowManager",
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
