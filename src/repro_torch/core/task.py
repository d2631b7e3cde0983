"""Task: the unit of brokered work (paper §3.2: "Task extends
concurrent.futures.Future").

A Task is a Future-like object holding the workload description, resource
requirements, provider binding, a strict state machine, and a trace of
timestamped events.  Kinds:

  noop      - zero-work task (the paper's overhead-isolation instrument)
  callable  - arbitrary python callable (the "executable" task type)
  compute   - a model step: (arch, step kind) of a reduced config on the
              provider's device, a train step or a prefill (see
              core/managers/compute.py)
  sleep     - fixed-duration task (paper Exp 3B heterogeneous workloads)
  kernel    - real kernel work: ``payload`` names a registered kernel plus
              problem shape/dtype/reps, resolved against kernels/registry.py
              and executed rep-by-rep (progress_frac advances per completed
              rep, so checkpoint/resume skips finished reps)
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Optional

from repro_torch.runtime.tracing import Counter, Trace

_ids = Counter("task")


class TaskState(str, Enum):
    NEW = "NEW"
    BOUND = "BOUND"  # assigned to a provider by the binding policy
    PARTITIONED = "PARTITIONED"  # placed into a pod
    SUBMITTED = "SUBMITTED"  # pod handed to the provider connector
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


FINAL_STATES = {TaskState.DONE, TaskState.FAILED, TaskState.CANCELED}

# SLO classes, in strict drain-priority order: the dispatcher empties every
# "interactive" lane before any "batch" lane sees budget (core/dispatcher.py)
SLO_CLASSES = ("interactive", "batch")

LEGAL = {
    TaskState.NEW: {TaskState.BOUND, TaskState.CANCELED},
    TaskState.BOUND: {TaskState.PARTITIONED, TaskState.BOUND, TaskState.CANCELED},
    TaskState.PARTITIONED: {TaskState.SUBMITTED, TaskState.BOUND, TaskState.CANCELED},
    TaskState.SUBMITTED: {TaskState.RUNNING, TaskState.BOUND, TaskState.FAILED, TaskState.CANCELED},
    TaskState.RUNNING: {TaskState.DONE, TaskState.FAILED, TaskState.CANCELED},
    TaskState.DONE: set(),
    TaskState.FAILED: {TaskState.BOUND},  # retry: re-bind
    TaskState.CANCELED: set(),
}


class IllegalTransition(RuntimeError):
    pass


@dataclass
class Resources:
    """Per-task resource requirements (the paper's cpu/gpu/memory triple)."""

    cpus: int = 1
    accels: int = 0  # GPUs, in the paper and here
    memory_mb: int = 256

    def fits(self, cap: "Resources") -> bool:
        return self.cpus <= cap.cpus and self.accels <= cap.accels and self.memory_mb <= cap.memory_mb


class Task(Future):
    def __init__(
        self,
        kind: str = "noop",
        fn: Optional[Callable[[], Any]] = None,
        *,
        resources: Optional[Resources] = None,
        provider: Optional[str] = None,  # user-pinned provider (paper: task provider)
        arch: Optional[str] = None,
        shape: Optional[str] = None,
        step_kind: Optional[str] = None,
        duration: float = 0.0,  # for kind="sleep"
        payload: Any = None,
        max_retries: int = 2,
        inputs: Optional[list[str]] = None,
        outputs: Optional[dict[str, float]] = None,
        tenant: str = "default",
        slo_class: str = "batch",
    ):
        super().__init__()
        assert kind in ("noop", "callable", "compute", "sleep", "kernel"), kind
        assert slo_class in SLO_CLASSES, slo_class
        self.uid = _ids.next()
        self.kind = kind
        self.fn = fn
        self.resources = resources or Resources()
        self.pinned_provider = provider
        self.arch, self.shape, self.step_kind = arch, shape, step_kind
        self.duration = duration
        self.payload = payload
        self.max_retries = max_retries
        self.retries = 0
        self.provider: Optional[str] = provider
        # logical group binding; provider holds the concrete member resolved
        # at dispatch time (core/group.py) and may change on failover
        self.group: Optional[str] = None
        self.pod_uid: Optional[str] = None
        # streaming-dispatcher scheduling hints (core/dispatcher.py): DAG
        # depth orders micro-batches so shallow (critical-path-upstream)
        # tasks bind first and deeper-workflow tasks backfill idle capacity
        self.depth: int = 0
        self.workflow: Optional[str] = None
        # declared data dependencies (core/staging.py): ``inputs`` names
        # datasets that must be resident at the executing site before the
        # task runs; ``outputs`` maps produced dataset name -> size_mb,
        # registered at the executing site on completion (stage-out).
        self.inputs: list[str] = list(inputs or [])
        self.outputs: dict[str, float] = dict(outputs or {})
        # placement reserved by the dispatcher's staging gate: the binding
        # policy already chose (and accounted for) this target, so dispatch
        # must honor it — inputs were staged to its site on that promise
        self.reserved_provider: Optional[str] = None
        self.staging_attempts: int = 0
        # True once a dispatch round registered the task in a Submission the
        # broker's backlog() scan can see: the autoscaler uses it to subtract
        # staging-stalled retries from demand without double-discounting
        # first-time tasks (which are in neither the ready heap nor backlog)
        self.in_submission: bool = False
        # multi-tenant front door (core/admission.py + the dispatcher's
        # per-tenant lanes): ``tenant`` keys rate limits / queue bounds /
        # fair-share weights, ``slo_class`` picks the priority lane
        # ("interactive" preempts queued "batch" backfill).  ``admitted``
        # flips once the task passes admission (or is exempt: internal
        # requeues re-enter without being re-charged); ``admission_held``
        # marks a held queue slot and is cleared exactly once on release.
        self.tenant = tenant
        self.slo_class = slo_class
        self.admitted: bool = False
        self.admission_held: bool = False
        # task-level checkpoint/restore (ckpt/checkpoint.py): fraction of the
        # work already captured in a checkpoint dataset.  A resumed sleep
        # task executes only the remaining (1 - progress_frac) of its
        # duration; ``ckpt_dataset`` names the replicated checkpoint in the
        # DatasetRegistry (also appended to ``inputs`` so the staging gate
        # places the resume next to its bytes); ``resumes`` counts
        # checkpoint resumes, which — unlike ``retries`` — never charge
        # ``max_retries``.
        self.progress_frac: float = 0.0
        self.ckpt_dataset: Optional[str] = None
        self.resumes: int = 0
        # kind="kernel" bookkeeping (managers/compute.py KernelRuntime):
        # ``kernel_done_s`` accumulates wall seconds of *completed* reps
        # (the durable-progress clock the checkpointer reads on preempt);
        # ``kernel_stats`` is the last execution's summary the broker folds
        # into the ``kernel.exec`` event on successful completion.
        self.kernel_done_s: float = 0.0
        self.kernel_stats: Optional[dict] = None
        self.trace = Trace()
        self._state_lock = threading.RLock()
        self._tstate = TaskState.NEW
        self.trace.add("created")

    # ------------------------------------------------------------------
    @property
    def tstate(self) -> TaskState:
        return self._tstate

    def advance(self, new: TaskState) -> None:
        with self._state_lock:
            if new not in LEGAL[self._tstate]:
                raise IllegalTransition(f"{self.uid}: {self._tstate.value} -> {new.value}")
            self._tstate = new
            self.trace.add(f"state:{new.value}")

    def try_advance(self, new: TaskState) -> bool:
        with self._state_lock:
            if new not in LEGAL[self._tstate]:
                return False
            self._tstate = new
            self.trace.add(f"state:{new.value}")
            return True

    @property
    def final(self) -> bool:
        return self._tstate in FINAL_STATES

    # ------------------------------------------------------------------
    def mark_done(self, result: Any = None) -> None:
        """Completion is authoritative and idempotent: with re-binding and
        speculative copies the same work may finish more than once (or finish
        on the 'old' provider after a re-bind) - first completion wins, any
        state.  At-least-once execution, exactly-once completion."""
        with self._state_lock:
            if self._tstate in FINAL_STATES:  # duplicate completion: no-op
                return
            self._tstate = TaskState.DONE
            self.trace.add("state:DONE")
        self.trace.add("exec_done")
        if not self.done():
            self.set_result(result)

    def mark_failed(self, exc: BaseException) -> bool:
        """Race-safe: a stale failure (e.g. from a provider the task was
        already re-bound away from) is ignored unless the task is actually
        in-flight.  Returns True iff this call performed the transition."""
        with self._state_lock:
            if self._tstate not in (TaskState.SUBMITTED, TaskState.RUNNING):
                return False
            self._tstate = TaskState.FAILED
            self.trace.add("state:FAILED")
        self.trace.add("exec_failed")
        self.last_error = exc
        if self.retries >= self.max_retries and not self.done():
            self.set_exception(exc)
        return True

    def mark_canceled(self) -> None:
        with self._state_lock:
            if self._tstate in FINAL_STATES:
                return
            self._tstate = TaskState.CANCELED
            self.trace.add("state:CANCELED")
        if not self.done():
            self.cancel()
            if not self.cancelled():  # running futures refuse cancel(); force it
                self.set_exception(CancelledError(self.uid))

    def reset_for_retry(self) -> None:
        """FAILED -> BOUND (fault tolerance re-binding)."""
        with self._state_lock:
            self.retries += 1
            self.advance(TaskState.BOUND)
            self.pod_uid = None

    def reset_for_resume(self) -> None:
        """FAILED -> BOUND after a checkpoint capture (ckpt/checkpoint.py):
        the resumed task re-executes only the work beyond ``progress_frac``,
        and — unlike ``reset_for_retry`` — never charges ``max_retries``:
        preemption is the platform's fault, not the task's."""
        with self._state_lock:
            self.advance(TaskState.BOUND)
            self.pod_uid = None
            self.trace.add("resumed")


class CancelledError(RuntimeError):
    pass


def describe(task: Task) -> dict:
    """JSON-serializable task description (what gets written into a pod)."""
    return {
        "uid": task.uid,
        "kind": task.kind,
        "resources": vars(task.resources),
        "provider": task.provider,
        "group": task.group,
        "arch": task.arch,
        "shape": task.shape,
        "step_kind": task.step_kind,
        "duration": task.duration,
        "retries": task.retries,
        "inputs": list(task.inputs),
        "outputs": dict(task.outputs),
        "tenant": task.tenant,
        "slo_class": task.slo_class,
    }
