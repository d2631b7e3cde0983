"""CaaS Manager (paper §3.1) adapted to GPU pools.

  pod == a dispatch group submitted to the pool in ONE bulk call (the
         paper's bulk submission that keeps OVH low).

The manager traces env setup/teardown per pod (TPT per the paper) and task
exec windows (TTX), executes noop/sleep/callable tasks directly, and runs
``kernel`` tasks on the provider's device (``handle.devices[0]``).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import torch

from repro_torch.core.pod import Pod
from repro_torch.core.provider import ProviderHandle
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.clock import get_clock


class ProviderDown(RuntimeError):
    pass


class Preempted(RuntimeError):
    """A task was killed mid-execution by an external actor (spot reclaim,
    HPC walltime kill, chaos injection).  The killer calls
    ``task.mark_failed(Preempted(...))`` on a RUNNING task; the executing
    manager notices the FAILED state when the work function returns and
    reports the failure exactly once through the normal completion hook, so
    the broker's retry machinery owns the recovery."""


class ComputeRuntime:
    """Executes ``compute`` tasks: a model step on the provider's device.
    The model steps are not ported yet, so such a task fails with a typed
    error the broker reports like any other task failure."""

    def run(self, task: Task, device: torch.device) -> Any:
        raise NotImplementedError(
            "kind='compute' tasks run the model steps, which the PyTorch port "
            "does not have yet (ROADMAP.md, 'Modules to port': the model steps "
            "behind kind='compute')"
        )


COMPUTE_RUNTIME = ComputeRuntime()


def _synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU, where
    every operation has finished when it returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class KernelRuntime:
    """Executes ``kernel`` tasks: real kernel work on the wire.

    ``task.payload`` is a plain dict::

        {"kernel": "rglru_scan",            # kernels/registry.py name
         "shape": {"B": 1, "L": 64, ...},   # omitted -> the kernel's tiny shape
         "dtype": "float32", "reps": 3, "seed": 0,
         "config": {"block_d": 512}}        # optional explicit blocks

    The operands are made on the provider's device, so a CUDA provider runs
    the hand-written kernel and a CPU provider its plain version.  Block
    config: explicit payload config > the kernel's committed defaults.
    Execution is rep-granular and resumable: ``progress_frac`` advances
    after every completed repetition, so a preempt-killed task resumed from
    its checkpoint skips the reps it already finished.
    """

    def run(self, task: Task, device: torch.device) -> Any:
        import time as _time

        from repro_torch.kernels import registry as kreg

        spec = dict(task.payload or {})
        kdef = kreg.get_kernel(spec["kernel"])
        shape = dict(spec.get("shape") or kdef.tiny_shape)
        dtype = spec.get("dtype", "float32")
        reps = max(1, int(spec.get("reps", 1)))
        seed = int(spec.get("seed", 0))
        config = spec.get("config") or kdef.defaults(shape)
        args = kdef.make_args(shape, dtype, seed, device)
        done = min(reps, int(round(task.progress_frac * reps)))
        t0 = _time.perf_counter()
        for r in range(done, reps):
            kdef.call(shape, args, config)
            _synchronize(device)
            # completed-rep boundary: durable progress the checkpointer can
            # capture without losing more than the rep in flight
            task.kernel_done_s += _time.perf_counter() - t0
            t0 = _time.perf_counter()
            task.progress_frac = (r + 1) / reps
        kernel_s = task.kernel_done_s
        # lifetime totals (reps survive preempt/resume cycles): the broker
        # emits ONE kernel.exec per completed task, so execs reconcile with
        # completed-task counts and reps/seconds with total work performed
        task.kernel_stats = {
            "kernel": kdef.name,
            "reps": reps,
            "kernel_s": kernel_s,
            "config": kreg.config_sig(config),
        }
        return {
            "kernel": kdef.name,
            "sig": kreg.shape_sig(shape, dtype),
            "config": kreg.config_sig(config),
            "reps": reps,
            "skipped_reps": done,
            "kernel_s": kernel_s,
        }


KERNEL_RUNTIME = KernelRuntime()


class CaaSManager:
    """One per cloud-like provider.  Bulk pod submission + tracing."""

    def __init__(
        self,
        handle: ProviderHandle,
        on_task_done: Optional[Callable] = None,
        on_task_skipped: Optional[Callable] = None,
        on_task_finishing: Optional[Callable] = None,
    ):
        self.handle = handle
        self.spec = handle.spec
        self.on_task_done = on_task_done
        self.on_task_skipped = on_task_skipped
        # runs BEFORE mark_done resolves the future: resolving enqueues
        # dependent tasks synchronously, so anything a dependent must be able
        # to observe (declared outputs in the staging registry) registers here
        self.on_task_finishing = on_task_finishing
        self._pool = ThreadPoolExecutor(
            max_workers=self.spec.concurrency, thread_name_prefix=f"caas-{handle.name}"
        )
        self._down = threading.Event()
        self._inflight: set = set()
        self._lock = threading.Lock()
        # health signal counters: consumed by provider-group breakers and
        # the group-aware metrics rows (broker.group_rows / benchmarks)
        self.completed = 0
        self.failed = 0

    # -- lifecycle -----------------------------------------------------
    def fail(self):
        """Simulate a provider outage (tests / fault-tolerance benchmarks)."""
        self._down.set()

    def recover(self):
        self._down.clear()

    def stats(self) -> dict:
        return {
            "provider": self.handle.name,
            "down": self.down,
            "completed": self.completed,
            "failed": self.failed,
        }

    @property
    def down(self) -> bool:
        return self._down.is_set()

    def shutdown(self, wait: bool = True):
        self._pool.shutdown(wait=wait, cancel_futures=not wait)

    # -- submission ----------------------------------------------------
    def submit_pods(self, pods: list[Pod]):
        """Bulk submission: one enqueue per pod (not per task)."""
        if self.down:
            raise ProviderDown(self.handle.name)
        if self.spec.submit_latency_s:
            get_clock().sleep(self.spec.submit_latency_s)  # modeled API round-trip
        futures = []
        for pod in pods:
            for t in pod.tasks:
                t.try_advance(TaskState.SUBMITTED)
                t.trace.add("submitted")
            futures.append(self._pool.submit(self._run_pod, pod))
        return futures

    # -- execution -----------------------------------------------------
    def _run_pod(self, pod: Pod):
        pod.trace.add("env_setup_start")
        if self.spec.env_setup_s:
            get_clock().sleep(self.spec.env_setup_s * (1 if pod.model != "scpp" else 1.0))
        pod.trace.add("env_setup_done")
        try:
            for t in pod.tasks:
                if self.down:
                    # fail the remaining tasks so the broker re-binds them
                    for rest in pod.tasks:
                        if (
                            not rest.final
                            and rest.provider == self.handle.name
                            and rest.mark_failed(ProviderDown(self.handle.name))
                            and self.on_task_done
                        ):
                            self.on_task_done(rest, self.handle.name, failed=True)
                    return
                self._run_task(t)
        finally:
            pod.trace.add("env_teardown_start")
            pod.trace.add("env_teardown_done")

    def _run_task(self, task: Task):
        # canceled, speculatively completed elsewhere, or re-bound away:
        # tell the broker so group load accounting releases the slot
        if task.final or not task.try_advance(TaskState.RUNNING):
            if self.on_task_skipped:
                self.on_task_skipped(task, self.handle.name)
            return
        task.trace.add("exec_start")
        try:
            result = self._execute(task)
        except BaseException as e:
            if task.mark_failed(e):
                with self._lock:
                    self.failed += 1
                if self.on_task_done:
                    self.on_task_done(task, self.handle.name, failed=True)
            return
        if task.tstate == TaskState.FAILED:
            # preempt-style kill landed while _execute was running (see
            # Preempted): report the failure exactly once so the broker
            # retries it — the success path below would swallow it,
            # stranding the task's future forever
            with self._lock:
                self.failed += 1
            if self.on_task_done:
                self.on_task_done(task, self.handle.name, failed=True)
            return
        # skip on duplicate completions (speculation / post-rebind finishes):
        # mark_done no-ops those, and the hook must not re-register outputs
        if self.on_task_finishing and not task.final:
            self.on_task_finishing(task, self.handle.name)
        task.mark_done(result)
        with self._lock:
            self.completed += 1
        if self.on_task_done:
            self.on_task_done(task, self.handle.name, failed=False)

    def _execute(self, task: Task) -> Any:
        if task.kind == "noop":
            return None
        if task.kind == "sleep":
            # checkpoint resume (ckpt/checkpoint.py): only the work beyond
            # the captured progress_frac is re-executed
            get_clock().sleep(task.duration * (1.0 - task.progress_frac))
            return None
        if task.kind == "callable":
            return task.fn() if task.fn else None
        if task.kind == "compute":
            return COMPUTE_RUNTIME.run(task, self.handle.devices[0])
        if task.kind == "kernel":
            return KERNEL_RUNTIME.run(task, self.handle.devices[0])
        raise ValueError(task.kind)
