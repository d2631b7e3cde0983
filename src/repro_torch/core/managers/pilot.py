"""HPC (Pilot) Manager — the RADICAL-Pilot connector analogue (paper §3.1).

A *pilot* is a persistent allocation acquired once (after a modeled batch
queue wait), into which the manager bulk-submits task descriptions.  Tasks
execute inside the standing allocation without per-task scheduler round
trips — exactly the pilot abstraction Hydra uses on Bridges2.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from repro_torch.core.managers.compute import COMPUTE_RUNTIME, KERNEL_RUNTIME, ProviderDown
from repro_torch.core.pod import Pod
from repro_torch.core.provider import ProviderHandle
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.clock import get_clock
from repro_torch.runtime.tracing import Trace


class PilotManager:
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
        # pre-resolution hook: see CaaSManager.on_task_finishing
        self.on_task_finishing = on_task_finishing
        self.trace = Trace()
        self._q: queue.Queue = queue.Queue()
        self._down = threading.Event()
        self._stop = threading.Event()
        self._started = threading.Event()
        self._workers: list[threading.Thread] = []
        self._stats_lock = threading.Lock()
        # health signal counters (see CaaSManager.stats)
        self.completed = 0
        self.failed = 0
        self._boot = threading.Thread(target=self._acquire_pilot, daemon=True)
        self._boot.start()

    # -- pilot lifecycle -------------------------------------------------
    def _acquire_pilot(self):
        self.trace.add("pilot_queue_start")
        if self.spec.queue_delay_s:
            get_clock().sleep(self.spec.queue_delay_s)  # modeled batch queue wait
        self.trace.add("pilot_active")
        for i in range(self.spec.concurrency):
            w = threading.Thread(
                target=self._worker, daemon=True, name=f"pilot-{self.handle.name}-{i}"
            )
            w.start()
            self._workers.append(w)
        self._started.set()

    def fail(self):
        self._down.set()

    def recover(self):
        self._down.clear()

    @property
    def down(self) -> bool:
        return self._down.is_set()

    def stats(self) -> dict:
        return {
            "provider": self.handle.name,
            "down": self.down,
            "completed": self.completed,
            "failed": self.failed,
        }

    def shutdown(self, wait: bool = True):
        self._stop.set()
        for _ in self._workers:
            self._q.put(None)
        if wait:
            for w in self._workers:
                w.join(timeout=5.0)
        self.trace.add("pilot_released")

    # -- submission --------------------------------------------------------
    def submit_pods(self, pods: list[Pod]):
        """Bulk submission of task descriptions into the pilot queue."""
        if self.down:
            raise ProviderDown(self.handle.name)
        if self.spec.submit_latency_s:
            get_clock().sleep(self.spec.submit_latency_s)
        for pod in pods:
            pod.trace.add("env_setup_start")
            pod.trace.add("env_setup_done")  # pilot env already standing
            for t in pod.tasks:
                t.try_advance(TaskState.SUBMITTED)
                t.trace.add("submitted")
                self._q.put((t, pod))

    # -- execution ---------------------------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                return
            task, pod = item
            if self.down:
                if (
                    task.provider == self.handle.name
                    and task.mark_failed(ProviderDown(self.handle.name))
                    and self.on_task_done
                ):
                    self.on_task_done(task, self.handle.name, failed=True)
                continue
            self._run_task(task)
            if all(t.final for t in pod.tasks):
                pod.trace.add("env_teardown_done")

    def _run_task(self, task: Task):
        # finished elsewhere or re-bound away: release the group load slot
        if task.final or not task.try_advance(TaskState.RUNNING):
            if self.on_task_skipped:
                self.on_task_skipped(task, self.handle.name)
            return
        task.trace.add("exec_start")
        try:
            if task.kind == "noop":
                result = None
            elif task.kind == "sleep":
                get_clock().sleep(task.duration)
                result = None
            elif task.kind == "callable":
                result = task.fn() if task.fn else None
            elif task.kind == "compute":
                result = COMPUTE_RUNTIME.run(task, self.handle.devices[0])
            elif task.kind == "kernel":
                result = KERNEL_RUNTIME.run(task, self.handle.devices[0])
            else:
                raise ValueError(task.kind)
        except BaseException as e:
            if task.mark_failed(e):
                with self._stats_lock:
                    self.failed += 1
                if self.on_task_done:
                    self.on_task_done(task, self.handle.name, failed=True)
            return
        if task.tstate == TaskState.FAILED:
            # preempt-style kill mid-execution: see CaaSManager._run_task
            with self._stats_lock:
                self.failed += 1
            if self.on_task_done:
                self.on_task_done(task, self.handle.name, failed=True)
            return
        # duplicate completions skip the hook: see CaaSManager._run_task
        if self.on_task_finishing and not task.final:
            self.on_task_finishing(task, self.handle.name)
        task.mark_done(result)
        with self._stats_lock:
            self.completed += 1
        if self.on_task_done:
            self.on_task_done(task, self.handle.name, failed=False)
