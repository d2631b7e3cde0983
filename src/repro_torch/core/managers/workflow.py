"""Workflow Manager — the Argo-connector analogue (paper §5.4).

Counterpart of ``repro/core/managers/workflow.py``, copied with its imports rewritten.

Hydra itself brokers *workloads* (independent tasks); workflows need a DAG
engine on top.  In the paper that engine is Argo on Kubernetes and
RADICAL-EnTK on HPC; here it is a dependency tracker with two dispatch
modes:

  frontier  - every readiness event becomes its own ``broker.submit()``
              (the faithful baseline: per-micro-frontier pipeline rounds,
              often single-task pods).
  streaming - readiness events are fed to the broker's long-lived
              StreamingDispatcher (core/dispatcher.py), which coalesces
              ready tasks across ALL running workflow instances into
              micro-batched, late-bound pods and backfills idle capacity
              with deeper-workflow tasks.

The mode follows ``broker.streaming`` unless overridden, so
``Hydra(streaming=True)`` is all a caller needs to change.

DAGs are validated before execution: a cyclic workflow used to deadlock the
run loop forever (no task ever became ready); now ``Workflow.add`` rejects
edges that close a cycle and ``WorkflowManager.run`` re-validates every
instance, raising ``ValueError`` naming the offending cycle.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.clock import guard_wait, now
from repro_torch.runtime.tracing import Trace


class Workflow:
    """A DAG of tasks.  add(task, deps=[...]) wires edges."""

    _n = 0

    def __init__(self, name: str = ""):
        Workflow._n += 1
        self.name = name or f"wf.{Workflow._n:05d}"
        self.tasks: list[Task] = []
        self.deps: dict[str, set[str]] = {}
        self.children: dict[str, list[str]] = {}
        self.trace = Trace()

    def add(self, task: Task, deps: Optional[list[Task]] = None) -> Task:
        if task.uid in self.deps:
            raise ValueError(f"{self.name}: task {task.uid} already added")
        dep_uids = {d.uid for d in (deps or [])}
        if task.uid in dep_uids:
            raise ValueError(f"{self.name}: cycle: {task.uid} -> {task.uid}")
        # forward deps may reference tasks added later; an edge dep -> task
        # closes a cycle iff task already reaches dep through children
        path = self._path_to(task.uid, dep_uids)
        if path is not None:
            raise ValueError(f"{self.name}: cycle: {' -> '.join(path + [path[0]])}")
        self.tasks.append(task)
        self.deps[task.uid] = set(dep_uids)
        for d in dep_uids:
            self.children.setdefault(d, []).append(task.uid)
        return task

    def _path_to(self, src: str, targets: set[str]) -> Optional[list[str]]:
        """DFS over children edges: a path src -> ... -> t in targets."""
        stack: list[tuple[str, list[str]]] = [(src, [src])]
        seen: set[str] = set()
        while stack:
            uid, path = stack.pop()
            if uid in targets:
                return path
            if uid in seen:
                continue
            seen.add(uid)
            for child in self.children.get(uid, []):
                stack.append((child, path + [child]))
        return None

    def find_cycle(self) -> Optional[list[str]]:
        """Full-graph validation (run-time guard): a cycle as a uid list,
        or None for a well-formed DAG."""
        WHITE, GREY, BLACK = 0, 1, 2
        color = {t.uid: WHITE for t in self.tasks}
        parent: dict[str, Optional[str]] = {}
        for root in color:
            if color[root] != WHITE:
                continue
            stack: list[tuple[str, bool]] = [(root, False)]
            parent[root] = None
            while stack:
                uid, done = stack.pop()
                if done:
                    color[uid] = BLACK
                    continue
                if color[uid] == BLACK:
                    continue
                color[uid] = GREY
                stack.append((uid, True))
                for child in self.children.get(uid, []):
                    if child not in color:
                        continue  # dep object never added: dangling, not cyclic
                    if color[child] == GREY:  # back edge: reconstruct
                        cycle, cur = [child], uid
                        while cur is not None and cur != child:
                            cycle.append(cur)
                            cur = parent.get(cur)
                        cycle.reverse()
                        return cycle
                    if color[child] == WHITE:
                        parent[child] = uid
                        stack.append((child, False))
        return None

    def depths(self) -> dict[str, int]:
        """Longest-path depth per task (roots = 0), topologically computed.
        Feeds the dispatcher's shallow-first backfill ordering."""
        indeg = {t.uid: len(self.deps.get(t.uid, ())) for t in self.tasks}
        depth = {uid: 0 for uid in indeg}
        frontier = [uid for uid, d in indeg.items() if d == 0]
        while frontier:
            uid = frontier.pop()
            for child in self.children.get(uid, []):
                if child not in indeg:
                    continue
                depth[child] = max(depth[child], depth[uid] + 1)
                indeg[child] -= 1
                if indeg[child] == 0:
                    frontier.append(child)
        return depth

    def find_dangling(self) -> Optional[tuple[str, str]]:
        """A (task_uid, dep_uid) pair whose dep was never add()ed: such a
        dep can never complete, so the task would never become ready and
        the run loop would wait forever."""
        known = {t.uid for t in self.tasks}
        for uid, deps in self.deps.items():
            for d in deps:
                if d not in known:
                    return (uid, d)
        return None

    @property
    def done(self) -> bool:
        return all(t.final for t in self.tasks)

    @property
    def failed(self) -> bool:
        for t in self.tasks:
            if t.tstate == TaskState.FAILED and t.retries >= t.max_retries:
                return True
            # dispatcher-surfaced errors (unplaceable task, persistent
            # outage) land in CANCELED with the error on the future: an
            # errored run must not read as a clean success
            if (
                t.tstate == TaskState.CANCELED
                and t.done()
                and not t.cancelled()
                and t.exception() is not None
            ):
                return True
        return False

    def makespan(self) -> Optional[float]:
        t0 = self.trace.first("started")
        t1 = self.trace.last("finished")
        return None if t0 is None or t1 is None else t1 - t0


class WorkflowManager:
    def __init__(
        self,
        broker,
        partitioning: Optional[str] = None,
        tasks_per_pod: Optional[int] = None,
        streaming: Optional[bool] = None,
    ):
        self.broker = broker
        # None = follow the broker's configuration.  In streaming mode pod
        # shaping belongs to the broker's dispatcher (batches span many
        # workflows), so an explicit per-manager override that disagrees
        # with the broker is rejected in run() instead of silently dropped.
        self._partitioning = partitioning
        self._tasks_per_pod = tasks_per_pod
        # None = follow the broker's mode (Hydra(streaming=True) is enough)
        self._streaming = streaming
        self._lock = threading.Lock()

    @property
    def partitioning(self) -> str:
        return self._partitioning or self.broker.partitioning

    @property
    def tasks_per_pod(self) -> int:
        return self._tasks_per_pod or self.broker.tasks_per_pod

    @property
    def streaming(self) -> bool:
        if self._streaming is not None:
            return self._streaming
        return bool(getattr(self.broker, "streaming", False))

    def _check_streaming_config(self) -> None:
        if not self.streaming:
            return
        if (self._partitioning is not None and self._partitioning != self.broker.partitioning) or (
            self._tasks_per_pod is not None and self._tasks_per_pod != self.broker.tasks_per_pod
        ):
            raise ValueError(
                "streaming mode: pod shaping is owned by the broker's dispatcher "
                "(batches span workflows); configure partitioning/tasks_per_pod "
                "on Hydra(...) instead of WorkflowManager"
            )

    def run(
        self,
        workflows: list[Workflow],
        wait: bool = True,
        timeout: Optional[float] = None,
    ) -> list[Workflow]:
        """Run many workflow instances concurrently (paper Exp 4: up to 800).

        Validates every DAG first (ValueError on cycles), then tracks
        dependencies and pushes readiness events either straight through
        ``broker.submit`` (frontier mode) or into the streaming dispatcher's
        ready-queue (streaming mode)."""
        self._check_streaming_config()
        by_uid: dict[str, tuple[Workflow, Task]] = {}
        remaining: dict[str, set[str]] = {}
        done_events = {wf.name: threading.Event() for wf in workflows}

        for wf in workflows:
            cycle = wf.find_cycle()
            if cycle is not None:
                raise ValueError(
                    f"{wf.name}: cycle: {' -> '.join(cycle + [cycle[0]])}"
                )
            dangling = wf.find_dangling()
            if dangling is not None:
                raise ValueError(
                    f"{wf.name}: task {dangling[0]} depends on {dangling[1]}, "
                    "which was never added to the workflow"
                )

        for wf in workflows:
            wf.trace.add("started")
            depth = wf.depths()
            for t in wf.tasks:
                t.depth = depth.get(t.uid, 0)
                t.workflow = wf.name
                by_uid[t.uid] = (wf, t)
                remaining[t.uid] = set(wf.deps[t.uid])

        # multi-tenant front door: admit the WHOLE run up front, in one
        # all-or-nothing call.  Mid-DAG admission would reject inside a
        # future done-callback — where an AdmissionError has no caller to
        # propagate to and a half-run workflow no clean abort — so the
        # manager charges every task before the first frontier dispatch;
        # the per-frontier dispatch()/submit() admit gates then see
        # already-admitted tasks and pass them through unchanged.  Raises
        # AdmissionError here, before any callback is wired or task sent.
        admission = getattr(self.broker, "admission", None)
        if admission is not None:
            admission.admit([t for _, t in by_uid.values()])

        def on_done(fut_task: Task):
            def cb(fut):
                wf, _ = by_uid[fut_task.uid]
                if fut.cancelled() or fut.exception() is not None:
                    # cancel downstream; the workflow is failed
                    self._cancel_downstream(wf, fut_task)
                    if wf.done:
                        wf.trace.add("finished")
                        done_events[wf.name].set()
                    return
                ready = []
                with self._lock:
                    for child_uid in wf.children.get(fut_task.uid, []):
                        remaining[child_uid].discard(fut_task.uid)
                        if not remaining[child_uid]:
                            ready.append(by_uid[child_uid][1])
                if ready:
                    self._submit(ready)
                if wf.done:
                    wf.trace.add("finished")
                    done_events[wf.name].set()

            return cb

        for uid, (wf, t) in by_uid.items():
            t.add_done_callback(on_done(t))

        # feed the initial frontier of every workflow in ONE bulk push
        frontier = [t for uid, (wf, t) in by_uid.items() if not remaining[uid]]
        if frontier:
            self._submit(frontier)

        if wait:
            # guard timeout: ONE budget across all workflows, bounded on the
            # active clock AND real time — a frozen virtual clock must not
            # multiply the real-time bound by the number of workflows
            v_deadline = None if timeout is None else now() + timeout
            r_deadline = None if timeout is None else time.monotonic() + timeout

            def _in_flight() -> bool:
                # keeps guard_wait's virtual-idle valve closed while any
                # task is executing real (non-clock) work on a provider
                return any(
                    t.tstate
                    in (TaskState.PARTITIONED, TaskState.SUBMITTED, TaskState.RUNNING)
                    for _, t in by_uid.values()
                )

            for wf in workflows:
                left = (
                    None
                    if timeout is None
                    else max(0.0, min(v_deadline - now(), r_deadline - time.monotonic()))
                )
                guard_wait(done_events[wf.name], left, in_flight=_in_flight)
        return workflows

    def _submit(self, tasks: list[Task]):
        if self.streaming:
            self.broker.dispatch(tasks)
        else:
            self.broker.submit(tasks, partitioning=self.partitioning, tasks_per_pod=self.tasks_per_pod)

    def _cancel_downstream(self, wf: Workflow, failed: Task):
        stack = list(wf.children.get(failed.uid, []))
        seen = set()
        while stack:
            uid = stack.pop()
            if uid in seen:
                continue
            seen.add(uid)
            for t in wf.tasks:
                if t.uid == uid and not t.final:
                    t.mark_canceled()
            stack.extend(wf.children.get(uid, []))
