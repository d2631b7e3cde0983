"""Checkpointing: save/restore of a state tree of tensors with a manifest,
atomic step directories, async save, and retention.

Counterpart of ``repro/ckpt/checkpoint.py``, with the same layout:

    <dir>/step_00000100/
        manifest.json     # step, flat leaf paths, shapes, dtypes
        arrays.npz        # one entry per flattened leaf
    <dir>/LATEST          # atomic pointer file

A tree is nested dicts, lists and tuples whose leaves are tensors (or
anything ``np.asarray`` takes); its leaves flatten to the same ``a/b/0``
paths as the reference's, so each package restores the other's files.

bfloat16 leaves: numpy has no bfloat16, and the reference writes its bf16
arrays as raw 2-byte words (``np.save`` records them as ``<V2``).  This
module writes a bf16 tensor's words the same way, through a ``uint16`` view,
and reads them back through that view into a bf16 tensor, so every bit
survives in both directions and no value goes through fp32.

``TaskCheckpointer`` (bottom of this module) is the broker-facing sibling:
task-level checkpoint/restore where checkpoints are replicated datasets in
the broker's DatasetRegistry, letting a preempt-killed task resume from its
captured ``progress_frac`` on a surviving provider (core/broker.py).
"""
from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

_RAW_BF16 = np.dtype("V2")  # how numpy stores a bfloat16 word


def _flatten(tree) -> dict[str, Any]:
    """Leaves by path, dict keys sorted: the reference's path scheme."""
    flat = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(f"{prefix}/{k}" if prefix else str(k), t[k])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = t

    walk("", tree)
    return flat


def _unflatten(like_tree, leaves: dict[str, Any], prefix: str = ""):
    """``like_tree``'s structure with each leaf replaced from ``leaves``."""
    if isinstance(like_tree, dict):
        return {
            k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like_tree.items()
        }
    if isinstance(like_tree, (list, tuple)):
        out = [_unflatten(v, leaves, f"{prefix}/{i}") for i, v in enumerate(like_tree)]
        return type(like_tree)(out) if isinstance(like_tree, tuple) else out
    return leaves[prefix]


def _to_host(leaf):
    """A host copy of one leaf, taken now: the caller may go on mutating
    the device tensor while the write is pending."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> np.ndarray:
    """The array ``np.savez`` writes for one leaf: a bf16 tensor as its raw
    2-byte words, as the reference writes its bf16 arrays."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(_RAW_BF16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """One stored leaf as a tensor of the dtype it was written in."""
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}: expected 2-byte words")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable, contiguous copy


def save(ckpt_dir: str, step: int, state_tree, keep: int = 3) -> str:
    """Synchronous checkpoint save.  Returns the step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state_tree)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    manifest = {
        "step": step,
        "leaves": {
            k: {"shape": list(a.shape), "dtype": _dtype_name(flat[k], a)}
            for k, a in arrays.items()
        },
    }
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _write_latest(ckpt_dir, final)
    _retain(ckpt_dir, keep)
    return final


def _write_latest(ckpt_dir: str, final: str):
    latest = os.path.join(ckpt_dir, "LATEST")
    tmpf = latest + ".tmp"
    with open(tmpf, "w") as f:
        f.write(os.path.basename(final))
    os.replace(tmpf, latest)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class _SaveHandle:
    """Completion handle for ``async_save``: ``wait()`` blocks until the
    scheduled write finished and re-raises any stored error."""

    def __init__(self):
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._path: Optional[str] = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> str:
        if not self._done.wait(timeout):
            raise TimeoutError("async_save did not complete in time")
        if self._error is not None:
            raise self._error
        return self._path


def async_save(
    ckpt_dir: str, step: int, state_tree, keep: int = 3, delay_s: float = 0.0
) -> _SaveHandle:
    """Asynchronous checkpoint save on the shared Clock: snapshot the tree
    to host memory NOW (so the caller may keep mutating device state),
    schedule the write via ``Clock.call_later`` -- deterministic under
    ``virtual_time()`` -- and return a handle whose ``wait()`` joins the
    write and re-raises errors."""
    from repro_torch.runtime.clock import get_clock

    host_tree = _unflatten(state_tree, {k: _to_host(v) for k, v in _flatten(state_tree).items()})
    handle = _SaveHandle()

    def work():
        try:
            handle._path = save(ckpt_dir, step, host_tree, keep)
        except BaseException as e:  # re-raised on wait()
            handle._error = e
        finally:
            handle._done.set()

    get_clock().call_later(delay_s, work)
    return handle


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training: save() snapshots to host
    memory synchronously and writes in a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state_tree):
        self.wait()
        host_tree = _unflatten(state_tree, {k: _to_host(v) for k, v in _flatten(state_tree).items()})

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, like_tree, step: Optional[int] = None):
    """Restore a state tree.  ``like_tree`` gives the structure, and each of
    its tensor leaves the dtype and device its restored counterpart gets.

    Returns (step, state_tree) or raises FileNotFoundError.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like_tree)
    missing = set(flat_like) - set(manifest["leaves"])
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for k, want in flat_like.items():
            arr = data[k]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {want.shape}")
            t = _from_numpy(arr, manifest["leaves"][k]["dtype"])
            out[k] = t.to(device=want.device, dtype=want.dtype)
    return step, _unflatten(like_tree, out)


class TaskCheckpointer:
    """Task-level checkpoint/restore for the broker (core/broker.py wires
    this via ``Hydra.enable_task_checkpoints``).

    Checkpoints are *replicated datasets*: each preempted task's captured
    progress registers as ``ckpt:<uid>`` in the broker's DatasetRegistry
    with a durable replica in the shared store, and the checkpoint name is
    appended to the task's declared ``inputs``.  The resume therefore
    re-enters through the dispatcher's staging gate like any data-carrying
    task: the TransferEngine stages the checkpoint to whatever surviving
    site the policy picks (placement obeys data gravity), and the shared
    replica survives the death of the site that was running the task.

    The progress model is write-behind: a running task is assumed to have
    durably checkpointed at every ``interval_s`` of executed work, so a
    preemption loses only the tail since the last interval boundary —
    ``lost_s = done_s - floor(done_s / interval_s) * interval_s`` — and
    the resumed task executes only the remaining work
    (``managers/compute.py`` sleeps ``duration * (1 - progress_frac)``).
    Resumes never charge ``Task.max_retries``.
    """

    def __init__(self, registry, events, interval_s: float = 5.0, size_mb: float = 64.0):
        from repro_torch.runtime.clock import get_clock  # noqa: F401 (validated here)

        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.events = events
        self.interval_s = interval_s
        self.size_mb = size_mb
        self._lock = threading.Lock()
        # legacy accumulators (HYDRA_EVENTS_CHECK ground truth)
        self.saves = 0
        self.resumes = 0
        self.reexecuted_s = 0.0
        self.preempted_work_s = 0.0

    def eligible(self, task) -> bool:
        """Only work with resumable progress checkpoints: duration-modeled
        sleeps and rep-granular kernel payloads (managers/compute.py
        KernelRuntime advances ``progress_frac`` per completed rep).
        noop/callable/compute tasks restart from zero like before."""
        if task.kind == "kernel":
            return True
        return task.kind == "sleep" and task.duration > 0

    def on_preempt(self, task) -> None:
        """A preempt-style kill landed on ``task`` (state FAILED): capture
        its progress as a checkpoint dataset and mark it resumable.  The
        caller (broker) then resets the task WITHOUT charging a retry."""
        from repro_torch.core.staging import SHARED_SITE
        from repro_torch.runtime.clock import get_clock

        if task.kind == "kernel":
            # rep-granular payloads checkpoint themselves: the KernelRuntime
            # advances progress_frac at every completed-rep boundary, so the
            # current value already IS the last durable checkpoint and only
            # the partial rep in flight is lost (it was never counted done)
            done_s = task.kernel_done_s
            lost_s = 0.0
        else:
            prior_s = task.progress_frac * task.duration
            t0 = task.trace.last("exec_start")
            run_s = 0.0
            if t0 is not None:
                run_s = min(max(0.0, get_clock().now() - t0), task.duration - prior_s)
            done_s = prior_s + run_s
            # last durable interval boundary; never regress below prior progress
            ckpt_s = max(math.floor(done_s / self.interval_s) * self.interval_s, prior_s)
            lost_s = done_s - ckpt_s
            task.progress_frac = min(1.0, ckpt_s / task.duration)
        name = f"ckpt:{task.uid}"
        # durable shared-store replica: survives the executing site's death;
        # the staging gate moves it (via TransferEngine) to the resume site
        self.registry.add(name, self.size_mb, sites=(SHARED_SITE,))
        if task.ckpt_dataset is None:
            task.ckpt_dataset = name
        if name not in task.inputs:
            task.inputs.append(name)
        task.resumes += 1
        task.trace.add(f"ckpt_resume:{task.progress_frac:.3f}")
        with self._lock:
            self.saves += 1
            self.resumes += 1
            self.reexecuted_s += lost_s
            self.preempted_work_s += done_s
            self.events.emit(
                "ckpt.save",
                task=task.uid,
                dataset=name,
                progress=task.progress_frac,
            )
            self.events.emit(
                "ckpt.resume",
                task=task.uid,
                progress=task.progress_frac,
                lost_s=lost_s,
                done_s=done_s,
            )

    def stats(self) -> dict:
        """Log-derived view adapter (legacy accumulators stay as strict-mode
        ground truth); ``reexec_frac`` is exp13's headline recovery metric."""
        self.events.maybe_check()
        view = self.events.view
        reexec = view.get("hydra.ckpt.reexecuted_s")
        preempted = view.get("hydra.ckpt.preempted_work_s")
        return {
            "saves": int(view.get("hydra.ckpt.saves")),
            "resumes": int(view.get("hydra.ckpt.resumes")),
            "reexecuted_s": reexec,
            "preempted_work_s": preempted,
            "reexec_frac": (reexec / preempted) if preempted > 0 else 0.0,
        }
