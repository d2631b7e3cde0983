"""The port's checkpoints (repro_torch/ckpt/checkpoint.py) against the reference.

Files cross between the packages: a tree of fp32, int32 and bf16 leaves
written by the reference restores in the port bit for bit, and the port's
file reads in the reference exactly as the reference's own.  bf16 is the
hard leaf: numpy has no bfloat16, so both packages store its raw 2-byte
words, and the port reads them back through a ``uint16`` view.  The
reference's own ``restore`` cannot cast those words back to bfloat16 (its
own files or the port's: ROADMAP.md, queue 3), so on the reference side the
bf16 words are read as the reference's ``np.load`` gives them.

Also here: retention and ``latest_step`` match, async saves, the task
checkpointer's kernel branch, and a preempt-killed kernel task on a CPU
broker resuming from its completed reps without charging a retry.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro_torch.ckpt import checkpoint as tck
from repro_torch.ckpt.checkpoint import TaskCheckpointer
from repro_torch.core import Hydra, Preempted, ProviderSpec, Task, TaskState
from repro_torch.core.events import EventBus
from repro_torch.core.staging import DatasetRegistry
from repro_torch.runtime.clock import virtual_time

from conftest import wait_until

torch.set_num_threads(1)


def _numpy_tree(seed: int = 0) -> dict:
    """Leaves made with numpy from a seed; bf16 as ml_dtypes words."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "params": {
            "w": f32,
            "emb": rng.standard_normal((4, 6)).astype(np.float32).astype(ml_dtypes.bfloat16),
        },
        "opt": [rng.integers(-1000, 1000, (7,), dtype=np.int32), rng.standard_normal((2,)).astype(np.float32)],
        "step": np.asarray(rng.integers(0, 100), dtype=np.int32),
    }


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _bits(leaf) -> np.ndarray:
    """The raw bits of a leaf, whatever package made it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.reshape(-1)
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy().view(np.uint8)
    arr = np.asarray(leaf).reshape(-1)
    if arr.dtype == ml_dtypes.bfloat16 or arr.dtype.kind == "V":
        return arr.view(np.uint16)
    return arr.view(np.uint8)


def _flat(tree):
    return tck._flatten(tree)


def test_reference_file_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _numpy_tree()
    jck.save(str(tmp_path), 7, _jax_tree(tree))
    like = _torch_tree(_numpy_tree(seed=1))  # same structure, other values
    step, out = tck.restore(str(tmp_path), like)
    assert step == 7
    want, got = _flat(tree), _flat(out)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == _flat(like)[k].dtype
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


def test_port_file_reads_in_the_reference_as_its_own(tmp_path):
    tree = _numpy_tree()
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    tck.save(str(port_dir), 7, _torch_tree(tree))
    jck.save(str(ref_dir), 7, _jax_tree(tree))
    step_dir = "step_00000007"
    # the same manifest, byte for byte
    assert (port_dir / step_dir / "manifest.json").read_bytes() == (ref_dir / step_dir / "manifest.json").read_bytes()
    # the reference's restore of the fp32 and int32 leaves, bit for bit
    like = _jax_tree({"opt": tree["opt"], "params": {"w": tree["params"]["w"]}, "step": tree["step"]})
    step, out = jck.restore(str(port_dir), like)
    assert step == 7
    for k, v in _flat(out).items():
        np.testing.assert_array_equal(_bits(v), _bits(_flat(tree)[k]))
    # the bf16 words load as the reference's own do
    with np.load(port_dir / step_dir / "arrays.npz") as port, np.load(ref_dir / step_dir / "arrays.npz") as ref:
        assert set(port.files) == set(ref.files)
        for k in ref.files:
            assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape
            np.testing.assert_array_equal(port[k].reshape(-1).view(np.uint8), ref[k].reshape(-1).view(np.uint8))
        emb = port["params/emb"].view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(emb.view(np.uint16), tree["params"]["emb"].view(np.uint16))


def test_reference_restore_cannot_cast_bf16_words_from_either_package(tmp_path):
    """The reference's defect, recorded in ROADMAP.md queue 3: its restore
    casts the stored ``V2`` words with ``astype(bfloat16)``, which numpy
    refuses, on its own file as on the port's."""
    tree = {"emb": _numpy_tree()["params"]["emb"]}
    jck.save(str(tmp_path / "ref"), 1, _jax_tree(tree))
    tck.save(str(tmp_path / "port"), 1, _torch_tree(tree))
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="cast"):
            jck.restore(str(tmp_path / d), _jax_tree(tree))
        _, out = tck.restore(str(tmp_path / d), _torch_tree(tree))
        np.testing.assert_array_equal(_bits(out["emb"]), _bits(tree["emb"]))


def test_restore_puts_leaves_on_the_like_trees_dtype_and_device(tmp_path):
    tree = _torch_tree(_numpy_tree())
    tck.save(str(tmp_path), 3, tree)
    like = {
        "params": {"w": torch.zeros(3, 5, dtype=torch.float64), "emb": torch.zeros(4, 6, dtype=torch.float32)},
        "opt": (torch.zeros(7, dtype=torch.int64), torch.zeros(2)),
        "step": torch.zeros((), dtype=torch.int32),
    }
    _, out = tck.restore(str(tmp_path), like)
    assert isinstance(out["opt"], tuple)
    assert out["params"]["w"].dtype == torch.float64 and out["opt"][0].dtype == torch.int64
    # bf16 widened to fp32 is exact
    assert torch.equal(out["params"]["emb"], tree["params"]["emb"].float())
    assert all(t.device == torch.device("cpu") for t in _flat(out).values())
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore(str(tmp_path), {**like, "step": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing leaves"):
        tck.restore(str(tmp_path), {**like, "extra": torch.zeros(1)})


def test_retention_and_latest_step_match_the_reference(tmp_path):
    tree = _numpy_tree()
    for step in (1, 2, 5, 9):
        tck.save(str(tmp_path / "port"), step, _torch_tree(tree), keep=2)
        jck.save(str(tmp_path / "ref"), step, _jax_tree(tree), keep=2)
    listing = {d: sorted(os.listdir(tmp_path / d)) for d in ("port", "ref")}
    assert listing["port"] == listing["ref"] == ["LATEST", "step_00000005", "step_00000009"]
    assert tck.latest_step(str(tmp_path / "port")) == jck.latest_step(str(tmp_path / "ref")) == 9
    assert tck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), _torch_tree(tree))


def test_async_save_snapshots_now_and_writes_on_the_clock(tmp_path):
    t = torch.arange(4, dtype=torch.float32)
    with virtual_time():
        handle = tck.async_save(str(tmp_path), 4, {"t": t}, delay_s=5.0)
        t += 100  # mutated after the snapshot: the checkpoint keeps 0..3
        assert handle.wait(timeout=30) == str(tmp_path / "step_00000004")
    _, out = tck.restore(str(tmp_path), {"t": torch.zeros(4)})
    assert torch.equal(out["t"], torch.arange(4, dtype=torch.float32))

    ck = tck.AsyncCheckpointer(str(tmp_path / "bg"), keep=1)
    ck.save(1, {"t": t})
    ck.save(2, {"t": t * 2})
    ck.wait()
    assert tck.latest_step(str(tmp_path / "bg")) == 2
    assert sorted(os.listdir(tmp_path / "bg")) == ["LATEST", "step_00000002"]


def test_checkpointer_kernel_branch_loses_nothing():
    ck = TaskCheckpointer(DatasetRegistry(), EventBus(strict=False), interval_s=2.0)
    kernel = Task(kind="kernel", payload={"kernel": "rglru_scan", "reps": 4})
    assert ck.eligible(kernel)
    assert not ck.eligible(Task(kind="noop"))
    kernel.progress_frac = 0.75
    kernel.kernel_done_s = 1.5
    ck.on_preempt(kernel)
    assert kernel.progress_frac == 0.75
    assert kernel.resumes == 1 and kernel.retries == 0
    assert kernel.ckpt_dataset == f"ckpt:{kernel.uid}"
    assert kernel.ckpt_dataset in kernel.inputs
    assert ck.registry.known(kernel.ckpt_dataset)
    stats = ck.stats()
    assert stats["preempted_work_s"] == pytest.approx(1.5)
    assert stats["reexecuted_s"] == 0.0


def test_preempt_killed_kernel_task_resumes_at_its_rep_boundary(tmp_path):
    """Kill a running kernel task as the chaos engine does.  Its execution
    runs on to the end of its reps, as the reference's does (a kill marks
    the task and does not stop the loop); the resume then skips every rep
    already done and charges no retry."""
    h = Hydra(device="cpu", pod_store="memory", streaming=True, batch_window=0.0, workdir=str(tmp_path))
    h.register_provider(ProviderSpec(name="a", concurrency=1))
    h.register_provider(ProviderSpec(name="b", concurrency=1))
    ck = h.enable_task_checkpoints(interval_s=2.0)
    shape = {"E": 4, "C": 128, "D": 256, "F": 512}
    task = Task(kind="kernel", payload={"kernel": "moe_gmm", "shape": shape, "reps": 40, "seed": 3})
    h.dispatch([task])
    assert wait_until(lambda: task.tstate == TaskState.RUNNING and task.progress_frac > 0, timeout=60.0, poll=0.001)
    assert task.mark_failed(Preempted(task.provider or "?"))
    assert wait_until(task.done, timeout=120.0)
    result = task.result()
    assert task.tstate == TaskState.DONE and task.exception() is None
    assert task.retries == 0 and task.resumes == 1
    assert 0 < result["skipped_reps"] <= result["reps"] == 40
    assert task.ckpt_dataset in task.inputs
    assert ck.stats()["resumes"] == 1
    assert h.kernel_execs == 1 and h.kernel_reps == 40
    h.shutdown(wait=True)
