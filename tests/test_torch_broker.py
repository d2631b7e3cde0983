"""The PyTorch port's broker slice held against the JAX reference, on the CPU.

A reference ``Hydra`` and a port ``Hydra(device="cpu")`` run the same task
list through the streaming dispatcher to a CaaS and a pilot provider: one
2-rep kernel task per registered kernel at its tiny shape, 64 noops and 8
short sleeps.  They must agree on final states, results (the wall-clock
``kernel_s`` aside), kernel accounting and the multiset of event names.
The ORDER of events is not compared: the reference's own same-seed stream
identity is not ground truth on this tree (ROADMAP.md, queue 3).

Also here: the port never loads JAX, imports nothing of the reference
package, refuses a CUDA broker where no CUDA device exists, and raises a
typed error for what it does not port yet (the model steps).
"""
from __future__ import annotations

import ast
import collections
import concurrent.futures as cf
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import Hydra as JaxHydra
from repro.core import ProviderSpec as JaxProviderSpec
from repro.core import Task as JaxTask
from repro.core.provider import ProviderProxy as JaxProviderProxy
from repro_torch.core import Hydra, ProviderSpec, Task, TaskState
from repro_torch.core.managers.compute import COMPUTE_RUNTIME, KERNEL_RUNTIME
from repro_torch.core.provider import ProviderProxy
from repro_torch.kernels import ops
from repro_torch.kernels import registry as kreg

# the shapes here are small: one intra-op thread keeps the CPU free for the
# other test workers, whose timing-sensitive broker tests share the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _workload(task_cls) -> list:
    tasks = [
        task_cls(kind="kernel", payload={"kernel": name, "reps": 2, "seed": i})
        for i, name in enumerate(sorted(kreg.KERNELS))
    ]
    tasks += [task_cls(kind="noop") for _ in range(64)]
    tasks += [task_cls(kind="sleep", duration=0.005) for _ in range(8)]
    return tasks


def _drive(hydra, spec_cls, task_cls, tmp_path) -> dict:
    """Dispatch the workload in one call: 2 x 40 slots >= 76 tasks, so the
    dispatcher takes one batch and the event multiset is deterministic."""
    hydra.register_provider(spec_cls(name="cloud", platform="cloud", connector="caas", concurrency=40))
    hydra.register_provider(spec_cls(name="hpc", platform="hpc", connector="pilot", concurrency=40))
    tasks = _workload(task_cls)
    hydra.dispatch(tasks)
    _, pending = cf.wait(tasks, timeout=300)
    assert not pending
    out = {
        "states": [t.tstate.value for t in tasks],
        "results": [
            {k: v for k, v in r.items() if k != "kernel_s"} if isinstance(r, dict) else r
            for r in (t.result() for t in tasks)
        ],
        "execs_by": dict(hydra.kernel_execs_by),
        "reps": hydra.kernel_reps,
        "events": collections.Counter(e.name for e in hydra.events.events()),
    }
    hydra.shutdown(wait=True)  # strict event/ledger cross-checks (tests/conftest.py)
    return out


def test_port_broker_matches_reference_on_one_workload(tmp_path):
    ref = _drive(
        JaxHydra(streaming=True, pod_store="memory", workdir=str(tmp_path / "jax")),
        JaxProviderSpec, JaxTask, tmp_path,
    )
    before = ops.launch_counts()
    port = _drive(
        Hydra(streaming=True, pod_store="memory", workdir=str(tmp_path / "torch"), device="cpu"),
        ProviderSpec, Task, tmp_path,
    )
    assert set(port["states"]) == {TaskState.DONE.value}
    assert port["states"] == ref["states"]
    assert port["results"] == ref["results"]
    assert port["execs_by"] == ref["execs_by"] == {name: 1 for name in kreg.KERNELS}
    assert port["reps"] == ref["reps"] == 2 * len(kreg.KERNELS)
    assert port["events"] == ref["events"]
    assert ops.launch_counts() == before  # CPU providers ran the plain versions


def test_importing_the_port_does_not_load_jax():
    """Every module file of the port, namespace packages included."""
    code = (
        "import sys, importlib, pathlib, repro_torch\n"
        "root = pathlib.Path(repro_torch.__file__).parent\n"
        "for f in sorted(root.rglob('*.py')):\n"
        "    parts = ('repro_torch',) + f.relative_to(root).with_suffix('').parts\n"
        "    importlib.import_module('.'.join(p for p in parts if p != '__init__'))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('kernels.ops', 'kernels.autotune', 'ckpt.checkpoint', 'core.autoscaler', 'core.market',\n"
        "          'core.chaos', 'core.managers.workflow', 'facts.model', 'facts.workflow', 'scenarios.spec',\n"
        "          'scenarios.traffic', 'scenarios.presets', 'scenarios.runner', 'scenarios',\n"
        "          'configs', 'configs.base', 'configs.registry', 'configs.recurrentgemma_2b', 'models.spec',\n"
        "          'models.layers', 'models.attention', 'models.transformer', 'models.rglru', 'models.ssm',\n"
        "          'models.model', 'data.pipeline', 'launch.serve'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_module_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    offenders = {str(f.relative_to(ROOT)): r for f in files if (r := _imported_roots(f) & {"jax", "jaxlib", "repro"})}
    assert offenders == {}


def test_cuda_broker_refuses_to_start_without_a_cuda_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Hydra(workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA device"):
        Hydra(device="cuda", workdir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []  # raised before building anything


@pytest.mark.parametrize(
    "spec",
    [
        {"n_devices": 1, "device_offset": 0},
        {"n_devices": 3, "device_offset": 0},
        {"n_devices": 2, "device_offset": 4},
    ],
)
def test_provider_pools_wrap_like_the_reference(spec):
    """An oversubscribed pool shares the visible device (provider.py:272-281)."""
    ref = JaxProviderProxy().register(JaxProviderSpec(name="p", **spec))
    port = ProviderProxy(device="cpu").register(ProviderSpec(name="p", **spec))
    assert len(port.devices) == len(ref.devices)
    assert all(d == CPU for d in port.devices)


def test_unported_subsystems_raise_naming_the_roadmap(tmp_path):
    """A compute step of a model family not ported yet raises naming its
    ROADMAP item; the checkpointer, the autotuner and the autoscaler attach,
    and train and prefill steps run (tests/test_torch_train.py,
    tests/test_torch_serve.py)."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md.*item 4b"):
        COMPUTE_RUNTIME.run(Task(kind="compute", arch="grok-1-314b"), CPU)
    h = Hydra(device="cpu", pod_store="memory", workdir=str(tmp_path))
    assert h.enable_task_checkpoints() is h.checkpointer
    assert h.enable_kernel_autotune(timer="model") is h.autotuner
    assert h.autotuner.device == CPU
    h.shutdown(wait=True)


def test_compute_tasks_fail_with_a_typed_error(tmp_path):
    """A train-step compute task (the default step kind) of a family not
    ported yet fails through the broker with the typed error that names its
    ROADMAP item."""
    h = Hydra(device="cpu", pod_store="memory", streaming=True, workdir=str(tmp_path))
    h.register_provider(ProviderSpec(name="cloud"))
    task = Task(kind="compute", arch="grok-1-314b", max_retries=0)
    h.dispatch([task])
    cf.wait([task], timeout=60)
    assert task.tstate == TaskState.FAILED
    assert isinstance(task.exception(), NotImplementedError)
    assert "item 4b" in str(task.exception())
    h.shutdown(wait=True)


# ---------------------------------------------------------------------------
# KernelRuntime: the reference's rep-granular contract (test_kernel_tasks.py)
# ---------------------------------------------------------------------------


def test_kernel_runtime_executes_and_advances_progress():
    task = Task(kind="kernel", payload={"kernel": "moe_gmm", "reps": 2, "seed": 1})
    result = KERNEL_RUNTIME.run(task, CPU)
    assert result["kernel"] == "moe_gmm"
    assert result["reps"] == 2 and result["skipped_reps"] == 0
    assert result["kernel_s"] > 0
    assert task.progress_frac == 1.0
    assert task.kernel_stats["reps"] == 2
    kdef = kreg.get_kernel("moe_gmm")
    assert task.kernel_stats["config"] == kreg.config_sig(kdef.defaults(kdef.tiny_shape))


def test_kernel_runtime_resume_skips_completed_reps():
    task = Task(kind="kernel", payload={"kernel": "rglru_scan", "reps": 4})
    task.progress_frac = 0.5  # two of four reps completed before the kill
    task.kernel_done_s = 0.125
    result = KERNEL_RUNTIME.run(task, CPU)
    assert result["skipped_reps"] == 2 and result["reps"] == 4
    assert task.progress_frac == 1.0
    assert result["kernel_s"] > 0.125
    assert task.kernel_stats["kernel_s"] == result["kernel_s"]


def test_kernel_runtime_honors_explicit_payload_config_and_dtype():
    shape = {"B": 1, "H": 2, "KV": 1, "L": 64, "hd": 32, "causal": True, "window": 16}
    task = Task(
        kind="kernel",
        payload={"kernel": "flash_attention", "shape": shape, "dtype": "bfloat16", "config": {"block_q": 32, "block_k": 16}},
    )
    result = KERNEL_RUNTIME.run(task, CPU)
    assert result["config"] == "block_k=16,block_q=32"
    assert result["sig"] == kreg.shape_sig(shape, "bfloat16")
