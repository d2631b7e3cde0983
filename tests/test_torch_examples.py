"""The port's copies of the four examples (``repro_torch/examples``), on the
CPU at a small size, each with its reference example's own checks: every
FACTS workflow done and none failed, ``train_lm``'s "training must reduce
loss", and ``OK`` printed.  The draws differ from the reference's by design
(ROADMAP.md, "Random draws"), so the printed quantiles, tokens and losses
are not compared with it.  Also: the port's sharding and example modules
import no JAX, and an example runs as ``python -m``.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core import TaskState
from repro_torch.examples import facts_workflow, quickstart, serve_lm, train_lm
from repro_torch.kernels import ops

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# train_lm cut for the CPU: one layer at width 128 over a vocabulary of 128,
# 60 steps of 16 x 16 tokens (the loss falls 5.36 -> 5.10)
TRAIN_LM_SMALL = dict(steps=60, seq_len=16, global_batch=16, n_layers=1, d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=128)


def _ok(capsys) -> bool:
    return capsys.readouterr().out.rstrip().splitlines()[-1] == "OK"


def test_quickstart_brokers_every_task_and_prints_ok(capsys):
    out = quickstart.main(device="cpu", n_noops=50, n_sleeps=5)
    assert _ok(capsys)
    assert out["states"] == {TaskState.DONE.value: 50 + 5 + 2}, out["states"]
    assert np.isfinite([out["train"][k] for k in ("ce", "loss", "grad_norm", "lr")]).all()


def test_facts_workflow_runs_every_instance_to_done(capsys):
    out = facts_workflow.main(n_instances=4, n_samples=200, device="cpu")
    assert _ok(capsys) and len(out["p50s"]) == 4 and np.isfinite(out["p50s"]).all()


def test_serve_lm_serves_three_families_without_kernels_on_the_cpu(capsys):
    before = ops.launch_counts()
    outs = serve_lm.main(device="cpu", batch=2, prompt_len=16, gen=4)
    assert _ok(capsys) and list(outs) == list(serve_lm.ARCHS)
    assert all(o["logits_finite"] and o["tokens"].shape == (2, 4) for o in outs.values())
    assert ops.launch_counts() == before  # CPU tensors take the plain versions


def test_train_lm_reduces_the_loss(capsys):
    out = train_lm.main(device="cpu", **TRAIN_LM_SMALL)
    assert _ok(capsys) and out["steps"] == TRAIN_LM_SMALL["steps"] and out["final_loss"] < out["first_loss"]
    from repro_torch.configs.registry import ARCHS

    assert "llama3-100m" not in ARCHS  # the example leaves the registry as it found it


def test_examples_run_as_modules_and_the_port_imports_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.parallel.sharding, repro_torch.optim.compression, repro_torch.launch.mesh\n"
        "import repro_torch.train.step, repro_torch.launch.train\n"
        "import repro_torch.examples.train_lm, repro_torch.examples.quickstart, repro_torch.examples.serve_lm\n"
        "import repro_torch.examples.facts_workflow\n"
        "assert 'jax' not in sys.modules and not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('NO_JAX')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert "NO_JAX" in out.stdout, out.stdout + out.stderr
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.facts_workflow", "2", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.rstrip().splitlines()[-1] == "OK", out.stdout + out.stderr
