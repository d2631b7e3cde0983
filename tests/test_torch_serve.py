"""The port's serve path against the JAX reference, on the CPU: the serving
entry point, the data pipeline and ``kind="compute"`` prefill tasks on the broker.

Weights cross from the reference's ``Model.init`` through numpy
(``params_from_jax``), the vlm family's tanh gates opened in both
(``open_gates``: at their init of zero the images would not reach the
tokens); prompts, and after them the audio frames and the image
embeddings, are drawn with numpy from the same seed in both packages, so
greedy decoding must give the reference's tokens exactly.
Sampled tokens (``temperature > 0``) come from a ``torch.Generator`` and differ
from the reference's ``jax.random`` draws by design (ROADMAP.md §3).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.data import pipeline as jpipe
from repro.launch import serve as jserve_module
from repro.launch.serve import serve as jserve
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import Hydra, ProviderSpec, Task, TaskState
from repro_torch.core.managers import compute
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models.model import Model
from repro_torch.models.spec import params_from_jax
from test_torch_models import open_gates

torch.set_num_threads(1)

SERVE_ARCHS = [
    "llama3-8b", "falcon-mamba-7b", "recurrentgemma-2b", "grok-1-314b", "arctic-480b", "seamless-m4t-medium",
    "llama-3.2-vision-11b",
]


class _OpenedModel(JModel):
    """The reference's model with the vlm gates opened at init."""

    def init(self, rng):
        return open_gates(super().init(rng))


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_greedy_serve_gives_the_reference_tokens(name, monkeypatch):
    kw = dict(batch=2, prompt_len=12, gen=6, seed=3)
    monkeypatch.setattr(jserve_module, "Model", _OpenedModel)  # the reference's serve draws its weights through it
    ref = jserve(name, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, _OpenedModel(jget_arch(name).reduced()).init(jax.random.key(3))), "cpu")
    before = ops.launch_counts()
    out = serve(name, device="cpu", params=params, **kw)
    assert ops.launch_counts() == before  # CPU tensors: the plain versions ran
    assert out["tokens"].shape == (2, 6) and out["tokens"].dtype == np.int32
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert out["logits_finite"] and out["peak_mem_bytes"] is None and out["device"] == "cpu"
    assert set(out["prefill_launches"].values()) == {0} and set(out["decode_launches"].values()) == {0}
    assert set(ref) <= set(out)
    assert out["prefill_s"] > 0 and out["tokens_per_s"] > 0


def test_sampled_serve_draws_from_a_torch_generator():
    kw = dict(batch=2, prompt_len=8, gen=10, temperature=1.0, device="cpu")
    a, b = serve("recurrentgemma-2b", seed=0, **kw), serve("recurrentgemma-2b", seed=0, **kw)
    c = serve("recurrentgemma-2b", seed=1, **kw)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 256


def test_serve_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve("llama3-8b")


def test_unported_families_raise_naming_the_roadmap():
    """No family is left unported: ``Model`` takes every config, and the two
    that raised last, audio and vlm, serve from weights drawn from the seed,
    their frontend stubs drawn after the prompts (the same seed, the same
    tokens)."""
    from repro_torch.configs import ARCHS

    for name in ARCHS:
        Model(get_arch(name).reduced())
    for name in ("seamless-m4t-medium", "llama-3.2-vision-11b"):
        a, b = (serve(name, device="cpu", batch=2, prompt_len=8, gen=4) for _ in range(2))
        assert a["tokens"].shape == (2, 4) and a["logits_finite"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["dense", "audio", "vlm"])
def test_batches_equal_the_reference(family):
    kw = dict(vocab_size=256, seq_len=16, global_batch=2, seed=5, enc_len=4, d_model=8, n_img_tokens=3, family=family)
    for step in (0, 1, 7):
        want = jpipe.batch_at(jpipe.DataConfig(**kw), step)
        got = tpipe.batch_at(tpipe.DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    want = jpipe.data_config_for(jget_arch("seamless-m4t-medium"), jget_shape("train_4k"), seed=2)
    got = tpipe.data_config_for(get_arch("seamless-m4t-medium"), get_shape("train_4k"), seed=2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_prefetcher_moves_batches_to_the_device():
    cfg = tpipe.DataConfig(vocab_size=100, seq_len=8, global_batch=3, seed=1)
    pf = tpipe.Prefetcher(cfg, start_step=4, depth=2, device="cpu")
    try:
        for want_step in (4, 5, 6):
            step, batch = next(pf)
            assert step == want_step
            ref = tpipe.batch_at(cfg, step)
            for k, v in batch.items():
                assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
                assert np.array_equal(v.numpy(), ref[k])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# kind="compute" prefill tasks through the broker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_compute_prefill_task_finishes_through_the_broker(name, tmp_path):
    h = Hydra(device="cpu", pod_store="memory", streaming=True, workdir=str(tmp_path))
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    h.register_provider(ProviderSpec(name="hpc", platform="hpc", connector="pilot"))
    tasks = [Task(kind="compute", arch=name, step_kind="prefill", max_retries=0) for _ in range(3)]
    builds = compute.ARTIFACTS.builds
    try:
        h.dispatch(tasks)
        done, pending = cf.wait(tasks, timeout=120)
        assert not pending
        for t in tasks:
            assert t.tstate == TaskState.DONE, t.exception()
            assert t.result() == {"logits_shape": [2, 1, 256]}
    finally:
        h.shutdown(wait=True)
    assert compute.ARTIFACTS.builds - builds <= 1  # one model and params per (arch, step kind, device)


def test_compute_prefill_reuses_its_artifact_on_a_retry():
    rt = compute.ComputeRuntime()
    cpu = torch.device("cpu")
    task = Task(kind="compute", arch="falcon-mamba-7b", step_kind="prefill")
    first = rt.run(task, cpu)
    hits = compute.ARTIFACTS.hits
    task.retries = 1
    assert rt.run(task, cpu) == first == {"logits_shape": [2, 1, 256]}
    assert compute.ARTIFACTS.hits == hits + 1


def test_compute_train_step_raises_naming_the_train_slice():
    """The train slice is ported (tests/test_torch_train.py) for every
    family: a train step of the audio and of the vlm family (the last two
    to raise here) returns the reference's metrics, the default step kind
    is train, and only a step kind the reference lacks is refused."""
    rt = compute.ComputeRuntime()
    for task in (Task(kind="compute", arch="seamless-m4t-medium", step_kind="train"),
                 Task(kind="compute", arch="llama-3.2-vision-11b")):
        out = rt.run(task, torch.device("cpu"))
        assert sorted(out) == ["ce", "grad_norm", "loss", "lr", "tokens"] and all(np.isfinite(v) for v in out.values())
        assert int(rt._states[(task.arch, "train", "cpu")][1]["step"]) == 1
    with pytest.raises(ValueError):
        compute.COMPUTE_RUNTIME.run(Task(kind="compute", arch="llama3-8b", step_kind="decode"), torch.device("cpu"))
