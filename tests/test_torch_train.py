"""The port's train path held against the JAX reference, on the CPU.

Loss, gradients and AdamW steps of the reduced configs in fp32, on the
reference's weights (``params_from_jax``) and optimizer state
(``train_state_from_jax``), batches drawn with numpy; the backward kernels'
plain versions (``kernels/ref.py``) against autodiff of the forward; the
remat policies and the chunked head against the plain path; ``kind="compute"``
train tasks through the broker; ``launch/train`` restarting from its
checkpoint.  On CPU tensors the kernel wrappers run their plain versions;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the backward kernels
against them on the card.

Tolerances: relative 1e-5 for the attention and RG-LRU gradients and for the
loss and its metrics; every gradient leaf within 1e-4 x the max-abs of the
reference's leaf; after three AdamW steps, m, v within relative 1e-4 and the
params within 1e-2 x peak_lr max-abs wherever the update is well conditioned
(see ``compare_train_steps``); 1e-6 between remat policies and between the
chunked and the plain head.  The measured errors are printed by
running this file as a script:

    PYTHONPATH=src python tests/test_torch_train.py
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import compat_make_mesh
from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.parallel.sharding import STRATEGIES
from repro.train import step as jstep
from repro_torch.configs import get_arch
from repro_torch.core import Hydra, ProviderSpec, Task, TaskState
from repro_torch.core.managers import compute
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattention
from repro_torch.models import layers as tlayers
from repro_torch.models import spec as tspec
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = ["llama3-8b", "recurrentgemma-2b", "falcon-mamba-7b"]
GRAD_REL = 1e-5  # attention / RG-LRU gradients and the loss, relative
LEAF_TOL = 1e-4  # each gradient leaf, x the max-abs of the reference's leaf
REMAT_TOL = 1e-6
B, L = 2, 24  # past the reduced hybrid's window of 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _leaf_errs(port_tree, ref_tree) -> dict:
    """Max-abs error of every leaf over the max-abs of the reference's leaf, by path."""
    port = dict(zip(_paths(ref_tree), tspec.tree_leaves(port_tree)))
    return {p: _rel(port[p], leaf) for p, leaf in zip(_paths(ref_tree), tspec.tree_leaves(ref_tree))}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _batch(cfg, seed=0) -> dict:
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=L, global_batch=B, seed=seed, family=cfg.family)
    return batch_at(dc, 0)


@contextlib.contextmanager
def reference_expm1_exact():
    """The reference with expm1's derivative taken as exp(x) (JAX's
    ``AccuracyMode.HIGHEST``), as the port's RG-LRU gates take it
    (``models/rglru.py``: ``_OneMinusExp``).  JAX's default derivative,
    expm1(x) + 1, cancels where exp(x) is small, and the reference's gradient
    of lam and of the recurrence gate then strays ~1e-4 (relative to the
    leaf's scale) from its float64 value (ROADMAP.md, "Found in the
    reference"); ``test_one_minus_exp_derivative_is_exact_where_expm1_cancels``
    shows the cancellation.  Only the derivative changes: expm1's values are
    the same."""
    real = jnp.expm1
    jnp.expm1 = lambda x: jax.lax.expm1(x, accuracy=jax.lax.AccuracyMode.HIGHEST)
    try:
        yield
    finally:
        jnp.expm1 = real


def _models(name: str, **kw):
    cfg_j = jget_arch(name).reduced()
    cfg_t = get_arch(name).reduced()
    if kw:
        cfg_j, cfg_t = dataclasses.replace(cfg_j, **kw), cfg_t.replace(**kw)
    return JModel(cfg_j), Model(cfg_t)


# ---------------------------------------------------------------------------
# The backward kernels' plain versions and the models' attention
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (B, Lq, H, KV, hd, causal, window): GQA, L off every block of 128
    (2, 40, 4, 2, 16, True, None),
    (1, 70, 4, 1, 16, True, 16),
    (1, 33, 6, 2, 32, True, 8),
    (2, 20, 2, 2, 16, False, None),
]


def compare_attention_grads(case) -> dict:
    b, lq, h, kv, hd, causal, window = case
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in ((b, lq, h, hd), (b, lq, kv, hd), (b, lq, kv, hd), (b, lq, h, hd)))
    jf = lambda q, k, v: jattention.attention(q, k, v, causal=causal, window=window)
    jo, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = tattention.attention(tq, tk, tv, causal=causal, window=window)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    # the plain backward, in the kernel's (B, H, L, hd) layout
    bhld = lambda a: torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a), 1, 2)))
    pgrads = ref.attention_bwd_ref(bhld(q), bhld(k), bhld(v), bhld(jo), bhld(do), causal=causal, window=window)
    pgrads = [g.transpose(1, 2) for g in pgrads]
    errs = {"out": _rel(to, jo)}
    for name, j, t, p in zip(("dq", "dk", "dv"), jgrads, tgrads, pgrads):
        errs[f"{name}_port"] = _rel(t, j)
        errs[f"{name}_plain_vs_jax"] = _rel(p, j)
        errs[f"{name}_plain_vs_port"] = _rel(p, t)
    return errs


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"B{c[0]}_L{c[1]}_H{c[2]}_KV{c[3]}_hd{c[4]}_{'causal' if c[5] else 'full'}_w{c[6]}")
def test_attention_gradients_match_jax_vjp(case):
    errs = compare_attention_grads(case)
    assert max(errs.values()) <= GRAD_REL, errs


def compare_rglru_grads(with_h0: bool) -> dict:
    rng = np.random.default_rng(2)
    Bb, Lr, dr = 2, 37, 24
    log_a = -rng.uniform(0.01, 0.5, (Bb, Lr, dr)).astype(np.float32)
    gx = rng.normal(size=(Bb, Lr, dr)).astype(np.float32)
    h0 = rng.normal(size=(Bb, dr)).astype(np.float32) if with_h0 else None
    dy = rng.normal(size=(Bb, Lr, dr)).astype(np.float32)
    dh = rng.normal(size=(Bb, dr)).astype(np.float32)
    args = [jnp.asarray(log_a), jnp.asarray(gx)] + ([jnp.asarray(h0)] if with_h0 else [])
    (jy, _), vjp = jax.vjp(lambda *a: jref.rglru_ref(*a), *args)
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    th0 = torch.from_numpy(h0) if with_h0 else None
    got = ref.rglru_bwd_ref(torch.from_numpy(log_a), th0, torch.from_numpy(np.array(jy)), torch.from_numpy(dy), torch.from_numpy(dh))
    names = ("dlog_a", "dgx", "dh0")[: len(jgrads)]
    return {n: _rel(g, j) for n, g, j in zip(names, got, jgrads)}


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
def test_rglru_backward_plain_version_matches_jax_vjp(with_h0):
    errs = compare_rglru_grads(with_h0)
    assert max(errs.values()) <= GRAD_REL, errs


def test_attention_function_wires_the_backward_on_cpu_tensors(monkeypatch):
    """``ops``' autograd Function, with its forward launcher replaced by the
    plain version (the CUDA kernel cannot run here): its gradient is the
    backward wrapper's, routed to ``attention_bwd_ref``, and equals autograd
    of the plain forward; the backward counter does not move on the CPU."""
    monkeypatch.setattr(tfa, "flash_attention", lambda q, k, v, causal, window: ref.attention_ref(q, k, v, causal=causal, window=window))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).requires_grad_() for s in ((1, 4, 30, 16), (1, 2, 30, 16), (1, 2, 30, 16)))
    before = ops.backward_launch_counts()
    o = ops._FlashAttention.apply(q, k, v, True, 8)
    do = torch.randn(o.shape, generator=g)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(ref.attention_ref(q, k, v, causal=True, window=8), (q, k, v), do)
    assert o.grad_fn is not None
    assert max(_rel(a, b) for a, b in zip(got, want)) <= GRAD_REL
    assert ops.backward_launch_counts() == before


def test_rglru_function_wires_the_backward_on_cpu_tensors(monkeypatch):
    monkeypatch.setattr(trg, "rglru_scan", lambda log_a, gx, h0: ref.rglru_ref(log_a, gx, h0))
    g = torch.Generator().manual_seed(1)
    log_a = (-torch.rand(2, 19, 8, generator=g)).requires_grad_()
    gx, h0 = torch.randn(2, 19, 8, generator=g).requires_grad_(), torch.randn(2, 8, generator=g).requires_grad_()
    y, h_last = ops._RGLRUScan.apply(log_a, gx, h0)
    dy, dh = torch.randn(y.shape, generator=g), torch.randn(h_last.shape, generator=g)
    got = torch.autograd.grad((y, h_last), (log_a, gx, h0), (dy, dh))
    y2, h2 = ref.rglru_ref(log_a, gx, h0)
    want = torch.autograd.grad((y2, h2), (log_a, gx, h0), (dy, dh))
    assert max(_rel(a, b) for a, b in zip(got, want)) <= GRAD_REL


def test_one_minus_exp_derivative_is_exact_where_expm1_cancels():
    """The RG-LRU gates' 1 - exp(2 log_a) differentiates to -exp(x) itself;
    expm1's default derivative in both frameworks, expm1(x) + 1, keeps no
    digit of exp(x) below x = -17 in fp32 and loses them on the way there."""
    from repro_torch.models.rglru import _OneMinusExp

    x = torch.linspace(-40.0, -0.01, 257, dtype=torch.float32, requires_grad=True)
    (got,) = torch.autograd.grad(_OneMinusExp.apply(x).sum(), x)
    want = -torch.exp(x.detach().double())
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=0)
    assert torch.equal(_OneMinusExp.apply(x).detach(), -torch.expm1(x.detach()))
    default = np.asarray(jax.grad(lambda z: -jnp.sum(jnp.expm1(z)))(jnp.asarray(x.detach().numpy())), np.float64)
    rel = np.abs(default - want.numpy()) / np.abs(want.numpy())
    assert rel.max() > 0.5 and rel[x.detach().numpy() > -1].max() < 1e-6  # exact near 0, lost far from it


def test_kernels_without_a_backward_refuse_gradients():
    """The fault guard: under grad mode, an operand that requires grad is
    refused naming the ROADMAP item; without grad, or with no operand that
    requires grad, it passes (on the card the launch follows)."""
    x = torch.zeros(2, requires_grad=True)
    for kernel, item in (("selective_scan_chunk", "selective_scan backward"), ("moe_gmm", "item 4b")):
        with pytest.raises(ops.BackwardNotPorted, match=f"ROADMAP.md.*{item}"):
            ops._refuse_grad(kernel, {"x": x, "y": torch.zeros(2)})
        with torch.no_grad():
            ops._refuse_grad(kernel, {"x": x})
        ops._refuse_grad(kernel, {"x": x.detach()})
    assert issubclass(ops.BackwardNotPorted, NotImplementedError)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


def compare_loss_and_grads(name: str) -> dict:
    jm, tm = _models(name)
    jparams = jm.init(jax.random.key(0))
    batch = _batch(jm.cfg)
    with reference_expm1_exact():
        (jloss, jmetrics), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tspec.params_from_jax(_np(jparams), "cpu")
    leaves = tspec.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(metrics) == sorted(jmetrics)
    errs = {f"metric_{k}": _rel(metrics[k], jmetrics[k]) for k in jmetrics}
    it = iter(grads)
    errs.update({f"grad{p}": e for p, e in _leaf_errs(tspec.tree_map(lambda _: next(it), params), _np(jgrads)).items()})
    return errs


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_the_reference(name):
    errs = compare_loss_and_grads(name)
    metric = {k: e for k, e in errs.items() if k.startswith("metric_")}
    leaves = {k: e for k, e in errs.items() if k.startswith("grad")}
    assert max(metric.values()) <= GRAD_REL, metric
    assert max(leaves.values()) <= LEAF_TOL, sorted(leaves.items(), key=lambda kv: -kv[1])[:4]


def compare_train_steps(name: str, n_steps: int = 3) -> dict:
    jm, tm = _models(name)
    opt_j = jadamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    opt_t = adamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    mesh = compat_make_mesh((1,), ("data",))
    jfn = jax.jit(jstep.make_train_step(jm, STRATEGIES["tp"], mesh, opt_j))
    jparams, jopt = jstep.init_train_state(jm, jax.random.key(0))
    params, opt = tspec.train_state_from_jax(_np(jparams), _np(jopt), "cpu")
    tfn = tstep.make_train_step(tm, opt_t)
    dc = DataConfig(vocab_size=jm.cfg.vocab_size, seq_len=L, global_batch=B, family=jm.cfg.family)
    # AdamW's first steps move a param by ~ g / (|g| + eps): where sqrt(v-hat)
    # is within 100 eps of 0, fp32 noise in g (1e-7 of the leaf's scale) is
    # amplified by 1/eps, and one element of a llama3-8b leaf with |g| ~ 2e-9
    # moves 5e-2 x lr apart.  The params are held to 1e-2 x peak_lr wherever
    # every step's update was well conditioned in both (or g was exactly 0 in
    # both); the share of the other elements is reported and bounded.
    ill = [np.zeros(t.shape, bool) for t in tspec.tree_leaves(params)]
    errs = {}
    for i in range(n_steps):
        batch = batch_at(dc, i)
        with reference_expm1_exact():
            jparams, jopt, jmetrics = jfn(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, metrics = tfn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(metrics) == sorted(jmetrics)
        errs[f"step{i}_metrics"] = max(_rel(metrics[k], jmetrics[k]) for k in jmetrics)
        floor = (100 * opt_t.eps) ** 2 * (1 - opt_t.b2 ** (i + 1))  # sqrt(v-hat) = 100 eps
        for mask, tv, jv in zip(ill, tspec.tree_leaves(opt["v"]), tspec.tree_leaves(_np(jopt)["v"])):
            lo, hi = np.minimum(tv.numpy(), jv), np.maximum(tv.numpy(), jv)
            mask |= (lo < floor) & (hi > 0)
    jp, jo = _np(jparams), _np(jopt)
    well, worst_ill = 0.0, 0.0
    for t, r, mask in zip(tspec.tree_leaves(params), tspec.tree_leaves(jp), ill):
        d = np.abs(t.detach().numpy() - r) / opt_t.peak_lr
        well = max(well, float(d[~mask].max(initial=0.0)))
        worst_ill = max(worst_ill, float(d[mask].max(initial=0.0)))
    errs["params_over_lr"], errs["params_over_lr_ill_conditioned"] = well, worst_ill
    errs["ill_conditioned_share"] = sum(int(m.sum()) for m in ill) / sum(m.size for m in ill)
    errs["m"] = max(_leaf_errs(opt["m"], jo["m"]).values())
    errs["v"] = max(_leaf_errs(opt["v"], jo["v"]).values())
    errs["step"] = abs(int(opt["step"]) - int(jo["step"]))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == n_steps
    return errs


@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_match_the_reference(name):
    errs = compare_train_steps(name)
    assert errs["params_over_lr"] <= 1e-2 and errs["ill_conditioned_share"] <= 2e-2, errs
    assert errs["m"] <= 1e-4 and errs["v"] <= 1e-4 and errs["step"] == 0, errs
    assert max(v for k, v in errs.items() if k.endswith("_metrics")) <= 1e-4, errs


def _loss_grads(model: Model, params, batch):
    leaves = tspec.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def compare_variants(name: str) -> dict:
    """The chunked head (logit_chunk=8) and each remat policy against the
    plain path, on one set of weights."""
    base = get_arch(name).reduced()
    params = Model(base).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(base)
    loss0, metrics0, grads0 = _loss_grads(Model(base), params, batch)
    errs = {}
    for label, kw in [("logit_chunk8", {"logit_chunk": 8}), ("remat_dots", {"remat": "dots"}), ("remat_full", {"remat": "full"})]:
        loss, metrics, grads = _loss_grads(Model(base.replace(**kw)), params, batch)
        assert sorted(metrics) == sorted(metrics0)
        errs[label] = max([_rel(loss, loss0)] + [_rel(metrics[k], metrics0[k]) for k in metrics0] + [_rel(g, g0) for g, g0 in zip(grads, grads0)])
    return errs


@pytest.mark.parametrize("name", ARCHS)
def test_chunked_head_and_remat_policies_agree_with_the_plain_path(name):
    errs = compare_variants(name)
    assert max(errs.values()) <= REMAT_TOL, errs


def test_remat_dots_saves_the_matmuls_and_recomputes_the_kernels(monkeypatch):
    """Under "dots" the backward recomputes each layer's forward but not its
    matrix products: the attention wrapper runs twice a layer (once in the
    forward, once in the recompute), the products once; under "none" once."""
    calls = {"attn": 0, "mm": 0}
    real_attention = ops.flash_attention

    def counted(*a, **kw):
        calls["attn"] += 1
        return real_attention(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    cfg = get_arch("llama3-8b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    for policy, want in (("none", 2), ("dots", 4), ("full", 4)):
        calls["attn"] = 0
        _loss_grads(Model(cfg.replace(remat=policy)), params, batch)
        assert calls["attn"] == want, (policy, calls)
    assert tlayers.remat_policy("none") is None
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md.*item 6"):
        tlayers.remat_policy("collectives")
    with pytest.raises(ValueError):
        tlayers.remat_policy("bogus")


def test_train_state_crosses_from_the_reference():
    jm, tm = _models("recurrentgemma-2b")
    jparams, jopt = jstep.init_train_state(jm, jax.random.key(0))
    params, opt = tspec.train_state_from_jax(_np(jparams), _np(jopt), "cpu")
    assert set(opt) == {"m", "v", "step"} and opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
    for tree in (opt["m"], opt["v"]):
        assert all(t.dtype == torch.float32 and not t.any() for t in tspec.tree_leaves(tree))
    assert [tuple(t.shape) for t in tspec.tree_leaves(opt["m"])] == [tuple(t.shape) for t in tspec.tree_leaves(params)]
    spec = adamw.opt_state_specs(tm.specs())
    jspec = jadamw.opt_state_specs(jm.specs())
    assert spec["step"].dtype == jspec["step"].dtype == "int32"
    assert [(s.shape, s.axes, s.dtype) for s in tspec.tree_leaves(spec["m"])] == [
        (s.shape, s.axes, s.dtype) for s in jax.tree.leaves(jspec["m"], is_leaf=lambda x: hasattr(x, "axes"))
    ]


def test_step_builders_match_the_model_and_the_reference_metrics():
    jm, tm = _models("llama3-8b")
    assert tstep.metrics_struct(tm) == jstep.metrics_struct(jm)
    params, opt = tstep.init_train_state(tm, torch.Generator().manual_seed(0), "cpu")
    assert int(opt["step"]) == 0
    tokens = torch.from_numpy(_batch(tm.cfg)["tokens"])
    logits, cache = tstep.make_prefill_step(tm, cache_len=L + 2)(params, {"tokens": tokens})
    want_logits, _ = tm.prefill(params, {"tokens": tokens}, cache_len=L + 2)
    assert torch.equal(logits, want_logits) and logits.grad_fn is None
    pos = torch.full((B,), L, dtype=torch.int32)
    step_logits, _ = tstep.make_decode_step(tm)(params, cache, {"tokens": tokens[:, -1:], "pos": pos})
    assert step_logits.shape == (B, 1, tm.cfg.vocab_size) and step_logits.grad_fn is None


# ---------------------------------------------------------------------------
# The broker's compute train tasks and the standalone driver
# ---------------------------------------------------------------------------


def test_compute_train_tasks_keep_their_state_and_report_the_reference_metrics(tmp_path):
    """Train tasks through ``Hydra(device="cpu")``: the metrics' keys are the
    reference's (loss, optimizer), the state carries from task to task (the
    optimizer's step counts them), and every ported family trains."""
    jm, _ = _models("llama3-8b")
    want_keys = sorted(list(jstep.metrics_struct(jm)) + ["grad_norm", "lr"])
    rt = compute.ComputeRuntime()
    cpu = torch.device("cpu")
    first = rt.run(Task(kind="compute", arch="llama3-8b", step_kind="train"), cpu)
    second = rt.run(Task(kind="compute", arch="llama3-8b"), cpu)  # train is the default step kind
    assert sorted(first) == sorted(second) == want_keys
    assert first["tokens"] == 32.0 and first["lr"] < second["lr"]  # warmup: the step advanced
    assert int(rt._states[("llama3-8b", "train", "cpu")][1]["step"]) == 2
    assert all(np.isfinite(v) for v in (*first.values(), *second.values()))

    h = Hydra(device="cpu", pod_store="memory", streaming=True, workdir=str(tmp_path))
    h.register_provider(ProviderSpec(name="cloud"))
    tasks = [Task(kind="compute", arch=a, step_kind="train", max_retries=0) for a in ARCHS for _ in range(2)]
    try:
        h.dispatch(tasks)
        _, pending = cf.wait(tasks, timeout=120)
        assert not pending
        for t in tasks:
            assert t.tstate == TaskState.DONE, t.exception()
            assert sorted(t.result()) == want_keys and all(np.isfinite(v) for v in t.result().values())
    finally:
        h.shutdown(wait=True)
    for a in ARCHS:
        assert int(compute.COMPUTE_RUNTIME._states[(a, "train", "cpu")][1]["step"]) >= 2


def test_compute_train_task_matches_the_reference_runtime():
    """One train task of the port's runtime on the reference's initial state
    against the reference's runtime: the same metrics."""
    from repro.core.managers import compute as jcompute
    from repro.core.task import Task as JTask

    jrt = jcompute.ComputeRuntime()
    want = jrt.run(JTask(kind="compute", arch="falcon-mamba-7b", step_kind="train"))
    jparams, jopt = jrt._states[("falcon-mamba-7b", "train")]
    # the reference's state after its step, so rebuild its initial state to carry across
    jm = JModel(jget_arch("falcon-mamba-7b").reduced())
    jparams, jopt = jstep.init_train_state(jm, jax.random.key(0))
    rt = compute.ComputeRuntime()
    key = ("falcon-mamba-7b", "train", "cpu")
    rt._states[key] = tspec.train_state_from_jax(_np(jparams), _np(jopt), "cpu")
    got = rt.run(Task(kind="compute", arch="falcon-mamba-7b", step_kind="train"), torch.device("cpu"))
    assert sorted(got) == sorted(want)
    assert max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want) <= 1e-4, (got, want)


def test_train_restarts_from_its_checkpoint_bit_for_bit(tmp_path, monkeypatch):
    """Four steps straight equal two steps, a crash, a restart from the
    checkpoint of step 2 and two more steps: every param and moment bit."""
    kw = dict(steps=4, seq_len=16, global_batch=2, ckpt_every=2, log_every=0, device="cpu")
    straight = ttrain.train("recurrentgemma-2b", ckpt_dir=str(tmp_path / "a"), **kw)

    class Crash(Exception):
        pass

    class CrashAfterSave(ttrain.ckpt_lib.AsyncCheckpointer):
        def save(self, step, state_tree):
            super().save(step, state_tree)
            raise Crash

    with monkeypatch.context() as m:
        m.setattr(ttrain.ckpt_lib, "AsyncCheckpointer", CrashAfterSave)
        with pytest.raises(Crash):
            ttrain.train("recurrentgemma-2b", ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = ttrain.train("recurrentgemma-2b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed["steps"] == 2 and straight["steps"] == 4
    assert resumed["losses"] == straight["losses"][2:]
    for a, b in zip(tspec.tree_leaves(straight["params"]), tspec.tree_leaves(resumed["params"])):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        for a, b in zip(tspec.tree_leaves(straight["opt"][k]), tspec.tree_leaves(resumed["opt"][k])):
            assert torch.equal(a, b)
    assert int(resumed["opt"]["step"]) == 4


def test_train_driver_refuses_a_strategy_and_the_card_without_one():
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md.*item 6"):
        ttrain.train("llama3-8b", steps=1, strategy_name="fsdp_tp", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.train("llama3-8b", steps=1)


if __name__ == "__main__":
    for case in ATTN_CASES:
        print("attention", case, compare_attention_grads(case))
    for with_h0 in (True, False):
        print("rglru_bwd", "h0" if with_h0 else "no_h0", compare_rglru_grads(with_h0))
    for name in ARCHS:
        errs = compare_loss_and_grads(name)
        worst = max((k for k in errs if k.startswith("grad")), key=errs.get)
        print(name, "loss/metrics", {k: v for k, v in errs.items() if k.startswith("metric_")}, "worst grad leaf", worst, errs[worst])
    for name in ARCHS:
        print(name, "3 train steps", compare_train_steps(name))
    for name in ARCHS:
        print(name, "chunked head / remat", compare_variants(name))
