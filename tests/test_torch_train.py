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
from test_torch_models import open_gates

torch.set_num_threads(1)

ARCHS = [
    "llama3-8b", "recurrentgemma-2b", "falcon-mamba-7b", "grok-1-314b", "arctic-480b", "seamless-m4t-medium",
    "llama-3.2-vision-11b",
]
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


def _data(cfg, **kw) -> DataConfig:
    """The reduced config's data, its frontend stubs included (``enc_len``
    frames for audio, ``n_img_tokens`` patches for vlm); ``kw`` overrides
    (``seq_len``, ``global_batch``, ``seed``)."""
    return DataConfig(**{**dict(vocab_size=cfg.vocab_size, seq_len=L, global_batch=B, enc_len=cfg.enc_len_train,
                                d_model=cfg.d_model, n_img_tokens=cfg.n_img_tokens, family=cfg.family), **kw})


def _batch(cfg, seed=0) -> dict:
    return batch_at(_data(cfg, seed=seed), 0)


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
    # the same with the LSE given, as the wgmma route's forward hands it over
    lse = ref.attention_lse_ref(bhld(q), bhld(k), causal=causal, window=window)
    lgrads = ref.attention_bwd_ref(bhld(q), bhld(k), bhld(v), bhld(jo), bhld(do), causal=causal, window=window, lse=lse)
    lgrads = [g.transpose(1, 2) for g in lgrads]
    errs = {"out": _rel(to, jo)}
    for name, j, t, p, pl in zip(("dq", "dk", "dv"), jgrads, tgrads, pgrads, lgrads):
        errs[f"{name}_port"] = _rel(t, j)
        errs[f"{name}_plain_vs_jax"] = _rel(p, j)
        errs[f"{name}_plain_vs_port"] = _rel(p, t)
        errs[f"{name}_plain_lse_vs_jax"] = _rel(pl, j)
        errs[f"{name}_plain_lse_vs_plain"] = _rel(pl, p)
    return errs


_ATTN_ID = lambda c: f"B{c[0]}_L{c[1]}_H{c[2]}_KV{c[3]}_hd{c[4]}_{'causal' if c[5] else 'full'}_w{c[6]}"


@pytest.mark.parametrize("case", ATTN_CASES, ids=_ATTN_ID)
def test_attention_gradients_match_jax_vjp(case):
    errs = compare_attention_grads(case)
    assert max(errs.values()) <= GRAD_REL, errs


def compare_attention_lse(case) -> float:
    """``ref.attention_lse_ref`` (base 2, (B,H,Lq)) against JAX's logsumexp
    of the reference's masked scores (``models/attention.py``: scale, mask,
    ``_NEG`` where masked), times log2(e)."""
    b, lq, h, kv, hd, causal, window = case
    rng = np.random.default_rng(1)
    q, k = (rng.normal(size=s).astype(np.float32) for s in ((b, lq, h, hd), (b, lq, kv, hd)))
    s = jnp.einsum("blhd,bchd->blhc", q, np.repeat(k, h // kv, axis=2)) * (1.0 / hd**0.5)
    q_pos, k_pos = np.arange(lq)[:, None], np.arange(lq)[None, :]
    mask = np.ones((lq, lq), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = jnp.where(mask[None, :, None, :], s, jattention._NEG)
    want = np.swapaxes(np.asarray(jax.nn.logsumexp(s, axis=-1)), 1, 2) * np.log2(np.e)
    bhld = lambda a: torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))
    return _rel(ref.attention_lse_ref(bhld(q), bhld(k), causal=causal, window=window), want)


@pytest.mark.parametrize("case", ATTN_CASES, ids=_ATTN_ID)
def test_attention_lse_plain_version_matches_jax_logsumexp(case):
    assert compare_attention_lse(case) <= GRAD_REL


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
    of the plain forward; the backward counter does not move on the CPU.
    With ``keep_lse`` the forward's ``lse`` out argument is filled and that
    very tensor reaches the backward.  ``ops.flash_attention`` (taken here
    as if on the card) asks for it, on every route, only when a gradient
    will be taken."""
    seen = {"forward": [], "backward": []}

    def forward(q, k, v, causal, window, lse=None, config=None):  # the launcher: fills lse, returns o
        seen["forward"].append(lse)
        if lse is not None:
            lse.copy_(ref.attention_lse_ref(q, k, causal=causal, window=window))
        return ref.attention_ref(q, k, v, causal=causal, window=window)

    plain_bwd = ref.attention_bwd_ref

    def backward(*args, lse=None, **kw):
        seen["backward"].append(lse)
        return plain_bwd(*args, lse=lse, **kw)

    monkeypatch.setattr(tfa, "flash_attention", forward)
    monkeypatch.setattr(ref, "attention_bwd_ref", backward)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).requires_grad_() for s in ((1, 4, 30, 16), (1, 2, 30, 16), (1, 2, 30, 16)))
    do = torch.randn((1, 4, 30, 16), generator=g)
    want = torch.autograd.grad(ref.attention_ref(q, k, v, causal=True, window=8), (q, k, v), do)
    before = ops.backward_launch_counts()
    for keep_lse in (False, True):
        o = ops._FlashAttention.apply(q, k, v, True, 8, keep_lse)
        got = torch.autograd.grad(o, (q, k, v), do)
        assert o.grad_fn is not None
        assert max(_rel(a, b) for a, b in zip(got, want)) <= GRAD_REL
        lse = seen["forward"][-1]
        assert seen["backward"][-1] is lse
        if keep_lse:
            assert lse.shape == (1, 4, 30) and torch.equal(lse, ref.attention_lse_ref(q, k, causal=True, window=8))
        else:
            assert lse is None
    assert ops.backward_launch_counts() == before

    monkeypatch.setattr(ops, "_on_card", lambda *args: True)
    for route, grad, operands, keeps in (
        ("wgmma", True, (q, k, v), True),
        ("wgmma", False, (q, k, v), False),
        ("wgmma", True, (q.detach(), k.detach(), v.detach()), False),
        ("tf32x3", True, (q, k, v), True),
        ("tf32x3", False, (q, k, v), False),
        ("tf32", True, (q, k, v), True),
        ("tf32x3_cluster", True, (q.detach(), k.detach(), v.detach()), False),
    ):
        monkeypatch.setattr(tfa, "bwd_route", lambda dtype, hd: route)
        with torch.set_grad_enabled(grad):
            ops.flash_attention(*operands, causal=True, window=8)
        assert (seen["forward"][-1] is not None) == keeps, (route, grad)


def test_rglru_function_wires_the_backward_on_cpu_tensors(monkeypatch):
    monkeypatch.setattr(trg, "rglru_scan", lambda log_a, gx, h0, config=None: ref.rglru_ref(log_a, gx, h0))
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


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


def compare_loss_and_grads(name: str, **kw) -> dict:
    """The loss, its metrics and every gradient leaf (keyed ``grad/<path>``)
    of the reduced config (``kw`` replaces config fields in both), against
    ``jax.value_and_grad`` of the reference, the vlm gates opened."""
    jm, tm = _models(name, **kw)
    jparams = open_gates(jm.init(jax.random.key(0)))
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


def one_rank_steps(model: Model, opt_cfg: adamw.AdamWConfig):
    """The port's train step on one device, as a ``port_run`` of
    ``compare_train_steps``: (params, opt, numpy batches) -> yields (params,
    opt, metrics) after each step."""
    fn = tstep.make_train_step(model, opt_cfg)

    def run(params, opt, batches):
        for batch in batches:
            params, opt, metrics = fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
            yield params, opt, metrics

    return run


def compare_train_steps(name: str, n_steps: int = 3, port_run=None, **data_kw) -> dict:
    """The reference's and the port's ``n_steps`` train steps from the
    reference's initial state.  ``port_run(model, opt_cfg)`` builds the
    port's run (``one_rank_steps`` by default); ``data_kw`` overrides the
    batch (``_data``)."""
    jm, tm = _models(name)
    opt_j = jadamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    opt_t = adamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    mesh = compat_make_mesh((1,), ("data",))
    jfn = jax.jit(jstep.make_train_step(jm, STRATEGIES["tp"], mesh, opt_j))
    jparams, jopt = jstep.init_train_state(jm, jax.random.key(0))
    jparams = open_gates(jparams)
    params, opt = tspec.train_state_from_jax(_np(jparams), _np(jopt), "cpu")
    dc = _data(jm.cfg, **data_kw)
    port = (port_run or one_rank_steps)(tm, opt_t)(params, opt, [batch_at(dc, i) for i in range(n_steps)])
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
        params, opt, metrics = next(port)
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


# the share of parameter elements whose AdamW update may be ill conditioned
# (see compare_train_steps): an expert sees only the tokens routed to it
# (about half of the 48 at the reduced top-2 of 4), so more of its gradient
# elements lie near eps; arctic-480b's reads 2.3e-2, 3.9e-2 in one expert leaf
ILL_SHARE = {"moe": 5e-2}


@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_match_the_reference(name):
    errs = compare_train_steps(name)
    share = ILL_SHARE.get(get_arch(name).family, 2e-2)
    assert errs["params_over_lr"] <= 1e-2 and errs["ill_conditioned_share"] <= share, errs
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
    params = open_gates(Model(base).init(torch.Generator().manual_seed(0), "cpu"))
    batch = _batch(base)
    loss0, metrics0, grads0 = _loss_grads(Model(base), params, batch)
    errs = {}
    for label, kw in [("logit_chunk8", {"logit_chunk": 8}), ("remat_dots", {"remat": "dots"}), ("remat_full", {"remat": "full"}),
                      ("remat_collectives", {"remat": "collectives"})]:
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
    forward, once in the recompute), the products once; under "none" once.
    Under "collectives" the policy saves the two ``post_collective`` outputs
    of each layer (``transformer.py:86,88`` in the reference) and nothing
    else, so the attention runs twice a layer too; under the other policies
    the tag is ``x`` itself."""
    calls = {"attn": 0, "saved": []}
    real_attention = ops.flash_attention
    real_policy = tlayers._collectives_policy

    def counted(*a, **kw):
        calls["attn"] += 1
        return real_attention(*a, **kw)

    def policy(ctx, op, *a, **kw):
        out = real_policy(ctx, op, *a, **kw)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            calls["saved"].append(str(op))
        return out

    monkeypatch.setattr(ops, "flash_attention", counted)
    monkeypatch.setattr(tlayers, "_collectives_policy", policy)
    cfg = get_arch("llama3-8b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    for policy_name, want in (("none", 2), ("dots", 4), ("full", 4), ("collectives", 4)):
        calls["attn"] = 0
        _loss_grads(Model(cfg.replace(remat=policy_name)), params, batch)
        assert calls["attn"] == want, (policy_name, calls)
    assert calls["saved"] == ["repro_torch.post_collective.default"] * 2 * cfg.n_layers, calls["saved"]
    assert tlayers.remat_policy("none") is None and tlayers.remat_policy("collectives") is not None
    x = torch.ones(3)
    for policy_name in ("none", "dots", "full"):  # no other policy reads the tag: no copy
        assert tlayers.post_collective(x, policy_name) is x
    assert tlayers.post_collective(x, "collectives") is not x
    with torch.no_grad():
        assert tlayers.post_collective(x, "collectives") is x
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
    want = {a: sorted(list(jstep.metrics_struct(_models(a)[0])) + ["grad_norm", "lr"]) for a in ARCHS}
    want_keys = want["llama3-8b"]
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
            assert sorted(t.result()) == want[t.arch] and all(np.isfinite(v) for v in t.result().values())
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


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "llama-3.2-vision-11b"])
def test_launch_train_takes_the_encdec_and_vlm_configs(name):
    """``launch/train.py`` trains the reduced audio and vlm configs, their
    frontend stubs drawn by the data pipeline: four steps of finite losses
    and gradient norms, and on the CPU no kernel (forward
    or backward) launched."""
    out = ttrain.train(name, steps=4, seq_len=16, global_batch=2, log_every=0, device="cpu")
    assert out["steps"] == 4 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert all(set(d.values()) == {0} for d in out["launches"] + out["backward_launches"])
    assert ("enc_blocks" in out["params"]) == (name == "seamless-m4t-medium")
    assert ("xattn" in out["params"].get("superblocks", {})) == (name == "llama-3.2-vision-11b")


def test_train_driver_takes_a_strategy_and_refuses_the_card_without_one():
    """A strategy runs on a model axis of 1 (the driver's mesh) and, in a
    world of one, takes the plain step's losses and parameters bit for bit;
    on a "model" axis of 2 the step of "serve_2dtp" and of "tp_sp" builds
    and runs (an abstract (1, 2) mesh, rank 0's shards as meta tensors; the
    numbers are held on gloo in tests/test_torch_tensor_parallel.py).
    Without a card ``launch/train.py`` refuses device='cuda'."""
    kw = dict(steps=2, seq_len=16, global_batch=2, log_every=0, device="cpu")
    plain = ttrain.train("llama3-8b", **kw)
    sharded = ttrain.train("llama3-8b", strategy_name="fsdp_tp", **kw)
    assert sharded["losses"] == plain["losses"] and sharded["grad_norms"] == plain["grad_norms"]
    assert all(torch.equal(a, b) for a, b in zip(tspec.tree_leaves(sharded["params"]), tspec.tree_leaves(plain["params"])))
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    for name in ("serve_2dtp", "tp_sp"):
        fn, args, _ = dryrun.build_cell(get_arch("llama3-8b").reduced(), ShapeConfig("mini", 16, 2, "train"),
                                        Mesh(("data", "model"), (1, 2)), name)
        _, _, metrics = fn(*args)
        assert sorted(metrics) == ["ce", "grad_norm", "loss", "lr", "tokens"], (name, sorted(metrics))
    with pytest.raises(KeyError):
        ttrain.train("llama3-8b", strategy_name="bogus", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.train("llama3-8b", steps=1)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_train_driver_runs_every_strategy_on_a_model_axis_of_one(strategy):
    """``train(strategy_name=...)`` for every strategy the reference names,
    on the driver's (1, 1) mesh: two finite steps with the plain step's
    losses, no kernel launched on the CPU."""
    kw = dict(steps=2, seq_len=16, global_batch=2, log_every=0, device="cpu")
    out = ttrain.train("grok-1-314b", strategy_name=strategy, **kw)
    assert out["steps"] == 2 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert out["losses"] == ttrain.train("grok-1-314b", **kw)["losses"]


if __name__ == "__main__":
    for case in ATTN_CASES:
        print("attention", case, compare_attention_grads(case), "lse", compare_attention_lse(case))
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
