"""The port's moe family (``repro_torch/models/moe.py``) held against the JAX
reference (``repro/models/moe.py``), on the CPU.

Operands are drawn with numpy from a seed, the reference's weights cross
with ``params_from_jax``, and the configs are the reduced ones in fp32
(E4, top-2, groups of 16, D64, F128), with the capacity factor cut to 1.0
and below where a case needs tokens to drop.  On CPU tensors ``ops.moe_gmm``
runs its plain version; ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernel and its backward against it on the card.

Tolerances: the routing's dispatch and combine tensors and one MoE FFN
within max-abs 2e-5 (the reference's fp32 parity tolerance), the aux and z
losses within relative 1e-5; the model's losses within relative 1e-5 and
every gradient leaf, a reduction across layers, within 1e-4 of the
reference leaf's max-abs; prefill + decode against teacher forcing within
relative 1e-4; the ``moe_gmm`` backward's plain version within max-abs 2e-5
of ``jax.vjp`` in fp32 and one bf16 step (rtol = atol = 2e-2) in bf16.
The measured errors are printed by running this file as a script:

    PYTHONPATH=src python tests/test_torch_moe.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.models import spec as tspec
from repro_torch.models.model import Model

torch.set_num_threads(1)

ARCHS = ["grok-1-314b", "arctic-480b"]
TOL = 2e-5  # max-abs, the reference's fp32 parity tolerance
REL = 1e-5  # the aux, z and model losses, relative
LEAF_TOL = 1e-4  # a gradient leaf, relative to the reference leaf's max-abs
# the GEMM shapes chip_smoke.py holds the kernel at: on the tile grid, C, D
# and F ragged, F = 100 and 50 (the bf16 and fp32 mma routes), and D 95
# F 49 (mma in both; bf16 rows not even 4-byte aligned)
GMM_CASES = [
    {"E": 4, "C": 64, "D": 128, "F": 256},
    {"E": 3, "C": 80, "D": 96, "F": 200},
    {"E": 3, "C": 80, "D": 96, "F": 100},
    {"E": 3, "C": 80, "D": 96, "F": 50},
    {"E": 3, "C": 80, "D": 95, "F": 49},
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _abs(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)))


def _cfgs(name: str, **kw):
    cj, ct = jget_arch(name).reduced(), get_arch(name).reduced()
    return (dataclasses.replace(cj, **kw), ct.replace(**kw)) if kw else (cj, ct)


def _block_params(name: str, seed: int = 1, **kw):
    """A reduced config pair and the reference's first-layer moe weights,
    on both sides."""
    cj, ct = _cfgs(name, **kw)
    p_j = jax.tree.map(lambda t: t[0], JModel(cj).init(jax.random.key(seed))["blocks"]["moe"])
    return cj, ct, p_j, tspec.params_from_jax(_np(p_j), "cpu")


# ---------------------------------------------------------------------------
# capacity and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_the_reference(name, cf):
    for reduced in (False, True):
        cj, ct = jget_arch(name), get_arch(name)
        if reduced:
            cj, ct = cj.reduced(), ct.reduced()
        cj, ct = dataclasses.replace(cj, capacity_factor=cf), ct.replace(capacity_factor=cf)
        for g in (1, 2, 4, 5, 16, 256):
            assert moe.capacity(ct, g) == jmoe.capacity(cj, g)


def _logits(case: str, G: int, g: int, E: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "ties":  # a few distinct values: softmax gives bit-equal probabilities, top_k meets ties
        return rng.integers(0, 3, (G, g, E)).astype(np.float32)
    x = rng.normal(size=(G, g, E)).astype(np.float32)
    if case == "overflow":  # most tokens prefer expert 0: its queue runs past C
        x[..., 0] += 3.0
    return x


# (case, capacity factor): no token drops at the reduced configs' 2.0; at
# 1.0 some do; at 0.5 with a skewed router most requests find pos >= C
ROUTE_CASES = [("no_drop", 2.0), ("drop", 1.0), ("overflow", 0.5), ("ties", 2.0)]


def compare_route(name: str, case: str, cf: float) -> dict:
    cj, ct = _cfgs(name, capacity_factor=cf)
    logits = _logits(case, 3, 16, ct.n_experts)
    want = jmoe.route(cj, jnp.asarray(logits))
    got = moe.route(ct, torch.from_numpy(logits))
    errs = {k: _abs(g, w) for k, g, w in zip(("dispatch", "combine"), got, want)}
    errs.update({k: _rel(g, w) for k, g, w in zip(("aux", "z"), got[2:], want[2:])})
    errs["dropped"] = float(2 * 3 * 16 - np.asarray(want[0]).sum())  # requests with no slot
    return errs


@pytest.mark.parametrize("case,cf", ROUTE_CASES, ids=[c for c, _ in ROUTE_CASES])
@pytest.mark.parametrize("name", ARCHS)
def test_route_matches_the_reference(name, case, cf):
    errs = compare_route(name, case, cf)
    assert errs["dispatch"] == 0 and errs["combine"] <= TOL, errs
    assert errs["aux"] <= REL and errs["z"] <= REL, errs
    assert (errs["dropped"] > 0) == (case in ("drop", "overflow")), errs


def test_topk_breaks_ties_towards_the_lower_index():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.3, 0.4, 0.0]], np.float32)
    v, i = moe.topk(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    assert np.array_equal(i.numpy(), np.asarray(ji)) and np.array_equal(v.numpy(), np.asarray(jv))
    assert i.tolist() == [[0, 1], [1, 3], [2, 0]]


# ---------------------------------------------------------------------------
# the MoE FFN, its expert products, and the model
# ---------------------------------------------------------------------------


def compare_ffn(name: str, cf: float, L: int = 24) -> dict:
    cj, ct, p_j, p_t = _block_params(name, capacity_factor=cf)
    x = np.random.default_rng(3).normal(size=(2, L, ct.d_model)).astype(np.float32)
    y_j, aux_j = jmoe.moe_ffn(cj, jnp.asarray(x), p_j)
    y_t, aux_t = moe.moe_ffn(ct, torch.from_numpy(x), p_t)
    errs = {"y": _abs(y_t, y_j)}
    errs.update({k: _rel(aux_t[k], aux_j[k]) for k in aux_j})
    return errs


@pytest.mark.parametrize("cf", [2.0, 1.0])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_the_reference(name, cf):
    """Groups of 16 over 48 tokens (3 groups), with and without dropped
    tokens; arctic adds its dense residual MLP."""
    errs = compare_ffn(name, cf)
    assert errs["y"] <= TOL and errs["aux_loss"] <= REL and errs["z_loss"] <= REL, errs


def test_expert_products_go_to_moe_gmm_with_blocks_that_divide(monkeypatch):
    """The three expert products of a layer are three ``ops.moe_gmm`` calls
    on (E, G * C, D) @ (E, D, F) and (E, G * C, F) @ (E, F, D), with blocks
    that meet the reference's divisibility rule, at the reduced configs and
    at the full widths' prefill and decode shapes (grok C 80 and 2 a group,
    arctic C 5: 4864 takes no 512 block)."""
    calls = []
    real = ops.moe_gmm

    def recorded(x, w, **blocks):
        calls.append((tuple(x.shape), tuple(w.shape), blocks))
        return real(x, w, **blocks)

    monkeypatch.setattr(ops, "moe_gmm", recorded)
    cj, ct, p_j, p_t = _block_params("arctic-480b")
    moe.moe_ffn(ct, torch.zeros(2, 24, ct.d_model), p_t)
    E, F_, D = ct.n_experts, ct.d_ff, ct.d_model
    GC = 3 * moe.capacity(ct, 16)
    assert [(x, w) for x, w, _ in calls] == [((E, GC, D), (E, D, F_)), ((E, GC, D), (E, D, F_)), ((E, GC, F_), (E, F_, D))]
    for name, T in (("grok-1-314b", 4096), ("grok-1-314b", 4), ("arctic-480b", 4096), ("arctic-480b", 4)):
        cfg = get_arch(name)
        g = min(cfg.moe_group_size, T)
        rows = (T // g) * moe.capacity(cfg, g)
        for K, N in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            tgmm.check_blocks(rows, K, N, ops.block_dividing(rows, 128), ops.block_dividing(K, 512), ops.block_dividing(N, 256))
    with pytest.raises(ValueError, match="must divide"):
        tgmm.check_blocks(80, 4864, 7168, 128, 512, 256)


def test_prefill_and_decode_match_teacher_forcing():
    """As tests/test_decode_consistency.py holds the reference: the port's
    prefill of 16 tokens and 4 decode steps give the logits of its
    teacher-forced forward over the 20 tokens, for both moe configs."""
    for name in ARCHS:
        m = Model(get_arch(name).reduced())
        params = m.init(torch.Generator().manual_seed(1), "cpu")
        toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 20)).astype(np.int32))
        with torch.no_grad():
            full = m.logits(params, {"tokens": toks})
            _, cache = m.prefill(params, {"tokens": toks[:, :16]}, cache_len=20)
            for i in range(4):
                lg, cache = m.decode_step(params, cache, toks[:, 16 + i : 17 + i], torch.full((2,), 16 + i, dtype=torch.int32))
                assert _rel(lg[:, 0], full[:, 16 + i].numpy()) <= LEAF_TOL, (name, i)


def compare_loss_and_grads(name: str, **kw) -> dict:
    cj, ct = _cfgs(name, **kw)
    jm, tm = JModel(cj), Model(ct)
    jparams = jm.init(jax.random.key(0))
    batch = batch_at(DataConfig(vocab_size=ct.vocab_size, seq_len=24, global_batch=2, family=ct.family), 0)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tspec.params_from_jax(_np(jparams), "cpu")
    leaves = tspec.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(metrics) == sorted(jmetrics) == ["aux_loss", "ce", "loss", "tokens", "z_loss"]
    errs = {f"metric_{k}": _rel(metrics[k], jmetrics[k]) for k in jmetrics}
    jleaves = tspec.tree_leaves(_np(jgrads))
    errs.update({f"grad{i}": _rel(g, w) for i, (g, w) in enumerate(zip(grads, jleaves))})
    errs["nonzero_leaves"] = float(sum(bool(g.abs().max() > 0) for g in grads) / len(grads))
    return errs


@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(name, cf):
    """``Model.loss`` (cross entropy + 0.01 aux + 1e-3 z) and its gradient,
    the router's included, against ``jax.value_and_grad`` of the
    reference's, at the reduced capacity factor and with tokens dropped."""
    errs = compare_loss_and_grads(name, **({"capacity_factor": cf} if cf else {}))
    metric = {k: e for k, e in errs.items() if k.startswith("metric_")}
    leaves = {k: e for k, e in errs.items() if k.startswith("grad")}
    assert max(metric.values()) <= REL, metric
    assert max(leaves.values()) <= LEAF_TOL, sorted(leaves.items(), key=lambda kv: -kv[1])[:4]
    assert errs["nonzero_leaves"] == 1.0


def test_moe_loss_takes_no_chunked_head_as_in_the_reference(monkeypatch):
    """The reference chunks the head only for the dense, ssm, hybrid, vlm and
    audio families (``model.py:62``): a moe config with ``logit_chunk`` set
    takes the plain loss, with its aux metrics, in both."""
    cj, ct = _cfgs("grok-1-314b", logit_chunk=8)
    jm, tm = JModel(cj), Model(ct)
    jparams = jm.init(jax.random.key(4))
    params = tspec.params_from_jax(_np(jparams), "cpu")
    batch = batch_at(DataConfig(vocab_size=256, seq_len=24, global_batch=2), 0)
    monkeypatch.setattr(Model, "_loss_chunked_head", lambda *a: pytest.fail("moe took the chunked head"))
    with torch.no_grad():
        loss, metrics = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
        plain, _ = Model(ct.replace(logit_chunk=0)).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    jloss, jmetrics = jm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert "aux_loss" in metrics and "aux_loss" in jmetrics
    assert torch.equal(loss, plain) and _rel(loss, jloss) <= REL


def test_params_from_jax_carries_the_moe_trees():
    for name in ARCHS:
        cj, ct = _cfgs(name)
        jp = _np(JModel(cj).init(jax.random.key(0)))
        tp = tspec.params_from_jax(jp, "cpu")
        specs = Model(ct).specs()
        assert sorted(tp) == sorted(specs) and sorted(tp["blocks"]["moe"]) == sorted(specs["blocks"]["moe"])
        assert ("dense" in tp["blocks"]["moe"]) == (name == "arctic-480b")
        for t, s, j in zip(tspec.tree_leaves(tp), tspec.tree_leaves(specs), tspec.tree_leaves(jp)):
            assert tuple(t.shape) == s.shape and t.dtype == tspec.torch_dtype(s.dtype)
            assert np.array_equal(t.numpy(), j)


def test_remat_dots_recomputes_the_expert_matmuls(monkeypatch):
    """The reference's "dots" policy saves the products without batch dims;
    the expert products are batched over the experts, so under "dots" the
    backward runs each layer's three ``moe_gmm`` calls again: 6 calls for the
    two reduced layers under "none", 12 under "dots"."""
    calls = [0]
    real = ops.moe_gmm

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ops, "moe_gmm", counted)
    cfg = get_arch("grok-1-314b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_at(DataConfig(vocab_size=256, seq_len=16, global_batch=2), 0).items()}
    for policy, want in (("none", 6), ("dots", 12)):
        calls[0] = 0
        leaves = tspec.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = Model(cfg.replace(remat=policy)).loss(params, batch)
        torch.autograd.grad(loss, leaves)
        assert calls[0] == want, (policy, calls)


@pytest.mark.parametrize("name", ARCHS)
def test_launch_train_takes_the_moe_configs(name):
    """``launch/train.py`` trains a reduced moe config: four steps of finite
    losses and gradient norms, and on the CPU no kernel (forward or
    backward) launched."""
    from repro_torch.launch import train as ttrain

    out = ttrain.train(name, steps=4, seq_len=16, global_batch=2, log_every=0, device="cpu")
    assert out["steps"] == 4 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert all(set(d.values()) == {0} for d in out["launches"] + out["backward_launches"])
    assert "moe" in out["params"]["blocks"]


# ---------------------------------------------------------------------------
# the moe_gmm backward: its plain version and its autograd wiring
# ---------------------------------------------------------------------------


def _gmm_operands(shape: dict, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    E, C, D, F_ = shape["E"], shape["C"], shape["D"], shape["F"]
    x, w, dy = (rng.normal(size=s).astype(np.float32) for s in ((E, C, D), (E, D, F_), (E, C, F_)))
    w /= np.sqrt(D)
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx, jw, jdy = (jnp.asarray(a).astype(jt) for a in (x, w, dy))
    tx, tw, tdy = (tspec.params_from_jax(np.asarray(a), "cpu") for a in (jx, jw, jdy))
    return (jx, jw, jdy), (tx, tw, tdy)


def compare_gmm_bwd(shape: dict, dtype: str) -> dict:
    (jx, jw, jdy), (tx, tw, tdy) = _gmm_operands(shape, dtype)
    _, vjp = jax.vjp(jref.moe_gmm_ref, jx, jw)
    want = vjp(jdy)
    got = ref.moe_gmm_bwd_ref(tx, tw, tdy)
    errs = {}
    for k, g, w in zip(("dx", "dw"), got, want):
        assert g.dtype == tspec.torch_dtype(str(w.dtype)) and tuple(g.shape) == w.shape
        gw = np.asarray(w.astype(jnp.float32))
        errs[k] = _abs(g, gw)
        errs[f"{k}_bf16_steps_over"] = int((np.abs(g.float().numpy() - gw) > 2e-2 * np.abs(gw) + 2e-2).sum())
    return errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GMM_CASES, ids=lambda s: "E{E}_C{C}_D{D}_F{F}".format(**s))
def test_moe_gmm_backward_plain_version_matches_jax_vjp(shape, dtype):
    errs = compare_gmm_bwd(shape, dtype)
    if dtype == "float32":
        assert errs["dx"] <= TOL and errs["dw"] <= TOL, errs
    else:
        assert errs["dx_bf16_steps_over"] == 0 and errs["dw_bf16_steps_over"] == 0, errs


def test_moe_gmm_function_wires_the_backward_on_cpu_tensors(monkeypatch):
    """``ops``' autograd Function, with its forward launcher replaced by the
    plain version (the CUDA kernel cannot run here): its gradient is the
    backward wrapper's, routed to ``moe_gmm_bwd_ref``, and equals autograd of
    the plain forward; it asks only for the gradients autograd needs, and the
    backward counter does not move on the CPU."""
    asked = []
    plain_bwd = ref.moe_gmm_bwd_ref

    def backward(x, w, dy, need_dx, need_dw):
        asked.append((need_dx, need_dw))
        return plain_bwd(x, w, dy, need_dx, need_dw)

    monkeypatch.setattr(tgmm, "moe_gmm", lambda x, w, config=None: ref.moe_gmm_ref(x, w))
    monkeypatch.setattr(ref, "moe_gmm_bwd_ref", backward)
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 20, 16, generator=g), torch.randn(3, 16, 24, generator=g)
    dy = torch.randn(3, 20, 24, generator=g)
    before = ops.backward_launch_counts()
    for need in ((True, True), (True, False), (False, True)):
        xs, ws = x.clone().requires_grad_(need[0]), w.clone().requires_grad_(need[1])
        y = ops._MoeGmm.apply(xs, ws)
        wrt = [t for t, n in zip((xs, ws), need) if n]
        got = torch.autograd.grad(y, wrt, dy)
        want = torch.autograd.grad(ref.moe_gmm_ref(xs, ws), wrt, dy)
        assert y.grad_fn is not None and asked[-1] == need
        assert max(_rel(a, b.numpy()) for a, b in zip(got, want)) <= REL
    assert ops.backward_launch_counts() == before


def test_moe_gmm_backward_wrapper_checks_and_routes_cpu_tensors():
    g = torch.Generator().manual_seed(1)
    x, w, dy = torch.randn(2, 8, 4, generator=g), torch.randn(2, 4, 6, generator=g), torch.randn(2, 8, 6, generator=g)
    before = ops.backward_launch_counts()
    dx, dw = ops.moe_gmm_bwd(x, w, dy)
    assert ops.backward_launch_counts() == before
    assert torch.equal(dx, ref.moe_gmm_bwd_ref(x, w, dy)[0]) and torch.equal(dw, ref.moe_gmm_bwd_ref(x, w, dy)[1])
    assert ops.moe_gmm_bwd(x, w, dy, need_dx=False)[0] is None and ops.moe_gmm_bwd(x, w, dy, need_dw=False)[1] is None
    with pytest.raises(ValueError, match="dy has shape"):
        ops.moe_gmm_bwd(x, w, dy[:, :4].contiguous())
    with pytest.raises(TypeError, match="dy has dtype"):
        ops.moe_gmm_bwd(x, w, dy.to(torch.bfloat16))


if __name__ == "__main__":
    for name in ARCHS:
        for case, cf in ROUTE_CASES:
            print(name, "route", case, compare_route(name, case, cf))
        for cf in (2.0, 1.0):
            print(name, "moe_ffn cf", cf, compare_ffn(name, cf))
        for kw in ({}, {"capacity_factor": 1.0}):
            errs = compare_loss_and_grads(name, **kw)
            worst = max((k for k in errs if k.startswith("grad")), key=errs.get)
            print(name, "loss", kw, {k: v for k, v in errs.items() if k.startswith("metric_")}, "worst leaf", errs[worst])
    for shape in GMM_CASES:
        for dtype in ("float32", "bfloat16"):
            print("moe_gmm_bwd_ref", shape, dtype, compare_gmm_bwd(shape, dtype))
