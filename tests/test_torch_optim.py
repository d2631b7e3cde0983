"""The port's AdamW (``repro_torch/optim/adamw.py``) held against the
reference's (``repro/optim/adamw.py``), on the CPU.

Trees are drawn with numpy from a seed and cross as numpy arrays.
Tolerance: relative 1e-6 in fp32 (the schedule, the global norm, the
clipping scale and every updated leaf of m, v and fp32 params); bf16 params
bit for bit wherever the two packages' fp32 pre-cast values agree (they are
rounded to bf16 the same way).  The measured errors are printed by running
this file as a script:

    PYTHONPATH=src python tests/test_torch_optim.py
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.models import spec as tspec
from repro_torch.optim import adamw

REL = 1e-6


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _trees(seed: int, dtype: str, grad_scale: float = 1.0):
    """A two-level tree of params, grads and nonzero moments, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (8, 16), "b": (16,)}, "c": (4, 3, 5), "e": (7,)}

    def tree(fn):
        return {k: ({kk: fn(ss) for kk, ss in s.items()} if isinstance(s, dict) else fn(s)) for k, s in shapes.items()}

    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    params = tree(lambda s: rng.normal(size=s).astype(np_dtype))
    grads = tree(lambda s: (grad_scale * rng.normal(size=s)).astype(np_dtype))
    m = tree(lambda s: (0.1 * rng.normal(size=s)).astype(np.float32))
    v = tree(lambda s: (0.01 * rng.uniform(size=s)).astype(np.float32))
    return params, grads, {"m": m, "v": v, "step": np.asarray(4, np.int32)}


def _port(tree):
    return tspec.params_from_jax(tree, "cpu")


def test_lr_schedule_matches_the_reference_over_300_steps():
    for cfg_kw in ({}, {"warmup_steps": 1, "peak_lr": 1e-3}, {"warmup_steps": 10, "total_steps": 200}):
        jc, tc = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
        steps = np.arange(0, 301, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jadamw.lr_schedule(jc, s))(jnp.asarray(steps)))
        got = adamw.lr_schedule(tc, torch.from_numpy(steps))
        assert got.dtype == torch.float32
        assert _rel(got, want) <= REL, cfg_kw
        assert float(adamw.lr_schedule(tc, 7)) == pytest.approx(float(jadamw.lr_schedule(jc, jnp.asarray(7))), rel=REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_the_reference(dtype):
    _, grads, _ = _trees(1, dtype)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads)))
    got = adamw.global_norm(_port(grads))
    assert got.dtype == torch.float32 and float(got) == pytest.approx(want, rel=REL)


def compare_update(dtype: str, grad_scale: float) -> dict:
    """One apply_updates from the same trees in both packages."""
    params, grads, state = _trees(2, dtype, grad_scale)
    cfg_j, cfg_t = jadamw.AdamWConfig(), adamw.AdamWConfig()
    jp, js, jm = jadamw.apply_updates(cfg_j, *(jax.tree.map(jnp.asarray, t) for t in (params, grads, state)))
    tp, tg = _port(params), _port(grads)
    ts = {"m": _port(state["m"]), "v": _port(state["v"]), "step": torch.tensor(int(state["step"]), dtype=torch.int32)}
    ids = [id(t) for t in tspec.tree_leaves(tp) + tspec.tree_leaves(ts["m"])]
    tp2, ts2, tm = adamw.apply_updates(cfg_t, tp, tg, ts)
    assert [id(t) for t in tspec.tree_leaves(tp2) + tspec.tree_leaves(ts2["m"])] == ids  # in place
    errs = {"grad_norm": _rel(tm["grad_norm"], jm["grad_norm"]), "lr": _rel(tm["lr"], jm["lr"])}
    errs["step"] = int(ts2["step"]) - int(js["step"])
    assert ts2["step"].dtype == torch.int32
    for k in ("m", "v"):
        errs[k] = max(_rel(t, j) for t, j in zip(tspec.tree_leaves(ts2[k]), jax.tree.leaves(js[k])))
    got = tspec.tree_leaves(tp2)
    want = [np.asarray(x) for x in jax.tree.leaves(jp)]
    if dtype == "float32":
        errs["params"] = max(_rel(t, j) for t, j in zip(got, want))
    else:
        # m, v and the scalars agree bit for bit here (the fp32 cases show
        # it), so the fp32 values before the cast do too: the bf16 words
        # must be the same
        n_diff = 0
        for t, j in zip(got, want):
            t_words = t.view(torch.int16).numpy()
            j_words = j.view(np.int16)
            n_diff += int((t_words != j_words).sum())
        errs["bf16_words_differing"] = n_diff
        errs["bf16_params"] = max(_rel(t.float(), j.astype(np.float32)) for t, j in zip(got, want))
    return errs


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_the_reference(dtype, grad_scale):
    errs = compare_update(dtype, grad_scale)
    assert errs["step"] == 0
    assert max(errs[k] for k in ("grad_norm", "lr", "m", "v")) <= REL, errs
    if dtype == "float32":
        assert errs["params"] <= REL, errs
    else:
        assert errs["bf16_words_differing"] == 0, errs


def test_bf16_cast_rounds_like_the_reference():
    """The bf16 result is the fp32 value rounded to nearest even, as
    ``astype(bfloat16)`` rounds it: the same fp32 values give the same words."""
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32)
    x[:3] = [1.00390625, 1.01171875, -3.0078125]  # ties
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(got, want)


def test_clipping_scales_to_the_clip_norm():
    params, grads, state = _trees(4, "float32", grad_scale=100.0)
    tg = _port(grads)
    norm = float(adamw.global_norm(tg))
    assert norm > 1.0
    cfg = adamw.AdamWConfig(b1=0.0, b2=0.0, weight_decay=0.0)
    ts = {"m": _port(state["m"]), "v": _port(state["v"]), "step": torch.tensor(0, dtype=torch.int32)}
    _, ts, metrics = adamw.apply_updates(cfg, _port(params), tg, ts)
    # with b1 = 0 the first moment is the clipped gradient itself
    clipped = np.concatenate([t.numpy().ravel() for t in tspec.tree_leaves(ts["m"])])
    assert np.linalg.norm(clipped) == pytest.approx(cfg.grad_clip, rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(norm, rel=REL)


def test_init_state_matches_the_reference():
    params, _, _ = _trees(5, "bfloat16")
    js = jadamw.init_state(jax.tree.map(jnp.asarray, params))
    ts = adamw.init_state(_port(params))
    assert sorted(ts) == sorted(js) == ["m", "step", "v"]
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 0
    for t, j in zip(tspec.tree_leaves(ts["m"]) + tspec.tree_leaves(ts["v"]), jax.tree.leaves(js["m"]) + jax.tree.leaves(js["v"])):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape and not t.any()


if __name__ == "__main__":
    for dtype in ("float32", "bfloat16"):
        for scale in (1e-2, 10.0):
            print(dtype, "grad_scale", scale, compare_update(dtype, scale))
