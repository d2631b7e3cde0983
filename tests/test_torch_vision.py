"""The port's vlm family (``repro_torch/models/vision.py``, llama-3.2-vision-11b)
held against the JAX reference (``repro/models/vision.py``), on the CPU.

The reduced config in fp32 (4 layers in 2 superblocks of one self and one
gated cross layer, D64, 4 heads over 2 KV heads of width 16, 8 image
tokens): the reference's weights cross with ``params_from_jax``, and tokens
and image embeddings are drawn with numpy from a seed.  Both tanh gates of
every cross layer start at zero, which shuts the image path out of the
output and its gradients to zero, so every parity check here opens them in
both trees first (``open_gates``: 0.5 and -0.3), and one test shows that the
images move the logits only once the gates are open.  On CPU tensors
``ops.flash_attention`` runs its plain version; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernel, forward and backward, at this
family's shapes on the card.

Tolerances: the cross layer on its own, the forward logits, the prefill's
logits and every cache leaf, and four decode steps (against the reference's
and against the port's teacher-forced forward) within max-abs 1e-4 x max
|reference| (``REL_TOL`` of tests/test_torch_models.py), and the cross
layer in bf16 within 2e-2 (tests/test_kernels.py's bf16 tolerance);
``Model.loss`` within relative 1e-5 and every gradient leaf, the gates'
included, within 1e-4 of the reference leaf's max-abs (tests/test_torch_train.py's
``GRAD_REL`` and ``LEAF_TOL``, the rule of tests/test_torch_moe.py).  The
measured errors are printed by running this file as a script:

    PYTHONPATH=src python tests/test_torch_vision.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import vision as jvision
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import spec as tspec
from repro_torch.models import vision
from repro_torch.models.model import Model
from test_torch_models import GATES, REL_TOL, _np, _rel_err, compare_arch, frontend_extras, open_gates
from test_torch_train import GRAD_REL, LEAF_TOL, compare_loss_and_grads

torch.set_num_threads(1)

NAME = "llama-3.2-vision-11b"
BF16_TOL = 2e-2


def compare_xattn_block(dtype: str = "float32") -> float:
    """The gated cross layer of superblock 1 on its own, gates open: 12 text
    rows against the 8 image tokens (Lq != Lk, non-causal), in ``dtype``."""
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    cfg_j = dataclasses.replace(jget_arch(NAME).reduced(), **kw)
    cfg_t = get_arch(NAME).reduced().replace(**kw)
    jp = open_gates(JModel(cfg_j).init(jax.random.key(2)))
    p_j = jax.tree.map(lambda t: t[1], jp["superblocks"]["xattn"])
    p_t = tspec.layer(tspec.params_from_jax(_np(jp), "cpu")["superblocks"]["xattn"], 1)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 12, cfg_j.d_model)).astype(np.float32)).astype(cfg_j.compute_dtype)
    img = jnp.asarray(rng.normal(size=(2, cfg_j.n_img_tokens, cfg_j.d_model)).astype(np.float32)).astype(cfg_j.compute_dtype)
    want = jvision.xattn_block(cfg_j, x, p_j, img)
    with torch.no_grad():
        got = vision.xattn_block(cfg_t, tspec.params_from_jax(np.asarray(x), "cpu"), p_t, tspec.params_from_jax(np.asarray(img), "cpu"))
    assert got.dtype == tspec.torch_dtype(dtype) and str(want.dtype) == dtype
    return _rel_err(got, np.asarray(want.astype(jnp.float32)))


def test_xattn_block_matches_the_reference():
    assert compare_xattn_block() <= REL_TOL


def test_xattn_block_keeps_the_mixed_precision_order_in_bf16():
    """out_proj in bf16, cast to fp32, times tanh(gate) in fp32, added to x
    promoted to fp32, the sum cast back to bf16 (``vision.py:73-77``)."""
    assert compare_xattn_block("bfloat16") <= BF16_TOL


def test_forward_prefill_and_decode_match_the_reference():
    """Forward logits, prefill logits and every cache leaf (the 6-D self k
    and v padded to the cache length, the image k and v), and four decode
    steps against the reference's and against teacher forcing."""
    before = ops.launch_counts()
    errs = compare_arch(NAME)
    assert {f"prefill_cache/superblocks/{k}" for k in ("k", "v", "img_k", "img_v")} <= set(errs)
    assert sum(k.endswith("_teacher") for k in errs) == 4
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    assert not bad, bad
    assert ops.launch_counts() == before  # CPU tensors: the plain versions ran


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_gradients_match_the_reference(remat):
    """``Model.loss`` and every gradient leaf, the cross layers' and the
    gates' included (all nonzero with the gates open), against
    ``jax.value_and_grad`` of the reference under the same remat policy
    (one checkpoint a superblock, none on its self layers)."""
    errs = compare_loss_and_grads(NAME, remat=remat)
    metric = {k: e for k, e in errs.items() if k.startswith("metric_")}
    leaves = {k: e for k, e in errs.items() if k.startswith("grad")}
    assert {f"grad/superblocks/xattn/{g}" for g in GATES} <= set(leaves)
    assert max(metric.values()) <= GRAD_REL, metric
    assert max(leaves.values()) <= LEAF_TOL, sorted(leaves.items(), key=lambda kv: -kv[1])[:4]


def test_the_images_move_the_logits_only_through_open_gates():
    """With the gates at their init of zero the image path adds nothing
    (tanh(0) = 0): other images give the same logits, so a parity check on
    fresh weights cannot see the cross attention.  With the gates open,
    other images give other logits, and each gate alone opens its path."""
    cfg = get_arch(NAME).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(not bool(params["superblocks"]["xattn"][g].any()) for g in GATES)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32))
    imgs = [torch.from_numpy(frontend_extras(cfg, 2, seed)["img_embeds"]) for seed in (1, 2)]

    def moved(p) -> float:
        with torch.no_grad():
            a, b = (model.logits(p, {"tokens": tokens, "img_embeds": i}) for i in imgs)
        return float((a - b).abs().max()) / float(a.abs().max())

    assert moved(params) == 0.0
    opened = open_gates(params)
    assert moved(opened) > 1e-3
    xattn = params["superblocks"]["xattn"]
    attn_only = {**params, "superblocks": {**params["superblocks"], "xattn": {**xattn, "gate_attn": opened["superblocks"]["xattn"]["gate_attn"]}}}
    assert moved(attn_only) > 1e-3


def test_prefill_caches_the_images_and_decode_passes_them_through():
    """The self k and v are (n_super, period - 1, B, cache_len, KV, hd),
    padded on the cache axis, each decode step writing its token into them
    in place; the image k and v keep n_img_tokens and pass through decode as the same
    tensors."""
    cfg = get_arch(NAME).reduced()
    model = Model(cfg)
    params = open_gates(model.init(torch.Generator().manual_seed(0), "cpu"))
    tokens = torch.zeros((2, 12), dtype=torch.int32)
    batch = {"tokens": tokens, "img_embeds": torch.from_numpy(frontend_extras(cfg, 2)["img_embeds"])}
    with torch.no_grad():
        _, cache = model.prefill(params, batch, cache_len=20)
        want = tspec.tree_map(lambda s: s.shape, model.cache_specs(2, 20))
        assert tspec.tree_map(lambda t: tuple(t.shape), cache) == want
        before = cache["superblocks"]["k"].clone()
        _, new = model.decode_step(params, cache, tokens[:, -1:], torch.full((2,), 12, dtype=torch.int32))
    sb, nb = cache["superblocks"], new["superblocks"]
    assert sb["k"].dim() == 6 and nb["img_k"] is sb["img_k"] and nb["img_v"] is sb["img_v"]
    assert nb["k"] is sb["k"] and not torch.equal(nb["k"], before) and torch.equal(nb["k"][:, :, :, :12], before[:, :, :, :12])


def test_prefill_attention_calls(monkeypatch):
    """Every attention of a prefill goes to ``ops.flash_attention``: each
    self layer causal over the prompt, each cross layer non-causal from the
    prompt to the image tokens.  At full size (32 self + 8 cross layers)
    this is the 40 launches a llama-3.2-vision-11b prefill makes on the
    card."""
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True, window=None, block_q=None, block_k=None):
        calls.append((q.shape[2], k.shape[2], causal, window, block_q, block_k))
        return real(q, k, v, causal=causal, window=window, block_q=block_q, block_k=block_k)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = get_arch(NAME).reduced()
    model = Model(cfg)
    batch = {"tokens": torch.zeros((2, 12), dtype=torch.int32),
             "img_embeds": torch.from_numpy(frontend_extras(cfg, 2)["img_embeds"])}
    with torch.no_grad():
        model.prefill(model.init(torch.Generator().manual_seed(0), "cpu"), batch)
    n_img, period = cfg.n_img_tokens, cfg.cross_attn_period
    superblock = [(12, 12, True, None, 12, 12)] * (period - 1) + [(12, n_img, False, None, 12, n_img)]
    assert calls == superblock * (cfg.n_layers // period)
    full = get_arch(NAME)
    assert full.n_layers == 40 and full.n_layers // full.cross_attn_period == 8


if __name__ == "__main__":
    print("xattn_block fp32", compare_xattn_block(), "bf16", compare_xattn_block("bfloat16"))
    errs = compare_arch(NAME)
    worst = max(errs, key=errs.get)
    print(f"forward {errs['forward']:.3e} prefill_logits {errs['prefill_logits']:.3e} worst {worst} {errs[worst]:.3e} over {len(errs)} outputs")
    for remat in ("none", "dots", "full"):
        errs = compare_loss_and_grads(NAME, remat=remat)
        worst = max((k for k in errs if k.startswith("grad")), key=errs.get)
        print(f"remat={remat} loss/metrics", {k: v for k, v in errs.items() if k.startswith("metric_")}, "worst grad leaf", worst, errs[worst])
