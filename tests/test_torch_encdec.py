"""The port's audio family (``repro_torch/models/encdec.py``, seamless-m4t-medium)
held against the JAX reference (``repro/models/encdec.py``), on the CPU.

The reduced config in fp32 (2 encoder and 2 decoder layers, D64, 4 heads over
2 KV heads of width 16, 16 frames): the reference's weights cross with
``params_from_jax``, and tokens and frame embeddings are drawn with numpy
from a seed.  On CPU tensors ``ops.flash_attention`` runs its plain version;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel, forward
and backward, at this family's shapes on the card.

Tolerances: the encoder output, the cross attention, the forward logits,
the prefill's logits and every cache leaf, and four decode steps (against
the reference's and against the port's teacher-forced forward) within
max-abs 1e-4 x max |reference| (``REL_TOL`` of tests/test_torch_models.py);
``Model.loss`` within relative 1e-5 and every gradient leaf within 1e-4 of
the reference leaf's max-abs (tests/test_torch_train.py's ``GRAD_REL`` and
``LEAF_TOL``, the rule of tests/test_torch_moe.py).  The measured errors are
printed by running this file as a script:

    PYTHONPATH=src python tests/test_torch_encdec.py
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import encdec as jencdec
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import encdec
from repro_torch.models import spec as tspec
from repro_torch.models.model import Model
from test_torch_models import REL_TOL, _np, _rel_err, compare_arch, frontend_extras
from test_torch_train import GRAD_REL, LEAF_TOL, compare_loss_and_grads

torch.set_num_threads(1)

NAME = "seamless-m4t-medium"


def _weights(seed: int = 2):
    cfg_j, cfg_t = jget_arch(NAME).reduced(), get_arch(NAME).reduced()
    jp = JModel(cfg_j).init(jax.random.key(seed))
    return cfg_j, cfg_t, jp, tspec.params_from_jax(_np(jp), "cpu")


def compare_encoder() -> float:
    cfg_j, cfg_t, jp, tp = _weights()
    frames = frontend_extras(cfg_j, 2)["enc_frames"]
    want = np.asarray(jencdec.encode(cfg_j, jp, jnp.asarray(frames)))
    with torch.no_grad():
        got = encdec.encode(cfg_t, tp, torch.from_numpy(frames))
    return _rel_err(got, want)


def compare_cross_attention() -> float:
    """One decoder layer's cross attention on its own: 12 decoder rows
    against the 16 frames' encoder output (Lq != Lk, non-causal)."""
    cfg_j, cfg_t, jp, tp = _weights()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, cfg_j.d_model)).astype(np.float32)
    enc_out = rng.normal(size=(2, cfg_j.enc_len_train, cfg_j.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda t: t[1], jp["dec_blocks"])
    p_t = tspec.layer(tp["dec_blocks"], 1)
    want = np.asarray(jencdec._cross_attn(cfg_j, jnp.asarray(x), p_j, jnp.asarray(enc_out)))
    with torch.no_grad():
        got = encdec._cross_attn(cfg_t, torch.from_numpy(x), p_t, torch.from_numpy(enc_out))
    return _rel_err(got, want)


def test_encoder_output_matches_the_reference():
    assert compare_encoder() <= REL_TOL


def test_cross_attention_matches_the_reference():
    assert compare_cross_attention() <= REL_TOL


def test_forward_prefill_and_decode_match_the_reference():
    """Forward logits, prefill logits and every cache leaf (self k and v
    padded to the cache length, cross k and v over the frames), and four
    decode steps against the reference's and against teacher forcing."""
    before = ops.launch_counts()
    errs = compare_arch(NAME)
    assert {f"prefill_cache/layers/{k}" for k in ("k", "v", "cross_k", "cross_v")} <= set(errs)
    assert sum(k.endswith("_teacher") for k in errs) == 4
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    assert not bad, bad
    assert ops.launch_counts() == before  # CPU tensors: the plain versions ran


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_gradients_match_the_reference(remat):
    """``Model.loss`` and every gradient leaf, the encoder's included,
    against ``jax.value_and_grad`` of the reference under the same remat
    policy: the encoder output enters each decoder layer's checkpoint as an
    argument, so its gradient reaches the encoder under every policy."""
    errs = compare_loss_and_grads(NAME, remat=remat)
    metric = {k: e for k, e in errs.items() if k.startswith("metric_")}
    leaves = {k: e for k, e in errs.items() if k.startswith("grad")}
    assert any(k.startswith("grad/enc_blocks/") for k in leaves)
    assert max(metric.values()) <= GRAD_REL, metric
    assert max(leaves.values()) <= LEAF_TOL, sorted(leaves.items(), key=lambda kv: -kv[1])[:4]


def test_the_frames_move_the_logits():
    """The cross path carries the frames into every logit: other frames,
    other logits; the same frames, the same logits."""
    cfg = get_arch(NAME).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32))
    frames = [torch.from_numpy(frontend_extras(cfg, 2, seed)["enc_frames"]) for seed in (1, 1, 2)]
    with torch.no_grad():
        a, b, c = (model.logits(params, {"tokens": tokens, "enc_frames": f}) for f in frames)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-3 * float(a.abs().max())


def test_prefill_caches_the_frames_and_decode_passes_them_through():
    """The self k and v are padded to the cache length and written into
    copies by each decode step; the cross k and v keep the frames' length
    and pass through decode as the same tensors."""
    cfg = get_arch(NAME).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 12), dtype=torch.int32)
    batch = {"tokens": tokens, "enc_frames": torch.from_numpy(frontend_extras(cfg, 2)["enc_frames"])}
    with torch.no_grad():
        _, cache = model.prefill(params, batch, cache_len=20)
        want = tspec.tree_map(lambda s: s.shape, model.cache_specs(2, 20))
        assert tspec.tree_map(lambda t: tuple(t.shape), cache) == want
        _, new = model.decode_step(params, cache, tokens[:, -1:], torch.full((2,), 12, dtype=torch.int32))
    lc, nc = cache["layers"], new["layers"]
    assert nc["cross_k"] is lc["cross_k"] and nc["cross_v"] is lc["cross_v"]
    assert nc["k"].data_ptr() != lc["k"].data_ptr() and not torch.equal(nc["k"], lc["k"])
    assert torch.equal(nc["k"][:, :, :12], lc["k"][:, :, :12])


def test_prefill_attention_calls(monkeypatch):
    """Every attention of a prefill goes to ``ops.flash_attention``: each
    encoder layer non-causal over the frames, each decoder layer causal over
    the prompt and then non-causal from the prompt to the frames, with
    blocks that divide each length.  At full size (12 + 12 layers) this is
    the 36 launches a seamless-m4t-medium prefill makes on the card."""
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True, window=None, block_q=None, block_k=None):
        calls.append((q.shape[2], k.shape[2], causal, window, block_q, block_k))
        return real(q, k, v, causal=causal, window=window, block_q=block_q, block_k=block_k)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = get_arch(NAME).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 12), dtype=torch.int32),
             "enc_frames": torch.from_numpy(frontend_extras(cfg, 2)["enc_frames"])}
    with torch.no_grad():
        model.prefill(params, batch)
    Le = cfg.enc_len_serve
    want = [(Le, Le, False, None, Le, Le)] * cfg.n_enc_layers + [(12, 12, True, None, 12, 12), (12, Le, False, None, 12, Le)] * cfg.n_layers
    assert calls == want
    full = get_arch(NAME)
    assert full.n_enc_layers + 2 * full.n_layers == 36


if __name__ == "__main__":
    print("encoder", compare_encoder())
    print("cross attention", compare_cross_attention())
    errs = compare_arch(NAME)
    worst = max(errs, key=errs.get)
    print(f"forward {errs['forward']:.3e} prefill_logits {errs['prefill_logits']:.3e} worst {worst} {errs[worst]:.3e} over {len(errs)} outputs")
    for remat in ("none", "dots", "full"):
        errs = compare_loss_and_grads(NAME, remat=remat)
        worst = max((k for k in errs if k.startswith("grad")), key=errs.get)
        print(f"remat={remat} loss/metrics", {k: v for k, v in errs.items() if k.startswith("metric_")}, "worst grad leaf", worst, errs[worst])
