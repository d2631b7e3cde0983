"""The port's model steps held against the JAX reference, on the CPU.

The reference's weights (``Model.init``) cross through numpy into the port
(``params_from_jax``); tokens are drawn from a seed with numpy.  On CPU
tensors the port's kernel wrappers run their plain versions, so these tests
check the model code around the kernels; ``chip_smoke.py`` holds the same
model steps on the card against this CPU path.

Tolerance: max-abs error <= 1e-4 x max |reference|, in fp32 at
``.reduced()`` (the relative width tolerance of ``chip_smoke.py``).  The
measured errors are printed by running this file as a script:

    PYTHONPATH=src python tests/test_torch_models.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import all_cells as jall_cells
from repro.configs import get_arch as jget_arch
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.models.spec import ParamSpec as JParamSpec
from repro_torch.configs import ARCHS, SHAPES, all_cells, get_arch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import rglru, ssm
from repro_torch.models.attention import block_for
from repro_torch.models import spec as tspec
from repro_torch.models.model import Model

torch.set_num_threads(1)

REL_TOL = 1e-4
# the families compared here; the audio and vlm families, whose batches carry
# frontend extras, in tests/test_torch_encdec.py and tests/test_torch_vision.py
PORTED = [
    "llama3-8b", "internlm2-20b", "granite-3-8b", "llama3-405b", "falcon-mamba-7b", "recurrentgemma-2b",
    "grok-1-314b", "arctic-480b",
]
ALL_ARCHS = PORTED + ["seamless-m4t-medium", "llama-3.2-vision-11b"]
B, L, N_STEPS = 2, 12, 4  # prompt and decode steps of tests/test_decode_consistency.py
# the vlm family's tanh gates start at zero, which shuts its cross layers out
# of the output and their gradients to zero: its parity checks open them
GATES = {"gate_attn": 0.5, "gate_mlp": -0.3}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def open_gates(params):
    """A vlm parameter tree (the reference's or the port's) with both gates
    of every cross layer set to GATES; any other family's as it is."""
    if "xattn" not in params.get("superblocks", {}):
        return params
    xattn = dict(params["superblocks"]["xattn"])
    for k, g in GATES.items():
        xattn[k] = xattn[k] * 0 + g
    return {**params, "superblocks": {**params["superblocks"], "xattn": xattn}}


def frontend_extras(cfg, batch: int, seed: int = 1) -> dict:
    """The frontend stubs of a family's batch, drawn with numpy in fp32:
    ``enc_frames`` (B, enc_len_serve, D) for audio, ``img_embeds`` (B,
    n_img_tokens, D) for vlm, none for the others."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"enc_frames": rng.normal(size=(batch, cfg.enc_len_serve, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"img_embeds": rng.normal(size=(batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}
    return {}


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _leaves_err(port_tree, ref_tree) -> dict:
    """Relative error of every leaf, by its path."""
    out = {}

    def walk(p, r, path):
        if isinstance(r, dict):
            assert sorted(p) == sorted(r), (path, sorted(p), sorted(r))
            for k in r:
                walk(p[k], r[k], f"{path}/{k}")
        else:
            assert p.dtype == tspec.torch_dtype(str(np.asarray(r).dtype)), (path, p.dtype, r.dtype)
            out[path] = _rel_err(p, r)

    walk(port_tree, ref_tree, "")
    return out


def compare_arch(name: str, L: int = L) -> dict:
    """Forward, prefill of ``L`` tokens (logits and every cache leaf) and 4
    decode steps of the reduced config, port against reference, on the
    reference's weights (the vlm gates opened, ``open_gates``) and the
    family's frontend extras (``frontend_extras``).  Returns the relative
    error of each; the audio and vlm families also that of each decode
    step against the port's teacher-forced forward (``decode{i}_teacher``)."""
    cfg_j = jget_arch(name).reduced()
    jm, tm = JModel(cfg_j), Model(get_arch(name).reduced())
    jp = open_gates(jm.init(jax.random.key(2)))
    tp = tspec.params_from_jax(_np(jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab_size, (B, L + N_STEPS)).astype(np.int32)
    extras = frontend_extras(cfg_j, B)
    ex_j = {k: jnp.asarray(v) for k, v in extras.items()}
    ex_t = {k: torch.from_numpy(v) for k, v in extras.items()}
    errs = {}
    with torch.no_grad():
        full_j = np.asarray(jm.logits(jp, {"tokens": jnp.asarray(toks), **ex_j}))
        full_t = tm.logits(tp, {"tokens": torch.from_numpy(toks), **ex_t})
        errs["forward"] = _rel_err(full_t, full_j)
        lg_j, cache_j = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :L]), **ex_j}, cache_len=L + N_STEPS)
        lg_t, cache_t = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :L]), **ex_t}, cache_len=L + N_STEPS)
        errs["prefill_logits"] = _rel_err(lg_t, lg_j)
        errs.update({f"prefill_cache{k}": v for k, v in _leaves_err(cache_t, _np(cache_j)).items()})
        decode_j = jax.jit(jm.decode_step)
        for i in range(N_STEPS):
            step = toks[:, L + i : L + i + 1]
            pos = np.full((B,), L + i, np.int32)
            lg_j, cache_j = decode_j(jp, cache_j, jnp.asarray(step), jnp.asarray(pos))
            lg_t, cache_t = tm.decode_step(tp, cache_t, torch.from_numpy(step), torch.from_numpy(pos))
            errs[f"decode{i}_logits"] = _rel_err(lg_t, lg_j)
            if extras:
                errs[f"decode{i}_teacher"] = _rel_err(lg_t[:, 0], full_t[:, L + i].numpy())
            # greedy: the port picks the reference's next token
            assert np.array_equal(torch.argmax(lg_t[:, 0], -1).numpy(), np.argmax(np.asarray(lg_j)[:, 0], -1))
        errs.update({f"decode_cache{k}": v for k, v in _leaves_err(cache_t, _np(cache_j)).items()})
    return errs


@pytest.mark.parametrize("name", PORTED)
def test_forward_prefill_and_decode_match_the_reference(name):
    before = ops.launch_counts()
    errs = compare_arch(name)
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    assert not bad, bad
    assert ops.launch_counts() == before  # CPU tensors: the plain versions ran


@pytest.mark.parametrize("prompt", [16, 20, 37])
def test_hybrid_past_its_window_matches_the_reference(prompt):
    """Prompts as long as the reduced local window (16) and longer: the
    windowed prefill attention cuts keys off, ``ring_from_seq`` keeps the
    last 16 tokens of a rolled ring (offsets 0, 4 and 5), and the decode
    steps write over the oldest slots."""
    assert get_arch("recurrentgemma-2b").reduced().local_window == 16
    errs = compare_arch("recurrentgemma-2b", L=prompt)
    assert any(k.startswith("prefill_cache") and k.endswith("/k") for k in errs)
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    assert not bad, bad


# ---------------------------------------------------------------------------
# the two scans the models wire to kernels, against the reference's paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
def test_rglru_seq_matches_the_reference(use_pallas, with_h0):
    cfg = jget_arch("recurrentgemma-2b").reduced()
    p_j = jax.tree.map(lambda t: t[0], JModel(cfg).init(jax.random.key(3))["superblocks"]["rec1"])
    p_t = tspec.params_from_jax(_np(p_j), "cpu")
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 24, cfg.rnn_dim)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.rnn_dim)).astype(np.float32) if with_h0 else None
    y_j, h_j = jrglru.rglru_seq(p_j, jnp.asarray(u), None if h0 is None else jnp.asarray(h0), use_pallas=use_pallas)
    y_t, h_t = rglru.rglru_seq(p_t, torch.from_numpy(u), None if h0 is None else torch.from_numpy(h0))
    assert y_t.dtype == torch.float32 and h_t.dtype == torch.float32
    assert _rel_err(y_t, y_j) <= REL_TOL and _rel_err(h_t, h_j) <= REL_TOL


@pytest.mark.parametrize("path", ["assoc", "seq", "pallas_interpret"])
def test_selective_scan_chunked_matches_the_reference(path):
    """Three chunks of 8 at B 2, so the chunks are cut from a batched
    sequence and the state is carried twice; h0 nonzero."""
    cfg = jget_arch("falcon-mamba-7b").reduced()
    if path != "pallas_interpret":
        cfg = cfg.replace(ssm_scan=path)
    p_j = jax.tree.map(lambda t: t[0], JModel(cfg).init(jax.random.key(5))["blocks"])
    p_t = tspec.params_from_jax(_np(p_j), "cpu")
    rng = np.random.default_rng(6)
    Bn, Ln, di, N = 2, 24, cfg.d_inner, cfg.ssm_state
    xb = rng.normal(size=(Bn, Ln, di)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (Bn, Ln, di)).astype(np.float32)
    bm, cm = (rng.normal(size=(Bn, Ln, N)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(Bn, di, N)).astype(np.float32)
    y_j, h_j = jssm.selective_scan_chunked(
        cfg, p_j, *(jnp.asarray(t) for t in (xb, dt, bm, cm, h0)), use_pallas=path == "pallas_interpret"
    )
    y_t, h_t = ssm.selective_scan_chunked(get_arch("falcon-mamba-7b").reduced(), p_t, *(torch.from_numpy(t) for t in (xb, dt, bm, cm, h0)))
    assert ssm.chunk_len(get_arch("falcon-mamba-7b").reduced(), Ln) == 8
    assert _rel_err(y_t, y_j) <= REL_TOL and _rel_err(h_t, h_j) <= REL_TOL


def test_ssm_chunks_are_contiguous_operands(monkeypatch):
    """The wrapper refuses strided operands on the card, so every chunk the
    model hands it must be contiguous, x in the compute dtype and the rest
    fp32, as ``ops.selective_scan_chunk`` requires."""
    seen = []
    real = ops.selective_scan_chunk

    def spy(x, dt, b, c, a, h0, **kw):
        seen.append((x, dt, b, c, a, h0))
        return real(x, dt, b, c, a, h0, **kw)

    monkeypatch.setattr(ops, "selective_scan_chunk", spy)
    cfg = get_arch("falcon-mamba-7b").reduced()
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    m.prefill(params, {"tokens": torch.zeros((3, 20), dtype=torch.int32)})
    assert len(seen) == cfg.n_layers * (20 // ssm.chunk_len(cfg, 20))
    for ops_ in seen:
        assert all(t.is_contiguous() for t in ops_)
        assert [t.dtype for t in ops_[1:]] == [torch.float32] * 5


@pytest.mark.parametrize("length,block", [(16, 16), (1000, 125), (2176, 128), (4096, 128), (97, 97), (194, 97)])
def test_attention_blocks_divide_any_prompt(length, block):
    """The largest divisor of the prompt length up to 128 (the reference's
    chunk fallback), so the kernel's divisibility rule always holds."""
    assert block_for(length) == block
    tfa.check_blocks(length, length, block, block)


def test_attention_head_width_16_routes_fp32_to_simt_and_refuses_bf16():
    # the reduced configs' width: fp32 went from the CUDA cores (simt) to the
    # tensor cores' fp32-accurate tf32x3 route; bf16, once refused (narrower
    # than the wgmma kernel's smallest swizzle), takes one TF32 product a
    # product (tf32), forward and backward
    assert tfa.route(torch.float32, {"hd": 16}) == "tf32x3"
    assert tfa.route(torch.bfloat16, {"hd": 16}) == tfa.bwd_route(torch.bfloat16, 16) == "tf32"
    with pytest.raises(ValueError, match="head width 8"):
        tfa.route(torch.bfloat16, {"hd": 8})


# ---------------------------------------------------------------------------
# configs and specs: all ten architectures, no allocation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_config_counts_and_cut_match_the_reference(name):
    cj, ct = jget_arch(name), get_arch(name)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert dataclasses.asdict(ct.reduced()) == dataclasses.asdict(cj.reduced())
    for c_t, c_j in ((ct, cj), (ct.reduced(), cj.reduced())):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.param_count(active_only=True) == c_j.param_count(active_only=True)
        assert [c_t.layer_kind(i) for i in range(c_t.n_layers)] == [c_j.layer_kind(i) for i in range(c_j.n_layers)]
        assert (c_t.hd, c_t.d_inner, c_t.dt_rank, c_t.rnn_dim, c_t.sub_quadratic) == (
            c_j.hd, c_j.d_inner, c_j.dt_rank, c_j.rnn_dim, c_j.sub_quadratic
        )
    # every family is ported: the model's count is the reference's, full and reduced
    for c_t, c_j in ((ct, cj), (ct.reduced(), cj.reduced())):
        assert Model(c_t).param_count() == tspec.tree_size(Model(c_t).specs()) == JModel(c_j).param_count()


def test_registry_shapes_and_cells_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert sorted(ARCHS) == sorted(JARCHS)
    for skips in (False, True):
        assert [(a.name, s.name, ok) for a, s, ok in all_cells(skips)] == [(a.name, s.name, ok) for a, s, ok in jall_cells(skips)]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_spec_trees_match_the_reference(name):
    """Every leaf: shape, logical axes, dtype, init kind and scale."""
    for cfg_t, cfg_j in ((get_arch(name), jget_arch(name)), (get_arch(name).reduced(), jget_arch(name).reduced())):
        ref = jax.tree.map(
            lambda s: (s.shape, s.axes, s.dtype, s.init, s.scale), JModel(cfg_j).specs(),
            is_leaf=lambda x: isinstance(x, JParamSpec),
        )
        port = tspec.tree_map(lambda s: (s.shape, s.axes, s.dtype, s.init, s.scale), Model(cfg_t).specs())
        assert port == ref
        cache_ref = jax.tree.map(
            lambda s: (s.shape, s.dtype), JModel(cfg_j).cache_specs(4, 40), is_leaf=lambda x: isinstance(x, JParamSpec)
        )
        assert tspec.tree_map(lambda s: (s.shape, s.dtype), Model(cfg_t).cache_specs(4, 40)) == cache_ref


# ---------------------------------------------------------------------------
# parameters: carried across bit for bit, and drawn by every init kind
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_bf16_leaves_bit_for_bit():
    cfg = jget_arch("recurrentgemma-2b").reduced().replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref = _np(JModel(cfg).init(jax.random.key(7)))
    port = tspec.params_from_jax(ref, "cpu")
    n_bf16 = 0

    def check(p, r):
        nonlocal n_bf16
        assert tuple(p.shape) == r.shape
        if r.dtype.name == "bfloat16":
            n_bf16 += 1
            assert p.dtype == torch.bfloat16
            assert np.array_equal(p.view(torch.uint16).numpy(), r.view(np.uint16))
        else:
            assert p.dtype == torch.float32 and np.array_equal(p.numpy(), r)

    assert tspec.tree_map(lambda t: tuple(t.shape), port) == jax.tree.map(lambda a: a.shape, ref)
    for p, r in zip(tspec.tree_leaves(port), jax.tree.leaves(ref)):
        check(p, r)
    assert n_bf16 > 20


def test_init_params_kinds_and_ranges():
    cfg = get_arch("falcon-mamba-7b").reduced()
    ssm_params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    ref = _np(JModel(jget_arch("falcon-mamba-7b").reduced()).init(jax.random.key(0)))
    blocks = ssm_params["blocks"]
    # ssm_a_log is deterministic: exactly the reference's
    assert np.array_equal(blocks["a_log"].numpy(), ref["blocks"]["a_log"])
    dt = torch.nn.functional.softplus(blocks["b_dt"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 1e-1 + 1e-7
    assert torch.equal(blocks["d_skip"], torch.ones_like(blocks["d_skip"]))
    assert torch.equal(blocks["ln"], torch.zeros_like(blocks["ln"]))
    emb = ssm_params["embed"]
    assert abs(float(emb.std()) - 0.02) < 0.002 and abs(float(emb.mean())) < 0.002
    hyb = Model(get_arch("recurrentgemma-2b").reduced()).init(torch.Generator().manual_seed(0), "cpu")
    a = torch.sigmoid(hyb["superblocks"]["rec1"]["lam"]) ** rglru.LRU_C
    assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5
    # one seed, one draw; another seed, another
    again = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    other = Model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again["embed"], emb) and not torch.equal(other["embed"], emb)


def main():
    for name in PORTED:
        errs = compare_arch(name)
        worst = max(errs, key=errs.get)
        print(f"{name}: forward {errs['forward']:.3e} prefill_logits {errs['prefill_logits']:.3e} "
              f"decode_logits {max(v for k, v in errs.items() if k.startswith('decode') and k.endswith('logits')):.3e} "
              f"worst {worst} {errs[worst]:.3e} over {len(errs)} outputs")
    for prompt in (16, 20, 37):
        errs = compare_arch("recurrentgemma-2b", L=prompt)
        worst = max(errs, key=errs.get)
        print(f"recurrentgemma-2b past its window, prompt {prompt}: worst {worst} {errs[worst]:.3e} over {len(errs)} outputs")


if __name__ == "__main__":
    main()
