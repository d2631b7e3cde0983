"""The arithmetic of the two attention routes that took the last CUDA-core
widths onto the tensor cores, held against the JAX reference on the CPU.

* ``tf32x3_cluster`` (fp32 at head width 256, ``csrc/flash_attention.cu``
  and ``csrc/flash_attention_bwd_tf32x3.cu``): two blocks of a cluster own
  the same 64 rows and 128 head columns each.  A score-like product (S, and
  dP in the backward) is each block's three-TF32-product staged product
  over its half of the head (stages of 32 along the depth), then the pair's
  fp32 sum; both blocks hold that sum and multiply P (or dS) into their own
  half of the output, which is the whole-head product column by column.
  The backward's dQ and dK blocks stream 16 rows a tile (the hd 128 blocks'
  width), its dV blocks 32.
* ``tf32`` (bf16 at head width 16): the ``tf32x3`` kernels on bf16 rows,
  one TF32 product a product -- a bf16 value is exact in TF32, so the split
  leaves lo = 0 -- with P and dS rounded to TF32 as they enter the tensor
  cores, and o, dq, dk, dv rounded once to bf16.

The models are ``tests/test_torch_slice9.py``'s (``forward_model``,
``backward_model``) with the head split (``halves=2``) or one product
(``products=1``).  They run on the CPU only: the kernels run on a GPU
(``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them there).

Tolerances: fp32 max-abs 2e-5 (tests/test_kernels_parity.py:23) against
``flash_attention`` run in interpret mode, as ``tests/test_kernels.py`` runs
it, and relative 1e-4 at model width (the recurrentgemma-2b head, a shorter
sequence); one TF32 product must miss 2e-5 at hd 256, so the test tells the
designs apart.  bf16 rtol = atol = 2e-2 (tests/test_kernels.py:13).
Gradients: fp32 within 1e-5 of each gradient's largest element against
``jax.vjp`` of the reference's plain attention; bf16 element by element,
rtol = atol = 2e-2 with atol against the largest element.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa

import test_torch_slice9 as s9

F32_TOL = 2e-5
WIDTH_REL_TOL = 1e-4
BF16_TOL = 2e-2
BWD_REL_TOL = 1e-5


def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest, ties to even), kept as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _reference_forward(q, k, v, causal, window, blocks, dtype=jnp.float32):
    bq, bk = blocks
    out = jops.flash_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype), causal=causal,
                               window=window, block_q=bq, block_k=bk)
    return np.asarray(out.astype(jnp.float32))


def _reference_grads(q, k, v, do, causal, window):
    f = lambda q_, k_, v_: jref.attention_ref(q_, k_, v_, causal=causal, window=window)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(w) for w in vjp(jnp.asarray(do))]


# (B, H, KV, Lq, Lk, causal, window, JAX blocks (q, k)): causal with a
# window, non-causal, GQA, ragged and windowed (L not a multiple of the
# 64-row tile or the 32-row k tile), Lq != Lk both ways, rows with no live
# key (Lq past Lk + window)
CASES = {
    "mqa_windowed": (1, 4, 1, 256, 256, True, 64, (64, 64)),
    "non_causal": (1, 2, 2, 192, 192, False, None, (64, 64)),
    "gqa_ragged_windowed": (1, 4, 2, 320, 320, True, 100, (64, 64)),
    "lq96_lk200_non_causal": (1, 4, 2, 96, 200, False, None, (32, 40)),
    "lq200_lk96_causal": (1, 4, 1, 200, 96, True, None, (40, 32)),
    "lq300_lk100_window50": (1, 2, 1, 300, 100, True, 50, (60, 50)),
}


def _case(name, hd, seed):
    B, H, KV, lq, lk, causal, window, blocks = CASES[name]
    q, k, v, do = s9._operands(B, H, KV, lq, lk, hd, seed)
    return q, k, v, do, causal, window, blocks


# ---------------------------------------------------------------------------
# fp32 at head width 256: the two-block cluster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_cluster_forward_holds_the_fp32_tolerance(name):
    q, k, v, _, causal, window, blocks = _case(name, 256, seed=3)
    got, _ = s9.forward_model(q, k, v, causal, window, halves=2)
    err = float(np.max(np.abs(got - _reference_forward(q, k, v, causal, window, blocks))))
    assert err <= F32_TOL, err


def test_cluster_forward_holds_the_relative_tolerance_at_model_width():
    """recurrentgemma-2b's attention (hd 256, one KV head, window 2048 cut to
    128 with the sequence): relative 1e-4 of the largest output, and the
    max-abs tolerance too."""
    q, k, v, _ = s9._operands(1, 2, 1, 512, 512, 256, seed=5)
    got, _ = s9.forward_model(q, k, v, True, 128, halves=2)
    want = _reference_forward(q, k, v, True, 128, (128, 128))
    err = float(np.max(np.abs(got - want)))
    assert err <= WIDTH_REL_TOL * float(np.max(np.abs(want))) and err <= F32_TOL, err


def test_one_tf32_product_misses_the_fp32_tolerance_at_256():
    q, k, v, _, causal, window, blocks = _case("gqa_ragged_windowed", 256, seed=3)
    got, _ = s9.forward_model(q, k, v, causal, window, products=1, halves=2)
    err = float(np.max(np.abs(got - _reference_forward(q, k, v, causal, window, blocks))))
    assert err > 10 * F32_TOL, err


def test_the_pair_sum_is_the_whole_head_product_within_a_few_roundings():
    """Adding the two halves' partial S changes only the order of the fp32
    sums: o and LSE2 with the head split agree with the unsplit model
    within a few roundings, and the k split (4 parts of a small grid) merges
    to the same."""
    q, k, v, _ = s9._operands(1, 2, 2, 256, 256, 256, seed=6)
    o1, lse1 = s9.forward_model(q, k, v, False, None, halves=1, parts=1)
    for parts in (1, None):
        o2, lse2 = s9.forward_model(q, k, v, False, None, halves=2, parts=parts)
        assert float(np.max(np.abs(o2 - o1))) <= 2e-6
        assert float(np.max(np.abs(lse2 - lse1))) <= 1e-5 * float(np.max(np.abs(lse1)))
    assert tfa.fwd_parts(1, 2, 256, 256, False, None, s9.N_SM // 2) == 4


# the backward's cases: every row sees a key (the plain attention spreads a
# row that sees none evenly over the keys, and its gradient with it, where
# the kernels keep it 0)
BWD_CASES = ["gqa_ragged_windowed", "lq96_lk200_non_causal", "lq200_lk96_causal"]


@pytest.mark.parametrize("name", BWD_CASES)
def test_cluster_backward_holds_the_reference_gradients(name):
    q, k, v, do, causal, window, _ = _case(name, 256, seed=7)
    o, lse2 = s9.forward_model(q, k, v, causal, window, halves=2)
    got = s9.backward_model(q, k, v, o, do, lse2, causal, window, halves=2)
    for g, w in zip(got, _reference_grads(q, k, v, do, causal, window)):
        assert float(np.max(np.abs(g - w))) <= BWD_REL_TOL * float(np.max(np.abs(w)))


# ---------------------------------------------------------------------------
# bf16 at head width 16: one TF32 product
# ---------------------------------------------------------------------------

BF16_CASES = {**CASES, "reduced_window16": (2, 4, 2, 128, 128, True, 16, (64, 64))}


def _bf16_case(name, seed):
    B, H, KV, lq, lk, causal, window, blocks = BF16_CASES[name]
    q, k, v, do = (bf16(x) for x in s9._operands(B, H, KV, lq, lk, 16, seed))
    return q, k, v, do, causal, window, blocks


def _within_bf16(got, want, atol_scale):
    return bool(np.all(np.abs(got - want) <= BF16_TOL * np.abs(want) + BF16_TOL * atol_scale))


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_one_product_bf16_forward_holds_the_bf16_tolerance(name):
    """The model's bf16 o against the reference kernel on the same bf16
    operands (interpret mode), rtol = atol = 2e-2; and within one bf16
    rounding of the fp32 result, since P is rounded to TF32 (11 bits), not
    to bf16 as the reference rounds it."""
    q, k, v, _, causal, window, blocks = _bf16_case(name, seed=8)
    got, _ = s9.forward_model(q, k, v, causal, window, products=1, parts=1)
    got = bf16(got)
    want = _reference_forward(q, k, v, causal, window, blocks, jnp.bfloat16)
    assert _within_bf16(got, want, 1.0)
    exact = _reference_forward(q, k, v, causal, window, blocks)
    assert float(np.max(np.abs(got - exact))) <= 2 ** -8 * float(np.max(np.abs(exact)))


@pytest.mark.parametrize("name", ["reduced_window16", *BWD_CASES])
def test_one_product_bf16_backward_holds_the_bf16_tolerance(name):
    q, k, v, do, causal, window, _ = _bf16_case(name, seed=9)
    o, lse2 = s9.forward_model(q, k, v, causal, window, products=1, parts=1)
    o = bf16(o)
    got = [bf16(g) for g in s9.backward_model(q, k, v, o, do, lse2, causal, window, products=1)]
    for g, w in zip(got, _reference_grads(q, k, v, do, causal, window)):
        assert _within_bf16(g, w, float(np.max(np.abs(w))))


# ---------------------------------------------------------------------------
# the rules around the kernels, pure Python
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_no_attention_width_maps_to_the_cuda_cores(dtype, hd):
    dt = getattr(torch, dtype)
    want = {("bfloat16", 16): "tf32", ("float32", 256): "tf32x3_cluster"}.get(
        (dtype, hd), "wgmma" if dtype == "bfloat16" else "tf32x3")
    assert tfa.route(dt, {"hd": hd}) == tfa.bwd_route(dt, hd) == want
    assert "simt" not in tfa.ROUTES and "simt" not in tfa.BWD_ENTRIES


# (B, H, KV, L, window, fwd parts, kv parts): a cluster counts as one block
# on 66 SMs -- recurrentgemma-2b (640 q tiles, 128 k-side clusters, 10 heads
# a KV head) splits nothing; a small grid's k tiles split in 4
@pytest.mark.parametrize("b,h,kv,length,window,fwd,kvp", [
    (1, 10, 1, 4096, 2048, 1, 1), (1, 2, 2, 256, None, 4, 1), (1, 8, 2, 333, 50, 1, 2),
])
def test_cluster_grids_count_a_pair_as_one_block(b, h, kv, length, window, fwd, kvp):
    n = s9.N_SM // tfa.CLUSTER_BLOCKS["tf32x3_cluster"]
    causal = window is not None
    assert tfa.fwd_parts(b, h, length, length, causal, window, n) == fwd
    assert tfa.kv_parts(b, kv, h, length, n, tfa.KV_ROLES["tf32x3_cluster"]) == kvp


if __name__ == "__main__":
    for name in sorted(CASES):
        q, k, v, _, causal, window, blocks = _case(name, 256, seed=3)
        want = _reference_forward(q, k, v, causal, window, blocks)
        for products in (3, 1):
            got, _ = s9.forward_model(q, k, v, causal, window, products=products, halves=2)
            print(f"hd256 forward {name} products={products} max_abs_err={float(np.max(np.abs(got - want))):.3e}")
    for name in sorted(BF16_CASES):
        q, k, v, _, causal, window, blocks = _bf16_case(name, seed=8)
        got, _ = s9.forward_model(q, k, v, causal, window, products=1, parts=1)
        want = _reference_forward(q, k, v, causal, window, blocks, jnp.bfloat16)
        rel = float(np.max(np.abs(bf16(got) - want))) / float(np.max(np.abs(want)))
        print(f"bf16 hd16 forward {name} rel_err={rel:.3e}")
