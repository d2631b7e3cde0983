"""The arithmetic of the fp32 attention kernels on the tensor cores held
against the JAX reference, on the CPU.

The ``tf32x3`` forward (``csrc/flash_attention.cu``) and backward
(``csrc/flash_attention_bwd_tf32x3.cu``) run only on a GPU (``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold them against the plain versions there).
Here numpy models of what they compute are held against the reference, so
the design is checked before a card runs it:

* every product is three TF32 products, each operand value split into
  hi = tf32(v) and lo = tf32(v - hi) with TF32 rounding to nearest, ties
  away from zero (``cvt.rna``, as ``tests/test_torch_slice8.py`` models it);
  8 deep at a time (a k8 wgmma), the small products (lo hi, hi lo) of a
  stage first and the large ones (hi hi) last, into a fresh fp32 sum a
  stage of at most 32 along the depth, each stage's sum then added to the
  running one;
* the forward: q tiles of 64 rows, k tiles of 32 in the kernel's order
  (from the first tile the causal and window bounds leave), split into the
  rule's runs (``fwd_parts``), the online softmax in base 2 as the kernel
  takes it, P V of each k tile in one stage and O = O corr + P V, the runs
  merged in order; LSE2 = m log2(e) + log2(l);
* the backward from the forward's LSE2 and D = rowsum(dO o O): dQ blocks of
  64 q rows streaming K and V, dK and dV blocks of 64 k rows streaming the
  group's Q and dO head by head (tiles of 32 rows, 16 for the dQ and dK
  blocks at hd 128), the group's query heads split into ``kv_parts`` parts
  summed in order.

The forward must hold the reference's fp32 tolerance, max-abs 2e-5
(tests/test_kernels_parity.py:23), against ``flash_attention`` run in
interpret mode at the registry's three fp32 tiers, at head width 16 with a
window of 16 and at Lq != Lk both ways; one TF32 product a product must miss
it at the full tier, so the test tells the two designs apart.  The backward
must hold ``jax.vjp`` of the reference's plain attention within 1e-5 of each
gradient's largest element.  (On the card the kernels are held to 2e-5 and
1e-4.)
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
from repro_torch.kernels import registry as treg

F32_TOL = 2e-5
BWD_REL_TOL = 1e-5
LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)
ROWS = 64  # a block's own rows
N_SM = 132


def tf32_rna(v: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v: np.ndarray):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def stage(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a (..., M, K) @ b (..., K, N), K <= 32, as one stage: 8 deep at a time,
    the small products of every step first, then the large ones, into a
    fresh fp32 sum.  ``products=1`` keeps the large ones only."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    part = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    small = [(al, bh), (ah, bl)] if products == 3 else []
    steps = range(0, a.shape[-1], 8)
    for k0 in steps:
        for x, y in small:
            part += x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    for k0 in steps:
        part += ah[..., k0:k0 + 8] @ bh[..., k0:k0 + 8, :]
    return part


def staged(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a @ b over a deep K: stages of 32, each added to the running fp32 sum."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 32):
        out += stage(a[..., k0:k0 + 32], b[..., k0:k0 + 32, :], products)
    return out


def scores(a: np.ndarray, b: np.ndarray, products: int, halves: int = 1) -> np.ndarray:
    """a @ b over the head, as the kernels take a score-like product: with
    ``halves`` = 2 (fp32 at hd 256, two-block clusters) each block's staged
    product over its half of the head, then the pair's fp32 sum."""
    w = a.shape[-1] // halves
    out = staged(a[..., :w], b[..., :w, :], products)
    for h in range(1, halves):
        out = out + staged(a[..., h * w:(h + 1) * w], b[..., h * w:(h + 1) * w, :], products)
    return out


def fma(a, b, c):
    """fp32 a * b + c rounded once."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def live(qpos, kpos, lq, lk, causal, window):
    ok = (qpos < lq) & (kpos < lk)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    return ok


def tile(x: np.ndarray, r0: int, n: int) -> np.ndarray:
    """Rows [r0, r0 + n) of x (..., L, hd), zeros past L, as the kernels load them."""
    out = np.zeros(x.shape[:-2] + (n, x.shape[-1]), np.float32)
    got = x[..., r0:r0 + n, :]
    out[..., :got.shape[-2], :] = got
    return out


def forward_model(q, k, v, causal, window, products=3, bn=32, parts=None, halves=1):
    """What ``flash_fwd_tf32x3`` computes: (o, LSE2).  ``parts`` (by default
    the kernel's rule, ``fwd_parts`` on 132 SMs, a cluster of ``halves``
    blocks counting as one on 132 / halves) splits each q tile's k tiles
    into equal runs, each with its own online softmax, merged in order as
    ``flash_fwd_tf32x3_combine`` merges them.  ``halves`` = 2: S is the sum
    of the two head halves' products (``scores``)."""
    B, H, lq, hd = q.shape
    KV, lk = k.shape[1], k.shape[2]
    if parts is None:
        parts = tfa.fwd_parts(B, H, lq, lk, causal, window, N_SM // halves)
    kr, vr = (np.repeat(x, H // KV, axis=1) for x in (k, v))
    scale = np.float32(1.0 / np.sqrt(hd))
    o = np.zeros_like(q)
    lse = np.zeros((B, H, lq), np.float32)
    for q0 in range(0, lq, ROWS):
        qt = tile(q, q0, ROWS)
        qpos = np.arange(q0, q0 + ROWS)[:, None]
        lo = max(0, q0 - window + 1) if window is not None else 0
        hi = min(lk, q0 + ROWS) if causal else lk
        tiles = list(range(lo // bn * bn, hi, bn))
        run = -(-len(tiles) // parts)
        runs = []
        for p in range(parts):
            m = np.full((B, H, ROWS), NEG, np.float32)
            l = np.zeros((B, H, ROWS), np.float32)
            acc = np.zeros((B, H, ROWS, hd), np.float32)
            for kt in tiles[p * run:(p + 1) * run]:
                kk, vv = tile(kr, kt, bn), tile(vr, kt, bn)
                mask = live(qpos, np.arange(kt, kt + bn)[None, :], lq, lk, causal, window)
                s = np.where(mask, scores(qt, kk.swapaxes(-1, -2), products, halves) * scale, NEG)
                m_new = np.maximum(m, s.max(-1))
                corr = np.exp2((m - m_new) * LOG2E)
                with np.errstate(over="ignore"):  # a masked score's exponent, never selected (as in the kernel)
                    p_ = np.where(mask, np.exp2(fma(s, LOG2E, -(m_new * LOG2E)[..., None])), np.float32(0))
                l = l * corr + p_.sum(-1, dtype=np.float32)
                m = m_new
                acc = fma(acc, corr[..., None], stage(p_, vv, products))
            runs.append((m, l, acc))
        if parts == 1:
            m, l, acc = runs[0]
        else:  # the combine, parts in order
            m = np.max([r[0] for r in runs], axis=0)
            l = np.zeros_like(m)
            acc = np.zeros((B, H, ROWS, hd), np.float32)
            for m_p, l_p, acc_p in runs:
                w = np.exp2((m_p - m) * LOG2E)
                l = fma(w, l_p, l)
                acc = fma(w[..., None], acc_p, acc)
        n = min(ROWS, lq - q0)
        o[:, :, q0:q0 + n] = (acc / np.maximum(l, np.float32(1e-37))[..., None])[:, :, :n]
        with np.errstate(divide="ignore"):
            lse[:, :, q0:q0 + n] = (m * LOG2E + np.log2(l))[:, :, :n]
    return o, lse


def backward_model(q, k, v, o, do, lse2, causal, window, products=3, halves=1):
    """What ``flash_attention_bwd_tf32x3`` computes from the forward's o and
    LSE2: (dq, dk, dv).  ``products`` = 1 takes the large TF32 product alone
    (bf16 operands); ``halves`` = 2 forms S and dP as the sum of the two
    head halves' products (``scores``), blocks 128 columns wide."""
    B, H, lq, hd = q.shape
    KV, lk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = np.float32(1.0 / np.sqrt(hd))
    sl2 = np.float32(scale * LOG2E)
    d_rows = (do * o).sum(-1, dtype=np.float32)
    lse = np.where(lse2 == -np.inf, np.inf, lse2).astype(np.float32)  # no live key: P = 0
    ds_bn, dv_bn = (16 if hd // halves == 128 else 32), 32
    T = lambda x: x.swapaxes(-1, -2)

    # dQ blocks: 64 q rows, K and V streamed
    kr, vr = (np.repeat(x, rep, axis=1) for x in (k, v))
    dq = np.zeros_like(q)
    for q0 in range(0, lq, ROWS):
        qt, dot = tile(q, q0, ROWS), tile(do, q0, ROWS)
        rows = np.arange(q0, q0 + ROWS)
        lr = np.full((B, H, ROWS), np.inf, np.float32)
        dr = np.zeros((B, H, ROWS), np.float32)
        n = min(ROWS, lq - q0)
        lr[..., :n], dr[..., :n] = lse[..., q0:q0 + n], d_rows[..., q0:q0 + n]
        lo = max(0, q0 - window + 1) if window is not None else 0
        hi = min(lk, q0 + ROWS) if causal else lk
        acc = np.zeros((B, H, ROWS, hd), np.float32)
        for kt in range(lo // ds_bn * ds_bn, hi, ds_bn):
            kk, vv = tile(kr, kt, ds_bn), tile(vr, kt, ds_bn)
            mask = live(rows[:, None], np.arange(kt, kt + ds_bn)[None, :], lq, lk, causal, window)
            p = np.where(mask, np.exp2(fma(scores(qt, T(kk), products, halves), sl2, -lr[..., None])), np.float32(0))
            ds = p * (scores(dot, T(vv), products, halves) - dr[..., None])
            acc += stage(ds, kk, products)
        dq[:, :, q0:q0 + n] = (acc * scale)[:, :, :n]

    # dK and dV blocks: 64 k rows, the part's query heads streamed head by head
    parts = tfa.kv_parts(B, KV, H, lk, N_SM // halves, tfa.KV_ROLES["tf32x3"])
    per = rep // parts
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for k0 in range(0, lk, ROWS):
        kt_, vt_ = tile(k, k0, ROWS), tile(v, k0, ROWS)
        krows = np.arange(k0, k0 + ROWS)[:, None]
        lo = k0 if causal else 0
        hi = min(lq, k0 + ROWS - 1 + window) if window is not None else lq
        sums = {}
        for kind, bn in (("dk", ds_bn), ("dv", dv_bn)):
            total = np.zeros((B, KV, ROWS, hd), np.float32)
            for part in range(parts):
                acc = np.zeros((B, KV, ROWS, hd), np.float32)
                for g in range(part * per, (part + 1) * per):
                    heads = np.arange(KV) * rep + g
                    qh, doh = q[:, heads], do[:, heads]
                    for c0 in range(lo // bn * bn, hi, bn):
                        qq, dd = tile(qh, c0, bn), tile(doh, c0, bn)
                        cols = np.arange(c0, c0 + bn)
                        lc = np.full((B, KV, bn), np.inf, np.float32)
                        dc = np.zeros((B, KV, bn), np.float32)
                        n = min(bn, lq - c0)
                        lc[..., :n], dc[..., :n] = lse[:, heads, c0:c0 + n], d_rows[:, heads, c0:c0 + n]
                        mask = live(cols[None, :], krows, lq, lk, causal, window)
                        p = np.where(mask, np.exp2(fma(scores(kt_, T(qq), products, halves), sl2, -lc[..., None, :])),
                                     np.float32(0))
                        if kind == "dk":
                            ds = p * (scores(vt_, T(dd), products, halves) - dc[..., None, :])
                            acc += stage(ds, qq, products)
                        else:
                            acc += stage(p, dd, products)
                total = acc if part == 0 else total + acc
            sums[kind] = total * scale if kind == "dk" else total
        n = min(ROWS, lk - k0)
        dk[:, :, k0:k0 + n], dv[:, :, k0:k0 + n] = sums["dk"][:, :, :n], sums["dv"][:, :, :n]
    return dq, dk, dv


def _operands(B, H, KV, lq, lk, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, lq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, KV, lk, hd)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, H, lq, hd)).astype(np.float32)
    return q, k, v, do


def _tier(name):
    s = dict(getattr(treg.get_kernel("flash_attention"), f"{name}_shape"))
    return (s["B"], s["H"], s["KV"], s["L"], s["L"], s["hd"], s["causal"], s["window"])


# (B, H, KV, Lq, Lk, hd, causal, window, JAX blocks (q, k)): the registry's
# fp32 tiers, head width 16 with a window of 16 (the reduced configs), and
# Lq != Lk both ways (chip_smoke.py's forward and backward cases)
CASES = {
    "tiny": (*_tier("tiny"), (128, 128)),
    "smoke": (*_tier("smoke"), (128, 128)),
    "full": (*_tier("full"), (128, 128)),
    "hd16_window16": (2, 4, 2, 128, 128, 16, True, 16, (64, 64)),
    "lq96_lk200_non_causal": (1, 4, 2, 96, 200, 64, False, None, (32, 40)),
    "lq200_lk96_causal_hd128": (1, 4, 1, 200, 96, 128, True, None, (40, 32)),
}


def _reference_forward(q, k, v, case):
    *_, causal, window, (bq, bk) = case
    return np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                           window=window, block_q=bq, block_k=bk))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_tf32_products_hold_the_fp32_tolerance_forward(name):
    B, H, KV, lq, lk, hd, causal, window, _ = case = CASES[name]
    q, k, v, _ = _operands(B, H, KV, lq, lk, hd, seed=9)
    got, _ = forward_model(q, k, v, causal, window)
    err = float(np.max(np.abs(got - _reference_forward(q, k, v, case))))
    assert err <= F32_TOL, err


def test_split_k_tiles_merge_to_the_unsplit_result():
    """Splitting a q tile's k tiles into runs and merging them changes only
    the order of the fp32 sums: the full tier with 1, 2 and 4 parts agrees
    within a few roundings, and so does its LSE."""
    B, H, KV, lq, lk, hd, causal, window, _ = CASES["full"]
    q, k, v, _ = _operands(B, H, KV, lq, lk, hd, seed=9)
    o1, lse1 = forward_model(q, k, v, causal, window, parts=1)
    for parts in (2, 4):
        o, lse = forward_model(q, k, v, causal, window, parts=parts)
        assert float(np.max(np.abs(o - o1))) <= 2e-6
        assert float(np.max(np.abs(lse - lse1))) <= 1e-5 * float(np.max(np.abs(lse1)))


def test_one_tf32_product_misses_the_fp32_tolerance_forward():
    B, H, KV, lq, lk, hd, causal, window, _ = case = CASES["full"]
    q, k, v, _ = _operands(B, H, KV, lq, lk, hd, seed=9)
    got, _ = forward_model(q, k, v, causal, window, products=1)
    err = float(np.max(np.abs(got - _reference_forward(q, k, v, case))))
    assert err > 10 * F32_TOL, err


def test_forward_model_lse_is_the_plain_lse():
    """LSE2 from the online softmax's m and l against the reference's
    log-sum-exp of the masked scores, in base 2 (relative 1e-5), -inf where
    a row sees no key (Lq past Lk + window)."""
    q, k, v, _ = _operands(1, 2, 1, 300, 100, 32, seed=4)
    _, got = forward_model(q, k, v, True, 50)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), np.repeat(k, 2, axis=1).astype(np.float64)) / np.sqrt(32)
    mask = live(np.arange(300)[:, None], np.arange(100)[None, :], 300, 100, True, 50)
    with np.errstate(divide="ignore"):
        want = np.log2(np.where(mask, np.exp(s - s.max()), 0).sum(-1)) + s.max() * np.log2(np.e)
    finite = np.isfinite(want)
    assert not finite.all() and np.array_equal(np.isfinite(got), finite)
    assert np.max(np.abs(got[finite] - want[finite])) <= 1e-5 * np.max(np.abs(want[finite]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_tf32_products_hold_the_reference_gradients(name):
    B, H, KV, lq, lk, hd, causal, window, _ = CASES[name]
    q, k, v, do = _operands(B, H, KV, lq, lk, hd, seed=10)
    o, lse2 = forward_model(q, k, v, causal, window)
    got = backward_model(q, k, v, o, do, lse2, causal, window)
    f = lambda q_, k_, v_: jref.attention_ref(q_, k_, v_, causal=causal, window=window)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        w = np.asarray(w)
        assert float(np.max(np.abs(g - w))) <= BWD_REL_TOL * float(np.max(np.abs(w)))


# ---------------------------------------------------------------------------
# the rules around the kernels, pure Python
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_fp32_attention_takes_the_tensor_cores_up_to_128(hd):
    # one block a q tile up to 128; at 256 two-block clusters that split the
    # head (tests/test_torch_slice10.py models them)
    want = "tf32x3" if hd <= 128 else "tf32x3_cluster"
    assert tfa.route(torch.float32, {"hd": hd}) == want
    assert tfa.bwd_route(torch.float32, hd) == want
    assert hd in tfa.ROUTE_DIMS[torch.float32][want] and tfa.CLUSTER_BLOCKS.get(want, 1) == (1 if hd <= 128 else 2)


# (B, H, Lq, Lk, causal, window, parts on 132 SMs): the registry's tiers
# (64, 16 and 4 q tiles of 64 rows; tiny's longest q tile has 4 k tiles, too
# few to split), llama3-8b's width (2048 blocks), the Lq != Lk cases (7 and 3
# k tiles), the reduced configs' hd 16 with its window (3)
_FWD_PARTS = [
    (1, 8, 512, 512, True, None, 2), (1, 4, 256, 256, True, None, 4), (1, 2, 128, 128, True, None, 1),
    (1, 32, 4096, 4096, True, None, 1), (1, 4, 96, 200, False, None, 4), (1, 4, 200, 96, True, None, 1),
    (2, 4, 128, 128, True, 16, 1), (2, 4, 16, 16, True, None, 1),
]


@pytest.mark.parametrize("b,h,lq,lk,causal,window,want", _FWD_PARTS)
def test_forward_split_fills_the_card(b, h, lq, lk, causal, window, want):
    """``fwd_parts``: a grid that fills less than half the card is split so
    that it fits one wave, where that takes at least MIN_TILES_SAVED k
    tiles off the longest q tile; the full tier goes from 64 blocks to 128."""
    got = tfa.fwd_parts(b, h, lq, lk, causal, window, N_SM)
    blocks = -(-lq // ROWS) * b * h
    assert got == want and (got == 1 or blocks * got <= N_SM)


def _tf32x3_bwd_blocks(B, H, KV, lq, lk):
    parts = tfa.kv_parts(B, KV, H, lk, N_SM, tfa.KV_ROLES["tf32x3"])
    return -(-lq // ROWS) * B * H + 2 * -(-lk // ROWS) * B * KV * parts


@pytest.mark.parametrize("shape,simt_blocks", [
    ((1, 4, 2, 96, 200), (8, 8, 8)),  # the broker's fp32 Lq96 Lk200 case
    ((2, 4, 2, 128, 128), (16, 8, 16)),  # the reduced configs' hd 16 case
])
def test_tf32x3_backward_runs_on_more_blocks_than_the_simt_one(shape, simt_blocks):
    """One launch of dQ, dK and dV blocks side by side, the group's heads
    split into parts: at least twice the largest of the three grids of the
    first port's CUDA-core backward (preprocess, dK/dV, dQ), which ran one
    after another."""
    assert _tf32x3_bwd_blocks(*shape) >= 2 * max(simt_blocks)


if __name__ == "__main__":
    for name in sorted(CASES):
        B, H, KV, lq, lk, hd, causal, window, _ = case = CASES[name]
        q, k, v, _ = _operands(B, H, KV, lq, lk, hd, seed=9)
        want = _reference_forward(q, k, v, case)
        for products in (3, 1):
            got, _ = forward_model(q, k, v, causal, window, products=products)
            print(f"forward {name} products={products} max_abs_err={float(np.max(np.abs(got - want))):.3e}")
