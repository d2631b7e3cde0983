"""The arithmetic of two Hopper kernels held against the JAX reference, on the CPU.

The kernels run only on a GPU (``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold them against the plain versions there).  Here numpy models of what they
compute are held against the reference, so the algorithms are checked before
a card runs them:

* the fp32 GEMM's ``tf32x3`` route (``csrc/moe_gmm.cu``): each operand value
  split into hi = tf32(v) and lo = tf32(v - hi), TF32 rounding to nearest with
  ties away from zero done with integer operations on the fp32 bits (as
  ``cvt.rna.tf32.f32`` rounds), then y = x_hi w_hi + x_hi w_lo + x_lo w_hi
  summed in fp32 in the kernel's order: per 32-deep stage, 8 deep at a time,
  the small products first and the large ones last, each stage's sum then
  added to the running one.  It must hold the
  reference's fp32 tolerance, max-abs 2e-5 (tests/test_kernels_parity.py:23),
  at the registry's three tiers against ``moe_gmm`` run in interpret mode; one
  TF32 product alone must miss it at the full tier, so the test tells the two
  designs apart;
* the RG-LRU backward's one pass (``csrc/rglru_scan_bwd.cu``): segments taken
  in ticket order from the sequence's end, each split into its warps' parts,
  a part's summary (A, C) from a zero carry, the look-back composing the
  summaries to the right until a published carry-out (drawn at random, as the
  race between blocks may have it) or the sequence's end (dh_last), and the
  rescan of each part from its carry-in.  It is held against ``jax.vjp`` of
  the reference's plain recurrence within 1e-5 of the largest element of each
  gradient: the model and autodiff take the same products in fp32, the model's
  carries composed in another order, which moves them by a few fp32 roundings.
  (The kernel is held to 1e-4 of the largest element on the card.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import registry as treg

F32_TOL = 2e-5
BWD_REL_TOL = 1e-5


# ---------------------------------------------------------------------------
# the tf32x3 GEMM
# ---------------------------------------------------------------------------


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the 13 dropped bits' unit to the magnitude bits, then
    clear them.  The sign bit is apart, so this rounds |v| up on a tie."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v: np.ndarray):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def gemm_tf32(x: np.ndarray, w: np.ndarray, products: int) -> np.ndarray:
    """y = x @ w per expert from TF32 products, as the kernel's stages take
    them: per 32-deep stage, 8 deep at a time (a k8 wgmma), the small
    products (w_lo x_hi, w_hi x_lo) of its four steps first and the large
    ones (w_hi x_hi) last, into a fresh fp32 sum that is then added to the
    running one; ``products=1`` keeps the large ones only.  A product of two
    TF32 values is exact in fp32."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    E, C, D = x.shape
    acc = np.zeros((E, C, w.shape[-1]), np.float32)
    for k0 in range(0, D, 32):
        steps = range(k0, min(D, k0 + 32), 8)
        small = [(xh, wl), (xl, wh)] if products == 3 else []
        terms = [(k, xa, wb) for k in steps for xa, wb in small] + [(k, xh, wh) for k in steps]
        part = np.zeros_like(acc)
        for k, xa, wb in terms:
            part += np.einsum("ecd,edf->ecf", xa[:, :, k:k + 8], wb[:, k:k + 8], dtype=np.float32)
        acc += part
    return acc


def _gmm_operands(shape: dict, seed: int):
    rng = np.random.default_rng(seed)
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    return x, w


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's unit at 1
    v = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 1 + 1.5 * ulp, 3.0], np.float32)
    got = tf32_rna(v)
    assert got.tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0]
    assert not np.any(got.view(np.uint32) & np.uint32(0x1FFF))
    hi, lo = split_tf32(v)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - v) <= 2.0**-22 * np.abs(v))


@pytest.mark.parametrize("tier", ["tiny", "smoke", "full"])
def test_three_tf32_products_hold_the_fp32_tolerance(tier):
    shape = dict(getattr(treg.get_kernel("moe_gmm"), f"{tier}_shape"))
    x, w = _gmm_operands(shape, seed=8)
    want = np.asarray(jops.moe_gmm(jnp.asarray(x), jnp.asarray(w)))
    err = float(np.max(np.abs(gemm_tf32(x, w, products=3) - want)))
    assert err <= F32_TOL, err


def test_one_tf32_product_misses_the_fp32_tolerance():
    shape = dict(treg.get_kernel("moe_gmm").full_shape)
    x, w = _gmm_operands(shape, seed=8)
    want = np.asarray(jops.moe_gmm(jnp.asarray(x), jnp.asarray(w)))
    err = float(np.max(np.abs(gemm_tf32(x, w, products=1) - want)))
    assert err > 10 * F32_TOL, err


# ---------------------------------------------------------------------------
# the RG-LRU backward in one pass
# ---------------------------------------------------------------------------


def _segmented_rglru_bwd(la, h0, y, dy, dh_last, T, W, rng, p_inclusive):
    """What ``csrc/rglru_scan_bwd.cu`` computes.  Segments of T steps are
    taken in ticket order, from the sequence's end; each is cut into W parts
    of T / W steps.  A part's summary is its reverse walk from a zero carry
    (C) and the product of its a's (A), so c_out = A c_in + C; the parts
    compose right to left into the segment's summary.  The look-back
    composes the summaries of the segments to the right until one whose
    carry-out is published (each is, with probability ``p_inclusive``) or
    the sequence's end, whose carry-in is dh_last.  Each part is walked again
    from its own carry-in: g_t = dy_t + c, dgx_t = g_t, dlog_a_t = g_t a_t
    h_{t-1} (h0 at t = 0), c = a_t g_t; the part holding t = 0 gives dh0.
    fp32 throughout."""
    B, L, dr = la.shape
    a = np.exp(la)
    P = T // W
    nseg = -(-L // T)
    one, zero = np.ones((B, dr), np.float32), np.zeros((B, dr), np.float32)
    dla, dgx, dh0 = np.empty_like(la), np.empty_like(la), None
    agg, out = {}, {}
    for seg in range(nseg - 1, -1, -1):
        t0 = seg * T
        parts = []
        for p0 in range(t0, t0 + T, P):  # a part past the sequence's end is empty: (1, 0)
            A, C = one, zero
            for t in range(min(L, p0 + P) - 1, p0 - 1, -1):
                C = a[:, t] * (dy[:, t] + C)
                A = A * a[:, t]
            parts.append((p0, A, C))
        A, C = one, zero
        for _, Ap, Cp in reversed(parts):
            C = Ap * C + Cp
            A = A * Ap
        agg[seg] = (A, C)
        if seg == nseg - 1:
            carry = dh_last
        else:
            Ac, Cc, carry = one, zero, None
            for j in range(seg + 1, nseg):
                if rng.random() < p_inclusive:
                    carry = Ac * out[j] + Cc
                    break
                Cc = Ac * agg[j][1] + Cc
                Ac = Ac * agg[j][0]
            if carry is None:  # composed through the last segment
                carry = Ac * dh_last + Cc
        out[seg] = A * carry + C
        for p0, Ap, Cp in reversed(parts):
            c = carry
            for t in range(min(L, p0 + P) - 1, p0 - 1, -1):
                g = dy[:, t] + c
                dgx[:, t] = g
                dla[:, t] = g * a[:, t] * (y[:, t - 1] if t > 0 else h0)
                c = a[:, t] * g
            if p0 == 0:
                dh0 = c
            carry = Ap * carry + Cp
    return dla, dgx, dh0


# (B, L, dr, T, W): L off the segments (300 / 64, and 300 / 256 as the kernel
# runs it), L shorter than a segment, one step; dr 50, off the kernel's
# 32-channel blocks; T 128 in 8 parts of 16, the kernel's other length
_BWD_SHAPES = [
    (2, 300, 50, 64, 8),
    (2, 300, 50, 256, 8),
    (2, 300, 50, 128, 8),
    (2, 40, 50, 64, 8),
    (1, 1, 50, 64, 8),
    (1, 1, 50, 256, 8),
]


@pytest.mark.parametrize("B,L,dr,T,W", _BWD_SHAPES)
@pytest.mark.parametrize("p_inclusive", [0.0, 0.5, 1.0])
def test_rglru_backward_in_one_pass_matches_autodiff_of_the_reference(B, L, dr, T, W, p_inclusive):
    rng = np.random.default_rng(L * 31 + T + B)
    la = -rng.uniform(0.01, 1.0, (B, L, dr)).astype(np.float32)
    gx = rng.normal(size=(B, L, dr)).astype(np.float32)
    h0 = rng.normal(size=(B, dr)).astype(np.float32)
    dy = rng.normal(size=(B, L, dr)).astype(np.float32)
    dh_last = rng.normal(size=(B, dr)).astype(np.float32)
    (y, _), vjp = jax.vjp(jref.rglru_ref, jnp.asarray(la), jnp.asarray(gx), jnp.asarray(h0))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh_last)))
    got = _segmented_rglru_bwd(la, h0, np.asarray(y), dy, dh_last, T, W, rng, p_inclusive)
    for name, g, w in zip(("dlog_a", "dgx", "dh0"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        err = float(np.max(np.abs(g - w))) / float(np.max(np.abs(w)))
        assert err <= BWD_REL_TOL, (name, err)
