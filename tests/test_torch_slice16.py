"""The arithmetic of the GEMM's split contraction held against the JAX reference, on the CPU.

The kernels run only on a GPU (``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold them against the plain versions there).  Here numpy models of what they
compute are held against the reference:

* the ``tf32x3`` gradients with the contraction split over a thread-block
  cluster (``csrc/gmm.cuh``, ``gmm_tf32x3<.., true>``, ``sum_parts``): the
  32-deep stages cut into P parts of consecutive stages; each part walks its
  stages in order, each stage three TF32 products a term (the small ones
  first, into a fresh fp32 sum, then the large ones) added to the part's
  running sum; the parts' sums then added in part order, fp32 adds that
  round to nearest.  dx and dw at the small shapes where the kernel splits,
  at P = 1, 2, 4 and 8, against ``jax.vjp`` of the reference's expert
  einsum, and the same sums of the forward's product against ``moe_gmm``
  run in interpret mode, within the reference's fp32 tolerance (max-abs
  2e-5, tests/test_kernels_parity.py:23), at the registry's tiers too;
* the ``mma`` route's arithmetic (``gmm_mma``, ``stage_tf32x3``): the same
  three products a term, a k8 step of mma.sync at a time, in the same stage
  order, at the shapes whose strides TMA cannot describe (F 50, F 100, D 95
  F 49), each product cut into the parts its rule gives;
* the host's rule (``split_of`` in ``csrc/gmm.cuh``, mirrored here by
  ``plan``; the card's own launches are held to the rule's properties by
  ``chip_smoke.py`` and ``tests/test_torch_cuda.py``): one part at
  grok-1's and arctic-480b's widths, where the tiles fill the card, and no
  small grid left on one part while it has two stages to share;
* the route rule: every GEMM whose D or F rows are not a multiple of 16
  bytes goes to ``mma``.

As scripts they print the measured errors.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import registry as treg

F32_TOL = 2e-5
BK = 32  # a stage's depth
# the clusters of P blocks an H100 (132 SMs, NVIDIA H100 80GB HBM3 at 700
# W) holds at once, P = 0 .. 8, by the occupancy calculator
# (chip_smoke.py's ``occupancy moe_gmm`` lines): a split launch asks for
# half an SM's shared memory and more, one block an SM, so clusters of P
# blocks are placed on P SMs of a GPC; P = 1, the one-block kernels at two
# blocks an SM (tf32x3's gradients, the mma route's fp32 kernels)
RESIDENT = {
    "tf32x3": [0, 264, 66, 39, 30, 22, 17, 15, 15],
    "mma": [0, 264, 66, 39, 30, 22, 17, 15, 15],
}


# ---------------------------------------------------------------------------
# the rule's mirror (csrc/gmm.cuh: split_of, MIN_SAVED, min_saved, the tiles)
# ---------------------------------------------------------------------------

MAX_PARTS = 8
# each route's block tile (rows and columns of the product as its kernel
# computes it) and stage depth; tf32x3 computes out^T, so its rows are out's
# columns
TILES = {"mma": (64, 64, 32), "tf32x3": (64, 128, 32)}


def min_saved(route: str, dtype) -> int:
    """The fewest stages a split must take off a walk on ``route``
    (``tf32x3::MIN_SAVED``, ``mma::min_saved``)."""
    if route == "tf32x3":
        return 3
    return 1 if dtype == torch.float32 else 2


def split_of(tiles: int, n_k: int, resident, saved: int) -> tuple[int, int]:
    """(P, stages a part): the largest P, at most MAX_PARTS and ``n_k``,
    whose ``tiles`` clusters of P blocks are all resident at once
    (``resident[P]``) and which takes ``saved`` stages or more off a
    block's walk, else 1; then as many parts as it takes ceil(n_k / P)
    stages a part to cover the walk.  (1, 0) for an empty walk."""
    want = 1
    for p in range(min(n_k, MAX_PARTS), 1, -1):
        if tiles <= resident[p] and n_k - -(-n_k // p) >= saved:
            want = p
            break
    if n_k < 1:
        return 1, 0
    spp = -(-n_k // want)
    return -(-n_k // spp), spp


def plan(route: str, product: str, E: int, C: int, D: int, F: int, resident, dtype=torch.float32) -> dict:
    """How ``csrc/gmm.cuh`` cuts one product (``"forward"``, ``"dx"``,
    ``"dw"``) on ``route``: ``tiles``, ``stages`` and ``parts`` of
    ``stages_per_part``.  ``mma`` computes out itself (y C x F, dx C x D,
    dw D x F), ``tf32x3`` its transpose, and its forward never splits."""
    bm, bn, bk = TILES[route]
    M, N, K = {"forward": (C, F, D), "dx": (C, D, F), "dw": (D, F, C)}[product]
    if route == "tf32x3":
        M, N = N, M
    tiles, n_k = -(-M // bm) * -(-N // bn) * E, -(-K // bk)
    if (route, product) == ("tf32x3", "forward"):
        return {"tiles": tiles, "stages": n_k, "parts": 1, "stages_per_part": n_k}
    parts, spp = split_of(tiles, n_k, resident, min_saved(route, dtype))
    return {"tiles": tiles, "stages": n_k, "parts": parts, "stages_per_part": spp}


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32, to nearest, ties away from zero (cvt.rna)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v: np.ndarray):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def stage_sum(ah, al, bh, bl, k0: int, K: int) -> np.ndarray:
    """One 32-deep stage from depth k0: its small products (a_lo b_hi, a_hi
    b_lo) of each k8 step first, then the large ones (a_hi b_hi), into a
    fresh fp32 sum.  a (E, M, K), b (E, K, N), split into hi and lo."""
    steps = range(k0, min(K, k0 + BK), 8)
    terms = [(k, aa, bb) for k in steps for aa, bb in ((al, bh), (ah, bl))] + [(k, ah, bh) for k in steps]
    part = np.zeros((ah.shape[0], ah.shape[1], bh.shape[2]), np.float32)
    for k, aa, bb in terms:
        part += np.einsum("emk,ekn->emn", aa[:, :, k:k + 8], bb[:, k:k + 8], dtype=np.float32)
    return part


def split_product(a: np.ndarray, b: np.ndarray, parts: int) -> np.ndarray:
    """out = a @ b per expert as the split kernels sum it: the stages cut
    into ``parts`` runs of ceil(stages / parts) (the last may hold fewer),
    each run's stage sums added in order to its own running sum from zero,
    then the runs' sums added in part order."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    K = a.shape[2]
    n_k = -(-K // BK)
    spp = -(-n_k // parts)
    total = None
    for kb0 in range(0, n_k, spp):
        run = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
        for kb in range(kb0, min(n_k, kb0 + spp)):
            run += stage_sum(ah, al, bh, bl, kb * BK, K)
        total = run if total is None else total + run  # fp32, round to nearest, in part order
    return total


def gradients(x, w, dy, parts_dx: int, parts_dw: int):
    """dx = dy_x @ w^T (contracting F) and dw = x^T @ dy_w (contracting C),
    each split as its kernel splits it; ``dy`` = (dy_x, dy_w)."""
    dx = split_product(dy[0], np.swapaxes(w, 1, 2), parts_dx)
    dw = split_product(np.swapaxes(x, 1, 2), dy[1], parts_dw)
    return dx, dw


def operands(shape: dict, seed: int):
    """x, w (scaled by D^-1/2, so that y is of unit scale) and two output
    gradients: dy_x for dx and dy_w = dy_x C^-1/2 for dw, so that each
    gradient is of unit scale and the max-abs tolerance means what it means
    at the tiers (dw summed over C unit terms grows as C^1/2: ~45 at its
    largest at C96)."""
    rng = np.random.default_rng(seed)
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    return x, w, (dy, (dy / np.sqrt(C)).astype(np.float32))


def reference_gradients(x, w, dy):
    """dx and dw by jax.vjp of the reference's expert einsum
    (``ref.moe_gmm_ref``), dx from dy_x and dw from dy_w."""
    _, vjp = jax.vjp(jref.moe_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    return np.asarray(vjp(jnp.asarray(dy[0]))[0]), np.asarray(vjp(jnp.asarray(dy[1]))[1])


def max_abs(got, want) -> float:
    return float(np.max(np.abs(got - np.asarray(want, np.float32))))


# the small shapes where the tf32x3 gradients lose to torch.bmm (PERF.md):
# C16 (dx^T 16 tiles of 16 stages), E4 C64 D128 F256, C65 / C96 / C200, and
# the reduced grok-1 step's up and down products
SMALL_SHAPES = {
    "c16": {"E": 4, "C": 16, "D": 256, "F": 512},
    "sweep": {"E": 4, "C": 64, "D": 128, "F": 256},
    "c65": {"E": 5, "C": 65, "D": 256, "F": 384},
    "c96": {"E": 5, "C": 96, "D": 256, "F": 384},
    "c200": {"E": 3, "C": 200, "D": 256, "F": 256},
    "grok_1_reduced_up": {"E": 4, "C": 32, "D": 64, "F": 128},
    "grok_1_reduced_down": {"E": 4, "C": 32, "D": 128, "F": 64},
}
PARTS = [1, 2, 4, 8]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", list(SMALL_SHAPES))
def test_split_tf32x3_gradients_match_jax_vjp(name, parts):
    x, w, dy = operands(SMALL_SHAPES[name], seed=16)
    want = reference_gradients(x, w, dy)
    got = gradients(x, w, dy, parts, parts)
    errs = [max_abs(g, r) for g, r in zip(got, want)]
    assert max(errs) <= F32_TOL, errs


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ["tiny", "smoke", "full", "c16", "sweep", "grok_1_reduced_up", "grok_1_reduced_down"])
def test_split_tf32x3_sums_match_moe_gmm_in_interpret_mode(name, parts):
    """The forward's product summed as the split gradients sum theirs, at
    the registry's tiers (at the full tier one accumulator for all twelve
    products of a stage missed the tolerance: gmm.cuh) and the small
    shapes whose blocks the reference's rule divides, against the Pallas
    kernel in interpret mode."""
    kdef = treg.get_kernel("moe_gmm")
    shape = dict(getattr(kdef, f"{name}_shape")) if name in ("tiny", "smoke", "full") else SMALL_SHAPES[name]
    x, w, _ = operands(shape, seed=17)
    want = np.asarray(jops.moe_gmm(jnp.asarray(x), jnp.asarray(w)))
    err = max_abs(split_product(x, w, parts), want)
    assert err <= F32_TOL, err


def test_part_order_is_the_only_order():
    """Two parts' sums added in part order give the kernel's bits, every
    time; the stages summed as one run (P = 1) may differ in the last bits
    but not past the tolerance."""
    x, w, dy = operands(SMALL_SHAPES["c16"], seed=18)
    a, b = split_product(dy[0], np.swapaxes(w, 1, 2), 8), split_product(dy[0], np.swapaxes(w, 1, 2), 8)
    one = split_product(dy[0], np.swapaxes(w, 1, 2), 1)
    assert np.array_equal(a, b)
    assert max_abs(a, one) <= F32_TOL


# the mma route's shapes: D or F rows not a multiple of 16 bytes (in fp32:
# F 50 and D 95 F 49; F 100 is mma in bf16 only, tf32x3 in fp32)
MMA_SHAPES = {
    "ragged_f50": {"E": 3, "C": 80, "D": 96, "F": 50},
    "odd_d95_f49": {"E": 3, "C": 80, "D": 95, "F": 49},
    "ragged_d50": {"E": 3, "C": 80, "D": 50, "F": 96},
}


@pytest.mark.parametrize("name", list(MMA_SHAPES))
def test_mma_route_three_tf32_products_match_the_reference(name):
    """The mma route's fp32 arithmetic (three TF32 m16n8k8 products a term
    in tf32x3's stage order) with each product cut into the parts its rule
    gives: the forward against moe_gmm in interpret mode, dx and dw against
    jax.vjp."""
    shape = MMA_SHAPES[name]
    assert tgmm.route(torch.float32, shape) == "mma"
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    p = {prod: plan("mma", prod, E, C, D, F, RESIDENT["mma"])["parts"] for prod in ("forward", "dx", "dw")}
    assert all(n > 1 for n in p.values()), p  # fp32: a stage saved pays, so every product here is split
    x, w, dy = operands(shape, seed=19)
    y = np.asarray(jops.moe_gmm(jnp.asarray(x), jnp.asarray(w)))
    errs = [max_abs(split_product(x, w, p["forward"]), y)]
    errs += [max_abs(g, r) for g, r in zip(gradients(x, w, dy, p["dx"], p["dw"]), reference_gradients(x, w, dy))]
    assert max(errs) <= F32_TOL, errs


# ---------------------------------------------------------------------------
# the host's rule
# ---------------------------------------------------------------------------

WIDTHS = {
    "grok_1_314b": {"E": 8, "C": 1280, "D": 6144, "F": 32768},
    "arctic_480b": {"E": 128, "C": 80, "D": 7168, "F": 4864},
}


@pytest.mark.parametrize("route", ["tf32x3", "mma"])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_model_widths_take_one_part(name, route):
    s = WIDTHS[name]
    for product in ("forward", "dx", "dw"):
        got = plan(route, product, s["E"], s["C"], s["D"], s["F"], RESIDENT[route])
        assert got["parts"] == 1 and got["stages_per_part"] == got["stages"], (product, got)


# the parts the rule gives each tf32x3 gradient of the small shapes on an
# H100: (dx, dw), the best of P = 1 to 8 timed at each (PERF.md)
RULE_TF32X3 = {
    "c16": (6, 1),  # dx^T: 16 tiles of 16 stages; 16 clusters of 8 or 7 are not resident at once: 6 parts of 3
    "sweep": (8, 1),  # dx 8 tiles of 8 stages; dw 2 stages: one saved does not pay
    "c65": (4, 1),  # dx 20 tiles of 12 stages: 5 wanted, 4 parts of 3; dw 3 stages: two saved do not pay
    "c96": (4, 1),
    "c200": (4, 4),  # dx 24 tiles of 8 stages, dw 24 tiles of 7: 4 parts of 2
    "grok_1_reduced_up": (4, 1),  # dx 4 tiles of 4 stages
    "grok_1_reduced_down": (1, 1),  # dx 2 stages
}


@pytest.mark.parametrize("name", list(RULE_TF32X3))
def test_no_small_grid_is_left_unsplit(name):
    """The rule on an H100's residency: each gradient's parts as listed;
    at most 8 parts, each at least one stage, every cluster resident at
    once, and a split only where it takes 3 stages or more off a block's
    walk; the forward keeps its one-block path."""
    s = SMALL_SHAPES[name]
    for product, want in zip(("dx", "dw"), RULE_TF32X3[name]):
        got = plan("tf32x3", product, s["E"], s["C"], s["D"], s["F"], RESIDENT["tf32x3"])
        parts, spp, n_k = got["parts"], got["stages_per_part"], got["stages"]
        assert parts == want, (product, got)
        assert (parts - 1) * spp < n_k <= parts * spp  # every part holds a stage
        assert parts == 1 or (got["tiles"] <= RESIDENT["tf32x3"][parts] and n_k - spp >= min_saved("tf32x3", torch.float32))
    assert plan("tf32x3", "forward", s["E"], s["C"], s["D"], s["F"], RESIDENT["tf32x3"])["parts"] == 1


@pytest.mark.parametrize("tiles,n_k,saved,want", [
    (16, 16, 3, (6, 3)),  # c16's dx: 16 clusters of 8 or 7 are not resident at once
    (4, 4, 3, (4, 1)),    # the reduced grok-1 up product's dx
    (8, 2, 3, (1, 2)),    # ... and the down product's: one stage saved does not pay
    (30, 3, 3, (1, 3)),   # c65's dw: two stages saved do not pay
    (6, 3, 1, (3, 1)),    # ... on the fp32 mma route they do (E3 C80 D96 F50's forward)
    (12, 2, 2, (1, 2)),   # the bf16 mma route's dx there: one stage saved does not pay
    (20, 12, 3, (4, 3)),  # 5 wanted, 4 parts of 3 cover 12 stages
    (31, 16, 3, (3, 6)),  # 31 clusters of 4 are not resident at once, of 3 are
    (240, 16, 3, (1, 16)),  # more tiles than clusters of 2
    (7680, 1024, 3, (1, 1024)),  # grok-1's dx
    (3, 1, 1, (1, 1)),    # one stage: nothing to share
    (3, 0, 1, (1, 0)),    # an empty walk
    (15, 16, 3, (8, 2)),  # 15 clusters of 8 are resident at once: 8 parts of 2
])
def test_split_of_matches_the_host_rule(tiles, n_k, saved, want):
    assert split_of(tiles, n_k, RESIDENT["tf32x3"], saved) == want


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_odd_strides_take_the_mma_route(dtype):
    dt = getattr(torch, dtype)
    assert tgmm.route(dt, {"D": 95, "F": 49}) == "mma"
    assert tgmm.route(dt, {"D": 96, "F": 50}) == "mma"
    assert tgmm.route(dt, {"D": 128, "F": 256}) == ("wgmma" if dtype == "bfloat16" else "tf32x3")
    assert "simt" not in tgmm.ROUTES and tgmm.ROUTES["mma"] == 0  # the C entry points' route 0


if __name__ == "__main__":
    for name, shape in SMALL_SHAPES.items():
        x, w, dy = operands(shape, seed=16)
        want = reference_gradients(x, w, dy)
        for parts in PARTS:
            errs = [max_abs(g, r) for g, r in zip(gradients(x, w, dy, parts, parts), want)]
            print(f"tf32x3 split {name} P={parts}: dx {errs[0]:.3e} dw {errs[1]:.3e} (tolerance {F32_TOL})")
    for name, shape in MMA_SHAPES.items():
        E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
        p = {prod: plan("mma", prod, E, C, D, F, RESIDENT["mma"])["parts"] for prod in ("forward", "dx", "dw")}
        x, w, dy = operands(shape, seed=19)
        y = np.asarray(jops.moe_gmm(jnp.asarray(x), jnp.asarray(w)))
        errs = [max_abs(split_product(x, w, p["forward"]), y)]
        errs += [max_abs(g, r) for g, r in zip(gradients(x, w, dy, p["dx"], p["dw"]), reference_gradients(x, w, dy))]
        print(f"mma {name} parts {p}: forward {errs[0]:.3e} dx {errs[1]:.3e} dw {errs[2]:.3e}")
