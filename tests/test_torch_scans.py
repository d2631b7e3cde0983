"""The port's two scans held against the JAX reference, on the CPU.

The CUDA kernels (``csrc/rglru_scan.cu``, ``csrc/selective_scan.cu``) run
only on a GPU, where ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
them against the plain versions.  Here the port's wrappers, given CPU
tensors, run those plain versions against the reference on the shapes the
kernels find hardest (bf16 x, widths and lengths off the kernels' tiles),
and a numpy model of the rglru kernel's segmented scan (summaries from a
zero state, the decoupled look-back, the rescan from the incoming state) is
held against the reference's sequential scan, so the algorithm the kernel
implements is checked before a card runs it.  (The kernel's warps split each
segment into parts; the model does the same.)

Tolerances: max-abs 2e-5 in fp32, the reference's parity tolerance
(tests/test_kernels_parity.py:23).  With bf16 x both packages widen x to
fp32 exactly and compute in fp32, so the fp32 tolerance holds there too.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import registry as jreg
from repro_torch.kernels import _build, ops
from repro_torch.kernels import registry as treg
from repro_torch.kernels import selective_scan as tss

torch.set_num_threads(1)

F32_TOL = 2e-5


def _max_err(got, want) -> float:
    return max(float(np.max(np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)))) for g, w in zip(got, want))


def _scan_operands(shape: dict, x_dtype: str, seed: int) -> list:
    """numpy operands of the selective scan (h0 nonzero, so the incoming
    state is exercised); x rounded to ``x_dtype``."""
    rng = np.random.default_rng(seed)
    B, ck, di, N = (shape[k] for k in ("B", "chunk", "di", "N"))
    f32 = np.float32
    return [
        np.asarray(jnp.asarray(rng.normal(size=(B, ck, di)), x_dtype)),
        rng.uniform(0.001, 0.1, (B, ck, di)).astype(f32),
        rng.normal(size=(B, ck, N)).astype(f32), rng.normal(size=(B, ck, N)).astype(f32),
        -rng.uniform(0.5, 2.0, (di, N)).astype(f32), rng.normal(size=(B, di, N)).astype(f32),
    ]


# (shape, x dtype): the registry's tiny tier with bf16 x, and the ragged
# cases chip_smoke.py runs on the card (di 50 is no multiple of the
# kernel's 32 channels or of four floats; di 45 puts bf16 rows on odd 2-byte
# offsets; chunk 100 is no multiple of its 64-step tiles; di 1536 at the
# falcon-mamba chunk and state width)
_SCAN_CASES = [
    ({"B": 1, "chunk": 32, "di": 128, "N": 8}, "bfloat16"),
    ({"B": 2, "chunk": 100, "di": 50, "N": 4}, "float32"),
    ({"B": 2, "chunk": 100, "di": 50, "N": 4}, "bfloat16"),
    ({"B": 1, "chunk": 40, "di": 45, "N": 8}, "bfloat16"),
    ({"B": 1, "chunk": 256, "di": 1536, "N": 16}, "bfloat16"),
]


@pytest.mark.parametrize("shape,x_dtype", _SCAN_CASES, ids=lambda v: v if isinstance(v, str) else "B{B}_chunk{chunk}_di{di}_N{N}".format(**v))
def test_port_selective_scan_matches_reference_off_the_tiles(shape, x_dtype):
    arrays = _scan_operands(shape, x_dtype, seed=11)
    want = jreg.get_kernel("selective_scan").ref(shape, tuple(jnp.asarray(a) for a in arrays))
    targs = treg.from_jax_args("selective_scan", arrays)
    assert targs[0].dtype == getattr(torch, x_dtype)
    got = ops.selective_scan_chunk(*targs)
    assert [g.dtype for g in got] == [torch.float32, torch.float32]
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert _max_err([g.numpy() for g in got], want) <= F32_TOL


def test_port_selective_scan_bf16_x_matches_reference_pallas_kernel():
    """bf16 x through the reference's own Pallas kernel (interpret mode), the
    registry's bf16 operands."""
    shape = dict(jreg.get_kernel("selective_scan").tiny_shape)
    jdef, tdef = jreg.get_kernel("selective_scan"), treg.get_kernel("selective_scan")
    jargs = jdef.make_args(shape, "bfloat16", 4)
    assert jargs[0].dtype == jnp.bfloat16
    kernel = jdef.call(shape, jargs, jdef.defaults(shape), True)
    got = tdef.call(shape, treg.from_jax_args("selective_scan", [np.asarray(a) for a in jargs]), tdef.defaults(shape))
    assert _max_err([g.numpy() for g in got], kernel) <= F32_TOL


def test_port_rglru_matches_reference_off_the_tiles():
    """L 300 is no multiple of the kernel's 256-step segments or 32-step
    parts, dr 50 of its 32 channels or of four floats."""
    rng = np.random.default_rng(12)
    B, L, dr = 2, 300, 50
    la = -rng.uniform(0.01, 1.0, (B, L, dr)).astype(np.float32)
    gx = rng.normal(size=(B, L, dr)).astype(np.float32)
    h0 = rng.normal(size=(B, dr)).astype(np.float32)
    want = jref.rglru_ref(jnp.asarray(la), jnp.asarray(gx), jnp.asarray(h0))
    got = ops.rglru_scan(*treg.from_jax_args("rglru_scan", [la, gx, h0]))
    assert _max_err([g.numpy() for g in got], want) <= F32_TOL


def test_kernels_refuse_operands_off_16_byte_boundaries():
    """The scans copy rows by 16-byte chunks from each operand's first
    boundary on (TMA needs the same), so the launchers check it."""
    _build.check_aligned("rglru_scan", torch.zeros(8), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="16-byte"):
        _build.check_aligned("rglru_scan", torch.zeros(8), torch.zeros(9)[1:])


def test_selective_scan_kernel_states_its_limit_on_n():
    shape = {"B": 1, "chunk": 4, "di": 8, "N": tss.MAX_N + 1}
    args = treg.get_kernel("selective_scan").make_args(shape, "float32", 0, "cpu")
    with pytest.raises(ValueError, match=f"limit"):
        tss.selective_scan_chunk(*args)
    assert tss.MAX_N >= 64


# ---------------------------------------------------------------------------
# the rglru kernel's algorithm, in numpy
# ---------------------------------------------------------------------------


def _segmented_rglru(la, gx, h0, T, W, rng, p_inclusive):
    """What ``csrc/rglru_scan.cu`` computes, segment by segment: the W warps
    of a segment's block each take a summary of their part (T / W steps)
    from a zero state (the product A of its a's, its end state H), composed
    into the segment's summary; the look-back composes the summaries of the
    segments before it, h -> A h + H, until it meets one whose end state is
    published (each is, with probability ``p_inclusive``, as the race
    between blocks may have it) or the sequence's start (h0); each part is
    walked again from its own starting state.  fp32 throughout."""
    B, L, dr = la.shape
    a = np.exp(la)
    P = T // W
    one, zero = np.ones((B, dr), np.float32), np.zeros((B, dr), np.float32)
    agg, incl = [], []
    y = np.empty_like(gx)
    for t0 in range(0, L, T):
        parts = []
        for p0 in range(t0, t0 + T, P):  # a part past the sequence's end is empty: (1, 0)
            A, H = one, zero
            for t in range(p0, min(L, p0 + P)):
                H = a[:, t] * H + gx[:, t]
                A = A * a[:, t]
            parts.append((p0, A, H))
        A, H = one, zero
        for _, Ap, Hp in parts:
            H = Ap * H + Hp
            A = A * Ap
        agg.append((A, H))
        Ac, Hc, h = one, zero, None
        for j in range(len(incl) - 1, -1, -1):
            if rng.random() < p_inclusive:
                h = Ac * incl[j] + Hc
                break
            Hc = Ac * agg[j][1] + Hc
            Ac = Ac * agg[j][0]
        if h is None:
            h = Ac * h0 + Hc
        incl.append(A * h + H)
        for p0, Ap, Hp in parts:
            hp = h
            for t in range(p0, min(L, p0 + P)):
                hp = a[:, t] * hp + gx[:, t]
                y[:, t] = hp
            h = Ap * h + Hp
    return y, hp


# (L, T, W): the kernel's own segment (256 steps in 8 parts of 32), L not a
# multiple of it (the last segment's last parts empty), and smaller shapes
# whose segments are many
@pytest.mark.parametrize("L,T,W", [(600, 256, 8), (300, 256, 8), (130, 16, 4), (97, 7, 1)])
@pytest.mark.parametrize("p_inclusive", [0.0, 0.5, 1.0])
def test_rglru_segmented_scan_matches_reference(L, T, W, p_inclusive):
    rng = np.random.default_rng(L * 31 + T)
    B, dr = 2, 24
    la = -rng.uniform(0.01, 1.0, (B, L, dr)).astype(np.float32)
    gx = rng.normal(size=(B, L, dr)).astype(np.float32)
    h0 = rng.normal(size=(B, dr)).astype(np.float32)
    got = _segmented_rglru(la, gx, h0, T, W, rng, p_inclusive)
    want = jref.rglru_ref(jnp.asarray(la), jnp.asarray(gx), jnp.asarray(h0))
    assert _max_err(got, want) <= F32_TOL
