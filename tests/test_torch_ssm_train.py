"""The ssm family's training on the port, held against the JAX reference on the CPU.

The selective scan's backward kernel (``csrc/selective_scan_bwd.cu``) runs
only on a GPU, where ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
it against its plain version.  Here:

  * the plain version (``ref.selective_scan_chunk_bwd_ref``), chained over
    chunks, and a plain mirror of the kernel's split of a chunk in time
    (``split_in_time_backward``: each part's chains from zero, their fold,
    then the plain version on each part, a later part's segments from the
    starts the kernel rebuilds), against ``jax.vjp`` of the
    reference's chunked scan
    (``repro.models.ssm.selective_scan_chunked``, both XLA lowerings: the
    reference's Pallas kernel has no VJP, and ``tests/test_torch_scans.py``
    holds the forward of both against it), and against torch's autograd of
    the plain forward;
  * the autograd Function that carries the kernel on the card
    (``ops._SelectiveScanChunk``), with its launchers replaced by their
    plain versions (no CUDA kernel can run here) and ``ops`` routing as on
    the card: its gradients, its backward launches, a zero ``dh_last``;
  * falcon-mamba-7b's reduced loss, gradients and three AdamW steps through
    that Function against the reference's, and ``remat="dots"`` replaying
    each chunk's forward before its backward.

Tolerances: the gradients within 1e-5 of the largest element of the
reference's (``GRAD_REL``; dx with bf16 x within 1e-2, one bf16 rounding);
the model's loss, gradient leaves and train steps as
``tests/test_torch_train.py`` holds every family (1e-5, 1e-4, 1e-4).  Run
as a script it prints the measured errors:

    PYTHONPATH=src python tests/test_torch_ssm_train.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as tss
from repro_torch.models.model import Model
from test_torch_train import GRAD_REL, LEAF_TOL, REMAT_TOL, _batch, _loss_grads, _rel, compare_loss_and_grads, compare_train_steps

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
BF16_DX_TOL = 1e-2  # one bf16 rounding of dx, relative to its largest element
GRADS = ("dx", "ddt", "db", "dc", "da", "dh0")


def _operands(B, L, di, N, seed, x_dtype=np.float32) -> dict:
    """numpy operands of a scan over L steps: dt in softplus's range, a_log
    as the reference initialises it (log 1 .. N), a nonzero h0, and the
    cotangents dy and dh_last."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "x": np.asarray(jnp.asarray(rng.normal(size=(B, L, di)), x_dtype)),
        "dt": rng.uniform(0.001, 0.1, (B, L, di)).astype(f32),
        "b": rng.normal(size=(B, L, N)).astype(f32),
        "c": rng.normal(size=(B, L, N)).astype(f32),
        "a_log": np.log(rng.uniform(1.0, N, (di, N))).astype(f32),
        "h0": rng.normal(size=(B, di, N)).astype(f32),
        "dy": rng.normal(size=(B, L, di)).astype(f32),
        "dh": rng.normal(size=(B, di, N)).astype(f32),
    }


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


def chained_plain_backward(x, dt, b, c, a, h0, dy, dh_last, ck, backward=ref.selective_scan_chunk_bwd_ref):
    """The plain backward (or ``backward``, a function of the same
    operands) chained over the chunks of ``ck`` steps, as autograd chains
    ``ops._SelectiveScanChunk`` in ``models/ssm.selective_scan_chunked``:
    each chunk's dh0 is the previous chunk's dh_last and dA sums over the
    chunks.  Returns the six gradients over the whole sequence (dx, ddt, db,
    dc, da, dh0)."""
    n = x.shape[1] // ck
    part = lambda t, i: t[:, i * ck:(i + 1) * ck].contiguous()
    starts = [h0]
    for i in range(n - 1):
        starts.append(ref.selective_scan_chunk_ref(part(x, i), part(dt, i), part(b, i), part(c, i), a, starts[-1])[1])
    grads, g, da = [None] * n, dh_last, torch.zeros_like(a)
    for i in range(n - 1, -1, -1):
        *grads[i], da_i, g = backward(part(x, i), part(dt, i), part(b, i), part(c, i), a, starts[i], part(dy, i), g)
        da = da + da_i
    return tuple(torch.cat([grads[i][k] for i in range(n)], dim=1) for k in range(4)) + (da, g)


def compare_with_jax_vjp(mode: str, B: int, L: int, ck: int, di: int, N: int, x_dtype=np.float32,
                         backward=ref.selective_scan_chunk_bwd_ref) -> dict:
    """The chained plain backward (or ``backward``) against ``jax.vjp`` of
    the reference's ``selective_scan_chunked`` under ``ssm_scan=mode``, with
    cotangents on y and h_last; the gradient of a_log through a =
    -exp(a_log)."""
    o = _operands(B, L, di, N, seed=3, x_dtype=x_dtype)
    cfg = dataclasses.replace(jget_arch(ARCH).reduced(), ssm_chunk=ck, ssm_scan=mode)

    def scan(a_log, x, dt, b, c, h0):
        return jssm.selective_scan_chunked(cfg, {"a_log": a_log}, x, dt, b, c, h0)

    _, vjp = jax.vjp(scan, *(jnp.asarray(o[k]) for k in ("a_log", "x", "dt", "b", "c", "h0")))
    d_a_log, dx, ddt, db, dc, dh0 = vjp((jnp.asarray(o["dy"]), jnp.asarray(o["dh"])))
    want = {"dx": dx, "ddt": ddt, "db": db, "dc": dc, "d_a_log": d_a_log, "dh0": dh0}
    a = -torch.exp(_t(o["a_log"]))
    got = chained_plain_backward(*(_t(o[k]) for k in ("x", "dt", "b", "c")), a, _t(o["h0"]), _t(o["dy"]), _t(o["dh"]), ck,
                                 backward)
    got = dict(zip(("dx", "ddt", "db", "dc", "d_a_log", "dh0"), got[:4] + (got[4] * a, got[5])))  # d a / d a_log = a
    return {k: _rel(got[k], want[k]) for k in want}


# (B, L, chunk, di, N): two and three chunks; N 4 (no padding in the
# kernel) and 5 (padded to 8); di off the kernel's 32-channel blocks
_VJP_CASES = [(2, 24, 8, 16, 4), (2, 80, 40, 45, 5)]


@pytest.mark.parametrize("mode", ["assoc", "seq"])
@pytest.mark.parametrize("case", _VJP_CASES, ids=lambda c: "B{}_L{}_ck{}_di{}_N{}".format(*c))
def test_plain_backward_matches_jax_vjp_of_the_reference_scan(mode, case):
    errs = compare_with_jax_vjp(mode, *case)
    assert max(errs.values()) <= GRAD_REL, errs


def compare_with_torch_autograd(x_dtype) -> dict:
    """The plain backward against torch's autograd of the plain forward on
    one chunk, every operand requiring grad, a nonzero dh_last."""
    o = _operands(2, 37, 24, 5, seed=4, x_dtype=x_dtype)
    a = -torch.exp(_t(o["a_log"]))
    ins = [_t(o[k]) for k in ("x", "dt", "b", "c")] + [a, _t(o["h0"])]
    leaves = [t.clone().requires_grad_() for t in ins]
    y, h_last = ref.selective_scan_chunk_ref(*leaves)
    want = torch.autograd.grad((y, h_last), leaves, (_t(o["dy"]), _t(o["dh"])))
    got = ref.selective_scan_chunk_bwd_ref(*ins, _t(o["dy"]), _t(o["dh"]))
    assert [g.dtype for g in got] == [w.dtype for w in want] and [g.shape for g in got] == [w.shape for w in want]
    return {k: _rel(g, w) for k, g, w in zip(GRADS, got, want)}


@pytest.mark.parametrize("x_dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16x"])
def test_plain_backward_matches_autograd_of_the_plain_forward(x_dtype):
    errs = compare_with_torch_autograd(x_dtype)
    tol = {k: GRAD_REL for k in GRADS}
    if x_dtype == jnp.bfloat16:
        tol["dx"] = BF16_DX_TOL
    assert all(errs[k] <= tol[k] for k in GRADS), errs


def test_chained_chunks_backward_equals_one_chunk_of_twice_the_length():
    """Two chunks chained through h (dh0 of the second as dh_last of the
    first) give the one chunk's gradients bit for bit, but dA, which the
    chain sums in another order (within fp32 rounding)."""
    o = _operands(2, 32, 24, 4, seed=5)
    a = -torch.exp(_t(o["a_log"]))
    args = [_t(o[k]) for k in ("x", "dt", "b", "c")]
    one = ref.selective_scan_chunk_bwd_ref(*args, a, _t(o["h0"]), _t(o["dy"]), _t(o["dh"]))
    two = chained_plain_backward(*args, a, _t(o["h0"]), _t(o["dy"]), _t(o["dh"]), 16)
    for k, g1, g2 in zip(GRADS, one, two):
        if k == "da":
            assert _rel(g2, g1) <= 1e-6
        else:
            assert torch.equal(g1, g2), k


SEG = 8  # steps of the kernel's segments at N <= 16 (csrc/selective_scan_bwd.cu: seg_of)


def split_plan(chunk: int, parts: int, seg: int = SEG) -> list[tuple[int, int]]:
    """The steps [lo, hi) of each part, cut as the kernel cuts a chunk
    (``plan_of``): whole segments of ``seg`` steps, ceil(segments / parts) a
    part, so the last part may hold fewer and a shorter segment."""
    nseg = -(-chunk // seg)
    spp = -(-nseg // min(parts, nseg))
    return [(lo, min(chunk, lo + spp * seg)) for lo in range(0, chunk, spp * seg)]


def split_in_time_backward(x, dt, b, c, a, h0, dy, dh_last, parts: int):
    """A plain mirror of the kernel's split of one chunk in time.  Pass A:
    each part p from zero (part 0 from h0) gives F_p, its states at its end,
    D_p, the running product of its e_t, and L_p, the dy_t C_t weighted by
    that product (its gradient at its start), and keeps F and the running
    sum of dt at each of its segments' starts; the fold: H_1 = F_0, H_{p+1}
    = D_p H_p + F_p, G_{P-1} = dh_last, G_{p-1} = D_p G_p + L_p, in the
    order of the parts; then pass B: part 0 the plain backward from (H_0,
    G_0) (its segment starts are the forward's states), every later part
    the plain backward on each segment from the last, carrying the gradient,
    from the start the kernel rebuilds: H_p at the part's first segment,
    else F + exp(A sum dt) H_p.  dA summed over the segments and parts in
    that order, dh0 part 0's.  Returns the six gradients as the plain
    backward does."""
    bounds = split_plan(x.shape[1], parts)
    a = a.float()
    xf, dtf, bf, cf, dyf = x.float(), dt.float(), b.float(), c.float(), dy.float()
    F, L, D, starts = [], [], [], []
    for p, (lo, hi) in enumerate(bounds):
        f = h0.float() if p == 0 else torch.zeros_like(h0)
        l, d, sdt = torch.zeros_like(h0), torch.ones_like(h0), torch.zeros_like(dtf[:, 0])
        starts.append({})  # a segment's first step -> (F, the dt sum) there
        for t in range(lo, hi):
            if (t - lo) % SEG == 0:
                starts[p][t] = (f, sdt)
            e = torch.exp(dtf[:, t, :, None] * a[None])
            f = e * f + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
            d = d * e
            l = l + d * (dyf[:, t, :, None] * cf[:, t, None, :])
            sdt = sdt + dtf[:, t]
        F.append(f), L.append(l), D.append(d)
    P = len(bounds)
    H = [h0.float()] + [F[0]] * (P > 1)
    for p in range(1, P - 1):
        H.append(D[p] * H[p] + F[p])
    G = [dh_last.float()]
    for p in range(P - 1, 0, -1):
        G.insert(0, D[p] * G[0] + L[p])
    part = lambda t, lo, hi: t[:, lo:hi].contiguous()
    plain = lambda lo, hi, start, g: ref.selective_scan_chunk_bwd_ref(
        *(part(t, lo, hi) for t in (x, dt, b, c)), a, start, part(dy, lo, hi), g)
    grads = [plain(*bounds[0], H[0], G[0])]
    for p, (lo, hi) in list(enumerate(bounds))[1:]:
        segs, g = [], G[p]
        for t0 in sorted(starts[p], reverse=True):
            f, sdt = starts[p][t0]
            start = H[p] if t0 == lo else f + torch.exp(a[None] * sdt[..., None]) * H[p]
            segs.insert(0, plain(t0, min(hi, t0 + SEG), start, g))
            g = segs[0][5]
        da = segs[-1][4]
        for sg in reversed(segs[:-1]):
            da = da + sg[4]
        grads.append(tuple(torch.cat([sg[k] for sg in segs], dim=1) for k in range(4)) + (da, g))
    da = grads[0][4]
    for g in grads[1:]:
        da = da + g[4]
    return tuple(torch.cat([g[k] for g in grads], dim=1) for k in range(4)) + (da, grads[0][5])


# parts asked for -> a chunk the kernel cuts into that many: 37 steps are 5
# segments (the last of 5 steps), so parts of 3 + 2, 2 + 2 + 1 and 1 each;
# 123 steps are 16 segments in 8 parts of 2, the last segment of 3 steps
_SPLIT_CHUNKS = {1: 37, 2: 37, 3: 37, 5: 37, 8: 123}


@pytest.mark.parametrize("x_dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16x"])
@pytest.mark.parametrize("parts", sorted(_SPLIT_CHUNKS))
def test_split_in_time_backward_matches_the_plain_backward_and_jax_vjp(parts, x_dtype):
    """The kernel's decomposition of a chunk in time, in plain PyTorch: at
    one part bit-equal to the plain backward; at 2 to 8 parts (ragged last
    parts) within 1e-5 of its largest element (dx with bf16 x within one
    bf16 rounding, BF16_DX_TOL), and within GRAD_REL of ``jax.vjp`` of the
    reference's scan over the one chunk."""
    chunk = _SPLIT_CHUNKS[parts]
    assert len(split_plan(chunk, parts)) == parts
    o = _operands(2, chunk, 24, 5, seed=8, x_dtype=x_dtype)
    a = -torch.exp(_t(o["a_log"]))
    args = [_t(o[k]) for k in ("x", "dt", "b", "c")] + [a, _t(o["h0"]), _t(o["dy"]), _t(o["dh"])]
    got = split_in_time_backward(*args, parts)
    want = ref.selective_scan_chunk_bwd_ref(*args)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    if parts == 1:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    tol = {k: GRAD_REL for k in GRADS}
    if x_dtype == jnp.bfloat16:
        tol["dx"] = BF16_DX_TOL
    errs = {k: _rel(g, w) for k, g, w in zip(GRADS, got, want)}
    assert all(errs[k] <= tol[k] for k in GRADS), errs
    split = lambda *ops_: split_in_time_backward(*ops_, parts)
    errs = compare_with_jax_vjp("seq", 2, chunk, chunk, 24, 5, x_dtype, backward=split)
    tol = {k: GRAD_REL for k in errs}
    if x_dtype == jnp.bfloat16:
        tol["dx"] = BF16_DX_TOL
    assert all(errs[k] <= tol[k] for k in errs), errs


@pytest.fixture
def routed_as_on_card(monkeypatch):
    """``ops`` routing as on the card (its operand checks kept) with the
    selective-scan launchers replaced by their plain versions, counted as
    the launchers count: the autograd Function and its backward wrapper
    run, and no CUDA kernel."""
    real = ops._on_card
    monkeypatch.setattr(ops, "_on_card", lambda *args: real(*args) or True)

    def forward(*args, config=None):
        tss.LAUNCHES.bump()
        return ref.selective_scan_chunk_ref(*args)

    def backward(*args):
        tss.BWD_LAUNCHES.bump()
        return ref.selective_scan_chunk_bwd_ref(*args)

    monkeypatch.setattr(tss, "selective_scan_chunk", forward)
    monkeypatch.setattr(tss, "selective_scan_chunk_bwd", backward)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def test_selective_scan_function_wires_the_backward_on_cpu_tensors(routed_as_on_card):
    """``ops.selective_scan_chunk`` under grad is the Function: its
    gradients equal autograd of the plain forward, with dh_last given and
    with h_last unused (autograd hands the backward zeros), one backward
    launch a call; without grad it launches the forward alone."""
    o = _operands(2, 19, 40, 4, seed=6)
    a_log = _t(o["a_log"]).requires_grad_()
    leaves = [_t(o[k]).requires_grad_() for k in ("x", "dt", "b", "c")]
    h0 = _t(o["h0"]).requires_grad_()
    dy, dh = _t(o["dy"]), _t(o["dh"])
    inputs = (*leaves, a_log, h0)
    a = -torch.exp(a_log)
    for with_dh in (True, False):
        y, h_last = ops.selective_scan_chunk(*leaves, a, h0)
        assert y.grad_fn is not None and h_last.grad_fn is not None
        outs, cots = ((y, h_last), (dy, dh)) if with_dh else ((y,), (dy,))
        got = torch.autograd.grad(outs, inputs, cots, retain_graph=True)
        y2, h2 = ref.selective_scan_chunk_ref(*leaves, a, h0)
        want = torch.autograd.grad((y2, h2) if with_dh else (y2,), inputs, cots, retain_graph=True)
        assert max(_rel(g, w) for g, w in zip(got, want)) <= GRAD_REL, with_dh
    assert ops.launch_counts()["selective_scan"] == 2 and ops.backward_launch_counts()["selective_scan_bwd"] == 2
    with torch.no_grad():
        y, _ = ops.selective_scan_chunk(*leaves, a, h0)
    assert y.grad_fn is None and ops.launch_counts()["selective_scan"] == 3
    assert ops.backward_launch_counts() == {"flash_attention_bwd": 0, "selective_scan_bwd": 2, "rglru_scan_bwd": 0, "moe_gmm_bwd": 0}


def test_backward_wrapper_checks_its_operands():
    """The public backward wrapper refuses what the kernel does not take,
    on the CPU as on the card: a dh_last of another shape, an fp64 dy."""
    o = _operands(1, 8, 16, 4, seed=7)
    a = -torch.exp(_t(o["a_log"]))
    args = [_t(o[k]) for k in ("x", "dt", "b", "c")] + [a, _t(o["h0"])]
    with pytest.raises(ValueError, match="dh_last has shape"):
        ops.selective_scan_chunk_bwd(*args, _t(o["dy"]), _t(o["dh"])[:, :8])
    with pytest.raises(TypeError, match="dy has dtype"):
        ops.selective_scan_chunk_bwd(*args, _t(o["dy"]).double(), _t(o["dh"]))
    got = ops.selective_scan_chunk_bwd(*args, _t(o["dy"]), _t(o["dh"]))
    assert [tuple(g.shape) for g in got] == [(1, 8, 16), (1, 8, 16), (1, 8, 4), (1, 8, 4), (16, 4), (1, 16, 4)]


def _reduced_chunks() -> int:
    """selective_scan launches a forward of the reduced config: a chunk a
    layer, over the test batch's sequence."""
    cfg = get_arch(ARCH).reduced()
    return cfg.n_layers * _batch(cfg)["tokens"].shape[1] // cfg.ssm_chunk


def test_ssm_loss_and_gradients_through_the_backward_match_the_reference(routed_as_on_card):
    errs = compare_loss_and_grads(ARCH)
    n = _reduced_chunks()
    assert ops.launch_counts()["selective_scan"] == n and ops.backward_launch_counts()["selective_scan_bwd"] == n
    metric = {k: e for k, e in errs.items() if k.startswith("metric_")}
    leaves = {k: e for k, e in errs.items() if k.startswith("grad")}
    assert max(metric.values()) <= GRAD_REL, metric
    assert max(leaves.values()) <= LEAF_TOL, sorted(leaves.items(), key=lambda kv: -kv[1])[:4]


def test_ssm_three_train_steps_through_the_backward_match_the_reference(routed_as_on_card):
    errs = compare_train_steps(ARCH)
    assert ops.backward_launch_counts()["selective_scan_bwd"] == 3 * _reduced_chunks()
    assert errs["params_over_lr"] <= 1e-2 and errs["ill_conditioned_share"] <= 2e-2, errs
    assert errs["m"] <= 1e-4 and errs["v"] <= 1e-4 and errs["step"] == 0, errs
    assert max(v for k, v in errs.items() if k.endswith("_metrics")) <= 1e-4, errs


def test_remat_dots_replays_each_chunk_before_its_backward(routed_as_on_card):
    """Under "dots" each layer's chunks run forward twice (the forward and
    the backward's recompute) and backward once, and the gradients are the
    plain path's; under "none" once and once."""
    base = get_arch(ARCH).reduced()
    params = Model(base).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(base)
    n = _reduced_chunks()
    grads = {}
    for policy, forwards in (("none", n), ("dots", 2 * n)):
        ops.reset_launch_counts()
        loss, _, grads[policy] = _loss_grads(Model(base.replace(remat=policy)), params, batch)
        assert ops.launch_counts()["selective_scan"] == forwards and ops.backward_launch_counts()["selective_scan_bwd"] == n
    assert max(_rel(g, g0) for g, g0 in zip(grads["dots"], grads["none"])) <= REMAT_TOL


if __name__ == "__main__":
    for mode in ("assoc", "seq"):
        for case in _VJP_CASES:
            print("jax.vjp", mode, case, compare_with_jax_vjp(mode, *case))
    for x_dtype in (np.float32, jnp.bfloat16):
        print("torch autograd", np.dtype(x_dtype).name, compare_with_torch_autograd(x_dtype))
    for parts, chunk in sorted(_SPLIT_CHUNKS.items()):
        split = lambda *ops_, parts=parts: split_in_time_backward(*ops_, parts)
        print("split in time, jax.vjp", parts, chunk, compare_with_jax_vjp("seq", 2, chunk, chunk, 24, 5, backward=split))
