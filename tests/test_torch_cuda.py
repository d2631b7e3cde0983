"""The port's hand-written kernels against their plain versions, on a GPU.

Marked ``cuda``: they need a CUDA device and nvcc, and skip where there is
none (the check runs inside a fixture, never at import, so every
test worker collects the same tests).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: max-abs 2e-5 in fp32, the reference's parity tolerance
(tests/test_kernels_parity.py:23); rtol = atol = 2e-2 in bf16
(tests/test_kernels.py:13), and one bf16 rounding step element by element
where a case says so; relative 1e-4 for the scans with bf16 x at width
(their outputs are fp32).  flash_attention and moe_gmm each have two
kernels: bf16 calls must be counted on the tensor-core route (``wgmma``),
fp32 calls on the CUDA-core route (``simt``).
"""
from __future__ import annotations

import threading

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import registry as kreg

pytestmark = pytest.mark.cuda

_ROUTED = ("flash_attention", "moe_gmm")


def _route_delta(name, before):
    return {r: n - before[r] for r, n in ops.route_launch_counts()[name].items()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
@pytest.mark.parametrize("tier", ["tiny", "smoke", "full"])
def test_kernel_matches_plain_version_on_the_card(card, name, tier):
    kdef = kreg.get_kernel(name)
    shape = dict(getattr(kdef, f"{tier}_shape"))
    args = kdef.make_args(shape, "float32", 0, card)
    before = ops.launch_counts()[name]
    routes = ops.route_launch_counts().get(name)
    got = kdef.call(shape, args, kdef.defaults(shape))
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    if name in _ROUTED:
        assert _route_delta(name, routes) == {"simt": 1, "wgmma": 0}
    assert kreg.max_abs_err(got, kdef.ref(shape, args)) <= 2e-5


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_bf16_kernel_matches_plain_version_on_the_card(card, name):
    kdef = kreg.get_kernel(name)
    shape = dict(kdef.smoke_shape)
    args = kdef.make_args(shape, "bfloat16", 1, card)
    routes = ops.route_launch_counts()[name]
    got = kdef.call(shape, args, kdef.defaults(shape))
    want = kdef.ref(shape, args)
    assert _route_delta(name, routes) == {"simt": 0, "wgmma": 1}
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# the head widths of llama3-8b (128) and recurrentgemma-2b (256): their own
# instances of the CUDA kernel, the 256 one with dynamic shared memory
_WIDE_HEADS = [
    {"B": 1, "H": 8, "KV": 2, "L": 256, "hd": 128, "causal": True, "window": None},
    {"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 128, "causal": False, "window": None},
    {"B": 1, "H": 4, "KV": 1, "L": 256, "hd": 256, "causal": True, "window": 64},
    {"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 256, "causal": False, "window": None},
    # L not a multiple of the 128-row q tile, windowed
    {"B": 1, "H": 4, "KV": 2, "L": 320, "hd": 128, "causal": True, "window": 100},
    {"B": 1, "H": 4, "KV": 1, "L": 320, "hd": 256, "causal": True, "window": 100},
]


@pytest.mark.parametrize("shape", _WIDE_HEADS, ids=lambda s: f"hd{s['hd']}_L{s['L']}_w{s['window']}")
def test_attention_wide_heads_match_plain_version_on_the_card(card, shape):
    kdef = kreg.get_kernel("flash_attention")
    config = {"block_q": 64, "block_k": 64}
    args = kdef.make_args(shape, "float32", 2, card)
    assert kreg.max_abs_err(kdef.call(shape, args, config), kdef.ref(shape, args)) <= 2e-5
    # bf16: kernel and plain version round the same fp32 value once, so
    # they stay within one bf16 step of each other element by element
    args = kdef.make_args(shape, "bfloat16", 2, card)
    routes = ops.route_launch_counts()["flash_attention"]
    got, want = kdef.call(shape, args, config).float(), kdef.ref(shape, args).float()
    assert _route_delta("flash_attention", routes) == {"simt": 0, "wgmma": 1}
    assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3).all())


# bf16 GEMMs off the tile grid: C, D and F ragged (TMA clips at the edge of
# each expert; w is read through the transpose bit), and F = 100, whose
# 200-byte row stride TMA cannot describe, so the rule takes the simt kernel
@pytest.mark.parametrize(
    "shape,route",
    [({"E": 3, "C": 80, "D": 96, "F": 200}, "wgmma"), ({"E": 3, "C": 80, "D": 96, "F": 100}, "simt")],
    ids=["ragged", "ragged_f100"],
)
def test_bf16_gemm_off_the_tile_grid_on_the_card(card, shape, route):
    kdef = kreg.get_kernel("moe_gmm")
    args = kdef.make_args(shape, "bfloat16", 3, card)
    routes = ops.route_launch_counts()["moe_gmm"]
    got, want = kdef.call(shape, args, kdef.defaults(shape)).float(), kdef.ref(shape, args).float()
    assert _route_delta("moe_gmm", routes) == {r: int(r == route) for r in ("simt", "wgmma")}
    assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3).all())


# the scans off their kernels' tiles: di 50 (no multiple of 32 channels or
# of four floats), di 45 in bf16 (rows start on odd 2-byte offsets), chunk
# 100 and L 300 (no multiple of the 64-step tiles or the 256-step
# segments), N 5 (padded to 8) and N 64 (the stated limit), bf16 x at the
# falcon-mamba chunk
_SCAN_CASES = [
    ("selective_scan", {"B": 2, "chunk": 100, "di": 50, "N": 4}, "float32"),
    ("selective_scan", {"B": 2, "chunk": 100, "di": 50, "N": 4}, "bfloat16"),
    ("selective_scan", {"B": 1, "chunk": 40, "di": 45, "N": 8}, "bfloat16"),
    ("selective_scan", {"B": 1, "chunk": 256, "di": 1536, "N": 16}, "bfloat16"),
    ("selective_scan", {"B": 1, "chunk": 40, "di": 96, "N": 5}, "float32"),
    ("selective_scan", {"B": 2, "chunk": 48, "di": 64, "N": 64}, "float32"),
    ("rglru_scan", {"B": 2, "L": 300, "dr": 50}, "float32"),
]


def _scan_args(name, shape, dtype, seed, device):
    """The registry's operands with a nonzero incoming state."""
    args = list(kreg.get_kernel(name).make_args(shape, dtype, seed, device))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    args[-1] = torch.randn(args[-1].shape, generator=g, device=device)
    return tuple(args)


@pytest.mark.parametrize("name,shape,dtype", _SCAN_CASES, ids=lambda v: v if isinstance(v, str) else "_".join(f"{k}{n}" for k, n in v.items()))
def test_scan_off_the_tiles_matches_plain_version_on_the_card(card, name, shape, dtype):
    kdef = kreg.get_kernel(name)
    args = _scan_args(name, shape, dtype, 5, card)
    before = ops.launch_counts()[name]
    got = kdef.call(shape, args, {"block_d": min(shape.get("di", shape.get("dr")), 512)})
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    want = kdef.ref(shape, args)
    assert all(g.dtype == torch.float32 and g.shape == w.shape for g, w in zip(got, want))
    err = kreg.max_abs_err(got, want)
    if dtype == "float32":
        assert err <= 2e-5
    else:
        assert err / max(float(w.abs().max()) for w in want) <= 1e-4


@pytest.mark.parametrize("name", ["rglru_scan", "selective_scan"])
def test_scans_from_two_threads_on_two_streams(card, name):
    """The broker's manager threads launch concurrently: each call has its
    own scratch, so two threads on two streams each get their own answer."""
    kdef = kreg.get_kernel(name)
    shape = dict(kdef.full_shape)
    reps = 8
    args = [_scan_args(name, shape, "float32", seed, card) for seed in (21, 22)]
    streams = [torch.cuda.Stream(card) for _ in args]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(card))
    outs = [[] for _ in args]
    start = threading.Barrier(len(args))

    def work(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            for _ in range(reps):
                outs[i].append(kdef.call(shape, args[i], kdef.defaults(shape)))
        streams[i].synchronize()

    before = ops.launch_counts()[name]
    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + len(args) * reps
    for i, a in enumerate(args):
        want = kdef.ref(shape, a)
        assert len(outs[i]) == reps
        assert max(kreg.max_abs_err(got, want) for got in outs[i]) <= 2e-5


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
def test_wall_timed_tune_on_the_card_resolves_through_ops(card, name, monkeypatch):
    """A wall-timed sweep times one launch per route with CUDA events, keys
    its winner by the card's device type, and a kernel call under
    HYDRA_AUTOTUNE=1 resolves to it."""
    from repro_torch.core.managers.compute import KERNEL_RUNTIME
    from repro_torch.core.task import Task
    from repro_torch.kernels.autotune import Autotuner, set_autotuner, unset_autotuner

    kdef = kreg.get_kernel(name)
    shape = dict(kdef.full_shape)
    tuner = Autotuner(timer="wall", device=card, reps=3, warmup=1)
    before = ops.launch_counts()[name]
    result = tuner.tune(name, shape, "float32")
    assert ops.launch_counts()[name] - before == 4  # one launch key: warm-up + 3 reps
    assert result.key.startswith(f"tune:{name}:cuda:") and result.best_s > 0
    set_autotuner(tuner)
    monkeypatch.setenv("HYDRA_AUTOTUNE", "1")
    try:
        task = Task(kind="kernel", payload={"kernel": name, "shape": shape})
        assert KERNEL_RUNTIME.run(task, card)["config"] == kreg.config_sig(result.config)
    finally:
        unset_autotuner(tuner)


@pytest.mark.parametrize("site", [0, 7, 123, 999])
def test_facts_on_the_card_matches_the_cpu(card, site):
    """fit at relative 1e-5; project from draws made on the CPU and moved
    over, at max-abs 1e-3 mm."""
    import numpy as np

    from repro_torch.facts import model as facts

    pre = facts.preprocess(site, 1)
    on_card, on_cpu = facts.fit(pre, device=card), facts.fit(pre, device="cpu")
    for k in ("theta", "cov", "sigma2"):
        np.testing.assert_allclose(on_card[k], on_cpu[k], rtol=1e-5)
    z = facts.draws(pre, on_cpu, n_samples=150_000, seed=1, device="cpu")
    want = facts.project_from_draws(pre, on_cpu, *z)
    got = facts.project_from_draws(pre, on_cpu, *(t.to(card) for t in z))
    assert np.abs(got["rise_mm"] - want["rise_mm"]).max() <= 1e-3
    assert np.abs(got["trajectories"] - want["trajectories"]).max() <= 1e-3


# head width 16, the reduced model configs' width: fp32 on the simt kernel
# (the bf16 tensor-core kernel starts at 32, and its route refuses 16)
@pytest.mark.parametrize("L", [16, 128])
@pytest.mark.parametrize("window", [None, 16], ids=["causal", "window16"])
def test_attention_head_width_16_on_the_card(card, L, window):
    shape = {"B": 2, "H": 4, "KV": 2, "L": L, "hd": 16, "causal": True, "window": window}
    kdef = kreg.get_kernel("flash_attention")
    args = kdef.make_args(shape, "float32", 3, card)
    routes = ops.route_launch_counts()["flash_attention"]
    got = kdef.call(shape, args, {"block_q": 64, "block_k": 64})
    assert _route_delta("flash_attention", routes) == {"simt": 1, "wgmma": 0}
    assert kreg.max_abs_err(got, kdef.ref(shape, args)) <= 2e-5


# the reduced models' prefill on the card against the CPU (relative 1e-4 in
# fp32, as chip_smoke.py holds the full widths), launching exactly their kernels
@pytest.mark.parametrize(
    "name,want",
    [
        ("llama3-8b", {"flash_attention": 2}),
        ("falcon-mamba-7b", {"selective_scan": 4}),
        ("recurrentgemma-2b", {"flash_attention": 2, "rglru_scan": 4}),
    ],
)
def test_reduced_model_prefill_on_the_card_matches_the_cpu(card, name, want):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    model = Model(get_arch(name).reduced())
    params = model.init(torch.Generator(card).manual_seed(0), card)
    tokens = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    before = ops.launch_counts()
    got = model.prefill(params, {"tokens": tokens.to(card)}, cache_len=20)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ops.launch_counts().items()} == {k: want.get(k, 0) for k in before}
    ref = model.prefill(tree_map(lambda t: t.cpu(), params), {"tokens": tokens}, cache_len=20)
    for g, w in zip(tree_leaves({"logits": got[0], "cache": got[1]}), tree_leaves({"logits": ref[0], "cache": ref[1]})):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


# ---------------------------------------------------------------------------
# The backward kernels against their plain versions (kernels/ref.py), and the
# gradients on the card: fp32 relative 1e-4 (against the largest element),
# bf16 rtol = atol = 2e-2 element by element, atol against the largest
# element (gradients are small numbers)
# ---------------------------------------------------------------------------

BWD_ATTN_CASES = [  # (B, H, KV, Lq, Lk, hd, causal, window, dtype)
    (2, 4, 2, 130, 130, 16, True, None, torch.float32),
    (1, 4, 1, 200, 200, 16, True, 16, torch.float32),
    (1, 2, 2, 70, 150, 64, False, None, torch.float32),
    (1, 2, 1, 96, 200, 128, True, None, torch.float32),
    (1, 4, 1, 320, 320, 256, True, 100, torch.float32),
    (1, 4, 2, 200, 200, 32, True, None, torch.bfloat16),
    (2, 8, 2, 256, 256, 128, True, None, torch.bfloat16),
    (1, 2, 1, 4096, 4096, 256, True, 2048, torch.bfloat16),  # past the window, as recurrentgemma-2b
]


def _close(got, want, dtype):
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    if dtype == torch.float32:
        return float((g - w).abs().max()) <= 1e-4 * scale
    return bool(((g - w).abs() <= 2e-2 * w.abs() + 2e-2 * scale).all())


@pytest.mark.parametrize("case", BWD_ATTN_CASES, ids=lambda c: f"H{c[1]}KV{c[2]}_Lq{c[3]}_Lk{c[4]}_hd{c[5]}_{'causal' if c[6] else 'full'}_w{c[7]}_{str(c[8])[6:]}")
def test_attention_backward_kernel_matches_plain_version(card, case):
    from repro_torch.kernels import ref

    B, H, KV, Lq, Lk, hd, causal, window, dtype = case
    g = torch.Generator(card).manual_seed(0)
    q = torch.randn(B, H, Lq, hd, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=card).to(dtype) for _ in range(2))
    o = ref.attention_ref(q, k, v, causal=causal, window=window)
    do = torch.randn(B, H, Lq, hd, generator=g, device=card).to(dtype)
    before = ops.backward_launch_counts()["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.backward_launch_counts()["flash_attention_bwd"] == before + 1
    for a, b in zip(got, ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)):
        assert a.dtype == dtype and a.shape == b.shape and _close(a, b, dtype)


@pytest.mark.parametrize("B,L,dr", [(2, 300, 50), (1, 4096, 2560), (2, 37, 64)])
def test_rglru_backward_kernel_matches_plain_version(card, B, L, dr):
    from repro_torch.kernels import ref

    g = torch.Generator(card).manual_seed(1)
    log_a = -torch.rand(B, L, dr, generator=g, device=card) * 0.1
    gx, dy = (torch.randn(B, L, dr, generator=g, device=card) for _ in range(2))
    h0, dh = (torch.randn(B, dr, generator=g, device=card) for _ in range(2))
    y, _ = ops.rglru_scan(log_a, gx, h0)
    got = ops.rglru_scan_bwd(log_a, h0, y, dy, dh)
    torch.cuda.synchronize()
    for a, b in zip(got, ref.rglru_bwd_ref(log_a, h0, y, dy, dh)):
        assert _close(a, b, torch.float32)


def test_kernel_outputs_carry_gradients_on_the_card(card):
    """flash_attention and rglru_scan hand back outputs with a grad_fn, and
    their gradients equal autograd of the plain versions on the card."""
    from repro_torch.kernels import ref

    g = torch.Generator(card).manual_seed(3)
    q = torch.randn(1, 4, 64, 16, generator=g, device=card).requires_grad_()
    k, v = (torch.randn(1, 2, 64, 16, generator=g, device=card).requires_grad_() for _ in range(2))
    o = ops.flash_attention(q, k, v, causal=True, window=16)
    assert o.grad_fn is not None
    do = torch.randn(o.shape, generator=g, device=card)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(ref.attention_ref(q, k, v, causal=True, window=16), (q, k, v), do)
    assert all(_close(a, b, torch.float32) for a, b in zip(got, want))
    log_a = (-torch.rand(2, 40, 64, generator=g, device=card)).requires_grad_()
    gx = torch.randn(2, 40, 64, generator=g, device=card).requires_grad_()
    y, h_last = ops.rglru_scan(log_a, gx)
    assert y.grad_fn is not None and h_last.grad_fn is not None
    dy = torch.randn(y.shape, generator=g, device=card)
    got = torch.autograd.grad((y * dy).sum() + h_last.sum(), (log_a, gx))
    y2, h2 = ref.rglru_ref(log_a, gx)
    want = torch.autograd.grad((y2 * dy).sum() + h2.sum(), (log_a, gx))
    assert all(_close(a, b, torch.float32) for a, b in zip(got, want))


def test_kernels_without_a_backward_raise_under_grad_on_the_card(card):
    """selective_scan_chunk and moe_gmm refuse operands that require grad
    under grad mode (no silent loss of gradients) and launch without it."""
    B, ck, di, N = 2, 8, 32, 4
    x = torch.randn(B, ck, di, device=card, requires_grad=True)
    rest = (torch.rand(B, ck, di, device=card), torch.randn(B, ck, N, device=card), torch.randn(B, ck, N, device=card),
            -torch.rand(di, N, device=card), torch.zeros(B, di, N, device=card))
    with pytest.raises(ops.BackwardNotPorted, match="selective_scan backward"):
        ops.selective_scan_chunk(x, *rest)
    xg = torch.randn(2, 64, 32, device=card)
    w = torch.randn(2, 32, 64, device=card, requires_grad=True)
    with pytest.raises(ops.BackwardNotPorted, match="item 4b"):
        ops.moe_gmm(xg, w)
    before = ops.launch_counts()
    with torch.no_grad():
        ops.selective_scan_chunk(x, *rest)
        ops.moe_gmm(xg, w)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["selective_scan"] == before["selective_scan"] + 1 and after["moe_gmm"] == before["moe_gmm"] + 1


@pytest.mark.parametrize("name", ["llama3-8b", "recurrentgemma-2b"])
def test_reduced_model_gradients_on_the_card_match_the_cpu(card, name):
    """One loss and its gradients of the reduced config (fp32) on the card,
    through the kernels and their backwards, against the CPU's plain path:
    every leaf within 1e-4 of its scale, and every leaf's gradient nonzero."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    model = Model(get_arch(name).reduced())
    params = model.init(torch.Generator(card).manual_seed(0), card)
    batch = batch_at(DataConfig(vocab_size=256, seq_len=24, global_batch=2), 0)

    def grads(params, device):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return torch.autograd.grad(loss, leaves)

    before = ops.backward_launch_counts()
    on_card = grads(params, card)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.backward_launch_counts().items()}
    assert launched["flash_attention_bwd"] == 2 and launched["rglru_scan_bwd"] == (4 if name == "recurrentgemma-2b" else 0)
    on_cpu = grads(tree_map(lambda t: t.detach().cpu(), params), "cpu")
    for a, b in zip(on_card, on_cpu):
        assert bool(a.abs().max() > 0)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
