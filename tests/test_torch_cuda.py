"""The port's hand-written kernels against their plain versions, on a GPU.

Marked ``cuda``: they need a CUDA device and nvcc, and skip where there is
none (the check runs inside a fixture, never at import, so every
test worker collects the same tests).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: max-abs 2e-5 in fp32, the reference's parity tolerance
(tests/test_kernels_parity.py:23); rtol = atol = 2e-2 in bf16
(tests/test_kernels.py:13), and one bf16 rounding step element by element
where a case says so; relative 1e-4 for the scans with bf16 x at width
(their outputs are fp32), and for the gradients of both scans' backwards
(the selective scan's dx with bf16 x element by element).  flash_attention runs on the tensor cores at
every width: bf16 on ``wgmma`` (one TF32 product a product, ``tf32``, at
head width 16), fp32 on ``tf32x3`` (three TF32 products a term, held at the
fp32 tolerance with TF32 off in the plain version; on two-block clusters,
``tf32x3_cluster``, at 256).  moe_gmm and its backward have tensor-core
kernels (bf16 ``wgmma``, fp32 ``tf32x3``) and warp-level ``mma`` for the
GEMMs whose strides TMA cannot describe; where a product's tiles are few,
the ``tf32x3`` gradients and ``mma`` split its contraction over a cluster.
"""
from __future__ import annotations

import threading

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import registry as kreg

pytestmark = pytest.mark.cuda

_ROUTED = ("flash_attention", "moe_gmm")
_FP32_ROUTE = {"flash_attention": "tf32x3", "moe_gmm": "tf32x3"}  # at the registry's tiers


def _tc_route(dtype, hd):
    """The tensor-core route of an attention call: bf16 on wgmma from head
    width 32, on one TF32 product at 16; fp32 on tf32x3 up to 128, on
    two-block clusters at 256."""
    if dtype == torch.bfloat16:
        return "wgmma" if hd >= 32 else "tf32"
    return "tf32x3" if hd <= 128 else "tf32x3_cluster"


def _route_delta(name, before):
    return {r: n - before[r] for r, n in ops.route_launch_counts()[name].items()}


def _one_on(name, route):
    """One launch on ``route``, none on the kernel's other routes."""
    return {r: int(r == route) for r in ops.route_launch_counts()[name]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")  # the plain GEMM in full fp32, not TF32
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
        assert _route_delta(name, routes) == _one_on(name, _FP32_ROUTE[name])
    assert kreg.max_abs_err(got, kdef.ref(shape, args)) <= 2e-5


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_bf16_kernel_matches_plain_version_on_the_card(card, name):
    kdef = kreg.get_kernel(name)
    shape = dict(kdef.smoke_shape)
    args = kdef.make_args(shape, "bfloat16", 1, card)
    routes = ops.route_launch_counts()[name]
    got = kdef.call(shape, args, kdef.defaults(shape))
    want = kdef.ref(shape, args)
    assert _route_delta(name, routes) == _one_on(name, "wgmma")
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
    routes = ops.route_launch_counts()["flash_attention"]
    assert kreg.max_abs_err(kdef.call(shape, args, config), kdef.ref(shape, args)) <= 2e-5
    assert _route_delta("flash_attention", routes) == _one_on("flash_attention", _tc_route(torch.float32, shape["hd"]))
    # bf16: kernel and plain version round the same fp32 value once, so
    # they stay within one bf16 step of each other element by element
    args = kdef.make_args(shape, "bfloat16", 2, card)
    routes = ops.route_launch_counts()["flash_attention"]
    got, want = kdef.call(shape, args, config).float(), kdef.ref(shape, args).float()
    assert _route_delta("flash_attention", routes) == _one_on("flash_attention", "wgmma")
    assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3).all())


# bf16 GEMMs off the tile grid: C, D and F ragged (TMA clips at the edge of
# each expert; w is read through the transpose bit), F = 100, whose
# 200-byte row stride TMA cannot describe, so the rule takes the mma kernel
# (4-byte copies), and D 95 F 49, whose rows are not even 4-byte aligned
# (the mma kernel that stages its loads through registers)
@pytest.mark.parametrize(
    "shape,route",
    [({"E": 3, "C": 80, "D": 96, "F": 200}, "wgmma"), ({"E": 3, "C": 80, "D": 96, "F": 100}, "mma"),
     ({"E": 3, "C": 80, "D": 95, "F": 49}, "mma")],
    ids=["ragged", "ragged_f100", "odd_d95_f49"],
)
def test_bf16_gemm_off_the_tile_grid_on_the_card(card, shape, route):
    kdef = kreg.get_kernel("moe_gmm")
    args = kdef.make_args(shape, "bfloat16", 3, card)
    routes = ops.route_launch_counts()["moe_gmm"]
    got, want = kdef.call(shape, args, kdef.defaults(shape)).float(), kdef.ref(shape, args).float()
    assert _route_delta("moe_gmm", routes) == _one_on("moe_gmm", route)
    assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3).all())


# fp32 GEMMs on the tensor cores (three TF32 products a term): the tiers, C,
# D and F off the 128 x 64 x 32 tiles (TMA clips at the edge of each
# expert), and F = 50 and D 95 F 49, whose row strides TMA cannot describe,
# so the rule takes the mma kernel (three TF32 mma.sync products a term);
# max-abs 2e-5 against the plain version in full fp32 (TF32 off)
_FP32_GEMMS = [
    *[(dict(getattr(kreg.get_kernel("moe_gmm"), f"{tier}_shape")), "tf32x3") for tier in ("tiny", "smoke", "full")],
    ({"E": 3, "C": 80, "D": 96, "F": 200}, "tf32x3"),
    ({"E": 3, "C": 80, "D": 96, "F": 50}, "mma"),
    ({"E": 3, "C": 80, "D": 95, "F": 49}, "mma"),
]


@pytest.mark.parametrize("shape,route", _FP32_GEMMS, ids=["tiny", "smoke", "full", "ragged", "ragged_f50", "odd_d95_f49"])
def test_fp32_gemm_on_its_route_matches_plain_version_on_the_card(card, shape, route):
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.get_float32_matmul_precision() == "highest"
    kdef = kreg.get_kernel("moe_gmm")
    args = kdef.make_args(shape, "float32", 4, card)
    routes = ops.route_launch_counts()["moe_gmm"]
    got = kdef.call(shape, args, kdef.defaults(shape))
    torch.cuda.synchronize()
    assert _route_delta("moe_gmm", routes) == _one_on("moe_gmm", route)
    assert got.dtype == torch.float32 and got.shape == (shape["E"], shape["C"], shape["F"])
    assert kreg.max_abs_err(got, kdef.ref(shape, args)) <= 2e-5


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


# head width 16, the reduced model configs' width: fp32 on the tf32x3 kernel
# (the bf16 tensor-core kernel starts at 32, and its route refuses 16)
@pytest.mark.parametrize("L", [16, 128])
@pytest.mark.parametrize("window", [None, 16], ids=["causal", "window16"])
def test_attention_head_width_16_on_the_card(card, L, window):
    shape = {"B": 2, "H": 4, "KV": 2, "L": L, "hd": 16, "causal": True, "window": window}
    kdef = kreg.get_kernel("flash_attention")
    args = kdef.make_args(shape, "float32", 3, card)
    routes = ops.route_launch_counts()["flash_attention"]
    got = kdef.call(shape, args, {"block_q": 64, "block_k": 64})
    assert _route_delta("flash_attention", routes) == _one_on("flash_attention", "tf32x3")
    assert kreg.max_abs_err(got, kdef.ref(shape, args)) <= 2e-5


def _open_gates(params):
    """A vlm tree with both tanh gates of every cross layer opened (0.5 and
    -0.3): at their init of zero the image path reaches neither the output
    nor the gradients.  Any other family's tree as it is."""
    xattn = params.get("superblocks", {}).get("xattn")
    if xattn is None:
        return params
    xattn = {**xattn, "gate_attn": torch.full_like(xattn["gate_attn"], 0.5), "gate_mlp": torch.full_like(xattn["gate_mlp"], -0.3)}
    return {**params, "superblocks": {**params["superblocks"], "xattn": xattn}}


def _extras(cfg, batch: int, device) -> dict:
    """The frontend stubs of the audio and vlm families' batches."""
    g = torch.Generator().manual_seed(2)
    if cfg.family == "audio":
        return {"enc_frames": torch.randn(batch, cfg.enc_len_train, cfg.d_model, generator=g).to(device)}
    if cfg.family == "vlm":
        return {"img_embeds": torch.randn(batch, cfg.n_img_tokens, cfg.d_model, generator=g).to(device)}
    return {}


# the reduced models' prefill on the card against the CPU (relative 1e-4 in
# fp32, as chip_smoke.py holds the full widths), launching exactly their
# kernels: seamless-m4t-medium 2 encoder, 2 decoder and 2 cross attentions
# (Lk 16), llama-3.2-vision-11b 2 self and 2 cross attentions (Lk 8)
@pytest.mark.parametrize(
    "name,want",
    [
        ("llama3-8b", {"flash_attention": 2}),
        ("falcon-mamba-7b", {"selective_scan": 4}),
        ("recurrentgemma-2b", {"flash_attention": 2, "rglru_scan": 4}),
        ("grok-1-314b", {"flash_attention": 2, "moe_gmm": 6}),
        ("arctic-480b", {"flash_attention": 2, "moe_gmm": 6}),
        ("seamless-m4t-medium", {"flash_attention": 6}),
        ("llama-3.2-vision-11b", {"flash_attention": 4}),
    ],
)
def test_reduced_model_prefill_on_the_card_matches_the_cpu(card, name, want):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    model = Model(get_arch(name).reduced())
    params = _open_gates(model.init(torch.Generator(card).manual_seed(0), card))
    tokens = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    extras = _extras(model.cfg, 2, "cpu")
    before = ops.launch_counts()
    got = model.prefill(params, {"tokens": tokens.to(card), **{k: v.to(card) for k, v in extras.items()}}, cache_len=20)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ops.launch_counts().items()} == {k: want.get(k, 0) for k in before}
    ref = model.prefill(tree_map(lambda t: t.cpu(), params), {"tokens": tokens, **extras}, cache_len=20)
    for g, w in zip(tree_leaves({"logits": got[0], "cache": got[1]}), tree_leaves({"logits": ref[0], "cache": ref[1]})):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


# ---------------------------------------------------------------------------
# The backward kernels against their plain versions (kernels/ref.py), and the
# gradients on the card: fp32 relative 1e-4 (against the largest element),
# bf16 rtol = atol = 2e-2 element by element, atol against the largest
# element (gradients are small numbers)
# ---------------------------------------------------------------------------

BWD_ATTN_CASES = [  # (B, H, KV, Lq, Lk, hd, causal, window, dtype)
    # fp32 on the tf32x3 route at hd 16 to 128, on tf32x3_cluster at 256
    (2, 4, 2, 130, 130, 16, True, None, torch.float32),
    (1, 4, 1, 200, 200, 16, True, 16, torch.float32),
    (1, 2, 2, 70, 150, 64, False, None, torch.float32),
    (1, 2, 1, 96, 200, 128, True, None, torch.float32),
    (1, 4, 1, 320, 320, 256, True, 100, torch.float32),
    (1, 4, 2, 200, 200, 32, True, None, torch.bfloat16),
    (2, 8, 2, 256, 256, 128, True, None, torch.bfloat16),
    (1, 2, 1, 4096, 4096, 256, True, 2048, torch.bfloat16),  # past the window, as recurrentgemma-2b
    # bf16 on the wgmma route: the model widths, ragged lengths, GQA and MQA,
    # Lq != Lk both ways, and rows with no live key (Lq past Lk + window)
    (2, 4, 2, 130, 130, 16, True, None, torch.bfloat16),  # hd 16 on tf32
    (1, 4, 2, 333, 333, 64, True, None, torch.bfloat16),
    (1, 8, 2, 200, 200, 128, True, 50, torch.bfloat16),
    (1, 8, 2, 333, 333, 256, True, 100, torch.bfloat16),
    (1, 10, 1, 4096, 4096, 256, True, 2048, torch.bfloat16),  # recurrentgemma-2b's heads (2 parts)
    (2, 32, 8, 2048, 2048, 128, True, None, torch.bfloat16),  # llama3-8b's heads
    (1, 4, 2, 96, 200, 64, False, None, torch.bfloat16),
    (1, 4, 2, 96, 200, 256, False, None, torch.bfloat16),
    (1, 4, 1, 200, 96, 128, True, None, torch.bfloat16),
    (1, 2, 1, 300, 100, 64, True, 50, torch.bfloat16),
    # fp32 on tf32x3 at every width it takes: the broker's Lq != Lk case,
    # GQA split into parts, ragged, windowed, Lq past Lk + window, and the
    # llama3-8b card-vs-CPU gradient check's heads
    (1, 4, 2, 96, 200, 64, False, None, torch.float32),
    (1, 4, 1, 200, 96, 128, True, None, torch.float32),
    (1, 8, 2, 333, 333, 32, True, 50, torch.float32),
    (1, 2, 1, 300, 100, 64, True, 50, torch.float32),
    (1, 32, 8, 256, 256, 128, True, None, torch.float32),
    # fp32 at hd 256 on tf32x3_cluster: Lq != Lk both ways, GQA split into
    # parts, ragged and windowed, rows with no live key; bf16 at hd 16 on
    # tf32: the same kinds
    (1, 4, 2, 96, 200, 256, False, None, torch.float32),
    (1, 2, 1, 200, 96, 256, True, None, torch.float32),
    (1, 8, 2, 333, 333, 256, True, 50, torch.float32),
    (1, 2, 1, 300, 100, 256, True, 50, torch.float32),
    (1, 10, 1, 1024, 1024, 256, True, 300, torch.float32),
    (1, 4, 2, 96, 200, 16, False, None, torch.bfloat16),
    (1, 4, 1, 200, 96, 16, True, None, torch.bfloat16),
    (1, 8, 2, 333, 333, 16, True, 50, torch.bfloat16),
    (1, 2, 1, 300, 100, 16, True, 50, torch.bfloat16),
    # the cross attentions of the reduced vlm config (8 image tokens: shorter
    # than one 32-row k tile of the forward and one 64-row kv block of the
    # backward) and of llama-3.2-vision-11b's width (hd 128, Lq > Lk)
    (2, 4, 2, 16, 8, 16, False, None, torch.float32),
    (1, 8, 2, 256, 64, 128, False, None, torch.bfloat16),
]
_BWD_ID = lambda c: f"B{c[0]}H{c[1]}KV{c[2]}_Lq{c[3]}_Lk{c[4]}_hd{c[5]}_{'causal' if c[6] else 'full'}_w{c[7]}_{str(c[8])[6:]}"
# the cases whose forward writes LSE and whose backward reads it: every route's
_LSE_CASES = list(BWD_ATTN_CASES)


def _close(got, want, dtype):
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    if dtype == torch.float32:
        return float((g - w).abs().max()) <= 1e-4 * scale
    return bool(((g - w).abs() <= 2e-2 * w.abs() + 2e-2 * scale).all())


def _bwd_operands(card, case):
    B, H, KV, Lq, Lk, hd, causal, window, dtype = case
    g = torch.Generator(card).manual_seed(0)
    q = torch.randn(B, H, Lq, hd, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=card).to(dtype) for _ in range(2))
    do = torch.randn(B, H, Lq, hd, generator=g, device=card).to(dtype)
    return q, k, v, do


def _bwd_route_delta(before):
    return {r: n - before[r] for r, n in ops.backward_route_launch_counts()["flash_attention_bwd"].items()}


# every case as a standalone call (no LSE), and also as the train step calls
# it (the forward kernel's o and LSE)
_BWD_RUNS = [(c, False) for c in BWD_ATTN_CASES] + [(c, True) for c in _LSE_CASES]


@pytest.mark.parametrize("case,with_lse", _BWD_RUNS, ids=lambda x: _BWD_ID(x) if isinstance(x, tuple) else ("lse_from_forward" if x else "lse_recomputed"))
def test_attention_backward_kernel_matches_plain_version(card, case, with_lse):
    """Each route against the plain backward (which computes its own LSE):
    with the forward kernel's o and LSE, as the train step calls it, or with
    the plain o and no LSE (the wrapper then runs the LSE preprocess)."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

    B, H, KV, Lq, Lk, hd, causal, window, dtype = case
    path = tfa.bwd_route(dtype, hd)
    q, k, v, do = _bwd_operands(card, case)
    lse = None
    if with_lse:
        lse = torch.empty(B, H, Lq, dtype=torch.float32, device=card)
        o = tfa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    else:
        o = ref.attention_ref(q, k, v, causal=causal, window=window)
    before = ops.backward_launch_counts()["flash_attention_bwd"]
    routes = ops.backward_route_launch_counts()["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
    torch.cuda.synchronize()
    assert ops.backward_launch_counts()["flash_attention_bwd"] == before + 1
    assert _bwd_route_delta(routes) == {r: int(r == path) for r in routes}
    assert path == _tc_route(dtype, hd)
    for a, b in zip(got, ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)):
        assert a.dtype == dtype and a.shape == b.shape and _close(a, b, dtype)


@pytest.mark.parametrize("case", _LSE_CASES, ids=_BWD_ID)
def test_forward_writes_lse_without_changing_its_output(card, case):
    """The forward on every route with an ``lse`` out argument
    give the same o, bit for bit, as without, and LSE within 1e-5 (relative
    to its largest element) of the plain LSE; a row with no live key gets
    -inf in both."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

    B, H, KV, Lq, Lk, hd, causal, window, dtype = case
    q, k, v, _ = _bwd_operands(card, case)
    routes = ops.route_launch_counts()["flash_attention"]
    o = tfa.flash_attention(q, k, v, causal=causal, window=window)
    lse = torch.full((B, H, Lq), float("nan"), dtype=torch.float32, device=card)
    o_lse = tfa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    torch.cuda.synchronize()
    path = _tc_route(dtype, hd)
    assert _route_delta("flash_attention", routes) == {r: 2 * int(r == path) for r in routes}
    assert torch.equal(o, o_lse)
    want = ref.attention_lse_ref(q, k, causal=causal, window=window)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), finite) and bool((lse[~finite] == float("-inf")).all())
    assert float((lse - want)[finite].abs().max()) <= 1e-5 * float(want[finite].abs().max())


# the fp32 forward on tf32x3 at every width it takes, against the plain
# version at max-abs 2e-5: causal, windowed, ragged (no multiple of the 64-row
# q tile or the 32-row k tile), non-causal, GQA and MQA, and Lq != Lk both
# ways (causal, positions from 0 in q and k)
_TF32X3_FWD = [  # (B, H, KV, Lq, Lk, hd, causal, window)
    (2, 4, 2, 130, 130, 16, True, None),
    (1, 4, 1, 200, 200, 16, True, 16),
    (1, 4, 4, 128, 128, 32, False, None),
    (1, 4, 2, 333, 333, 32, True, 50),
    (2, 8, 2, 256, 256, 64, True, None),
    (1, 2, 1, 256, 256, 64, True, 32),
    (1, 2, 2, 192, 192, 64, False, None),
    (1, 4, 2, 96, 200, 64, False, None),
    (1, 4, 1, 200, 96, 128, True, None),
    (1, 4, 2, 320, 320, 128, True, 100),
    (1, 2, 1, 300, 100, 64, True, 50),
]


# the forward on the two routes added beside tf32x3: fp32 at hd 256 on
# two-block clusters (max-abs 2e-5 against the plain version) and bf16 at hd
# 16 on one TF32 product (rtol = atol = 2e-2, and one bf16 step element by
# element); causal, windowed, ragged, non-causal, GQA and MQA, Lq != Lk both
# ways, rows with no live key, recurrentgemma-2b's heads past the window
_SPLIT_AND_BF16_FWD = [  # (B, H, KV, Lq, Lk, hd, causal, window, dtype)
    *[(*c, dt) for dt, hd in ((torch.float32, 256), (torch.bfloat16, 16)) for c in (
        (2, 4, 2, 130, 130, hd, True, None),
        (1, 4, 1, 200, 200, hd, True, 16),
        (1, 4, 4, 128, 128, hd, False, None),
        (1, 4, 2, 96, 200, hd, False, None),
        (1, 4, 1, 200, 96, hd, True, None),
        (1, 2, 1, 300, 100, hd, True, 50),
    )],
    (1, 10, 1, 4096, 4096, 256, True, 2048, torch.float32),
    (1, 2, 2, 256, 256, 256, False, None, torch.float32),  # a small grid: its k tiles in 4 parts
]


@pytest.mark.parametrize("case", _SPLIT_AND_BF16_FWD, ids=_BWD_ID)
def test_cluster_and_bf16_hd16_forward_match_plain_version_on_the_card(card, case):
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

    B, H, KV, Lq, Lk, hd, causal, window, dtype = case
    q, k, v, _ = _bwd_operands(card, case)
    routes = ops.route_launch_counts()["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _route_delta("flash_attention", routes) == _one_on("flash_attention", _tc_route(dtype, hd))
    seen = ref.attention_mask(Lq, Lk, causal, window, card).any(-1)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    g, w = got[:, :, seen].float(), want[:, :, seen].float()
    if dtype == torch.float32:
        assert float((g - w).abs().max()) <= 2e-5
    else:
        assert bool(((g - w).abs() <= 1e-2 * w.abs() + 1e-3).all())
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)
    assert got.dtype == dtype and bool((got[:, :, ~seen] == 0).all())


@pytest.mark.parametrize("case", _TF32X3_FWD, ids=lambda c: f"B{c[0]}H{c[1]}KV{c[2]}_Lq{c[3]}_Lk{c[4]}_hd{c[5]}_{'causal' if c[6] else 'full'}_w{c[7]}")
def test_tf32x3_forward_matches_plain_version_on_the_card(card, case):
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

    B, H, KV, Lq, Lk, hd, causal, window = case
    q, k, v, _ = _bwd_operands(card, (B, H, KV, Lq, Lk, hd, causal, window, torch.float32))
    routes = ops.route_launch_counts()["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _route_delta("flash_attention", routes) == _one_on("flash_attention", "tf32x3")
    # a row that sees no key (Lq past Lk + window) gets 0, as the Pallas
    # kernel's acc / max(l, 1e-37) gives it; the plain version's softmax of
    # all -1e30 spreads it evenly over the keys instead
    seen = ref.attention_mask(Lq, Lk, causal, window, card).any(-1)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert float((got - want)[:, :, seen].abs().max()) <= 2e-5
    assert bool((got[:, :, ~seen] == 0).all())


def _rglru_bwd_operands(card, B, L, dr, seed=1):
    g = torch.Generator(card).manual_seed(seed)
    log_a = -torch.rand(B, L, dr, generator=g, device=card) * 0.1
    gx, dy = (torch.randn(B, L, dr, generator=g, device=card) for _ in range(2))
    h0, dh = (torch.randn(B, dr, generator=g, device=card) for _ in range(2))
    y, _ = ops.rglru_scan(log_a, gx, h0)
    return log_a, h0, y, dy, dh


# one step, a ragged L shorter than a segment, dr off the 32-channel blocks
# and L off the segments, and recurrentgemma-2b's width
@pytest.mark.parametrize("B,L,dr", [(2, 300, 50), (1, 4096, 2560), (2, 37, 64), (1, 1, 64)])
def test_rglru_backward_kernel_matches_plain_version(card, B, L, dr):
    from repro_torch.kernels import ref

    operands = _rglru_bwd_operands(card, B, L, dr)
    before = ops.backward_launch_counts()["rglru_scan_bwd"]
    got = ops.rglru_scan_bwd(*operands)
    torch.cuda.synchronize()
    assert ops.backward_launch_counts()["rglru_scan_bwd"] == before + 1
    for a, b in zip(got, ref.rglru_bwd_ref(*operands)):
        assert _close(a, b, torch.float32)


@pytest.mark.parametrize("B,L,dr", [(2, 300, 50), (1, 4096, 2560)])
def test_rglru_backward_is_one_kernel(card, B, L, dr):
    """A call is one kernel launch (the scratch's zeroing is a memset), and
    matches the plain version."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as trg

    operands = _rglru_bwd_operands(card, B, L, dr, seed=2)
    trg.rglru_scan_bwd(*operands)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = trg.rglru_scan_bwd(*operands)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "rglru" in e.name]
    assert len(kernels) == 1 and "rglru_bwd_kernel" in kernels[0]
    for a, b in zip(got, ref.rglru_bwd_ref(*operands)):
        assert _close(a, b, torch.float32)


def test_rglru_backward_from_two_threads_on_two_streams(card):
    """Two calls at once, each on its own stream: each has its own scratch
    (flags, summaries, ticket), so each gets its own answer."""
    from repro_torch.kernels import ref

    args = [_rglru_bwd_operands(card, 1, 4096, 2560, seed) for seed in (21, 22)]
    streams = [torch.cuda.Stream(card) for _ in args]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(card))
    outs = [[] for _ in args]
    start = threading.Barrier(len(args))

    def work(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            for _ in range(4):
                outs[i].append(ops.rglru_scan_bwd(*args[i]))
        streams[i].synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for a, out in zip(args, outs):
        want = ref.rglru_bwd_ref(*a)
        assert len(out) == 4
        assert all(_close(g, w, torch.float32) for got in out for g, w in zip(got, want))


# the moe_gmm backward at chip_smoke.py's GEMM cases: on the tile grid, C, D
# and F ragged, F = 100 (bf16 on mma) and 50 (mma in both dtypes), and D 95
# F 49 (mma in both, bf16 rows not even 4-byte aligned);
# then the persistent bf16 kernels' edges (chip_smoke.py's
# BWD_GMM_EDGE_CASES): 240 dw tiles, more than one wave of 132 blocks, a
# ragged last wave, and each block's walk crossing experts; a contraction
# shorter than one 64-deep slice (C 16); a ragged last slice after three
# full ones (C 200); an F edge (F 200) with three M tiles; dw's short
# contraction, one slice 96 deep instead of two 64-deep ones, at its ends
# (C 65 and 96)
_GMM_BWD_SHAPES = [
    {"E": 4, "C": 64, "D": 128, "F": 256},
    {"E": 3, "C": 80, "D": 96, "F": 200},
    {"E": 3, "C": 80, "D": 96, "F": 100},
    {"E": 3, "C": 80, "D": 96, "F": 50},
    {"E": 3, "C": 80, "D": 95, "F": 49},
    {"E": 40, "C": 80, "D": 384, "F": 512},
    {"E": 4, "C": 16, "D": 256, "F": 512},
    {"E": 3, "C": 200, "D": 256, "F": 256},
    {"E": 6, "C": 128, "D": 384, "F": 200},
    {"E": 5, "C": 65, "D": 256, "F": 384},
    {"E": 5, "C": 96, "D": 256, "F": 384},
]


def _gmm_bwd_operands(card, shape, dtype, seed=0):
    g = torch.Generator(card).manual_seed(seed)
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    x = torch.randn(E, C, D, generator=g, device=card).to(dtype)
    w = (torch.randn(E, D, F, generator=g, device=card) / D ** 0.5).to(dtype)
    dy = torch.randn(E, C, F, generator=g, device=card).to(dtype)
    return x, w, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", _GMM_BWD_SHAPES, ids=lambda s: "E{E}_C{C}_D{D}_F{F}".format(**s))
def test_moe_gmm_backward_kernel_matches_plain_version(card, shape, dtype):
    """dx and dw on the forward's route against the plain version (fp32
    relative 1e-4, bf16 element by element), each alone too."""
    from repro_torch.kernels import moe_gmm as tgmm
    from repro_torch.kernels import ref

    x, w, dy = _gmm_bwd_operands(card, shape, dtype)
    route = tgmm.route(dtype, shape)
    before = ops.backward_route_launch_counts()["moe_gmm_bwd"]
    got = ops.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    after = ops.backward_route_launch_counts()["moe_gmm_bwd"]
    assert {r: n - before[r] for r, n in after.items()} == {r: int(r == route) for r in after}
    want = ref.moe_gmm_bwd_ref(x, w, dy)
    assert all(a.dtype == dtype and _close(a, b, dtype) for a, b in zip(got, want))
    dx, none = ops.moe_gmm_bwd(x, w, dy, need_dw=False)
    none2, dw = ops.moe_gmm_bwd(x, w, dy, need_dx=False)
    assert none is None and none2 is None and torch.equal(dx, got[0]) and torch.equal(dw, got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_moe_gmm_backward_is_deterministic(card, dtype):
    """Two calls on the same operands give bit-equal dx and dw: no atomics,
    every sum taken in one order (the persistent bf16 kernels' walk over
    more tiles than one wave; the tf32x3 gradients' parts added in part
    order at C16, dx in 6 parts)."""
    for shape in ({"E": 40, "C": 80, "D": 384, "F": 512}, {"E": 4, "C": 16, "D": 256, "F": 512}):
        x, w, dy = _gmm_bwd_operands(card, shape, dtype, seed=5)
        first = ops.moe_gmm_bwd(x, w, dy)
        second = ops.moe_gmm_bwd(x, w, dy)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


# each product's launch on the card held to the rule's properties
# (csrc/gmm.cuh, split_of) on the card's own residency table: the small
# shapes split, the model widths on one part
_GMM_PLAN_SHAPES = [
    ({"E": 4, "C": 16, "D": 256, "F": 512}, torch.float32),
    ({"E": 4, "C": 32, "D": 64, "F": 128}, torch.float32),
    ({"E": 3, "C": 80, "D": 96, "F": 50}, torch.float32),
    ({"E": 3, "C": 80, "D": 95, "F": 49}, torch.bfloat16),
    ({"E": 8, "C": 1280, "D": 6144, "F": 32768}, torch.float32),
    ({"E": 128, "C": 80, "D": 7168, "F": 4864}, torch.float32),
]


@pytest.mark.parametrize("shape,dtype", _GMM_PLAN_SHAPES,
                         ids=["c16_fp32", "grok_1_reduced_up_fp32", "ragged_f50_fp32", "odd_d95_f49_bf16", "grok_1_314b_fp32",
                              "arctic_480b_fp32"])
def test_moe_gmm_launch_config_follows_the_rule(card, shape, dtype):
    from repro_torch.kernels import moe_gmm as tgmm

    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    for product in ("forward", "dx", "dw"):
        cfg = tgmm.launch_config(product, E, C, D, F, dtype, card)
        if cfg is None:
            continue
        parts, n_k, spp, res, saved = cfg["parts"], cfg["stages"], cfg["stages_per_part"], cfg["resident"], cfg["min_saved"]
        tiles = cfg["blocks"] // parts
        qualifies = lambda p: tiles <= res[p] and n_k - -(-n_k // p) >= saved
        assert 1 <= parts <= tgmm.MAX_PARTS and (parts - 1) * spp < n_k <= parts * spp, cfg  # every part holds a stage
        assert parts == 1 or qualifies(parts), cfg  # resident at once, saving enough
        assert not any(qualifies(p) for p in range(parts + 1, min(n_k, tgmm.MAX_PARTS) + 1) if -(-n_k // p) < spp), cfg
        if C >= 1280 or E >= 128:
            assert parts == 1


def test_moe_gmm_gradient_is_the_backward_kernel_on_the_card(card):
    """``ops.moe_gmm`` under grad: its output's gradient is the backward
    kernel's (one backward launch), and matches autograd of the plain
    version; with only w requiring grad, only dw is computed."""
    from repro_torch.kernels import ref

    x, w, dy = _gmm_bwd_operands(card, {"E": 4, "C": 96, "D": 64, "F": 128}, torch.float32, seed=3)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = ops.backward_launch_counts()["moe_gmm_bwd"]
    got = torch.autograd.grad(ops.moe_gmm(xs, ws), (xs, ws), dy)
    torch.cuda.synchronize()
    assert ops.backward_launch_counts()["moe_gmm_bwd"] == before + 1
    want = torch.autograd.grad(ref.moe_gmm_ref(xs, ws), (xs, ws), dy)
    assert all(_close(a, b, torch.float32) for a, b in zip(got, want))
    (dw,) = torch.autograd.grad(ops.moe_gmm(x, ws), (ws,), dy)
    assert _close(dw, want[1], torch.float32)


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


def _ss_bwd_operands(card, B, ck, di, N, dtype, seed=1):
    """The selective scan's operands (dt in softplus's range, A as the
    reference initialises it, a nonzero h0) and the cotangents dy and
    dh_last."""
    g = torch.Generator(card).manual_seed(seed)
    x = torch.randn(B, ck, di, generator=g, device=card).to(dtype)
    dt = torch.rand(B, ck, di, generator=g, device=card) * 0.099 + 0.001
    b, c = (torch.randn(B, ck, N, generator=g, device=card) for _ in range(2))
    a = -(torch.rand(di, N, generator=g, device=card) * (N - 1) + 1)
    h0, dh = (torch.randn(B, di, N, generator=g, device=card) for _ in range(2))
    dy = torch.randn(B, ck, di, generator=g, device=card)
    return x, dt, b, c, a, h0, dy, dh


# the forward's ragged cases (_SCAN_CASES) and falcon-mamba-7b's chunk width,
# each in fp32 and with bf16 x; a chunk shorter than one 16-step segment
_SS_BWD_SHAPES = [(2, 100, 50, 4), (1, 40, 45, 8), (1, 256, 1536, 16), (1, 40, 96, 5), (2, 48, 64, 64), (2, 8, 32, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16x"])
@pytest.mark.parametrize("B,ck,di,N", _SS_BWD_SHAPES)
def test_selective_scan_backward_kernel_matches_plain_version(card, B, ck, di, N, dtype):
    """The six gradients against the plain version (relative 1e-4; dx with
    bf16 x element by element), one backward launch a call, and two calls
    bit-equal (no atomics: every sum across blocks in a fixed order)."""
    from repro_torch.kernels import ref

    operands = _ss_bwd_operands(card, B, ck, di, N, dtype)
    before = ops.backward_launch_counts()["selective_scan_bwd"]
    got = ops.selective_scan_chunk_bwd(*operands)
    again = ops.selective_scan_chunk_bwd(*operands)
    torch.cuda.synchronize()
    assert ops.backward_launch_counts()["selective_scan_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.selective_scan_chunk_bwd_ref(*operands)
    assert [g.dtype for g in got] == [dtype] + [torch.float32] * 5
    assert _close(got[0], want[0], dtype) and all(_close(a, b, torch.float32) for a, b in zip(got[1:], want[1:]))


# the edges of the backward's split of a chunk in time (parts of whole
# 8-step segments, one block of a cluster each) -> the parts its launch
# takes: the last part one step (113 steps, 8 parts of two segments); the
# last part shorter than a segment (45 steps, 6 parts of one); one part,
# forced by a chunk of one segment; B 2 with di 72 (three channel blocks,
# the last ragged)
_SS_BWD_SPLIT_EDGES = {(1, 113, 64, 16): 8, (2, 45, 96, 8): 6, (1, 7, 64, 16): 1, (2, 64, 72, 16): 8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16x"])
@pytest.mark.parametrize("B,ck,di,N", sorted(_SS_BWD_SPLIT_EDGES))
def test_selective_scan_backward_at_the_edges_of_its_parts(card, B, ck, di, N, dtype):
    """At the parts' edges: the launch takes the parts expected, the six
    gradients match the plain version (relative 1e-4; dx with bf16 x
    element by element) and two calls are bit-equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    assert ss.bwd_launch_config(B, ck, di, N, dtype, card)["parts"] == _SS_BWD_SPLIT_EDGES[(B, ck, di, N)]
    operands = _ss_bwd_operands(card, B, ck, di, N, dtype, seed=4)
    got = ops.selective_scan_chunk_bwd(*operands)
    again = ops.selective_scan_chunk_bwd(*operands)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.selective_scan_chunk_bwd_ref(*operands)
    assert _close(got[0], want[0], dtype) and all(_close(a, b, torch.float32) for a, b in zip(got[1:], want[1:]))


def test_selective_scan_backward_holds_16_warps_an_sm_at_falcon_width(card):
    """The split in time keeps at least four 4-warp blocks an SM resident at
    falcon-mamba-7b's chunk (B 1, 256 steps, di 8192, N 16), twice the 8
    warps of the walk before it: 2 parts, one wave of 512 blocks."""
    from repro_torch.kernels import selective_scan as ss

    for dtype in (torch.float32, torch.bfloat16):
        cfg = ss.bwd_launch_config(1, 256, 8192, 16, dtype, card)
        assert cfg["warps_per_sm"] >= 16 and cfg["parts"] == 2 and cfg["blocks"] == 512, cfg


def test_selective_scan_backward_of_two_chained_chunks_is_one_chunk_of_twice_the_length(card):
    """Two chunks chained through h (the second's dh0 handed to the first)
    give the gradients of one chunk of twice the length, within fp32
    rounding."""
    x, dt, b, c, a, h0, dy, dh = _ss_bwd_operands(card, 2, 80, 96, 16, torch.float32, seed=2)
    whole = ops.selective_scan_chunk_bwd(x, dt, b, c, a, h0, dy, dh)
    half = lambda t, i: t[:, 40 * i:40 * (i + 1)].contiguous()
    _, h1 = ops.selective_scan_chunk(half(x, 0), half(dt, 0), half(b, 0), half(c, 0), a, h0)
    second = ops.selective_scan_chunk_bwd(half(x, 1), half(dt, 1), half(b, 1), half(c, 1), a, h1, half(dy, 1), dh)
    first = ops.selective_scan_chunk_bwd(half(x, 0), half(dt, 0), half(b, 0), half(c, 0), a, h0, half(dy, 0), second[5])
    chained = [torch.cat([f, s], dim=1) for f, s in zip(first[:4], second[:4])] + [first[4] + second[4], first[5]]
    torch.cuda.synchronize()
    assert all(_close(g, w, torch.float32) for g, w in zip(chained, whole))


def test_selective_scan_gradient_is_the_backward_kernel_on_the_card(card):
    """``ops.selective_scan_chunk`` under grad: its outputs carry the
    gradient of the backward kernel (one launch), equal to autograd of the
    plain version, with h_last unused (autograd hands dh_last as zeros)."""
    from repro_torch.kernels import ref

    x, dt, b, c, a, h0, dy, _ = _ss_bwd_operands(card, 2, 40, 64, 16, torch.float32, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, dt, b, c, a, h0)]
    before = ops.backward_launch_counts()["selective_scan_bwd"]
    y, h_last = ops.selective_scan_chunk(*leaves)
    assert y.grad_fn is not None and h_last.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ops.backward_launch_counts()["selective_scan_bwd"] == before + 1
    want = torch.autograd.grad(ref.selective_scan_chunk_ref(*leaves)[0], leaves, dy)
    assert all(_close(g, w, torch.float32) for g, w in zip(got, want))


# attention backward launches of a reduced loss: one a self layer, and a
# cross layer's (seamless-m4t-medium 2 + 2 self and 2 cross, vision 2 + 2;
# falcon-mamba-7b none)
_REDUCED_ATTN_BWD = {"seamless-m4t-medium": 6, "llama-3.2-vision-11b": 4, "falcon-mamba-7b": 0}


@pytest.mark.parametrize("name", ["llama3-8b", "recurrentgemma-2b", "falcon-mamba-7b", "grok-1-314b", "arctic-480b",
                                  "seamless-m4t-medium", "llama-3.2-vision-11b"])
def test_reduced_model_gradients_on_the_card_match_the_cpu(card, name):
    """One loss and its gradients of the reduced config (fp32) on the card,
    through the kernels and their backwards, against the CPU's plain path:
    every leaf within 1e-4 of its scale, and every leaf's gradient nonzero
    (the vlm gates opened)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    model = Model(get_arch(name).reduced())
    params = _open_gates(model.init(torch.Generator(card).manual_seed(0), card))
    cfg = model.cfg
    batch = batch_at(DataConfig(vocab_size=256, seq_len=24, global_batch=2, enc_len=cfg.enc_len_train, d_model=cfg.d_model,
                                n_img_tokens=cfg.n_img_tokens, family=cfg.family), 0)

    def grads(params, device):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return torch.autograd.grad(loss, leaves)

    before = ops.backward_launch_counts()
    routes = ops.backward_route_launch_counts()["flash_attention_bwd"]
    on_card = grads(params, card)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.backward_launch_counts().items()}
    n_attn = _REDUCED_ATTN_BWD.get(name, 2)
    assert launched["flash_attention_bwd"] == n_attn and launched["rglru_scan_bwd"] == (4 if name == "recurrentgemma-2b" else 0)
    # two layers of three 8-step chunks over the 24 tokens
    assert launched["selective_scan_bwd"] == (6 if name == "falcon-mamba-7b" else 0)
    # three expert products a moe layer, each with its backward (remat="none" at .reduced())
    assert launched["moe_gmm_bwd"] == (6 if model.cfg.family == "moe" else 0)
    assert _bwd_route_delta(routes) == {r: n_attn * int(r == "tf32x3") for r in routes}  # fp32 at head width 16
    on_cpu = grads(tree_map(lambda t: t.detach().cpu(), params), "cpu")
    for a, b in zip(on_card, on_cpu):
        assert bool(a.abs().max() > 0)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
