#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and the CUDA
toolkit (``nvcc``), and exits non-zero on any failure.  Phases:

  1. set-up: the card's name and power limit; the CUDA kernels built from
     ``src/repro_torch/kernels/csrc`` into ``build/repro_torch``; TF32 off for
     fp32 matrix products and convolutions, so the plain versions are exact.
  2. kernels: every kernel held against its plain PyTorch version on the
     card -- the registry's tiny, smoke and full tiers in fp32 (max-abs
     <= 2e-5, the reference's parity tolerance), the attention variants and
     chunk chaining of the reference tests at every head width the kernel is
     built for, the scans off their kernels' tiles (fp32 at 2e-5, bf16 x at
     relative 1e-4) and at the full tier from two threads on two streams at
     once, and the full width of a model the repo configures (relative
     max error <= 1e-4 in fp32, <= 2e-2 in bf16; the attention widths also
     in fp32).  Every bf16 output is also held element by element (see
     BF16_ELEMENT_TOL).  One line per kernel and shape: error, the kernel's
     median time (``ms``, back-to-back calls; ``ms_cold``, each call behind a
     512 MB write, so L2 is cold and the host's launch overhead is hidden),
     the plain version's time, one library call's time where one exists, and
     the launches made.  flash_attention and moe_gmm each have two kernels, picked
     by rule (``route``): every bf16 call here must be counted on the
     tensor-core route (``wgmma``) and every fp32 call on the CUDA-core route
     (``simt``), save the one bf16 GEMM whose strides TMA cannot describe.
  3. broker: ``Hydra(device="cuda")`` with a cloud (CaaS) and an HPC (pilot)
     provider on the card runs a backlog of noop tasks, kernel tasks at the
     registry's full shapes and one 2-rep task per model width, with the
     event and ledger cross-checks on.  Every task must end DONE, the
     ``kernel.exec`` events must reconcile with the broker's counters, and
     each kernel's launch counter must rise by exactly the reps dispatched,
     the bf16 model-width reps on the ``wgmma`` route and the fp32 ones on
     ``simt``.
  4. scenario: the reference's acceptance scenario, ``searise_at_scale``
     (1024 FACTS members, 6 training jobs, 4 serve waves of 16 tasks, 4
     providers and an elastic burst pool) with the settings of
     ``searise_kernels``: the serve lane runs the four kernels, 2 reps a
     task, pre-tuned by the model-timer autotuner, with task checkpoints
     every 2 s.  It runs on ``Hydra(device="cuda")`` with chaos and as the
     no-chaos twin, the event and ledger cross-checks on.  Both must hold
     every invariant with no task failed or unresolved, tune each kernel
     once into a pinned ``tune:<kernel>:cuda:`` dataset, and launch each
     kernel exactly as many times as its ``kernel.exec`` events say reps
     ran, every launch on the ``simt`` route (fp32 payloads).
  5. autotune and FACTS: a wall-timed sweep of each kernel at its full tier
     on the card, whose winner a kernel task must then resolve to under
     ``HYDRA_AUTOTUNE=1``; 64 FACTS workflows of 150000 samples through
     ``WorkflowManager`` on ``Hydra(device="cuda")``, every one done with
     finite, ordered quantiles; and for four instances ``fit`` on the card
     against the CPU (relative 1e-5) and ``project`` on the card from draws
     made on the CPU against the CPU (max-abs 1e-3 mm).
  6. model: the port's serve path (``repro_torch.models``,
     ``launch/serve.py``) on the card.  Card against CPU at full width in
     fp32 on the same weights (relative max error <= 1e-4 on the logits and
     every cache leaf): recurrentgemma-2b cut to one superblock at a prompt
     of 2176 (past its 2048 window, so the window and the ring buffer
     bite), falcon-mamba-7b cut to 2 layers at 512 (two chunks carry the
     state), llama3-8b cut to 2 layers at 1000 (blocks of 125), each prefill
     launching exactly its kernels.  falcon-mamba-7b and llama3-8b at full
     width cut to 4 layers in bf16 at a prompt of 4096: finite, 64
     ``selective_scan`` and 4 ``wgmma`` attention launches, warm prefill
     time.  Then ``serve("recurrentgemma-2b",
     reduced=False, batch=4, prompt_len=4096, gen=32)`` in bf16, twice on
     one set of weights: finite logits, exactly 18 ``rglru_scan`` and 8
     ``flash_attention`` launches (all ``wgmma``) a prefill and none in
     decode.  In the first of these prefills, and in the bf16 ones at 4
     layers, every kernel launch is held against its plain version on the
     operands the path gave it (``path_kernels_checked``: relative <= 1e-4
     for fp32 outputs, <= 2e-2 and element by element for bf16).  It prints prefill seconds, decode ms a token, tokens/s, peak
     memory and the kernels' share of a prefill (from a ``torch.profiler``
     trace of one more prefill, and from the two kernels timed alone at the
     serve's shapes).  Last, three ``kind="compute", step_kind="prefill"``
     tasks, one a family, through ``Hydra(device="cuda")``: all DONE, with
     the launches of the reduced configs (head width 16 on ``simt``).
  7. train: the port's train path (``launch/train.py`` -> ``train/step.py``
     -> ``Model.loss`` under remat -> the kernels as autograd Functions ->
     their backward kernels -> ``optim/adamw.py``) on the card.  First the
     two backward kernels against their plain versions (fp32 relative
     <= 1e-4; bf16 element by element, rtol = atol = 2e-2 with atol against
     the largest element) at llama3-8b's and recurrentgemma-2b's attention
     widths in bf16, head width 16 in fp32, an Lq != Lk non-causal case, and
     the RG-LRU backward at B1 L4096 dr2560, each timed (warm and cold)
     beside its plain version, SDPA's autograd backward (attention; timed
     only) and its bound.  Then ``train("recurrentgemma-2b",
     reduced=False, steps=3, seq_len=4096, global_batch=1)`` in bf16: every
     backward launch of its first step held against its plain version on
     its own operands, finite losses, per step 16 / 36 forward launches
     (attention / rglru_scan, twice 8 / 18 under remat="dots") and 8 / 18
     backward launches, and every parameter leaf's gradient nonzero (the
     kernels carry gradients back).  llama3-8b at full width cut to 2 layers
     trains 2 steps at B2 x 2048 the same way; llama3-8b cut to 1 layer
     (B1 x 256, fp32) gives every gradient leaf on the card within 1e-4 of
     the CPU's; and ``kind="compute"`` train tasks on ``Hydra(device="cuda")``:
     3 llama3-8b and 3 recurrentgemma-2b tasks DONE with finite metrics and
     their backward launches, one falcon-mamba-7b task FAILED with
     ``ops.BackwardNotPorted`` (the selective_scan backward is not ported).
  8. report: the card line, one JSON line of the kernels (route, source, the
     TPU kernel each replaces, launches in phase 3 in total and by kernel
     route, in each scenario twin and in one full-size serve prefill
     (``model_launches``), model-width error and times, cold too, beside the
     roofline bound; the two backward kernels with their launches in the
     recurrentgemma-2b train run), and the device line last.

Each phase prints its wall seconds.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TIER_TOL = 2e-5  # max-abs, the reference's parity tolerance (tests/test_kernels_parity.py:23)
WIDTH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative max error at the model widths
# every bf16 output, element by element: |got - want| <= rtol * |want| + atol.
# Kernel and plain version both compute in fp32 and round once to bf16, so
# they differ by at most one rounding step (2^-7 of the value) plus fp32
# noise; a row the kernel got wrong fails here even where the outputs are
# small beside the largest one, which the max-relative check cannot see.
BF16_ELEMENT_TOL = (1e-2, 1e-3)

# (kernel, model config the width comes from, payload shape, dtype)
MODEL_WIDTHS = [
    ("flash_attention", "llama3_8b", {"B": 1, "H": 32, "KV": 8, "L": 4096, "hd": 128, "causal": True, "window": None}, "bfloat16"),
    ("flash_attention", "recurrentgemma_2b", {"B": 1, "H": 10, "KV": 1, "L": 4096, "hd": 256, "causal": True, "window": 2048}, "bfloat16"),
    ("selective_scan", "falcon_mamba_7b", {"B": 1, "chunk": 256, "di": 8192, "N": 16}, "float32"),
    ("rglru_scan", "recurrentgemma_2b", {"B": 2, "L": 4096, "dr": 2560}, "float32"),
    ("moe_gmm", "grok_1_314b", {"E": 8, "C": 1280, "D": 6144, "F": 32768}, "bfloat16"),
]

KERNEL_INFO = {
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:119"),
    "selective_scan": ("cuda", "src/repro_torch/kernels/csrc/selective_scan.cu", "src/repro/kernels/selective_scan.py:65"),
    "rglru_scan": ("cuda", "src/repro_torch/kernels/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan.py:52"),
    "moe_gmm": ("cuda", "src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:60"),
}

# attention variants of tests/test_kernels.py:17-56 and tests/test_kernels_parity.py:65-72
ATTN_VARIANTS = [
    ({"B": 1, "H": 4, "KV": 4, "L": 128, "hd": 64, "causal": True, "window": None}, "mha"),
    ({"B": 2, "H": 8, "KV": 2, "L": 256, "hd": 64, "causal": True, "window": None}, "gqa"),
    ({"B": 1, "H": 4, "KV": 1, "L": 128, "hd": 32, "causal": True, "window": None}, "mqa"),
    ({"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 64, "causal": True, "window": None}, "non_pow2"),
    ({"B": 1, "H": 2, "KV": 1, "L": 256, "hd": 64, "causal": True, "window": 32}, "window32"),
    ({"B": 1, "H": 2, "KV": 1, "L": 256, "hd": 64, "causal": True, "window": 128}, "window128"),
    ({"B": 1, "H": 2, "KV": 2, "L": 128, "hd": 64, "causal": False, "window": None}, "non_causal"),
    ({"B": 1, "H": 4, "KV": 4, "L": 128, "hd": 32, "causal": False, "window": None}, "mha_full"),
    ({"B": 1, "H": 4, "KV": 2, "L": 128, "hd": 32, "causal": True, "window": 64}, "gqa_windowed"),
    # the head widths of the model widths below (llama3-8b 128, recurrentgemma-2b 256)
    ({"B": 1, "H": 8, "KV": 2, "L": 256, "hd": 128, "causal": True, "window": None}, "gqa_hd128"),
    ({"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 128, "causal": False, "window": None}, "non_causal_hd128"),
    ({"B": 1, "H": 4, "KV": 1, "L": 256, "hd": 256, "causal": True, "window": 64}, "mqa_windowed_hd256"),
    ({"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 256, "causal": False, "window": None}, "non_causal_hd256"),
    # a length that is not a multiple of the 128-row q tile, windowed: TMA
    # clips the last K/V tiles at the edge of each head
    ({"B": 1, "H": 4, "KV": 2, "L": 320, "hd": 128, "causal": True, "window": 100}, "ragged_windowed_hd128"),
    ({"B": 1, "H": 4, "KV": 1, "L": 320, "hd": 256, "causal": True, "window": 100}, "ragged_windowed_hd256"),
]

# head width 16, the reduced model configs' width: fp32 only (the bf16
# tensor-core kernel starts at 32 and its route refuses 16)
HD16_CASES = [
    ({"B": 2, "H": 4, "KV": 2, "L": L, "hd": 16, "causal": True, "window": w}, f"hd16_L{L}_{'window16' if w else 'causal'}")
    for L in (16, 128) for w in (None, 16)
]

# bf16 GEMMs off the tile grid: C, D and F ragged (TMA clips per expert; w
# read through the transpose bit), and F = 100, whose 200-byte row stride TMA
# cannot describe, so the rule sends it to the simt kernel
GMM_CASES = [
    ({"E": 4, "C": 64, "D": 128, "F": 256}, "sweep"),
    ({"E": 3, "C": 80, "D": 96, "F": 200}, "ragged"),
    ({"E": 3, "C": 80, "D": 96, "F": 100}, "ragged_f100"),
]

# the scans off their kernels' tiles: di 50 (no multiple of 32 channels or
# of four floats), di 45 in bf16 (rows start on odd 2-byte offsets), chunk
# 100 and L 300 (no multiple of the 64-step tiles or the 256-step
# segments), and bf16 x at the falcon-mamba chunk; fp32 at TIER_TOL, bf16 x
# at relative 1e-4 (outputs are fp32)
SCAN_CASES = [
    ("selective_scan", {"B": 2, "chunk": 100, "di": 50, "N": 4}, "float32", "ragged"),
    ("selective_scan", {"B": 2, "chunk": 100, "di": 50, "N": 4}, "bfloat16", "ragged_bf16x"),
    ("selective_scan", {"B": 1, "chunk": 40, "di": 45, "N": 8}, "bfloat16", "odd_bf16x"),
    ("selective_scan", {"B": 1, "chunk": 256, "di": 1536, "N": 16}, "bfloat16", "chunk256_bf16x"),
    ("rglru_scan", {"B": 2, "L": 300, "dr": 50}, "float32", "ragged"),
]
SCAN_BF16X_TOL = 1e-4

# the kernels with a tensor-core and a CUDA-core route
ROUTED = ("flash_attention", "moe_gmm")

FLUSH_BYTES = 512 << 20  # more than the 50 MB L2, and long enough to hide a launch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, budget_s: float = 0.5, max_reps: int = 20) -> float:
    """Median of single-call times with CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = max(3, min(max_reps, int(budget_s / max(once, 1e-6))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median time of one call behind a write of ``flush`` (past L2) on the
    same stream: the card is busy with the write while the host enqueues the
    call, so the events time the kernel from a cold L2 and not the host."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def bound(kdef, shape: dict, dtype: str) -> tuple:
    """The least time of one call on the H100, from the data sheet's peaks
    (the port keeps them with its cost model, kernels/autotune.py)."""
    from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_OPS_PER_S

    cost = kdef.cost(shape, dtype)
    t_bytes = cost.hbm_bytes / HBM_BYTES_PER_S
    t_ops = cost.flops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def library_call(torch, name: str, shape: dict, args: tuple):
    """One PyTorch call computing the same function (a yardstick the port
    never calls), or None where PyTorch has none."""
    import torch.nn.functional as F

    if name == "flash_attention":
        q, k, v = args
        window = shape.get("window")
        if window is None:
            return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=shape["causal"], enable_gqa=True)
        L = shape["L"]
        pos = torch.arange(L, device=q.device)
        mask = (pos[None, :] <= pos[:, None] if shape["causal"] else torch.ones(L, L, dtype=torch.bool, device=q.device))
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    if name == "moe_gmm":
        x, w = args
        return lambda: torch.bmm(x, w)
    return None


def expected_route(name: str, shape: dict, dtype: str):
    """The route a call must take: bf16 on the tensor cores where TMA can
    describe the strides (all but the F = 100 GEMM), fp32 on the CUDA cores."""
    if name not in ROUTED:
        return None
    if dtype == "bfloat16" and not (name == "moe_gmm" and shape["F"] * 2 % 16):
        return "wgmma"
    return "simt"


def check_bf16_elements(got, want, label):
    """Raises where a bf16 output is off its plain version by more than
    BF16_ELEMENT_TOL, element by element."""
    rtol, atol = BF16_ELEMENT_TOL
    gf, wf = got.float(), want.float()
    n_over = int(((gf - wf).abs() > rtol * wf.abs() + atol).sum())
    if n_over:
        raise AssertionError(f"{label}: {n_over} of {got.numel()} elements over rtol {rtol:g} + atol {atol:g}")


def check_kernel(torch, kreg, ops, name, shape, dtype, seed, tol, relative, label, dev, timed=True, config=None, flush=None):
    """Kernel vs plain version on the card; raises past ``tol`` or if the
    call took another route than ``expected_route``."""
    kdef = kreg.get_kernel(name)
    config = config or kdef.defaults(shape)
    args = kdef.make_args(shape, dtype, seed, dev)
    before = ops.launch_counts()[name]
    routes_before = ops.route_launch_counts().get(name)
    got = as_tuple(kdef.call(shape, args, config))
    torch.cuda.synchronize()
    route = expected_route(name, shape, dtype)
    if route is not None:
        took = {r: n - routes_before[r] for r, n in ops.route_launch_counts()[name].items()}
        if took != {r: int(r == route) for r in took}:
            raise AssertionError(f"{name} {label}: launches by route {took}, want one on {route}")
    want = as_tuple(kdef.ref(shape, args))
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
            raise AssertionError(f"{name} {label}: kernel gave {g.shape} {g.dtype} on {g.device}, plain {w.shape} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {label}: kernel output is not finite")
        if g.dtype == torch.bfloat16:
            check_bf16_elements(g, w, f"{name} {label}")
    err = kreg.max_abs_err(got, want)
    scale = max(float(w.float().abs().max()) for w in want) if relative else 1.0
    if not err / scale <= tol:
        raise AssertionError(f"{name} {label}: error {err / scale:.3e} over tolerance {tol:g}")
    row = {"kernel": name, "case": label, "dtype": dtype, "route": route, "max_abs_err": err, "rel_err": err / scale if relative else None}
    if timed:
        row["ms"] = median_ms(torch, lambda: kdef.call(shape, args, config))
        row["ms_cold"] = cold_ms(torch, lambda: kdef.call(shape, args, config), flush)
        row["plain_ms"] = median_ms(torch, lambda: kdef.ref(shape, args), max_reps=5)
        lib = library_call(torch, name, shape, args)
        row["library_ms"] = median_ms(torch, lib) if lib is not None else None
        row["bound_ms"], row["bound_by"] = bound(kdef, shape, dtype)
    row["launches"] = ops.launch_counts()[name] - before
    print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    return row


def check_chunk_chaining(torch, ops, dev):
    """Two chunks chained through h0 equal one double-length chunk
    (tests/test_kernels.py:73), on the kernel."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, ck, di, N = 1, 16, 64, 8
    x = torch.randn(B, 2 * ck, di, generator=g, device=dev)
    dt = torch.rand(B, 2 * ck, di, generator=g, device=dev) * 0.099 + 0.001
    bm = torch.randn(B, 2 * ck, N, generator=g, device=dev)
    cm = torch.randn(B, 2 * ck, N, generator=g, device=dev)
    a = -(torch.rand(di, N, generator=g, device=dev) * 1.5 + 0.5)
    h0 = torch.zeros(B, di, N, device=dev)
    y_full, h_full = ops.selective_scan_chunk(x, dt, bm, cm, a, h0, block_d=32)

    def half(t, s):
        return t[:, s].contiguous()

    first, second = slice(0, ck), slice(ck, 2 * ck)
    _, h1 = ops.selective_scan_chunk(half(x, first), half(dt, first), half(bm, first), half(cm, first), a, h0, block_d=32)
    y2, h2 = ops.selective_scan_chunk(half(x, second), half(dt, second), half(bm, second), half(cm, second), a, h1, block_d=32)
    err = max(float((y_full[:, second] - y2).abs().max()), float((h_full - h2).abs().max()))
    if not err <= 1e-5:
        raise AssertionError(f"selective_scan chunk chaining: error {err:.3e} over 1e-5")
    print(f"kernel kernel=selective_scan case=chunk_chaining max_abs_err={err}", flush=True)


def check_concurrent(torch, kreg, ops, dev, reps: int = 8):
    """Both scans' full tier from two threads at once, each on its own
    stream, as the broker's manager threads launch: every call has its own
    scratch, so each thread gets its own answer."""
    for name in ("rglru_scan", "selective_scan"):
        kdef = kreg.get_kernel(name)
        shape = dict(kdef.full_shape)
        args = [kdef.make_args(shape, "float32", seed, dev) for seed in (21, 22)]
        streams = [torch.cuda.Stream(dev) for _ in args]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(dev))
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
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{name} two_threads: a thread did not finish in 120 s")
        torch.cuda.synchronize()
        launches = ops.launch_counts()[name] - before
        if launches != len(args) * reps or any(len(o) != reps for o in outs):
            raise AssertionError(f"{name} two_threads: {launches} launches, want {len(args) * reps}")
        err = max(kreg.max_abs_err(got, kdef.ref(shape, a)) for a, o in zip(args, outs) for got in o)
        if not err <= TIER_TOL:
            raise AssertionError(f"{name} two_threads: error {err:.3e} over tolerance {TIER_TOL:g}")
        print(f"kernel kernel={name} case=full_two_threads max_abs_err={err} launches={launches}", flush=True)


def run_broker(torch, kreg, ops, Hydra, ProviderSpec, Task, TaskState):
    """The port's main path: Hydra.dispatch -> StreamingDispatcher ->
    CaaS / pilot manager -> KernelRuntime -> the kernels, on cuda:0."""
    import concurrent.futures as cf

    os.environ["HYDRA_EVENTS_CHECK"] = "1"
    os.environ["HYDRA_LEDGER_CHECK"] = "1"
    h = Hydra(device="cuda", streaming=True, pod_store="memory")
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    h.register_provider(ProviderSpec(name="hpc", platform="hpc", connector="pilot"))
    names = sorted(kreg.KERNELS)
    kernel_tasks = []
    for i in range(64):  # the four kernels in turn, at the registry's full shapes
        n = names[i % len(names)]
        shape = dict(kreg.get_kernel(n).full_shape)
        task = Task(kind="kernel", payload={"kernel": n, "shape": dict(shape), "reps": 1, "seed": i})
        kernel_tasks.append((task, n, shape, "float32"))
    kernel_tasks += [
        (Task(kind="kernel", payload={"kernel": n, "shape": dict(shape), "dtype": dtype, "reps": 2, "seed": 100 + i}), n, shape, dtype)
        for i, (n, _, shape, dtype) in enumerate(MODEL_WIDTHS)
    ]
    noops = [Task(kind="noop") for _ in range(1024)]
    tasks = noops + [t for t, *_ in kernel_tasks]
    want_reps = {n: 0 for n in names}
    want_execs = {n: 0 for n in names}
    want_routes = {n: {"simt": 0, "wgmma": 0} for n in ROUTED}
    for t, n, shape, dtype in kernel_tasks:
        want_reps[n] += t.payload["reps"]
        want_execs[n] += 1
        if n in ROUTED:
            want_routes[n][expected_route(n, shape, dtype)] += t.payload["reps"]

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h.dispatch(tasks)
    done, pending = cf.wait(tasks, timeout=900)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = ops.route_launch_counts()
    if pending:
        raise AssertionError(f"broker: {len(pending)} tasks unfinished after 900 s")
    states = {}
    for t in tasks:
        states[t.tstate.value] = states.get(t.tstate.value, 0) + 1
        if t.tstate != TaskState.DONE or t.exception() is not None:
            raise AssertionError(f"broker: task {t.uid} ended {t.tstate.value}: {t.exception()!r}")
    for t, n, shape, dtype in kernel_tasks:
        r = t.result()
        want = {"kernel": n, "sig": kreg.shape_sig(shape, dtype), "reps": t.payload["reps"], "skipped_reps": 0,
                "config": kreg.config_sig(kreg.get_kernel(n).defaults(shape))}
        if {k: r[k] for k in want} != want:
            raise AssertionError(f"broker: task {t.uid} result {r} is not {want}")
    if h.kernel_execs_by != want_execs or h.kernel_reps != sum(want_reps.values()):
        raise AssertionError(f"broker: kernel_execs_by {h.kernel_execs_by} / reps {h.kernel_reps}, want {want_execs}")
    events = {}
    for e in h.events.events():
        if e.name == "kernel.exec":
            events[e.attrs["kernel"]] = events.get(e.attrs["kernel"], 0) + 1
    if events != want_execs:
        raise AssertionError(f"broker: kernel.exec events {events} do not reconcile with {want_execs}")
    if launches != want_reps:
        raise AssertionError(f"broker: launch counts {launches}, want the reps dispatched {want_reps}")
    if routes != want_routes:
        raise AssertionError(f"broker: launches by route {routes}, want {want_routes}")
    kernel_s = h.kernel_seconds
    h.shutdown(wait=True)  # strict: re-runs the event and ledger cross-checks
    print(
        f"broker tasks={len(tasks)} states={json.dumps(states)} wall_s={wall} tasks_per_s={len(tasks) / wall} "
        f"kernel_s={kernel_s} launches={json.dumps(launches)} routes={json.dumps(routes)}",
        flush=True,
    )
    return launches, routes


SERVE_KERNELS = ("flash_attention", "selective_scan", "rglru_scan", "moe_gmm")  # searise_kernels' order
FACTS_INSTANCES = 64
FACTS_SAMPLES = 150_000  # benchmarks/exp4_facts.py:21

MODEL_TOL = 1e-4  # relative max error, card against CPU in fp32
# (arch, layers kept, prompt length, the launches its prefill must make)
MODEL_CHECKS = [
    ("recurrentgemma-2b", 3, 2176, {"rglru_scan": 2, "flash_attention": 1}),
    ("falcon-mamba-7b", 2, 512, {"selective_scan": 4}),
    ("llama3-8b", 2, 1000, {"flash_attention": 2}),
]
# the other two families from the model path at full width, depth cut, bf16,
# batch 1: (arch, layers kept, prompt length, the launches its prefill must
# make): 16 selective_scan chunks of 256 a layer; one causal attention a layer
MODEL_WIDTH_RUNS = [
    ("falcon-mamba-7b", 4, 4096, {"selective_scan": 64}),
    ("llama3-8b", 4, 4096, {"flash_attention": 4}),
]
SERVE = {"arch": "recurrentgemma-2b", "batch": 4, "prompt_len": 4096, "gen": 32}
SERVE_PREFILL_LAUNCHES = {"flash_attention": 8, "selective_scan": 0, "rglru_scan": 18, "moe_gmm": 0}
# the reduced configs' prefill launches: 2 dense and 2 hybrid attention
# layers, 4 recurrent layers, 2 ssm layers x 2 chunks of 8
COMPUTE_ARCHS = ("llama3-8b", "falcon-mamba-7b", "recurrentgemma-2b")
COMPUTE_LAUNCHES = {"flash_attention": 4, "selective_scan": 4, "rglru_scan": 4, "moe_gmm": 0}
# the kernels' symbols in a profiler trace (csrc/*.cu)
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd", "selective_scan": "scan_kernel", "rglru_scan": "rglru_kernel", "moe_gmm": "gmm_"}


def scenario_spec():
    """searise_at_scale with the settings searise_kernels applies."""
    from repro_torch.scenarios import presets

    spec = presets.searise_at_scale(seed=0)
    spec.traffic.serve_kernels = SERVE_KERNELS
    spec.traffic.serve_kernel_reps = 2
    spec.kernel_autotune = True
    spec.checkpoint_interval_s = 2.0
    return spec


def run_scenarios(ops, device="cuda"):
    """The scenario path on the card, chaos and no-chaos twin: run_scenario
    -> build_broker -> Hydra(device="cuda") + checkpoints + autotuner +
    autoscaler -> ChaosEngine -> WorkflowManager -> StreamingDispatcher ->
    CaaS / pilot managers -> KernelRuntime -> the kernels."""
    from repro_torch.core.staging import SHARED_SITE
    from repro_torch.scenarios import check_invariants, run_scenario, runner

    os.environ["HYDRA_EVENTS_CHECK"] = "1"
    os.environ["HYDRA_LEDGER_CHECK"] = "1"
    spec = scenario_spec()
    brokers = []
    build = runner.build_broker

    def keep(spec_, device):  # the report drops the broker; keep it to read its log
        brokers.append(build(spec_, device))
        return brokers[-1]

    runner.build_broker = keep
    reports, counts, walls = {}, {}, {}
    try:
        for chaos in (True, False):
            tag = "chaos" if chaos else "baseline"
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            reports[tag] = run_scenario(spec, chaos=chaos, device=device)
            walls[tag] = time.perf_counter() - t0
            counts[tag] = (ops.launch_counts(), ops.route_launch_counts())
    finally:
        runner.build_broker = build
    violations = check_invariants(reports["chaos"], reports["baseline"], spec)
    if violations:
        raise AssertionError(f"scenario: invariants violated: {violations}")
    for (tag, rep), h in zip(reports.items(), brokers):
        launches, routes = counts[tag]
        if rep.failed_tasks or rep.unresolved_tasks:
            raise AssertionError(f"scenario {tag}: {rep.failed_tasks} failed, {rep.unresolved_tasks} unresolved tasks")
        if rep.kernel["tunes"] != len(SERVE_KERNELS):
            raise AssertionError(f"scenario {tag}: {rep.kernel['tunes']} tunes, want {len(SERVE_KERNELS)}")
        keys = sorted(h.autotuner.results())
        for name in SERVE_KERNELS:
            mine = [k for k in keys if k.startswith(f"tune:{name}:{device}:")]
            if len(mine) != 1 or not h.staging.registry.get(mine[0]).pinned or SHARED_SITE not in h.staging.registry.locate(mine[0]):
                raise AssertionError(f"scenario {tag}: {name} winner is not one pinned shared tune:{name}:{device}: dataset ({keys})")
        executed = {name: 0 for name in SERVE_KERNELS}
        for e in h.events.events():
            if e.name == "kernel.exec":
                executed[e.attrs["kernel"]] += e.attrs["reps"]
        if launches != executed or min(launches.values()) < 1:
            raise AssertionError(f"scenario {tag}: launches {launches}, kernel.exec reps {executed}")
        for name, by in routes.items():
            if by != {"simt": launches[name], "wgmma": 0}:
                raise AssertionError(f"scenario {tag}: {name} launches by route {by}, want all {launches[name]} on simt")
        k = rep.kernel
        print(
            f"scenario name={spec.name} twin={tag} tasks={rep.n_tasks} makespan_s={rep.makespan_s} wall_s={walls[tag]} "
            f"preempted={rep.preempted_tasks} recovered={rep.recovered_tasks} first_fault_s={rep.first_fault_s} "
            f"recovery_s={rep.recovery_s} kernel_execs={k['execs']} kernel_reps={k['reps']} kernel_s={k['seconds']} "
            f"tunes={k['tunes']} launches={json.dumps(launches)} scale={json.dumps(rep.scale.get('autoscaler', {}))}",
            flush=True,
        )
    chaos, base = reports["chaos"], reports["baseline"]
    print(
        f"scenario name={spec.name} tasks={chaos.n_tasks} makespan_chaos_s={chaos.makespan_s} makespan_base_s={base.makespan_s} "
        f"inflation={chaos.makespan_s / base.makespan_s} wall_chaos_s={walls['chaos']} wall_base_s={walls['baseline']} "
        f"preempted={chaos.preempted_tasks} recovered={chaos.recovered_tasks} "
        f"kernel_execs={chaos.kernel['execs']} kernel_reps={chaos.kernel['reps']} kernel_s={chaos.kernel['seconds']} "
        f"launches={json.dumps(counts['chaos'][0])} invariants={violations}",
        flush=True,
    )
    return {tag: counts[tag][0] for tag in counts}


def run_autotune(torch, kreg, dev):
    """A wall-timed sweep of each kernel at its full tier on the card; a
    kernel task under HYDRA_AUTOTUNE=1 must resolve to the winner."""
    from repro_torch.core.managers.compute import KERNEL_RUNTIME
    from repro_torch.core.task import Task
    from repro_torch.kernels.autotune import Autotuner, set_autotuner, unset_autotuner

    tuner = Autotuner(timer="wall", device=dev, reps=5, warmup=2)
    set_autotuner(tuner)
    os.environ["HYDRA_AUTOTUNE"] = "1"
    try:
        for name in sorted(kreg.KERNELS):
            shape = dict(kreg.get_kernel(name).full_shape)
            r = tuner.tune(name, shape, "float32")
            if not r.key.startswith(f"tune:{name}:{dev.type}:"):
                raise AssertionError(f"autotune {name}: key {r.key}")
            got = KERNEL_RUNTIME.run(Task(kind="kernel", payload={"kernel": name, "shape": shape}), dev)["config"]
            if got != kreg.config_sig(r.config):
                raise AssertionError(f"autotune {name}: a kernel task resolved {got}, the tuner chose {kreg.config_sig(r.config)}")
            print(
                f"autotune kernel={name} config={kreg.config_sig(r.config)} best_ms={r.best_s * 1e3} "
                f"swept={r.swept} exhaustive={r.exhaustive} timed={len(set(r.timings.values()))}",
                flush=True,
            )
    finally:
        os.environ.pop("HYDRA_AUTOTUNE", None)
        unset_autotuner(tuner)


def run_facts(torch, Hydra, ProviderSpec, dev):
    """64 FACTS workflows on the card through the broker, then four
    instances held against the CPU."""
    import numpy as np

    from repro_torch.core.managers.workflow import WorkflowManager
    from repro_torch.facts import model as facts
    from repro_torch.facts.workflow import make_workflow, result_of

    h = Hydra(device=dev.type, pod_store="memory", policy="load_aware")
    for name in ("jet2", "aws"):
        h.register_provider(ProviderSpec(name=name, platform="cloud", connector="caas", concurrency=8))
    h.register_provider(ProviderSpec(name="bridges2", platform="hpc", connector="pilot", concurrency=8))
    wfs = [make_workflow(h.data, i, seed=0, n_samples=FACTS_SAMPLES, device=dev) for i in range(FACTS_INSTANCES)]
    t0 = time.perf_counter()
    WorkflowManager(h).run(wfs, wait=True, timeout=600)
    wall = time.perf_counter() - t0
    bad = [wf.name for wf in wfs if not wf.done or wf.failed]
    if bad:
        raise AssertionError(f"facts: {len(bad)} workflows not done: {bad[:4]}")
    for i in range(FACTS_INSTANCES):
        q = list(result_of(h.data, i)["quantiles"].values())
        if not (np.all(np.isfinite(q)) and q == sorted(q)):
            raise AssertionError(f"facts: instance {i} quantiles {q}")
    h.shutdown(wait=True)
    fit_err, proj_err = 0.0, 0.0
    for site in (0, 7, 31, 63):
        pre = facts.preprocess(site, 0)
        on_card, on_cpu = facts.fit(pre, device=dev), facts.fit(pre, device="cpu")
        for k in ("theta", "cov", "sigma2"):
            err = float(np.max(np.abs(np.asarray(on_card[k]) - on_cpu[k]) / np.abs(on_cpu[k])))
            fit_err = max(fit_err, err)
        z = facts.draws(pre, on_cpu, n_samples=FACTS_SAMPLES, seed=0, device="cpu")
        want = facts.project_from_draws(pre, on_cpu, *z)
        got = facts.project_from_draws(pre, on_cpu, *(t.to(dev) for t in z))
        for k in ("rise_mm", "trajectories"):
            proj_err = max(proj_err, float(np.abs(got[k] - want[k]).max()))
    if not (fit_err <= 1e-5 and proj_err <= 1e-3):
        raise AssertionError(f"facts: card vs CPU fit relative error {fit_err:.3e} (<= 1e-5), project max-abs {proj_err:.3e} mm (<= 1e-3)")
    print(
        f"facts instances={FACTS_INSTANCES} n_samples={FACTS_SAMPLES} wall_s={wall} instances_per_s={FACTS_INSTANCES / wall} "
        f"fit_rel_err={fit_err} project_max_abs_mm={proj_err}",
        flush=True,
    )


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, got moved to want's device."""
    got, want = got.detach().to(want.device).float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# the wrappers of ``kernels/ops.py`` the model path calls, by the kernel
# each launches on the card
PATH_WRAPPERS = {"flash_attention": "flash_attention", "selective_scan_chunk": "selective_scan", "rglru_scan": "rglru_scan"}


@contextlib.contextmanager
def path_kernels_checked(torch, ops, label):
    """Holds every kernel launch the model path makes inside the block
    against the plain version (``kernels/ref.py``) on the same operands, at
    the shapes and on the data the path gives it: each output within
    WIDTH_TOL of its dtype, relative to its largest element, and bf16
    outputs also element by element (BF16_ELEMENT_TOL).  The wrappers in
    ``ops`` are swapped for ones that call the original (the path's own
    launch, counted as ever) and then the plain version, which launches no
    kernel.  Yields {kernel: {"calls": n, "rel_err": worst}}."""
    from repro_torch.kernels import ref

    plain = {
        "flash_attention": lambda q, k, v, causal=True, window=None, **_: ref.attention_ref(q, k, v, causal=causal, window=window),
        "selective_scan_chunk": lambda x, dt, b, c, a, h0, **_: ref.selective_scan_chunk_ref(x, dt, b, c, a, h0),
        "rglru_scan": lambda log_a, gx, h0=None, **_: ref.rglru_ref(log_a, gx, h0),
    }
    seen = {kernel: {"calls": 0, "rel_err": 0.0} for kernel in PATH_WRAPPERS.values()}
    originals = {wrapper: getattr(ops, wrapper) for wrapper in PATH_WRAPPERS}

    def checked(wrapper):
        kernel = PATH_WRAPPERS[wrapper]

        def call(*args, **kw):
            got = originals[wrapper](*args, **kw)
            want = plain[wrapper](*args, **kw)
            where = f"{label}: {kernel} call {seen[kernel]['calls']}"
            for g, w in zip(as_tuple(got), as_tuple(want)):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{where}: kernel output is not finite")
                err = rel_err(g, w)
                if not err <= WIDTH_TOL[str(g.dtype).removeprefix("torch.")]:
                    raise AssertionError(f"{where}: relative error {err:.3e} against the plain version, shape {tuple(g.shape)} {g.dtype}")
                if g.dtype == torch.bfloat16:
                    check_bf16_elements(g, w, where)
                seen[kernel]["rel_err"] = max(seen[kernel]["rel_err"], err)
            seen[kernel]["calls"] += 1
            return got

        return call

    for wrapper in PATH_WRAPPERS:
        setattr(ops, wrapper, checked(wrapper))
    try:
        yield seen
    finally:
        for wrapper, fn in originals.items():
            setattr(ops, wrapper, fn)


def check_model_on_card(torch, ops, name, n_layers, prompt, want, dev):
    """One prefill at full width in fp32 on the card and on the CPU, on the
    same weights: logits and every cache leaf within MODEL_TOL, and exactly
    ``want``'s launches on the card (fp32 attention on ``simt``)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    cfg = get_arch(name).replace(n_layers=n_layers, param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, prompt)), dtype=torch.int32)
    cache_len = prompt + 8
    with torch.no_grad():
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens.to(dev)}, cache_len=cache_len)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches, routes = ops.launch_counts(), ops.route_launch_counts()
        params = tree_map(lambda t: t.cpu(), params)
        t0 = time.perf_counter()
        want_logits, want_cache = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
        cpu_s = time.perf_counter() - t0
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"model {name}: prefill launches {launches}, want {full}")
    if routes["flash_attention"] != {"simt": full["flash_attention"], "wgmma": 0}:
        raise AssertionError(f"model {name}: attention launches by route {routes['flash_attention']}, want all on simt")
    errs = [rel_err(logits, want_logits)]
    errs += [rel_err(g, w) for g, w in zip(tree_leaves(cache), tree_leaves(want_cache))]
    if not bool(torch.isfinite(logits).all()) or not max(errs) <= MODEL_TOL:
        raise AssertionError(f"model {name}: card against CPU relative errors {errs}, tolerance {MODEL_TOL:g}")
    print(
        f"model arch={name} layers={n_layers} prompt={prompt} dtype=float32 logits_rel_err={errs[0]} "
        f"cache_rel_err={max(errs[1:])} cache_leaves={len(errs) - 1} card_s={card_s} cpu_s={cpu_s} "
        f"launches={json.dumps(launches)}",
        flush=True,
    )


def run_full_width(torch, ops, name, n_layers, prompt, want, dev):
    """One bf16 prefill of the full-width config cut to ``n_layers``: finite
    logits and cache, exactly ``want``'s launches (attention on ``wgmma``);
    then the prefill's time, warm."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves

    model = Model(get_arch(name).replace(n_layers=n_layers))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (1, prompt)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        ops.reset_launch_counts()
        with path_kernels_checked(torch, ops, f"model {name}") as checked:
            logits, cache = model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
        launches, routes = ops.launch_counts(), ops.route_launch_counts()
        full = {k: want.get(k, 0) for k in launches}
        if launches != full or routes["flash_attention"] != {"simt": 0, "wgmma": full["flash_attention"]}:
            raise AssertionError(f"model {name}: prefill launches {launches} by route {routes}, want {full} (attention on wgmma)")
        if any(checked[k]["calls"] != n for k, n in full.items() if k in checked):
            raise AssertionError(f"model {name}: calls held against the plain versions {checked}, want {full}")
        if not all(bool(torch.isfinite(t).all()) for t in [logits] + tree_leaves(cache)):
            raise AssertionError(f"model {name}: prefill output is not finite")
        prefill_ms = median_ms(torch, lambda: model.prefill(params, {"tokens": tokens}), budget_s=1.0, max_reps=5)
    print(
        f"model arch={name} layers={n_layers} prompt={prompt} dtype=bfloat16 batch=1 prefill_ms={prefill_ms} "
        f"launches={json.dumps(launches)} path_checked={json.dumps(checked)}",
        flush=True,
    )


def device_profile(torch, fn, grad: bool = False):
    """``fn()`` once under torch.profiler (with grad mode on only when
    ``grad``): its wall (synchronized) and the device time of every kernel
    the trace holds, by name."""
    from torch.profiler import ProfilerActivity, profile

    with torch.set_grad_enabled(grad), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    device = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    return out, wall_s, device


def top_kernels(device: dict, n: int = 5) -> list:
    return [[name[:80], t] for name, t in sorted(device.items(), key=lambda kv: -kv[1])[:n]]


def run_serve(torch, ops, dev):
    """recurrentgemma-2b at full size, bf16: two serves on one set of
    weights (the first warms the allocator and cuBLAS and holds each kernel
    launch of its prefill against the plain version; both are checked, the
    second is reported), then the kernels' share of one more prefill."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    model = Model(get_arch(SERVE["arch"]))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    kw = {k: v for k, v in SERVE.items() if k != "arch"}
    for run in range(2):
        ops.reset_launch_counts()
        # the first serve holds each kernel launch against its plain version
        with path_kernels_checked(torch, ops, "serve") if run == 0 else contextlib.nullcontext(checked) as checked:
            out = serve(SERVE["arch"], reduced=False, device="cuda", params=params, **kw)
        routes = ops.route_launch_counts()
        if run == 0 and any(checked[k]["calls"] != n for k, n in SERVE_PREFILL_LAUNCHES.items() if k in checked):
            raise AssertionError(f"serve: calls held against the plain versions {checked}, want {SERVE_PREFILL_LAUNCHES}")
        if not out["logits_finite"]:
            raise AssertionError("serve: logits are not finite")
        if out["prefill_launches"] != SERVE_PREFILL_LAUNCHES or set(out["decode_launches"].values()) != {0}:
            raise AssertionError(f"serve: prefill launches {out['prefill_launches']} (want {SERVE_PREFILL_LAUNCHES}), decode {out['decode_launches']} (want none)")
        if routes["flash_attention"] != {"simt": 0, "wgmma": 8} or set(routes["moe_gmm"].values()) != {0}:
            raise AssertionError(f"serve: launches by route {routes}, want the 8 attention launches on wgmma")
        if out["tokens"].shape != (SERVE["batch"], SERVE["gen"]):
            raise AssertionError(f"serve: tokens of shape {out['tokens'].shape}")

    # the kernels' share of a prefill: from a profiler trace, and from the
    # two kernels timed alone at the serve's shapes times their launches
    B, L = SERVE["batch"], SERVE["prompt_len"]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, L)), dtype=torch.int32, device=dev)
    (_, cache), wall_s, device = device_profile(
        torch, lambda: model.prefill(params, {"tokens": tokens}, cache_len=L + SERVE["gen"])
    )
    busy_s = sum(device.values())
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    _, step_s, step_device = device_profile(torch, lambda: model.decode_step(params, cache, tokens[:, -1:], pos))
    kernel_s = {k: sum(t for n, t in device.items() if sym in n) for k, sym in KERNEL_SYMBOLS.items()}
    cfg = model.cfg
    g = torch.Generator(dev).manual_seed(1)
    q = torch.randn(B, cfg.n_heads, L, cfg.hd, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(B, cfg.n_kv_heads, L, cfg.hd, generator=g, device=dev).to(torch.bfloat16)
    log_a = -torch.rand(B, L, cfg.rnn_dim, generator=g, device=dev) * 0.1
    gx = torch.randn(B, L, cfg.rnn_dim, generator=g, device=dev)
    attn_ms = median_ms(torch, lambda: ops.flash_attention(q, kv, kv, causal=True, window=cfg.local_window, block_q=128, block_k=128))
    rglru_ms = median_ms(torch, lambda: ops.rglru_scan(log_a, gx))
    alone_ms = SERVE_PREFILL_LAUNCHES["flash_attention"] * attn_ms + SERVE_PREFILL_LAUNCHES["rglru_scan"] * rglru_ms
    print(
        f"serve arch={SERVE['arch']} reduced=False dtype=bfloat16 batch={B} prompt_len={L} gen={SERVE['gen']} "
        f"prefill_s={out['prefill_s']} decode_ms_per_token={out['decode_s_per_token'] * 1e3} "
        f"tokens_per_s={out['tokens_per_s']} peak_mem_gb={out['peak_mem_bytes'] / 1e9} "
        f"prefill_launches={json.dumps(out['prefill_launches'])} routes={json.dumps(routes)} "
        f"path_checked={json.dumps(checked)}",
        flush=True,
    )
    print(
        f"serve_profile prefill_wall_s={wall_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / wall_s} "
        f"kernel_s={json.dumps(kernel_s)} kernel_share={sum(kernel_s.values()) / wall_s} "
        f"attention_alone_ms={attn_ms} rglru_alone_ms={rglru_ms} kernel_share_alone={alone_ms * 1e-3 / out['prefill_s']} "
        f"trace_kernels={len(device)} top={json.dumps(top_kernels(device))}",
        flush=True,
    )
    print(
        f"serve_profile_decode step_wall_s={step_s} device_busy_s={sum(step_device.values())} "
        f"device_idle_share={1 - sum(step_device.values()) / step_s} trace_kernels={len(step_device)} "
        f"top={json.dumps(top_kernels(step_device))}",
        flush=True,
    )
    print(f"card {card_line()}", flush=True)
    return out["prefill_launches"]


def run_compute_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState):
    """kind="compute" prefill tasks, one a family, through the broker on the
    card: ComputeRuntime -> the reduced model's prefill -> the kernels."""
    import concurrent.futures as cf

    h = Hydra(device="cuda", streaming=True, pod_store="memory")
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    h.register_provider(ProviderSpec(name="hpc", platform="hpc", connector="pilot"))
    tasks = [Task(kind="compute", arch=a, step_kind="prefill", max_retries=0) for a in COMPUTE_ARCHS]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h.dispatch(tasks)
    _, pending = cf.wait(tasks, timeout=300)
    wall = time.perf_counter() - t0
    launches, routes = ops.launch_counts(), ops.route_launch_counts()
    if pending:
        raise AssertionError(f"compute: {len(pending)} tasks unfinished after 300 s")
    for t in tasks:
        if t.tstate != TaskState.DONE or t.result() != {"logits_shape": [2, 1, 256]}:
            raise AssertionError(f"compute: {t.arch} task ended {t.tstate.value}: {t.exception()!r}")
    if launches != COMPUTE_LAUNCHES or routes["flash_attention"] != {"simt": 4, "wgmma": 0}:
        raise AssertionError(f"compute: launches {launches} by route {routes}, want {COMPUTE_LAUNCHES} (attention on simt)")
    h.shutdown(wait=True)
    print(f"compute tasks={len(tasks)} archs={list(COMPUTE_ARCHS)} wall_s={wall} launches={json.dumps(launches)}", flush=True)


# -- the train path --------------------------------------------------------

# attention backward cases: (label, B, H, KV, Lq, Lk, hd, causal, window, dtype)
BWD_ATTN_CASES = [
    ("llama3_8b", 2, 32, 8, 2048, 2048, 128, True, None, "bfloat16"),
    ("recurrentgemma_2b", 1, 10, 1, 4096, 4096, 256, True, 2048, "bfloat16"),
    ("hd16_reduced", 2, 4, 2, 128, 128, 16, True, 16, "float32"),
    ("lq96_lk200_non_causal", 1, 4, 2, 96, 200, 64, False, None, "float32"),
]
BWD_RGLRU_CASE = ("recurrentgemma_2b", 1, 4096, 2560)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN = {"arch": "recurrentgemma-2b", "steps": 3, "seq_len": 4096, "global_batch": 1}
# per step of recurrentgemma-2b (8 attention and 18 recurrent layers): the
# forward runs twice under remat="dots" (once more in the backward's recompute)
TRAIN_LAUNCHES = {"flash_attention": 16, "selective_scan": 0, "rglru_scan": 36, "moe_gmm": 0}
TRAIN_BACKWARD_LAUNCHES = {"flash_attention_bwd": 8, "rglru_scan_bwd": 18}
DENSE_TRAIN = {"arch": "llama3-8b", "layers": 2, "batch": 2, "seq_len": 2048, "steps": 2}
GRAD_CHECK = {"arch": "llama3-8b", "layers": 1, "batch": 1, "seq_len": 256}
GRAD_TOL = 1e-4
TRAIN_TASKS = (("llama3-8b", 3), ("recurrentgemma-2b", 3))
# a reduced step: llama3-8b 2 attention layers; recurrentgemma-2b 2 attention
# and 4 recurrent layers (remat="none": one forward)
TRAIN_TASK_LAUNCHES = {"flash_attention": 12, "selective_scan": 0, "rglru_scan": 12, "moe_gmm": 0}
TRAIN_TASK_BACKWARD_LAUNCHES = {"flash_attention_bwd": 12, "rglru_scan_bwd": 12}
# the train step's kernels in a profiler trace: the forward kernels and the
# backward kernels' symbols (csrc/*_bwd.cu)
TRAIN_SYMBOLS = {
    "flash_attention": ("flash_fwd",), "rglru_scan": ("rglru_kernel",),
    "flash_attention_bwd": ("bwd_pre", "bwd_dkdv", "bwd_dq"), "rglru_scan_bwd": ("seg_summary", "seg_carries", "seg_walk"),
}
BACKWARD_INFO = {
    "flash_attention_bwd": ("cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu", "src/repro/models/attention.py:36"),
    "rglru_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu", "src/repro/models/rglru.py:137"),
}


def check_grads(torch, got, want, dtype: str, label: str) -> float:
    """Each output against its plain version: fp32 within BWD_TOL of its
    largest element; bf16 element by element, |got - want| <= 2e-2 |want| +
    2e-2 max|want| (gradients are small numbers: atol against the largest).
    Returns the worst max-abs error and the worst of it over the largest
    element."""
    worst, worst_abs = 0.0, 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: kernel gave {tuple(g.shape)} {g.dtype} (finite: {bool(torch.isfinite(g).all())}), plain {tuple(w.shape)} {w.dtype}")
        gf, wf = g.float(), w.float()
        scale = max(float(wf.abs().max()), 1e-30)
        err = float((gf - wf).abs().max()) / scale
        if dtype == "bfloat16":
            tol = BWD_TOL["bfloat16"]
            n_over = int(((gf - wf).abs() > tol * wf.abs() + tol * scale).sum())
            if n_over:
                raise AssertionError(f"{label}: {n_over} of {g.numel()} elements over rtol = atol = {tol:g}")
        elif not err <= BWD_TOL["float32"]:
            raise AssertionError(f"{label}: relative error {err:.3e} over {BWD_TOL['float32']:g}")
        worst, worst_abs = max(worst, err), max(worst_abs, err * scale)
    return worst_abs, worst


def attention_live_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps: the work this run's shapes need."""
    import numpy as np

    qp = np.arange(Lq)
    hi = np.minimum(Lk, qp + 1) if causal else np.full(Lq, Lk)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(Lq, dtype=np.int64)
    return int(np.maximum(0, hi - lo).sum())


def attention_bwd_bound(B, H, KV, Lq, Lk, hd, causal, window, dtype: str) -> tuple:
    """2.5x the forward's multiply-adds over the live pairs (dV, dP, dQ, dK
    and the S recompute are five products against the forward's two) on the
    peak of the operands' type, against q, k, v, o, dO read and dq, dk, dv
    written once, on the H100's data-sheet peaks."""
    from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_OPS_PER_S

    flops = 2.5 * 4 * B * H * attention_live_pairs(Lq, Lk, causal, window) * hd
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (4 * B * H * Lq * hd + 4 * B * KV * Lk * hd)
    t_ops, t_bytes = flops / PEAK_OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rglru_bwd_bound(B, L, dr) -> tuple:
    """log_a, y, dy read and dlog_a, dgx written (fp32), h0 and dh_last read
    and dh0 written, over the memory rate; its ~6 fp32 operations an element
    are far below."""
    from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_OPS_PER_S

    t_bytes = 4 * (5 * B * L * dr + 3 * B * dr) / HBM_BYTES_PER_S
    t_ops = 6 * B * L * dr / PEAK_OPS_PER_S["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_backward(torch, q, k, v, do, causal, window):
    """SDPA's autograd backward on the same operands (a yardstick the port
    never calls): a function that runs it once, or None where SDPA refuses
    the shape."""
    import torch.nn.functional as F

    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    Lq, Lk = q.shape[2], k.shape[2]
    mask = None
    if window is not None or (causal and Lq != Lk):
        qp = torch.arange(Lq, device=q.device)[:, None]
        kp = torch.arange(Lk, device=q.device)[None, :]
        mask = (qp >= kp) if causal else torch.ones(Lq, Lk, dtype=torch.bool, device=q.device)
        if window is not None:
            mask = mask & ((qp - kp) < window)
    try:
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
        torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
    except RuntimeError as e:
        print(f"train_kernel sdpa_backward refused: {e}", flush=True)
        return None
    return lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)


def check_backward_kernels(torch, ops, dev, flush):
    """Each backward kernel against its plain version on the card, timed."""
    from repro_torch.kernels import ref

    rows = {}
    for label, B, H, KV, Lq, Lk, hd, causal, window, dtype in BWD_ATTN_CASES:
        dt = getattr(torch, dtype)
        g = torch.Generator(dev).manual_seed(11)
        q = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
        k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=dev).to(dt) for _ in range(2))
        o = ref.attention_ref(q, k, v, causal=causal, window=window)
        do = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
        before = ops.backward_launch_counts()["flash_attention_bwd"]
        got = run()
        torch.cuda.synchronize()
        if ops.backward_launch_counts()["flash_attention_bwd"] != before + 1:
            raise AssertionError(f"flash_attention_bwd {label}: the wrapper did not launch its kernel")
        abs_err, err = check_grads(torch, got, ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window), dtype, f"flash_attention_bwd {label}")
        lib = sdpa_backward(torch, q, k, v, do, causal, window)
        row = {
            "kernel": "flash_attention_bwd", "case": label, "dtype": dtype, "max_abs_err": abs_err, "rel_err": err,
            "ms": median_ms(torch, run), "ms_cold": cold_ms(torch, run, flush),
            "plain_ms": median_ms(torch, lambda: ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window), max_reps=3),
            "library_ms": median_ms(torch, lib, max_reps=10) if lib is not None else None,
        }
        row["bound_ms"], row["bound_by"] = attention_bwd_bound(B, H, KV, Lq, Lk, hd, causal, window, dtype)
        print("train_kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        rows.setdefault("flash_attention_bwd", {})[label] = row
        del q, k, v, o, do, got, lib
        torch.cuda.empty_cache()
    label, B, L, dr = BWD_RGLRU_CASE
    g = torch.Generator(dev).manual_seed(12)
    log_a = -torch.rand(B, L, dr, generator=g, device=dev) * 0.1
    gx, dy = (torch.randn(B, L, dr, generator=g, device=dev) for _ in range(2))
    h0, dh = (torch.randn(B, dr, generator=g, device=dev) for _ in range(2))
    y, _ = ops.rglru_scan(log_a, gx, h0)
    run = lambda: ops.rglru_scan_bwd(log_a, h0, y, dy, dh)
    got = run()
    torch.cuda.synchronize()
    abs_err, err = check_grads(torch, got, ref.rglru_bwd_ref(log_a, h0, y, dy, dh), "float32", f"rglru_scan_bwd {label}")
    row = {
        "kernel": "rglru_scan_bwd", "case": label, "dtype": "float32", "max_abs_err": abs_err, "rel_err": err,
        "ms": median_ms(torch, run), "ms_cold": cold_ms(torch, run, flush),
        "plain_ms": median_ms(torch, lambda: ref.rglru_bwd_ref(log_a, h0, y, dy, dh), max_reps=3), "library_ms": None,
    }
    row["bound_ms"], row["bound_by"] = rglru_bwd_bound(B, L, dr)
    print("train_kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    rows["rglru_scan_bwd"] = {label: row}
    return rows


# the backward wrappers of ``kernels/ops.py`` the autograd Functions call
BACKWARD_WRAPPERS = ("flash_attention_bwd", "rglru_scan_bwd")


@contextlib.contextmanager
def backward_kernels_checked(torch, ops, label, first: dict):
    """Holds the first ``first[kernel]`` backward launches of each kernel
    (the launches of one train step) against the plain version on the
    operands the path gave them (fp32 relative 1e-4, bf16 also element by
    element; ``check_grads``): the ``ops`` wrappers are swapped for ones
    that call the original (the path's own launch, counted) and then the
    plain version.  Yields {kernel: {"calls", "rel_err"}}."""
    from repro_torch.kernels import ref

    plain = {"flash_attention_bwd": ref.attention_bwd_ref, "rglru_scan_bwd": ref.rglru_bwd_ref}
    seen = {k: {"calls": 0, "rel_err": 0.0} for k in BACKWARD_WRAPPERS}
    originals = {w: getattr(ops, w) for w in BACKWARD_WRAPPERS}

    def checked(wrapper):
        def call(*args, **kw):
            got = originals[wrapper](*args, **kw)
            if seen[wrapper]["calls"] < first.get(wrapper, 0):
                with torch.no_grad():
                    want = plain[wrapper](*args, **kw)
                dtype = str(args[0].dtype).removeprefix("torch.")
                _, err = check_grads(torch, got, want, dtype, f"{label}: {wrapper} call {seen[wrapper]['calls']}")
                seen[wrapper]["rel_err"] = max(seen[wrapper]["rel_err"], err)
                seen[wrapper]["calls"] += 1
            return got

        return call

    for w in BACKWARD_WRAPPERS:
        setattr(ops, w, checked(w))
    try:
        yield seen
    finally:
        for w, fn in originals.items():
            setattr(ops, w, fn)


@contextlib.contextmanager
def grad_leaves_counted(torch):
    """Records, for every AdamW step taken inside, the share of parameter
    leaves whose gradient has a nonzero element (``adamw.apply_updates`` is
    wrapped; the step reads it through the module)."""
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import adamw

    shares = []
    original = adamw.apply_updates

    def counted(cfg, params, grads, state):
        leaves = tree_leaves(grads)
        shares.append(float(torch.stack([g.ne(0).any() for g in leaves]).float().mean()))
        return original(cfg, params, grads, state)

    adamw.apply_updates = counted
    try:
        yield shares
    finally:
        adamw.apply_updates = original


def run_train_full_size(torch, ops, dev):
    """recurrentgemma-2b at full size, bf16, through launch/train.py."""
    from repro_torch.launch.train import train

    with backward_kernels_checked(torch, ops, "train", TRAIN_BACKWARD_LAUNCHES) as checked, grad_leaves_counted(torch) as shares:
        ops.reset_launch_counts()
        out = train(TRAIN["arch"], reduced=False, device="cuda", log_every=0,
                    steps=TRAIN["steps"], seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"])
        launches, backward = ops.launch_counts(), ops.backward_launch_counts()
    for k, n in TRAIN_BACKWARD_LAUNCHES.items():
        if checked[k]["calls"] != n:
            raise AssertionError(f"train: {checked[k]['calls']} {k} calls held against the plain version in the first step, want {n}")
    import math

    if out["steps"] != TRAIN["steps"] or not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        raise AssertionError(f"train: losses {out['losses']}, grad norms {out['grad_norms']}")
    for i, (fwd, bwd) in enumerate(zip(out["launches"], out["backward_launches"])):
        if fwd != TRAIN_LAUNCHES or bwd != TRAIN_BACKWARD_LAUNCHES:
            raise AssertionError(f"train step {i}: launches {fwd} / backward {bwd}, want {TRAIN_LAUNCHES} / {TRAIN_BACKWARD_LAUNCHES}")
    if shares != [1.0] * TRAIN["steps"]:
        raise AssertionError(f"train: share of parameter leaves with a nonzero gradient per step {shares}, want 1.0")
    if min(launches["flash_attention"], launches["rglru_scan"], *backward.values()) < 1:
        raise AssertionError(f"train: a kernel of the path was not launched: {launches} {backward}")
    print(
        f"train arch={TRAIN['arch']} reduced=False dtype=bfloat16 batch={TRAIN['global_batch']} seq_len={TRAIN['seq_len']} "
        f"steps={out['steps']} step_s={json.dumps(out['step_s'])} losses={json.dumps(out['losses'])} "
        f"grad_norms={json.dumps(out['grad_norms'])} peak_mem_gb={out['peak_mem_bytes'] / 1e9} "
        f"launches_per_step={json.dumps(out['launches'][0])} backward_launches_per_step={json.dumps(out['backward_launches'][0])} "
        f"nonzero_grad_leaf_share={json.dumps(shares)} path_checked={json.dumps(checked)}",
        flush=True,
    )
    profile_train_step(torch, out["params"], out["opt"], dev)
    del out
    return backward


def profile_train_step(torch, params, opt, dev):
    """One more recurrentgemma-2b step, on the trained state, under
    torch.profiler: the device's busy and idle time, the kernels' share and
    the largest kernels by device time."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = get_arch(TRAIN["arch"])
    fn = step_lib.make_train_step(Model(cfg), adamw.AdamWConfig())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, TRAIN["steps"]).items()}
    _, wall_s, device = device_profile(torch, lambda: fn(params, opt, batch), grad=True)
    busy_s = sum(device.values())
    kernel_s = {k: sum(t for n, t in device.items() if any(sym in n for sym in syms)) for k, syms in TRAIN_SYMBOLS.items()}
    parts = {sym: sum(t for n, t in device.items() if sym in n) for sym in TRAIN_SYMBOLS["flash_attention_bwd"] + TRAIN_SYMBOLS["rglru_scan_bwd"]}
    print(
        f"train_profile arch={TRAIN['arch']} step_wall_s={wall_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / wall_s} "
        f"kernel_s={json.dumps(kernel_s)} kernel_share={sum(kernel_s.values()) / wall_s} backward_parts_s={json.dumps(parts)} "
        f"trace_kernels={len(device)} top={json.dumps(top_kernels(device, 8))}",
        flush=True,
    )


def run_train_dense_width(torch, ops, dev):
    """llama3-8b at full width cut to DENSE_TRAIN["layers"] layers, bf16,
    through make_train_step; the first step's backward launches checked."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = get_arch(DENSE_TRAIN["arch"]).replace(n_layers=DENSE_TRAIN["layers"])
    model = Model(cfg)
    params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev)
    fn = step_lib.make_train_step(model, adamw.AdamWConfig())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=DENSE_TRAIN["seq_len"], global_batch=DENSE_TRAIN["batch"])
    torch.cuda.reset_peak_memory_stats(dev)
    n = DENSE_TRAIN["layers"]
    step_s, losses, norms, per_step = [], [], [], []
    with backward_kernels_checked(torch, ops, "train_dense", {"flash_attention_bwd": n}) as checked, grad_leaves_counted(torch) as shares:
        for i in range(DENSE_TRAIN["steps"]):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, i).items()}
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = fn(params, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            per_step.append((ops.launch_counts(), ops.backward_launch_counts()))
    for fwd, bwd in per_step:
        if fwd["flash_attention"] != 2 * n or bwd != {"flash_attention_bwd": n, "rglru_scan_bwd": 0}:
            raise AssertionError(f"train_dense: launches {fwd} / backward {bwd}, want {2 * n} attention (remat) and {n} backward")
    if checked["flash_attention_bwd"]["calls"] != n or shares != [1.0] * DENSE_TRAIN["steps"] or not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train_dense: checked {checked}, nonzero-gradient shares {shares}, losses {losses}")
    print(
        f"train arch={DENSE_TRAIN['arch']} layers={n} dtype=bfloat16 batch={DENSE_TRAIN['batch']} seq_len={DENSE_TRAIN['seq_len']} "
        f"steps={len(losses)} step_s={json.dumps(step_s)} losses={json.dumps(losses)} grad_norms={json.dumps(norms)} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 1e9} launches_per_step={json.dumps(per_step[0][0])} "
        f"backward_launches_per_step={json.dumps(per_step[0][1])} nonzero_grad_leaf_share={json.dumps(shares)} "
        f"path_checked={json.dumps(checked)}",
        flush=True,
    )


def check_grads_on_card(torch, ops, dev):
    """One loss and its gradients at full width in fp32, on the card (the
    kernels and their backwards) and on the CPU (the plain versions), on the
    same weights and tokens: every leaf within GRAD_TOL of its scale."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    cfg = get_arch(GRAD_CHECK["arch"]).replace(n_layers=GRAD_CHECK["layers"], param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=GRAD_CHECK["seq_len"], global_batch=GRAD_CHECK["batch"]), 0)

    def grads(params, device):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return loss.detach(), torch.autograd.grad(loss, leaves)

    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss_card, on_card = grads(params, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = ops.backward_launch_counts()
    on_card = [g.cpu() for g in on_card]
    params = tree_map(lambda t: t.detach().cpu(), params)
    t0 = time.perf_counter()
    loss_cpu, on_cpu = grads(params, "cpu")
    cpu_s = time.perf_counter() - t0
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(on_card, on_cpu)]
    loss_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    if launched["flash_attention_bwd"] != GRAD_CHECK["layers"] or max(errs) > GRAD_TOL or loss_err > GRAD_TOL:
        raise AssertionError(f"train_grads: backward launches {launched}, leaf errors {errs}, loss error {loss_err}")
    print(
        f"train_grads arch={GRAD_CHECK['arch']} layers={GRAD_CHECK['layers']} dtype=float32 batch={GRAD_CHECK['batch']} "
        f"seq_len={GRAD_CHECK['seq_len']} leaves={len(errs)} worst_leaf_rel_err={max(errs)} loss_rel_err={loss_err} "
        f"card_s={card_s} cpu_s={cpu_s} backward_launches={json.dumps(launched)}",
        flush=True,
    )


def run_train_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState):
    """kind="compute" train tasks through the broker on the card; the ssm
    family's fails with the typed error of its missing backward."""
    import concurrent.futures as cf
    import math

    h = Hydra(device="cuda", streaming=True, pod_store="memory")
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    tasks = [Task(kind="compute", arch=a, step_kind="train", max_retries=0) for a, n in TRAIN_TASKS for _ in range(n)]
    ssm_task = Task(kind="compute", arch="falcon-mamba-7b", step_kind="train", max_retries=0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h.dispatch(tasks + [ssm_task])
    _, pending = cf.wait(tasks + [ssm_task], timeout=300)
    wall = time.perf_counter() - t0
    launches, backward = ops.launch_counts(), ops.backward_launch_counts()
    if pending:
        raise AssertionError(f"train_tasks: {len(pending)} tasks unfinished after 300 s")
    keys = ["ce", "grad_norm", "loss", "lr", "tokens"]
    for t in tasks:
        r = t.result() if t.tstate == TaskState.DONE else None
        if r is None or sorted(r) != keys or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"train_tasks: {t.arch} task ended {t.tstate.value} with {r}: {t.exception()!r}")
    from repro_torch.kernels.ops import BackwardNotPorted

    if ssm_task.tstate != TaskState.FAILED or not isinstance(ssm_task.exception(), BackwardNotPorted):
        raise AssertionError(f"train_tasks: the falcon-mamba-7b task ended {ssm_task.tstate.value} with {ssm_task.exception()!r}, want BackwardNotPorted")
    if launches != TRAIN_TASK_LAUNCHES or backward != TRAIN_TASK_BACKWARD_LAUNCHES:
        raise AssertionError(f"train_tasks: launches {launches} / backward {backward}, want {TRAIN_TASK_LAUNCHES} / {TRAIN_TASK_BACKWARD_LAUNCHES}")
    h.shutdown(wait=True)
    print(
        f"train_tasks tasks={len(tasks)} archs={json.dumps(dict(TRAIN_TASKS))} wall_s={wall} launches={json.dumps(launches)} "
        f"backward_launches={json.dumps(backward)} last_metrics={json.dumps(tasks[-1].result())} "
        f"ssm_task={ssm_task.tstate.value} ssm_error={type(ssm_task.exception()).__name__}",
        flush=True,
    )


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on a GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Hydra, ProviderSpec, Task, TaskState
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import registry as kreg

    # -- 1. set-up -------------------------------------------------------------
    phase_t0 = time.perf_counter()
    card = card_line()
    print(f"card {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.load(*_build.SOURCES)
    print(f"build sources={list(_build.SOURCES)} dir={_build.BUILD_DIR.relative_to(ROOT)} seconds={time.perf_counter() - t0}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    print(f"phase name=setup wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 2. kernels --------------------------------------------------------------
    phase_t0 = time.perf_counter()
    for name in sorted(kreg.KERNELS):
        kdef = kreg.get_kernel(name)
        for tier in ("tiny", "smoke", "full"):
            shape = dict(getattr(kdef, f"{tier}_shape"))
            check_kernel(torch, kreg, ops, name, shape, "float32", 0, TIER_TOL, False, tier, dev, flush=flush)
    for shape, label in ATTN_VARIANTS:
        for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
            check_kernel(
                torch, kreg, ops, "flash_attention", shape, dtype, 1, tol, False, f"{label}_{dtype}", dev,
                timed=False, config={"block_q": 64, "block_k": 64},
            )
    for shape, label in HD16_CASES:
        check_kernel(
            torch, kreg, ops, "flash_attention", shape, "float32", 1, TIER_TOL, False, label, dev,
            timed=False, config={"block_q": 64, "block_k": 64},
        )
    for shape, label in GMM_CASES:
        for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
            check_kernel(torch, kreg, ops, "moe_gmm", shape, dtype, 1, tol, False, f"{label}_{dtype}", dev, timed=False)
    check_chunk_chaining(torch, ops, dev)
    for name, shape, dtype, label in SCAN_CASES:
        fp32 = dtype == "float32"
        block = {"block_d": min(shape.get("di", shape.get("dr")), 512)}
        check_kernel(
            torch, kreg, ops, name, shape, dtype, 2, TIER_TOL if fp32 else SCAN_BF16X_TOL, not fp32, label, dev,
            timed=False, config=block,
        )
    check_concurrent(torch, kreg, ops, dev)
    widths = {}
    for name, model, shape, dtype in MODEL_WIDTHS:
        row = check_kernel(torch, kreg, ops, name, shape, dtype, 0, WIDTH_TOL[dtype], True, model, dev, flush=flush)
        widths.setdefault(name, row)  # the first width of a kernel goes in the report
        if dtype == "bfloat16" and name == "flash_attention":
            # the same width in fp32, where the relative tolerance is tight
            check_kernel(torch, kreg, ops, name, shape, "float32", 0, WIDTH_TOL["float32"], True, f"{model}_fp32", dev, timed=False)
        torch.cuda.empty_cache()

    print(f"phase name=kernels wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 3. broker ---------------------------------------------------------------
    phase_t0 = time.perf_counter()
    launches, routes = run_broker(torch, kreg, ops, Hydra, ProviderSpec, Task, TaskState)
    print(f"phase name=broker wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 4. scenario -------------------------------------------------------------
    phase_t0 = time.perf_counter()
    scenario_launches = run_scenarios(ops, device="cuda")
    print(f"phase name=scenario wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 5. autotune and FACTS ---------------------------------------------------
    phase_t0 = time.perf_counter()
    run_autotune(torch, kreg, dev)
    run_facts(torch, Hydra, ProviderSpec, dev)
    print(f"phase name=autotune_facts wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 6. model ----------------------------------------------------------------
    phase_t0 = time.perf_counter()
    del flush
    torch.cuda.empty_cache()
    for name, n_layers, prompt, want in MODEL_CHECKS:
        check_model_on_card(torch, ops, name, n_layers, prompt, want, dev)
        torch.cuda.empty_cache()
    for name, n_layers, prompt, want in MODEL_WIDTH_RUNS:
        run_full_width(torch, ops, name, n_layers, prompt, want, dev)
        torch.cuda.empty_cache()
    model_launches = run_serve(torch, ops, dev)
    torch.cuda.empty_cache()
    run_compute_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState)
    print(f"phase name=model wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 7. train ----------------------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    bwd_rows = check_backward_kernels(torch, ops, dev, flush)
    del flush
    torch.cuda.empty_cache()
    train_backward = run_train_full_size(torch, ops, dev)
    torch.cuda.empty_cache()
    run_train_dense_width(torch, ops, dev)
    torch.cuda.empty_cache()
    check_grads_on_card(torch, ops, dev)
    torch.cuda.empty_cache()
    run_train_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState)
    print(f"phase name=train wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 8. report ---------------------------------------------------------------
    report = []
    for name in sorted(kreg.KERNELS):
        route, source, replaces = KERNEL_INFO[name]
        row = widths[name]
        report.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "route_launches": routes.get(name), "width_route": row["route"],
            "scenario_launches": {tag: n[name] for tag, n in scenario_launches.items()},
            "model_launches": model_launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "ms_cold": row["ms_cold"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "model": row["case"], "dtype": row["dtype"],
        })
    for name, (route, source, replaces) in BACKWARD_INFO.items():
        row = bwd_rows[name]["recurrentgemma_2b"]
        report.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "note": "backward kernel; the reference has no Pallas backward and differentiates this function with XLA",
            "launches": train_backward[name], "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
            "ms": row["ms"], "ms_cold": row["ms_cold"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "model": row["case"], "dtype": row["dtype"],
        })
    print(f"card {card_line()}", flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
