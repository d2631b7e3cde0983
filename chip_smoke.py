#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and the CUDA
toolkit (``nvcc``) and Triton, and exits non-zero on any failure.  Phases:

  1. set-up: the card's name and power limit; the CUDA kernels built from
     ``src/repro_torch/kernels/csrc`` into ``build/repro_torch``; TF32 off for
     fp32 matrix products and convolutions, so the plain versions are exact.
  2. kernels: every kernel held against its plain PyTorch version on the
     card -- the registry's tiny, smoke and full tiers in fp32 (max-abs
     <= 2e-5, the reference's parity tolerance), the attention variants and
     chunk chaining of the reference tests at every head width the kernel is
     built for, and the full width of a model the repo configures (relative
     max error <= 1e-4 in fp32, <= 2e-2 in bf16; the attention widths also
     in fp32).  Every bf16 output is also held element by element (see
     BF16_ELEMENT_TOL).  One line per kernel and shape: error, the kernel's median time, the
     plain version's time, one library call's time where one exists, and the
     launches made.
  3. broker: ``Hydra(device="cuda")`` with a cloud (CaaS) and an HPC (pilot)
     provider on the card runs a backlog of noop tasks, kernel tasks at the
     registry's full shapes and one 2-rep task per model width, with the
     event and ledger cross-checks on.  Every task must end DONE, the
     ``kernel.exec`` events must reconcile with the broker's counters, and
     each kernel's launch counter must rise by exactly the reps dispatched.
  4. report: the card line, one JSON line of the kernels (route, source, the
     TPU kernel each replaces, launches in phase 3, model-width error and
     times beside the roofline bound), and the device line last.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the H100 SXM's published peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

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
    "selective_scan": ("triton", "src/repro_torch/kernels/selective_scan.py", "src/repro/kernels/selective_scan.py:65"),
    "rglru_scan": ("triton", "src/repro_torch/kernels/rglru_scan.py", "src/repro/kernels/rglru_scan.py:52"),
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
]


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


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def bound(kdef, shape: dict, dtype: str) -> tuple:
    cost = kdef.cost(shape, dtype)
    t_bytes = cost.hbm_bytes / PEAK_BYTES_PER_S
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


def check_kernel(torch, kreg, ops, name, shape, dtype, seed, tol, relative, label, dev, timed=True, config=None):
    """Kernel vs plain version on the card; raises past ``tol``."""
    kdef = kreg.get_kernel(name)
    config = config or kdef.defaults(shape)
    args = kdef.make_args(shape, dtype, seed, dev)
    before = ops.launch_counts()[name]
    got = as_tuple(kdef.call(shape, args, config))
    torch.cuda.synchronize()
    want = as_tuple(kdef.ref(shape, args))
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
            raise AssertionError(f"{name} {label}: kernel gave {g.shape} {g.dtype} on {g.device}, plain {w.shape} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {label}: kernel output is not finite")
        if g.dtype == torch.bfloat16:
            rtol, atol = BF16_ELEMENT_TOL
            gf, wf = g.float(), w.float()
            n_over = int(((gf - wf).abs() > rtol * wf.abs() + atol).sum())
            if n_over:
                raise AssertionError(f"{name} {label}: {n_over} of {g.numel()} elements over rtol {rtol:g} + atol {atol:g}")
            del gf, wf
    err = kreg.max_abs_err(got, want)
    scale = max(float(w.float().abs().max()) for w in want) if relative else 1.0
    if not err / scale <= tol:
        raise AssertionError(f"{name} {label}: error {err / scale:.3e} over tolerance {tol:g}")
    row = {"kernel": name, "case": label, "dtype": dtype, "max_abs_err": err, "rel_err": err / scale if relative else None}
    if timed:
        row["ms"] = median_ms(torch, lambda: kdef.call(shape, args, config))
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
    for t, n, _, _ in kernel_tasks:
        want_reps[n] += t.payload["reps"]
        want_execs[n] += 1

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h.dispatch(tasks)
    done, pending = cf.wait(tasks, timeout=900)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
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
    kernel_s = h.kernel_seconds
    h.shutdown(wait=True)  # strict: re-runs the event and ledger cross-checks
    print(
        f"broker tasks={len(tasks)} states={json.dumps(states)} wall_s={wall} tasks_per_s={len(tasks) / wall} "
        f"kernel_s={kernel_s} launches={json.dumps(launches)}",
        flush=True,
    )
    return launches


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
    card = card_line()
    print(f"card {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.load(*_build.SOURCES)
    print(f"build sources={list(_build.SOURCES)} dir={_build.BUILD_DIR.relative_to(ROOT)} seconds={time.perf_counter() - t0}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 2. kernels --------------------------------------------------------------
    for name in sorted(kreg.KERNELS):
        kdef = kreg.get_kernel(name)
        for tier in ("tiny", "smoke", "full"):
            shape = dict(getattr(kdef, f"{tier}_shape"))
            check_kernel(torch, kreg, ops, name, shape, "float32", 0, TIER_TOL, False, tier, dev)
    for shape, label in ATTN_VARIANTS:
        for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
            check_kernel(
                torch, kreg, ops, "flash_attention", shape, dtype, 1, tol, False, f"{label}_{dtype}", dev,
                timed=False, config={"block_q": 64, "block_k": 64},
            )
    for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
        check_kernel(torch, kreg, ops, "moe_gmm", {"E": 4, "C": 64, "D": 128, "F": 256}, dtype, 1, tol, False, f"sweep_{dtype}", dev, timed=False)
    check_chunk_chaining(torch, ops, dev)
    widths = {}
    for name, model, shape, dtype in MODEL_WIDTHS:
        row = check_kernel(torch, kreg, ops, name, shape, dtype, 0, WIDTH_TOL[dtype], True, model, dev)
        widths.setdefault(name, row)  # the first width of a kernel goes in the report
        if dtype == "bfloat16" and name == "flash_attention":
            # the same width in fp32, where the relative tolerance is tight
            check_kernel(torch, kreg, ops, name, shape, "float32", 0, WIDTH_TOL["float32"], True, f"{model}_fp32", dev, timed=False)
        torch.cuda.empty_cache()

    # -- 3. broker ---------------------------------------------------------------
    launches = run_broker(torch, kreg, ops, Hydra, ProviderSpec, Task, TaskState)

    # -- 4. report ---------------------------------------------------------------
    report = []
    for name in sorted(kreg.KERNELS):
        route, source, replaces = KERNEL_INFO[name]
        row = widths[name]
        report.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "model": row["case"], "dtype": row["dtype"],
        })
    print(f"card {card_line()}", flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
