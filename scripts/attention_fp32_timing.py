#!/usr/bin/env python3
"""Device time of the port's fp32 attention kernels, forward and backward, at
the cases chip_smoke.py holds them at, on one NVIDIA GPU.

    python3 scripts/attention_fp32_timing.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two commits can be timed on one card in one run:
unpack the other with ``git archive`` under ``build/`` and give its ``src``.
The cases are chip_smoke.py's: the registry's three fp32 attention tiers,
llama3-8b's attention width (``MODEL_WIDTHS``) and the Lq != Lk cases
(``LQ_LK_CASES``) forward, the fp32 entries of ``BWD_ATTN_CASES`` backward.
Each case prints one ``timing`` line of JSON: the route the call took (by
the kernel module's launch counters), the error against the plain version
(max-abs, and relative to the largest element), the kernel's median device
time (``ms``, chip_smoke.py's spin-kernel timing) and SDPA's device time on
the same operands with TF32 off.  The backward is timed as the package's
train step calls it: with the forward kernel's LSE where the route takes
one.  Set-up prints the card line and the ``ptxas`` lines (registers,
spills) of the sources it built.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cases(cs, kreg):
    """chip_smoke.py's fp32 attention cases: the forward's and the
    backward's, each (label, B, H, KV, Lq, Lk, hd, causal, window)."""
    kdef = kreg.get_kernel("flash_attention")
    shapes = [(tier, getattr(kdef, f"{tier}_shape")) for tier in ("tiny", "smoke", "full")]
    shapes += [(model, shape) for name, model, shape, dtype in cs.MODEL_WIDTHS
               if name == "flash_attention" and model == "llama3_8b"]
    fwd = [(label, s["B"], s["H"], s["KV"], s["L"], s["L"], s["hd"], s["causal"], s["window"]) for label, s in shapes]
    fwd += list(cs.LQ_LK_CASES)
    bwd = [c[:9] for c in cs.BWD_ATTN_CASES if c[9] == "float32"]
    return fwd, bwd


def operands(torch, case, dev):
    _, B, H, KV, Lq, Lk, hd, _, _ = case
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn(B, H, Lq, hd, generator=g, device=dev)
    k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=dev) for _ in range(2))
    do = torch.randn(B, H, Lq, hd, generator=g, device=dev)
    return q, k, v, do


def sdpa_mask(torch, Lq, Lk, causal, window, dev):
    qp = torch.arange(Lq, device=dev)[:, None]
    kp = torch.arange(Lk, device=dev)[None, :]
    mask = (qp >= kp) if causal else torch.ones(Lq, Lk, dtype=torch.bool, device=dev)
    return mask & ((qp - kp) < window) if window is not None else mask


def took(ops, name, before, counts):
    return [r for r, n in counts()[name].items() if n > before[r]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_fp32_timing: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import registry as kreg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    fwd_cases, bwd_cases = cases(cs, kreg)
    print(f"card {cs.card_line()} src={args.src}", flush=True)
    sources = [s for s in _build.SOURCES if s.startswith("flash_attention")]
    _build.load(*sources)
    for source in sources:
        for usage in _build.ptxas_usage(_build.BUILD_LOGS.get(source, "")):
            print(f"ptxas source={source} " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)

    for case in fwd_cases:
        label, B, H, KV, Lq, Lk, hd, causal, window = case
        q, k, v, _ = operands(torch, case, dev)
        before = ops.route_launch_counts()["flash_attention"]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        route = took(ops, "flash_attention", before, ops.route_launch_counts)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        err = float((got - want).abs().max())
        mask = sdpa_mask(torch, Lq, Lk, causal, window, dev)
        row = {
            "pass": "forward", "case": label, "route": route, "max_abs_err": err, "rel_err": err / float(want.abs().max()),
            "ms": cs.median_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window)),
            "sdpa_ms": cs.median_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)),
        }
        print("timing " + json.dumps(row), flush=True)
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()

    for case in bwd_cases:
        label, B, H, KV, Lq, Lk, hd, causal, window = case
        q, k, v, do = operands(torch, case, dev)
        lse = None
        if fa.bwd_route(q.dtype, hd) != "simt":  # the tensor-core routes read the forward's LSE
            lse = torch.empty(B, H, Lq, dtype=torch.float32, device=dev)
            o = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        else:
            o = ref.attention_ref(q, k, v, causal=causal, window=window)
        before = ops.backward_route_launch_counts()["flash_attention_bwd"]
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
        got = run()
        torch.cuda.synchronize()
        route = took(ops, "flash_attention_bwd", before, ops.backward_route_launch_counts)
        want = ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
        rel = max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want))
        lib = cs.sdpa_backward(torch, q, k, v, do, causal, window)
        row = {
            "pass": "backward", "case": label, "route": route, "rel_err": rel, "lse_from_forward": lse is not None,
            "ms": cs.median_ms(torch, run), "sdpa_ms": cs.median_ms(torch, lib, max_reps=10) if lib else None,
        }
        print("timing " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
