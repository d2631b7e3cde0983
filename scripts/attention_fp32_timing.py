#!/usr/bin/env python3
"""Device time of the port's attention kernels on the TF32 tensor-core routes
(fp32, and bf16 at head width 16), forward and backward, at the cases
chip_smoke.py holds them at, on one NVIDIA GPU.

    python3 scripts/attention_fp32_timing.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two commits can be timed on one card in one run:
unpack the other with ``git archive`` under ``build/`` and give its ``src``.
The cases are chip_smoke.py's: the registry's three fp32 attention tiers,
both attention model widths in fp32 (``MODEL_WIDTHS``: llama3-8b's hd 128,
recurrentgemma-2b's hd 256), the Lq != Lk cases (``LQ_LK_CASES``) and the
reduced configs' hd 16 in bf16 (``HD16_BF16_TIMED``) forward; the fp32 and
the bf16 hd 16 entries of ``BWD_ATTN_CASES`` backward.  Each case prints one
``timing`` line of JSON: the route the call took (by the kernel module's
launch counters; ``refused`` where the tree has no kernel for it), the
error against the plain version (max-abs, and relative to the largest
element), the kernel's median device time (``ms``, chip_smoke.py's
spin-kernel timing) and SDPA's device time on the same operands with TF32
off.  The backward is timed as the package's train step calls it: with the
forward kernel's LSE where the tree's forward writes one for the case.
Set-up prints the card line and the ``ptxas`` lines (registers, spills) of
the sources it built.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cases(cs, kreg):
    """chip_smoke.py's attention cases on the TF32 routes: the forward's and
    the backward's, each (label, B, H, KV, Lq, Lk, hd, causal, window,
    dtype)."""
    kdef = kreg.get_kernel("flash_attention")
    shapes = [(tier, getattr(kdef, f"{tier}_shape"), "float32") for tier in ("tiny", "smoke", "full")]
    shapes += [(model, shape, "float32") for name, model, shape, dtype in cs.MODEL_WIDTHS if name == "flash_attention"]
    shapes.append((cs.HD16_BF16_TIMED[1], cs.HD16_BF16_TIMED[0], "bfloat16"))
    fwd = [(label, s["B"], s["H"], s["KV"], s["L"], s["L"], s["hd"], s["causal"], s["window"], dt) for label, s, dt in shapes]
    fwd += [(*c, "float32") for c in cs.LQ_LK_CASES]
    bwd = [c[:10] for c in cs.BWD_ATTN_CASES if c[9] == "float32" or c[6] == 16]
    return fwd, bwd


def operands(torch, case, dev):
    _, B, H, KV, Lq, Lk, hd, _, _, dtype = case
    dt = getattr(torch, dtype)
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=dev).to(dt) for _ in range(2))
    do = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
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
        label, B, H, KV, Lq, Lk, hd, causal, window, dtype = case
        q, k, v, _ = operands(torch, case, dev)
        mask = sdpa_mask(torch, Lq, Lk, causal, window, dev)
        row = {"pass": "forward", "case": label, "dtype": dtype,
               "sdpa_ms": cs.median_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True))}
        before = ops.route_launch_counts()["flash_attention"]
        try:
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
        except ValueError as e:  # no kernel of this tree takes the case
            row.update(route="refused", error=str(e))
        else:
            torch.cuda.synchronize()
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            row.update(route=took(ops, "flash_attention", before, ops.route_launch_counts), max_abs_err=err,
                       rel_err=err / float(want.float().abs().max()),
                       ms=cs.median_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window)))
        print("timing " + json.dumps(row), flush=True)
        del q, k, v, mask
        torch.cuda.empty_cache()

    for case in bwd_cases:
        label, B, H, KV, Lq, Lk, hd, causal, window, dtype = case
        q, k, v, do = operands(torch, case, dev)
        lse = torch.empty(B, H, Lq, dtype=torch.float32, device=dev)
        try:  # the train step's forward: o and LSE from the forward kernel
            o = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        except ValueError:  # no forward of this tree writes LSE for the case
            o, lse = ref.attention_ref(q, k, v, causal=causal, window=window), None
        before = ops.backward_route_launch_counts()["flash_attention_bwd"]
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
        got = run()
        torch.cuda.synchronize()
        route = took(ops, "flash_attention_bwd", before, ops.backward_route_launch_counts)
        want = ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
        rel = max(float((g.float() - w.float()).abs().max()) / float(w.float().abs().max()) for g, w in zip(got, want))
        lib = cs.sdpa_backward(torch, q, k, v, do, causal, window)
        row = {
            "pass": "backward", "case": label, "dtype": dtype, "route": route, "rel_err": rel, "lse_from_forward": lse is not None,
            "ms": cs.median_ms(torch, run), "sdpa_ms": cs.median_ms(torch, lib, max_reps=10) if lib else None,
        }
        print("timing " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
