#!/usr/bin/env python3
"""How many of a profiler trace's first kernels are lost, by warm-up.

    python3 scripts/profiler_first_kernels.py [--rounds 8]

Run from the root of a checkout on one CUDA device.  It builds the attention
kernels, warms the card the way ``chip_smoke.py``'s model phase does (the
recurrentgemma-2b, grok-1 and the two encoder-decoder and vision serves at
full size), then profiles one call of the fp32 attention backward at the
reduced configs' shape (B2 H4 KV2 L128 hd16, window 16: three kernels,
``attn_bwd_rowstats``, ``tf32_bwd_dqkv``, ``attn_bwd_kv_sum``) ``--rounds``
times behind each warm-up: ``spins=1`` (one ``torch.cuda._sleep`` kernel
of a few cycles and a synchronize before the call), ``spins=8`` (eight such,
each waited for) and ``spins=16x1.25ms`` (sixteen of 1.25 ms each, each
waited for: ``chip_smoke.py``'s ``WARMUP_SPINS`` and ``WARMUP_SPIN_S``).
One ``trial`` line a trace: the call's kernels it holds and the number of
distinct kernel names (the spin's included); one ``lost`` line a warm-up:
the traces that lacked a kernel of the call.  ROADMAP.md fault 3.8.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NEEDED = ("attn_bwd_rowstats", "tf32_bwd_dqkv", "attn_bwd_kv_sum")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        print("profiler_first_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    _build.load(*_build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    print(f"card {cs.card_line()}", flush=True)
    cs.run_serve(torch, ops, dev)
    cs.run_moe_serve(torch, ops, dev)
    for spec in cs.FAMILY_SERVES:
        cs.run_family_serve(torch, ops, dev, spec)
    torch.cuda.empty_cache()

    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn(2, 4, 128, 16, generator=g, device=dev)
    k, v = (torch.randn(2, 2, 128, 16, generator=g, device=dev) for _ in range(2))
    do = torch.randn(2, 4, 128, 16, generator=g, device=dev)
    o, lse, _ = cs.forward_with_lse(torch, q, k, v, True, 16, "probe")

    warmups = {"1": (1, 1), "8": (8, 1), "16x1.25ms": (16, cs.spin_cycles(torch, 1.25e-3))}

    def trace(warmup: str) -> set:
        spins, cycles = warmups[warmup]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda.synchronize()
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            ops.flash_attention_bwd(q, k, v, o, do, causal=True, window=16, lse=lse)
            torch.cuda.synchronize()
        return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}

    lost = {w: 0 for w in warmups}
    for r in range(args.rounds):
        for spins in lost:
            names = trace(spins)
            have = [s for s in NEEDED if any(s in n for n in names)]
            lost[spins] += int(len(have) < len(NEEDED))
            print(f"trial round={r} spins={spins} kernels={have} names={len(names)}", flush=True)
    for spins, n in lost.items():
        print(f"lost spins={spins} traces={args.rounds} lacking_a_kernel={n}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
