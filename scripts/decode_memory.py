#!/usr/bin/env python3
"""Milliseconds a token and peak memory of the serve path's decode steps, on
one NVIDIA GPU.

    python3 scripts/decode_memory.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (default: this
checkout's), so that two commits can be held side by side on one card: unpack
the other with ``git archive`` under ``build/`` and run this script once a
tree, in the order parent, this, this, parent.  The cases are chip_smoke.py's
serve (``SERVE``: recurrentgemma-2b at full size, bf16, 4 prompts of 4096
tokens, 32 generated) and llama3-8b at full size at the same batch and
lengths.  Each draws its weights from seed 0 on the card, prefills, then
runs the greedy decode steps; the peak is reset after the prefill, so
``decode_peak_gb`` is the most allocated during the steps, beside
``decode_start_gb``, what was allocated when they began (weights, cache,
logits).  One ``decode_memory`` JSON line a case, after the card line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("recurrentgemma-2b", "llama3-8b")


def run_case(torch, arch_name: str, spec: dict, dev) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch(arch_name))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    B, L, gen = spec["batch"], spec["prompt_len"], spec["gen"]
    tokens = torch.randint(0, model.cfg.vocab_size, (B, L), generator=torch.Generator(dev).manual_seed(1), device=dev,
                           dtype=torch.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=L + gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        toks = logits[:, -1].argmax(-1)[:, None].int()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((B,), L + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, cache, toks, pos)
            toks = logits[:, -1].argmax(-1)[:, None].int()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (gen - 1)
    row = {"arch": arch_name, "dtype": str(model.cfg.compute_dtype), "batch": B, "prompt_len": L, "gen": gen,
           "decode_ms_per_token": ms, "decode_start_gb": start / 1e9,
           "decode_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "finite": bool(torch.isfinite(logits).all())}
    del params, cache, logits
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_memory: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    print(f"card {cs.card_line()} src={args.src}", flush=True)
    spec = {k: v for k, v in cs.SERVE.items() if k != "arch"}
    for arch_name in CASES:
        print("decode_memory " + json.dumps({"src": args.src, **run_case(torch, arch_name, spec, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
