#!/usr/bin/env python3
"""Step time and peak memory of the port's plain train step at chip_smoke.py's
llama3-8b train shape (``DENSE_TRAIN``: full width, 2 of 32 layers, B2 x
2048, bf16, remat "dots", AdamW at its defaults), on one NVIDIA GPU.

    python3 scripts/train_step_timing.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two commits can be timed on one card in one run:
unpack the other with ``git archive`` under ``build/`` and give its ``src``;
run parent, this, this, parent, each in a process of its own.  Eight
steps; one JSON line: the card, each step's seconds (the first pays the
kernels' loading and the allocator's growth), their median past the
first, the peak device memory over the steps, the losses (equal bits
across two trees mean the same arithmetic) and the attention's launches a
step.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_step_timing: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    spec = cs.DENSE_TRAIN
    dev = torch.device("cuda", 0)
    cfg = get_arch(spec["arch"]).replace(**spec["cut"])
    model = Model(cfg)
    params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev)
    fn = step_lib.make_train_step(model, adamw.AdamWConfig())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"], global_batch=spec["batch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses, launches = [], [], []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, i).items()}
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = fn(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        launches.append(ops.launch_counts()["flash_attention"])
    print(json.dumps({
        "timing": "train_step", "card": cs.card_line(), "src": args.src, "arch": spec["arch"], "layers": cfg.n_layers,
        "batch": spec["batch"], "seq_len": spec["seq_len"], "remat": cfg.remat, "step_s": step_s,
        "median_step_s": statistics.median(step_s[1:]), "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "losses": losses, "attention_launches_per_step": launches,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
