"""End-to-end driver: train a ~100M-param llama-style model for a few
hundred steps with checkpoint/restart.

Counterpart of ``examples/train_lm.py``.  Runs on a CUDA device unless the
caller asks for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.train_lm [steps] [--device cpu]

Uses the full framework path: config -> Model -> AdamW -> prefetching data
pipeline -> async checkpoints (``launch/train.py``).  The model is a
~100M-param member of the llama3 family (same code path as the 8B/405B
configs; only the dimensions differ), in fp32: on the card its attention
runs the fp32 flash kernel and its backward on the ``tf32x3`` route.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.train import train

WIDTHS_100M = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000)


def main(steps: int = 200, device: str = "cuda", seq_len: int = 128, global_batch: int = 8, **widths) -> dict:
    """Train the ~100M llama (``widths`` override ``WIDTHS_100M``: a test
    cuts depth and width); the loss must fall.  Returns ``train``'s dict."""
    arch100m = get_arch("llama3-8b").replace(
        **{**WIDTHS_100M, **widths}, param_dtype="float32", compute_dtype="float32", remat="none",
    )
    print(f"training {arch100m.param_count()/1e6:.0f}M params for {steps} steps")
    ARCHS["llama3-100m"] = arch100m  # register so the driver can resolve it
    try:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            out = train(
                "llama3-100m", reduced=False, steps=steps, seq_len=seq_len, global_batch=global_batch,
                peak_lr=6e-4, ckpt_dir=ckpt_dir, ckpt_every=max(steps // 4, 1), log_every=20, device=device,
            )
    finally:
        del ARCHS["llama3-100m"]

    print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} over {out['steps']} steps")
    if not out["final_loss"] < out["first_loss"]:
        raise AssertionError("training must reduce loss")
    print("OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, device=args.device)
