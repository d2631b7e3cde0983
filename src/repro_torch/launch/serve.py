"""Serving entry point: batched prefill + autoregressive decode with KV cache /
recurrent state (per family).

Counterpart of ``repro/launch/serve.py``.  Runs on a CUDA device unless the
caller asks for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

The prefill runs the model's kernels (flash attention, the two scans, the
expert GEMM) and the returned dict counts their launches; the decode steps
of the attention families are plain PyTorch and launch none.  The audio and
vlm families' frontend stubs (``enc_frames``, ``img_embeds``) are drawn
from the prompts' numpy generator after them, as the reference draws them.
Greedy decoding gives the reference's tokens for the same weights; with
``temperature > 0`` tokens are drawn from a ``torch.Generator`` and differ
from the reference's ``jax.random`` draws by design.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models.model import Model


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve(device='cuda') needs a CUDA device and none is visible; pass device='cpu'")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def serve(
    arch_name: str,
    *,
    reduced: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    temperature: float = 0.0,
    seed: int = 0,
    device="cuda",
    params: Optional[dict] = None,
) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens.  ``params`` (a tree on ``device``) replaces the weights
    drawn from ``seed``.  Returns the reference's dict, plus the kernel
    launches of the prefill and of the decode steps (``ops.launch_counts``
    is process-wide: run nothing else on the kernels meanwhile), whether
    every logit was finite and, on a CUDA device, the peak memory: of the
    whole serve, and of the decode steps alone beside what was allocated
    when they began."""
    dev = _device(device)
    arch = get_arch(arch_name)
    if reduced:
        arch = arch.reduced()
    model = Model(arch)
    rng = np.random.default_rng(seed)
    if params is None:
        params = model.init(torch.Generator(dev).manual_seed(seed), dev)
    prompts = torch.as_tensor(rng.integers(0, arch.vocab_size, (batch, prompt_len)), dtype=torch.int32, device=dev)
    # the frontend stubs, drawn after the prompts from the same rng, in fp32
    batch_in = {"tokens": prompts}
    if arch.family == "audio":
        frames = rng.normal(size=(batch, arch.enc_len_serve, arch.d_model))
        batch_in["enc_frames"] = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    if arch.family == "vlm":
        img = rng.normal(size=(batch, arch.n_img_tokens, arch.d_model))
        batch_in["img_embeds"] = torch.as_tensor(img, dtype=torch.float32, device=dev)
    cache_len = prompt_len + gen
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    with torch.no_grad():
        before = ops.launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch_in, cache_len=cache_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_launches = _launched(before)
        finite = bool(torch.isfinite(logits).all())

        gen_rng = torch.Generator(dev).manual_seed(seed + 1)

        def sample(lg):
            if temperature <= 0:
                return torch.argmax(lg[:, 0, :], dim=-1).to(torch.int32)
            probs = torch.softmax(lg[:, 0, :].float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen_rng)[:, 0].to(torch.int32)

        toks = sample(logits)[:, None]
        generated = [toks]
        peak = decode_start = None
        if dev.type == "cuda":  # the prefill's peak, then the decode steps' own
            peak, decode_start = torch.cuda.max_memory_allocated(dev), torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, cache, toks, pos)
            toks = sample(logits)[:, None]
            generated.append(toks)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        decode_launches = _launched(before)
        finite = finite and bool(torch.isfinite(logits).all())
    return {
        "arch": arch_name,
        "tokens": torch.cat(generated, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen - 1, 1),
        "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "prefill_launches": prefill_launches,
        "decode_launches": decode_launches,
        "logits_finite": finite,
        "peak_mem_bytes": max(peak, torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else None,
        "decode_start_mem_bytes": decode_start,
        "decode_peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "device": str(dev),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = serve(
        args.arch, reduced=args.reduced, batch=args.batch, prompt_len=args.prompt_len,
        gen=args.gen, temperature=args.temperature, device=args.device,
    )
    print(f"{args.arch} on {out['device']}: prefill {out['prefill_s']*1e3:.1f} ms, "
          f"decode {out['decode_s_per_token']*1e3:.1f} ms/tok, "
          f"{out['tokens_per_s']:.1f} tok/s, prefill launches {out['prefill_launches']}")
    print("sample tokens:", out["tokens"][0][:12].tolist())


if __name__ == "__main__":
    main()
