"""Serve a small model with batched requests: prefill + autoregressive
decode across three architecture families (KV cache, SSM state, hybrid).

Counterpart of ``examples/serve_lm.py``.  Runs on a CUDA device unless the
caller asks for the CPU::

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

On the card the three prefills run the flash attention, the selective scan
and the RG-LRU scan kernels.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import serve

ARCHS = ("llama3-8b", "falcon-mamba-7b", "recurrentgemma-2b")


def main(device: str = "cuda", batch: int = 4, prompt_len: int = 32, gen: int = 16) -> dict:
    """Serve each arch's reduced config; returns ``serve``'s dict by arch."""
    outs = {}
    for arch in ARCHS:
        out = serve(arch, reduced=True, batch=batch, prompt_len=prompt_len, gen=gen, temperature=0.8, device=device)
        print(f"{arch:22s} prefill {out['prefill_s']*1e3:7.1f} ms  "
              f"decode {out['decode_s_per_token']*1e3:6.1f} ms/tok  "
              f"{out['tokens_per_s']:7.1f} tok/s")
        outs[arch] = out
    print("OK")
    return outs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
