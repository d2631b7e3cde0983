"""RG-LRU linear recurrence (RecurrentGemma) on Hopper, as a Triton kernel.

Replaces the TPU kernel ``rglru_scan`` / ``_rglru_kernel`` in
``src/repro/kernels/rglru_scan.py`` (pallas_call at line 52).

What it computes: ``h_t = exp(log_a_t) * h_{t-1} + gx_t``, elementwise over
the ``dr`` channels, for log_a and gx (B,L,dr) and h0 (B,dr) in fp32; it
returns y (B,L,dr) and the last state (B,dr), both fp32.

What bounds it on this card: 3 operations per (t, channel) on 12 bytes: bound
by memory, ~75 microseconds at the recurrentgemma width (B 2, L 4096,
dr 2560).  What holds it back in practice is the dependent walk: B*dr/32
programs each take 4096 steps, and each step waits for its two loads.  This
kernel is expected to sit far from its bound; a chunked or associative scan
over L is the later redesign.

What the design does about it: one program per (batch row, block of 32
channels) walks L in order with the state in registers, reading one
coalesced row of log_a and gx and writing one row of y per step.  Channels
are independent, so the blocks run in any order.  ``exp`` is libdevice's,
as in the selective scan (see ``kernels/selective_scan.py``).  ``block_d``
keeps only the reference's divisibility rule.
"""
# no ``from __future__ import annotations``: Triton reads the kernel's
# ``tl.constexpr`` annotations as objects
import threading

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_D = 512
BLOCK_D = 32  # channels per program (one warp)

LAUNCHES = _build.LaunchCounter()

_KERNEL = None
_LOCK = threading.Lock()  # Triton compiles at first launch: one launch at a time


def check_blocks(dr: int, block_d: int) -> None:
    """The reference's divisibility rule (``rglru_scan.py:48-49``)."""
    bd = min(block_d, dr)
    if dr % bd:
        raise ValueError(f"rglru_scan: block_d {bd} must divide dr {dr}")


def _kernel():
    """Define the Triton kernel at first use: importing this module must not
    import Triton, which the CPU-only test environment lacks."""
    global _KERNEL, triton, tl, libdevice
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    try:
        from triton.language.extra import libdevice
    except ImportError:  # Triton 3.0 keeps it under the CUDA backend
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def _rglru_kernel(loga_ptr, gx_ptr, h0_ptr, y_ptr, h_ptr, L, dr, BLOCK_D: tl.constexpr):
        pid_b = tl.program_id(0)
        offs = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
        mask = offs < dr
        h = tl.load(h0_ptr + pid_b * dr + offs, mask=mask, other=0.0)
        base = pid_b * L * dr
        for t in range(0, L):
            la = tl.load(loga_ptr + base + t * dr + offs, mask=mask, other=0.0)
            g = tl.load(gx_ptr + base + t * dr + offs, mask=mask, other=0.0)
            h = libdevice.exp(la) * h + g
            tl.store(y_ptr + base + t * dr + offs, h, mask=mask)
        tl.store(h_ptr + pid_b * dr + offs, h, mask=mask)

    _KERNEL = _rglru_kernel
    return _KERNEL


def rglru_scan(log_a, gx, h0):
    """Launch the Triton kernel on contiguous CUDA tensors.  Returns
    (y (B, L, dr) fp32, h_last (B, dr) fp32)."""
    B, L, dr = log_a.shape
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan kernel: operands must be on a CUDA device, not {log_a.device}")
    y = torch.empty((B, L, dr), dtype=torch.float32, device=log_a.device)
    h_last = torch.empty((B, dr), dtype=torch.float32, device=log_a.device)
    with _LOCK, torch.cuda.device(log_a.device):
        _kernel()[(B, -(-dr // BLOCK_D))](log_a, gx, h0, y, h_last, L, dr, BLOCK_D=BLOCK_D, num_warps=1)
    LAUNCHES.bump()
    return y, h_last
