"""Mamba1 selective-scan chunk on Hopper, as a Triton kernel.

Replaces the TPU kernel ``selective_scan_chunk`` / ``_scan_kernel`` in
``src/repro/kernels/selective_scan.py`` (pallas_call at line 65).

What it computes: one sequence chunk of the diagonal SSM recurrence

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = <h_t, C_t>

for x (B,chunk,di) in fp32 or bf16, dt (B,chunk,di), B and C (B,chunk,N),
A (di,N) and h0 (B,di,N) in fp32; it returns y (B,chunk,di) and the last
state (B,di,N), both fp32, so chunks chain through h0.

What bounds it on this card: ~6 operations per (t, channel, N) on ~12 bytes
per (t, channel): bound by memory, a few microseconds at the falcon-mamba
width.  What holds it back in practice is the dependent walk over time: each
step waits for its loads before the next can use the state.

What the design does about it: one program per (batch row, block of 32
channels) walks the chunk in order, the (32, N) state in registers, and reads
one coalesced row of dt and x and the N-wide B and C rows per step.  Channels
are independent, so the blocks run in any order.  ``exp`` is libdevice's, the
same function the plain version's ``torch.exp`` calls on the card, because
Triton's default fp32 ``exp`` is an approximation whose error the recurrence
would carry forward.  ``block_d`` keeps only the reference's divisibility
rule; the Triton block width is this module's own choice.
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


def check_blocks(di: int, block_d: int) -> None:
    """The reference's divisibility rule (``selective_scan.py:60-61``)."""
    bd = min(block_d, di)
    if di % bd:
        raise ValueError(f"selective_scan_chunk: block_d {bd} must divide di {di}")


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
    def _scan_kernel(
        x_ptr, dt_ptr, b_ptr, c_ptr, a_ptr, h0_ptr, y_ptr, h_ptr,
        chunk, di, N,
        BLOCK_D: tl.constexpr, BLOCK_N: tl.constexpr,
    ):
        pid_b = tl.program_id(0)
        offs_d = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
        offs_n = tl.arange(0, BLOCK_N)
        mask_d = offs_d < di
        mask_n = offs_n < N
        mask_dn = mask_d[:, None] & mask_n[None, :]
        dn = offs_d[:, None] * N + offs_n[None, :]
        a = tl.load(a_ptr + dn, mask=mask_dn, other=0.0)
        h = tl.load(h0_ptr + pid_b * di * N + dn, mask=mask_dn, other=0.0)
        row = pid_b * chunk * di
        bc = pid_b * chunk * N
        for t in range(0, chunk):
            dt_t = tl.load(dt_ptr + row + t * di + offs_d, mask=mask_d, other=0.0)
            x_t = tl.load(x_ptr + row + t * di + offs_d, mask=mask_d, other=0.0).to(tl.float32)
            b_t = tl.load(b_ptr + bc + t * N + offs_n, mask=mask_n, other=0.0)
            c_t = tl.load(c_ptr + bc + t * N + offs_n, mask=mask_n, other=0.0)
            da = libdevice.exp(dt_t[:, None] * a)
            h = da * h + (dt_t * x_t)[:, None] * b_t[None, :]
            y_t = tl.sum(h * c_t[None, :], axis=1)
            tl.store(y_ptr + row + t * di + offs_d, y_t, mask=mask_d)
        tl.store(h_ptr + pid_b * di * N + dn, h, mask=mask_dn)

    _KERNEL = _scan_kernel
    return _KERNEL


def selective_scan_chunk(x, dt, b, c, a, h0):
    """Launch the Triton kernel on contiguous CUDA tensors.  Returns
    (y (B, chunk, di) fp32, h_last (B, di, N) fp32)."""
    B, chunk, di = x.shape
    N = b.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan kernel: operands must be on a CUDA device, not {x.device}")
    y = torch.empty((B, chunk, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
    with _LOCK, torch.cuda.device(x.device):
        kernel = _kernel()
        kernel[(B, -(-di // BLOCK_D))](
            x, dt, b, c, a, h0, y, h_last, chunk, di, N,
            BLOCK_D=BLOCK_D, BLOCK_N=1 << (N - 1).bit_length(), num_warps=1,
        )
    LAUNCHES.bump()
    return y, h_last
