"""Mamba1 selective-scan chunk on Hopper: the launcher of ``csrc/selective_scan.cu``.

Counterpart of ``repro/kernels/selective_scan.py``.  The kernel, its design
and what bounds it are described at the top of the CUDA source: threads over
(channel, state), time tiles fed by cp.async into a ring of stages.  This
module allocates the outputs, launches on the current stream and counts the
launches; ``kernels/ops.py`` checks the operands and sends CPU tensors to
the plain version instead.  ``block_d`` keeps only the reference's
divisibility rule; the kernel picks its own tiles and handles ragged edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_D = 512
MAX_N = 64  # the widest state the kernel holds (csrc/selective_scan.cu: MAX_N)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = _build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def check_blocks(di: int, block_d: int) -> None:
    """The reference's divisibility rule (``selective_scan.py:60-61``)."""
    bd = min(block_d, di)
    if di % bd:
        raise ValueError(f"selective_scan_chunk: block_d {bd} must divide di {di}")


def selective_scan_chunk(x, dt, b, c, a, h0):
    """Launch the CUDA kernel on contiguous CUDA tensors.  Returns
    (y (B, chunk, di) fp32, h_last (B, di, N) fp32)."""
    B, chunk, di = x.shape
    N = b.shape[-1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"selective_scan kernel: state width N = {N} is outside 1 to {MAX_N}, its limit")
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan kernel: operands must be on a CUDA device, not {x.device}")
    _build.check_aligned("selective_scan", x, dt, b, c, a, h0)
    y = torch.empty((B, chunk, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
    fn = _build.function("selective_scan", "selective_scan_fwd", _ARGTYPES)
    code = fn(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, chunk, di, N, X_DTYPES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("selective_scan", code)
    LAUNCHES.bump()
    return y, h_last
