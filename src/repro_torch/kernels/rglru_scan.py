"""RG-LRU linear recurrence (RecurrentGemma) on Hopper: the launchers of
``csrc/rglru_scan.cu`` (forward) and ``csrc/rglru_scan_bwd.cu`` (backward).

Counterpart of ``repro/kernels/rglru_scan.py``.  The kernel, its design and
what bounds it are described at the top of the CUDA source: segments of the
sequence scanned in parallel, fed by cp.async, and joined by a decoupled
look-back through a per-call scratch.  This module allocates the outputs and
that scratch, launches on the current stream and counts the launches;
``kernels/ops.py`` checks the operands and sends CPU tensors to the plain
version instead.  ``block_d`` keeps only the reference's divisibility rule;
the kernel picks its own tiles and handles ragged edges.  The backward (a
reverse-time scan) has no Pallas counterpart and counts its launches apart,
in ``BWD_LAUNCHES``: it is not a registry kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_D = 512

LAUNCHES = _build.LaunchCounter()

BWD_LAUNCHES = _build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def check_blocks(dr: int, block_d: int) -> None:
    """The reference's divisibility rule (``rglru_scan.py:48-49``)."""
    bd = min(block_d, dr)
    if dr % bd:
        raise ValueError(f"rglru_scan: block_d {bd} must divide dr {dr}")


def rglru_scan(log_a, gx, h0):
    """Launch the CUDA kernel on contiguous CUDA tensors.  Returns
    (y (B, L, dr) fp32, h_last (B, dr) fp32)."""
    B, L, dr = log_a.shape
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan kernel: operands must be on a CUDA device, not {log_a.device}")
    _build.check_aligned("rglru_scan", log_a, gx, h0)
    dev = log_a.device
    scratch_bytes = _build.function("rglru_scan", "rglru_scan_scratch_bytes", [ctypes.c_int] * 3, ctypes.c_longlong)
    y = torch.empty((B, L, dr), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, dr), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes(B, L, dr), dtype=torch.uint8, device=dev)
    fn = _build.function("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    code = fn(
        log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), scratch.data_ptr(),
        B, L, dr, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("rglru_scan", code)
    LAUNCHES.bump()
    return y, h_last


def rglru_scan_bwd(log_a, h0, y, dy, dh_last):
    """Launch the backward kernels on contiguous fp32 CUDA tensors: log_a, y,
    dy (B, L, dr), h0, dh_last (B, dr).  Returns (dlog_a, dgx, dh0), fp32.
    The segments' summaries and carries go to a per-call scratch."""
    B, L, dr = log_a.shape
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd kernel: operands must be on a CUDA device, not {log_a.device}")
    dlog_a, dgx = torch.empty_like(log_a), torch.empty_like(log_a)
    dh0 = torch.empty_like(h0)
    dev = log_a.device
    scratch_bytes = _build.function("rglru_scan_bwd", "rglru_scan_bwd_scratch_bytes", [ctypes.c_int] * 3, ctypes.c_longlong)
    scratch = torch.empty(scratch_bytes(B, L, dr) // 4, dtype=torch.float32, device=dev)
    fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd", _BWD_ARGTYPES)
    code = fn(
        log_a.data_ptr(), h0.data_ptr(), y.data_ptr(), dy.data_ptr(), dh_last.data_ptr(),
        dlog_a.data_ptr(), dgx.data_ptr(), dh0.data_ptr(), scratch.data_ptr(), B, L, dr,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("rglru_scan_bwd", code)
    BWD_LAUNCHES.bump()
    return dlog_a, dgx, dh0
