"""RG-LRU linear recurrence (RecurrentGemma) on Hopper: the launchers of
``csrc/rglru_scan.cu`` (forward) and ``csrc/rglru_scan_bwd.cu`` (backward).

Counterpart of ``repro/kernels/rglru_scan.py``.  The kernel, its design and
what bounds it are described at the top of the CUDA source: segments of the
sequence scanned in parallel, fed by cp.async, and joined by a decoupled
look-back through a per-call scratch.  This module allocates the outputs and
that scratch, launches on the current stream and counts the launches;
``kernels/ops.py`` checks the operands and sends CPU tensors to the plain
version instead.  The reference's ``block_d`` picks the variant launched:
:func:`tile` maps it onto the channels a block of the compiled variants,
and both the launch and the registry's launch key read that one function.
Every variant handles ragged edges.  The backward (a
reverse-time scan, one launch a call, the same design walking time in
reverse) has no Pallas counterpart and counts its launches apart, in
``BWD_LAUNCHES``: it is not a registry kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_D = 512
# the channels a block of the compiled variants (csrc/rglru_scan.cu: DC, one
# instance each); the default block_d 512 takes 32
CHANNELS = (8, 16, 32, 64)
SEGMENT = 256  # steps a block scans (csrc/rglru_scan.cu: T)
PARTS = 8  # a segment's parts, each walked by DC threads (csrc/rglru_scan.cu: W)

LAUNCHES = _build.LaunchCounter()

BWD_LAUNCHES = _build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def check_blocks(dr: int, block_d: int) -> None:
    """The reference's divisibility rule (``rglru_scan.py:48-49``)."""
    bd = min(block_d, dr)
    if dr % bd:
        raise ValueError(f"rglru_scan: block_d {bd} must divide dr {dr}")


def tile(shape: dict, config: dict, dtype=torch.float32) -> tuple:
    """The variant a launch at ``shape`` ({"B", "L", "dr"}) with the
    reference's block ``config`` takes: (channels a block,).  block_d / 16,
    rounded down to a power of two and held to the compiled 8 to 64, so
    the default 512 takes 32 and a larger block never a smaller tile.  The
    block is taken as given: the reference's clamp to dr changes which
    channels a block holds there, not the variant."""
    dc = min(CHANNELS[-1], max(CHANNELS[0], config["block_d"] // 16))
    return (1 << (dc.bit_length() - 1),)


def smem_bytes(dc: int) -> int:
    """Shared memory one block of the variant takes, dynamic and static, as
    csrc/rglru_scan.cu lays it out: the segment's log_a and gx tiles in rows
    of DC floats and a 16-byte chunk head, the parts' mbarriers and
    summaries, the ticket."""
    return 2 * SEGMENT * (dc * 4 + 16) + PARTS * 8 + 2 * PARTS * dc * 4 + 4


def rglru_scan(log_a, gx, h0, config=None):
    """Launch the CUDA kernel on contiguous CUDA tensors, the variant of the
    block ``config`` (default ``{"block_d": DEFAULT_BLOCK_D}``; :func:`tile`).
    Returns (y (B, L, dr) fp32, h_last (B, dr) fp32)."""
    B, L, dr = log_a.shape
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan kernel: operands must be on a CUDA device, not {log_a.device}")
    _build.check_aligned("rglru_scan", log_a, gx, h0)
    dev = log_a.device
    (dc,) = tile({"B": B, "L": L, "dr": dr}, config or {"block_d": DEFAULT_BLOCK_D})
    scratch_bytes = _build.function("rglru_scan", "rglru_scan_scratch_bytes", [ctypes.c_int] * 4, ctypes.c_longlong)
    y = torch.empty((B, L, dr), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, dr), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes(B, L, dr, dc), dtype=torch.uint8, device=dev)
    fn = _build.function("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    code = fn(
        log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), scratch.data_ptr(),
        B, L, dr, dc, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("rglru_scan", code)
    LAUNCHES.bump()
    return y, h_last


def rglru_scan_bwd(log_a, h0, y, dy, dh_last):
    """Launch the backward kernel on contiguous fp32 CUDA tensors: log_a, y,
    dy (B, L, dr), h0, dh_last (B, dr).  Returns (dlog_a, dgx, dh0), fp32.
    The segments' flags, summaries and carries go to a per-call scratch."""
    B, L, dr = log_a.shape
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd kernel: operands must be on a CUDA device, not {log_a.device}")
    dlog_a, dgx = torch.empty_like(log_a), torch.empty_like(log_a)
    dh0 = torch.empty_like(h0)
    dev = log_a.device
    scratch_bytes = _build.function("rglru_scan_bwd", "rglru_scan_bwd_scratch_bytes", [ctypes.c_int] * 3, ctypes.c_longlong)
    scratch = torch.empty(scratch_bytes(B, L, dr), dtype=torch.uint8, device=dev)
    fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd", _BWD_ARGTYPES)
    code = fn(
        log_a.data_ptr(), h0.data_ptr(), y.data_ptr(), dy.data_ptr(), dh_last.data_ptr(),
        dlog_a.data_ptr(), dgx.data_ptr(), dh0.data_ptr(), scratch.data_ptr(), B, L, dr,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("rglru_scan_bwd", code)
    BWD_LAUNCHES.bump()
    return dlog_a, dgx, dh0
