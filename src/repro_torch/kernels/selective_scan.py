"""Mamba1 selective-scan chunk on Hopper: the launchers of
``csrc/selective_scan.cu`` (forward) and ``csrc/selective_scan_bwd.cu``
(backward).

Counterpart of ``repro/kernels/selective_scan.py``.  The kernel, its design
and what bounds it are described at the top of the CUDA source: threads over
(channel, state), time tiles fed by cp.async into a ring of stages.  This
module allocates the outputs, launches on the current stream and counts the
launches; ``kernels/ops.py`` checks the operands and sends CPU tensors to
the plain version instead.  The reference's ``block_d`` picks the variant
launched for fp32 x: :func:`tile` maps it onto the channels a block of the
compiled variants, and both the launch and the registry's launch key read
that one function.  Every variant handles ragged edges.
The backward (the chunk split in time over a thread-block cluster: each
part walked forward once, the parts' chains folded through distributed
shared memory, each part's segments recomputed and walked in reverse; then
a second small launch that sums the blocks' partials of dB, dC and dA in a
fixed order) has no Pallas counterpart and counts its calls apart, in
``BWD_LAUNCHES``: it is not a registry kernel.  ``bwd_launch_config`` says
how a call is cut and what the occupancy calculator makes of it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_D = 512
MAX_N = 64  # the widest state the kernel holds (csrc/selective_scan.cu: MAX_N)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the channels a block of the compiled variants (csrc/selective_scan.cu: DC,
# one instance each for fp32 x); the default block_d 512 and bf16 x take 32
CHANNELS = (8, 16, 32, 64)
MAX_THREADS = 512  # a block's threads, DC x N padded / 4, at most: past it 64 channels take 32
STAGE, NSTAGE = 64, 2  # steps a tile, tiles in flight (csrc/selective_scan.cu)

LAUNCHES = _build.LaunchCounter()

BWD_LAUNCHES = _build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def check_blocks(di: int, block_d: int) -> None:
    """The reference's divisibility rule (``selective_scan.py:60-61``)."""
    bd = min(block_d, di)
    if di % bd:
        raise ValueError(f"selective_scan_chunk: block_d {bd} must divide di {di}")


def _padded(N: int) -> int:
    """N padded to a power of two of at least 4, as the kernel holds the states."""
    return max(4, 1 << (N - 1).bit_length())


def tile(shape: dict, config: dict, dtype=torch.float32) -> tuple:
    """The variant a launch at ``shape`` ({"B", "chunk", "di", "N"}) with the
    reference's block ``config`` and x of ``dtype`` takes: (channels a
    block,).  For fp32 x, block_d / 16 rounded down to a power of two and
    held to the compiled 8 to 64 (the default 512 takes 32; a larger block
    never a smaller tile), and to 32 where 64 channels would pass
    MAX_THREADS threads (N above 32); bf16 x keeps 32.  The block is taken
    as given, as in ``rglru_scan.tile``."""
    if dtype != torch.float32:
        return (32,)
    dc = min(CHANNELS[-1], max(CHANNELS[0], config["block_d"] // 16))
    dc = 1 << (dc.bit_length() - 1)
    while dc * _padded(shape["N"]) // 4 > MAX_THREADS:
        dc //= 2
    return (dc,)


def smem_bytes(dc: int, N: int, x_dtype=torch.float32) -> int:
    """Dynamic shared memory one block of the variant takes, as
    csrc/selective_scan.cu's Smem lays it out: NSTAGE stages of dt and x
    rows (DC values and a chunk head) and of B and C rows of N padded
    floats, y staged in two tiles, the stages' mbarriers."""
    isz, npad = x_dtype.itemsize, _padded(N)
    stage = STAGE * ((dc * 4 + 16) + (dc * isz + 31) // 16 * 16 + 2 * npad * 4)
    return NSTAGE * stage + 2 * STAGE * dc * 4 + NSTAGE * 8


def _check(kernel: str, x, N: int) -> None:
    if not 1 <= N <= MAX_N:
        raise ValueError(f"{kernel} kernel: state width N = {N} is outside 1 to {MAX_N}, its limit")
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel: operands must be on a CUDA device, not {x.device}")


def selective_scan_chunk(x, dt, b, c, a, h0, config=None):
    """Launch the CUDA kernel on contiguous CUDA tensors, the variant of the
    block ``config`` (default ``{"block_d": DEFAULT_BLOCK_D}``; :func:`tile`).
    Returns (y (B, chunk, di) fp32, h_last (B, di, N) fp32)."""
    B, chunk, di = x.shape
    N = b.shape[-1]
    _check("selective_scan", x, N)
    (dc,) = tile({"B": B, "chunk": chunk, "di": di, "N": N}, config or {"block_d": DEFAULT_BLOCK_D}, x.dtype)
    _build.check_aligned("selective_scan", x, dt, b, c, a, h0)
    y = torch.empty((B, chunk, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
    fn = _build.function("selective_scan", "selective_scan_fwd", _ARGTYPES)
    code = fn(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, chunk, di, N, X_DTYPES[x.dtype], dc,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("selective_scan", code)
    LAUNCHES.bump()
    return y, h_last


def selective_scan_chunk_bwd(x, dt, b, c, a, h0, dy, dh_last):
    """Launch the backward kernel on contiguous CUDA tensors: the forward's
    operands, and the gradients dy (B, chunk, di) and dh_last (B, di, N) of
    its two outputs.  Returns (dx, ddt, db, dc, da, dh0): dx in x's dtype,
    the rest fp32.  The segment starts, the dt sums and the blocks' partial
    sums (dA's one a batch row and part) go to a per-call scratch, every
    byte of it written before it is read.  Raises where the card refuses
    the cluster launch: nothing falls back."""
    B, chunk, di = x.shape
    N = b.shape[-1]
    _check("selective_scan_bwd", x, N)
    _build.check_aligned("selective_scan_bwd", x, dt, b, c, a, h0, dy, dh_last)
    dev = x.device
    dx = torch.empty_like(x)
    ddt = torch.empty((B, chunk, di), dtype=torch.float32, device=dev)
    db = torch.empty((B, chunk, N), dtype=torch.float32, device=dev)
    dc = torch.empty((B, chunk, N), dtype=torch.float32, device=dev)
    da = torch.empty((di, N), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    scratch_bytes = _build.function("selective_scan_bwd", "selective_scan_bwd_scratch_bytes", [ctypes.c_int] * 4,
                                    ctypes.c_longlong)
    scratch = torch.empty(scratch_bytes(B, chunk, di, N), dtype=torch.uint8, device=dev)
    fn = _build.function("selective_scan_bwd", "selective_scan_bwd", _BWD_ARGTYPES)
    code = fn(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), h0.data_ptr(), dy.data_ptr(),
        dh_last.data_ptr(), dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
        dh0.data_ptr(), scratch.data_ptr(), B, chunk, di, N, X_DTYPES[x.dtype],
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("selective_scan_bwd", code)
    BWD_LAUNCHES.bump()
    return dx, ddt, db, dc, da, dh0


BWD_CONFIG_KEYS = ("parts", "blocks", "threads", "smem_bytes", "blocks_per_sm", "warps_per_sm", "active_clusters",
                   "segment_steps")


def bwd_launch_config(B: int, chunk: int, di: int, N: int, dtype, device) -> dict:
    """How the backward's walk is launched at (B, chunk, di, N) with x of
    ``dtype`` on the CUDA ``device``: its parts P (the cluster's blocks),
    blocks, threads and dynamic shared memory a block, and what the
    occupancy calculator makes of it (blocks and warps resident an SM,
    clusters resident at once), with the steps of a segment."""
    out = (ctypes.c_longlong * len(BWD_CONFIG_KEYS))()
    fn = _build.function("selective_scan_bwd", "selective_scan_bwd_describe", [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _build.check("selective_scan_bwd", fn(B, chunk, di, N, X_DTYPES[dtype], torch.device(device).index or 0,
                                          ctypes.addressof(out)))
    return dict(zip(BWD_CONFIG_KEYS, (int(v) for v in out)))
