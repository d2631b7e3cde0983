"""Flash attention on Hopper: the launchers of ``csrc/flash_attention.cu``
(forward) and of the backward's two routes, ``csrc/flash_attention_bwd.cu``
(``simt``) and ``csrc/flash_attention_bwd_wgmma.cu`` (``wgmma``).

Counterpart of ``repro/kernels/flash_attention.py``.  The kernels, their
design and what bounds them are described at the top of the CUDA sources.
This module picks one of the two forward kernels by :func:`route`, launches
it on CUDA tensors and counts the launches, in total and by route;
``kernels/ops.py`` checks the operands and sends CPU tensors to the plain
version instead.  The backward (dq, dk, dv) has no Pallas counterpart and
counts its launches apart, in ``BWD_LAUNCHES`` and by route in
``BWD_ROUTE_LAUNCHES``: it is not a registry kernel.  :func:`bwd_route`
picks its route: bf16 on the tensor cores, fed by the forward's LSE
(``flash_attention(..., lse=...)``); fp32 on the CUDA cores.

The block sizes keep their TPU meaning in one respect only: the same
divisibility rule holds (``min(block, L)`` must divide ``L``), so a shape the
reference rejects is rejected here too.  The CUDA kernel picks its own tiles.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
# the head widths each kernel is instantiated for (csrc/flash_attention.cu:
# dispatch_hd, dispatch_wgmma; the backward's routes the same:
# csrc/flash_attention_bwd.cu: dispatch, csrc/flash_attention_bwd_wgmma.cu);
# 16 is the reduced configs' width
HEAD_DIMS = {"simt": (16, 32, 64, 128, 256), "wgmma": (32, 64, 128, 256)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}

LAUNCHES = _build.LaunchCounter()
ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}

BWD_LAUNCHES = _build.LaunchCounter()
BWD_ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}
KV_BLOCK_ROWS = 64  # k rows a dK/dV block of the wgmma backward
STATS_PAD_ROWS = 128  # its row statistics are padded to a multiple of these query rows

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_LSE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_WGMMA_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def route(dtype: torch.dtype, shape: dict) -> str:
    """Which kernel a launch takes, by rule and before it: ``"wgmma"`` (the
    tensor cores, fed by TMA) for bf16 operands, ``"simt"`` (fp32 products
    on the CUDA cores) for fp32, which keeps fp32 exact.  ``shape`` is a
    payload dict with the head width ``hd``.  A head width the route's
    kernel is not built for raises (bf16 at 16 among them: the tensor-core
    kernel starts at 32); every one it is built for gives strides of hd and
    L*hd bf16 elements, multiples of the 16 bytes a TMA tensor map requires."""
    path = "wgmma" if dtype == torch.bfloat16 else "simt"
    hd = shape["hd"]
    if hd not in HEAD_DIMS[path]:
        raise ValueError(
            f"flash_attention kernel: head width {hd} not in {HEAD_DIMS[path]}, "
            f"the widths of the {path} route ({dtype})"
        )
    return path


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """Which backward a launch takes, by rule and before it: ``"wgmma"``
    (every product on the tensor cores, fed by TMA and by the forward's LSE)
    for bf16 at head widths 32 to 256; ``"simt"`` (fp32 products on the CUDA
    cores) for fp32, which keeps fp32 exact within 1e-4, and for bf16 at 16,
    narrower than the tensor-core kernels' smallest swizzle.  Any other width
    raises."""
    if dtype == torch.bfloat16 and hd in HEAD_DIMS["wgmma"]:
        return "wgmma"
    if dtype in DTYPES and hd in HEAD_DIMS["simt"]:
        return "simt"
    raise ValueError(
        f"flash_attention_bwd kernel: head width {hd} ({dtype}) not in {HEAD_DIMS['wgmma']} (bf16, wgmma) "
        f"or {HEAD_DIMS['simt']} (simt)"
    )


def kv_parts(b: int, n_kv: int, h: int, lk: int, n_sm: int) -> int:
    """How many dK/dV blocks of the ``wgmma`` backward share a KV head's
    ``h // n_kv`` query heads: the divisor d of that count whose grid,
    ``ceil(lk / 64) * b * n_kv * d`` blocks of one block an SM each, takes
    the fewest waves times heads a block (``ceil(blocks / n_sm) * rep / d``),
    the smallest d on a tie.  With d > 1 each part sums into an fp32 scratch
    and a last pass adds them.  recurrentgemma-2b (B1, KV1, H10, Lk 4096) on
    132 SMs: 64 blocks alone, 2 parts give 128; llama3-8b (B2, KV8, H32, Lk
    2048): 512 blocks already, 1 part."""
    rep = h // n_kv
    blocks = -(-lk // KV_BLOCK_ROWS) * b * n_kv

    def cost(d: int) -> tuple:
        return (-(-blocks * d // n_sm)) * (rep // d), d

    return min((d for d in range(1, rep + 1) if rep % d == 0), key=cost)


def stats_rows(lq: int) -> int:
    """The query rows of the ``wgmma`` backward's row statistics: Lq padded
    to a multiple of ``STATS_PAD_ROWS``."""
    return -(-lq // STATS_PAD_ROWS) * STATS_PAD_ROWS


def check_blocks(lq: int, lk: int, block_q: int, block_k: int) -> None:
    """The reference's divisibility rule (``flash_attention.py:108-110``)."""
    bq, bk = min(block_q, lq), min(block_k, lk)
    if lq % bq or lk % bk:
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}) must divide (Lq, Lk) = ({lq}, {lk})")


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, hd)
    k: torch.Tensor,  # (B, KV, Lk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors of one dtype.  On
    the ``wgmma`` route an fp32 tensor ``lse`` of (B, H, Lq) also receives
    each query row's log-sum-exp in base 2, as the backward reads it."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: operands must be on a CUDA device, not {q.device}")
    path = route(q.dtype, {"hd": hd})
    if path == "wgmma":
        _build.check_aligned("flash_attention", q, k, v)
    if lse is not None:
        if path != "wgmma":
            raise ValueError("flash_attention kernel: only the wgmma route writes lse")
        _check_lse(lse, q)
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, h, n_kv, lq, lk, hd, int(causal), int(window is not None), int(window or 0),
        DTYPES[q.dtype], ROUTES[path], q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", code)
    LAUNCHES.bump()
    ROUTE_LAUNCHES[path].bump()
    return out


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    want = tuple(q.shape[:3])
    if lse.dtype != torch.float32 or tuple(lse.shape) != want or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(
            f"flash_attention kernel: lse must be a contiguous float32 {want} tensor on {q.device}, "
            f"not {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )


def flash_attention_bwd(
    q, k, v, o, do, *, causal: bool = True, window: Optional[int] = None, lse: Optional[torch.Tensor] = None,
):
    """Launch the backward kernels on contiguous CUDA tensors of one dtype:
    q, o, do (B,H,Lq,hd), k, v (B,KV,Lk,hd).  Returns (dq, dk, dv) in that
    dtype.  ``lse`` (B,H,Lq) fp32 is the forward's log-sum-exp in base 2;
    the ``wgmma`` route reads it, or runs the ``simt`` route's preprocess
    for it where it is None.  The ``simt`` route computes its own and takes
    none."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel: operands must be on a CUDA device, not {q.device}")
    path = bwd_route(q.dtype, hd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    mask = (int(causal), int(window is not None), int(window or 0))
    if path == "simt":
        if lse is not None:
            raise ValueError("flash_attention_bwd kernel: the simt route computes its own LSE and takes none")
        stats = torch.empty((2, b * h * lq), dtype=torch.float32, device=q.device)
        fn = _build.function("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            b, h, n_kv, lq, lk, hd, *mask, DTYPES[q.dtype], q.device.index, stream,
        )
        _build.check("flash_attention_bwd", code)
    else:
        _build.check_aligned("flash_attention_bwd", q, k, v, o, do)
        if lse is None:
            pre = torch.empty((2, b, h, lq), dtype=torch.float32, device=q.device)
            fn = _build.function("flash_attention_bwd", "flash_attention_bwd_lse", _BWD_LSE_ARGTYPES)
            code = fn(
                q.data_ptr(), k.data_ptr(), o.data_ptr(), do.data_ptr(), pre[0].data_ptr(), pre[1].data_ptr(),
                b, h, n_kv, lq, lk, hd, *mask, DTYPES[q.dtype], q.device.index, stream,
            )
            _build.check("flash_attention_bwd", code)
            lse = pre[0]
        _check_lse(lse, q)
        lq_pad = stats_rows(lq)
        parts = kv_parts(b, n_kv, h, lk, torch.cuda.get_device_properties(q.device).multi_processor_count)
        stats = torch.empty((b * h * lq_pad, 2), dtype=torch.float32, device=q.device)
        scratch = torch.empty((2, parts, b, n_kv, lk, hd), dtype=torch.float32, device=q.device) if parts > 1 else None
        fn = _build.function("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma", _BWD_WGMMA_ARGTYPES)
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            scratch[0].data_ptr() if scratch is not None else None,
            scratch[1].data_ptr() if scratch is not None else None,
            b, h, n_kv, lq, lk, hd, lq_pad, parts, *mask, q.device.index, stream,
        )
        _build.check("flash_attention_bwd_wgmma", code)
    BWD_LAUNCHES.bump()
    BWD_ROUTE_LAUNCHES[path].bump()
    return dq, dk, dv
