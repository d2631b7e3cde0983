"""Flash attention (forward) on Hopper: the launcher of ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention.py``.  The kernels, their
design and what bounds them are described at the top of the CUDA source.
This module picks one of its two kernels by :func:`route`, launches it on
CUDA tensors and counts the launches, in total and by route;
``kernels/ops.py`` checks the operands and sends CPU tensors to the plain
version instead.

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
# dispatch_hd, dispatch_wgmma); 16 is the reduced configs' width
HEAD_DIMS = {"simt": (16, 32, 64, 128, 256), "wgmma": (32, 64, 128, 256)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}

LAUNCHES = _build.LaunchCounter()
ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


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
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors of one dtype."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: operands must be on a CUDA device, not {q.device}")
    path = route(q.dtype, {"hd": hd})
    if path == "wgmma":
        _build.check_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, n_kv, lq, lk, hd, int(causal), int(window is not None), int(window or 0),
        DTYPES[q.dtype], ROUTES[path], q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", code)
    LAUNCHES.bump()
    ROUTE_LAUNCHES[path].bump()
    return out
