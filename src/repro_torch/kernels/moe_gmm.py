"""Grouped (per-expert) matrix product on Hopper: the launchers of
``csrc/moe_gmm.cu`` and of its backward, ``csrc/moe_gmm_bwd.cu``.

Counterpart of ``repro/kernels/moe_gmm.py``.  The kernels, their design and
what bounds them are described in the CUDA sources (``csrc/gmm.cuh`` holds
the bodies both share).  This module picks one of three kernels by
:func:`route`, launches it on CUDA tensors and counts the launches, in total
and by route, the backward's apart; ``kernels/ops.py`` checks the operands
and sends CPU tensors to the plain versions instead.

The block sizes keep only the reference's divisibility rule; the CUDA
kernels pick their own tiles and handle ragged edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_C = 128
DEFAULT_BLOCK_F = 256
DEFAULT_BLOCK_D = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1, "tf32x3": 2}

LAUNCHES = _build.LaunchCounter()
ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}
BWD_LAUNCHES = _build.LaunchCounter()  # one a backward call, which runs one kernel a gradient asked for
BWD_ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def route(dtype: torch.dtype, shape: dict) -> str:
    """Which kernel a launch takes, by rule and before it.  Where every
    global stride is a multiple of 16 bytes, as a TMA tensor map requires,
    the tensor cores, fed by TMA: ``"wgmma"`` for bf16 operands,
    ``"tf32x3"`` for fp32 ones (three TF32 products a term, fp32-accurate).
    ``"simt"`` (fp32 products on the CUDA cores) for the rest.  ``shape`` is
    a payload dict with ``D`` and ``F``."""
    # strides in bytes: x rows D * item and experts C * D * item, w rows
    # F * item and experts D * F * item: D and F decide
    item = 2 if dtype == torch.bfloat16 else 4
    if (shape["D"] * item) % 16 or (shape["F"] * item) % 16:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def check_blocks(C: int, D: int, F: int, block_c: int, block_d: int, block_f: int) -> None:
    """The reference's divisibility rule (``moe_gmm.py:53-56``)."""
    bc, bd, bf = min(block_c, C), min(block_d, D), min(block_f, F)
    if C % bc or D % bd or F % bf:
        raise ValueError(f"moe_gmm: blocks (c={bc}, d={bd}, f={bf}) must divide (C, D, F) = ({C}, {D}, {F})")


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x (E,C,D) @ w (E,D,F) -> (E,C,F) in x.dtype."""
    E, C, D = x.shape
    F = w.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm kernel: operands must be on a CUDA device, not {x.device}")
    path = route(x.dtype, {"D": D, "F": F})
    if path != "simt":
        _build.check_aligned("moe_gmm", x, w)
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    fn = _build.function("moe_gmm", "moe_gmm_fwd", _ARGTYPES)
    code = fn(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, D, F,
        DTYPES[x.dtype], ROUTES[path], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("moe_gmm", code)
    LAUNCHES.bump()
    ROUTE_LAUNCHES[path].bump()
    return y


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, need_dx: bool = True, need_dw: bool = True):
    """Launch the backward kernels: from x (E,C,D), w (E,D,F) and the
    output's gradient dy (E,C,F), dx = dy @ w^T (E,C,D) where ``need_dx`` and
    dw = x^T @ dy (E,D,F) where ``need_dw``, each in its operand's dtype
    (None where not asked), on the forward's route.  Asked for neither, it
    launches nothing."""
    E, C, D = x.shape
    F = w.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_bwd kernel: operands must be on a CUDA device, not {x.device}")
    if not (need_dx or need_dw):
        return None, None
    path = route(x.dtype, {"D": D, "F": F})
    if path != "simt":
        _build.check_aligned("moe_gmm_bwd", x, w, dy)
    dx = torch.empty((E, C, D), dtype=x.dtype, device=x.device) if need_dx else None
    dw = torch.empty((E, D, F), dtype=w.dtype, device=w.device) if need_dw else None
    fn = _build.function("moe_gmm_bwd", "moe_gmm_bwd", _BWD_ARGTYPES)
    code = fn(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr() if need_dx else None, dw.data_ptr() if need_dw else None,
        E, C, D, F, DTYPES[x.dtype], ROUTES[path], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("moe_gmm_bwd", code)
    BWD_LAUNCHES.bump()
    BWD_ROUTE_LAUNCHES[path].bump()
    return dx, dw
