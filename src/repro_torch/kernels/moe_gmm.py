"""Grouped (per-expert) matrix product on Hopper: the launcher of ``csrc/moe_gmm.cu``.

Counterpart of ``repro/kernels/moe_gmm.py``.  The kernel, its design and what
bounds it are described at the top of the CUDA source.  This module launches
it on CUDA tensors and counts the launches; ``kernels/ops.py`` checks the
operands and sends CPU tensors to the plain version instead.

The block sizes keep only the reference's divisibility rule; the CUDA kernel
picks its own tiles and masks ragged edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_C = 128
DEFAULT_BLOCK_F = 256
DEFAULT_BLOCK_D = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = _build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    fn = _build.function("moe_gmm", "moe_gmm_fwd", _ARGTYPES)
    code = fn(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, D, F,
        DTYPES[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("moe_gmm", code)
    LAUNCHES.bump()
    return y
