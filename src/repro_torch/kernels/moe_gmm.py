"""Grouped (per-expert) matrix product on Hopper: the launchers of
``csrc/moe_gmm.cu`` and of its backward, ``csrc/moe_gmm_bwd.cu``.

Counterpart of ``repro/kernels/moe_gmm.py``.  The kernels, their design and
what bounds them are described in the CUDA sources (``csrc/gmm.cuh`` holds
the bodies both share).  This module picks one of three kernels by
:func:`route`, launches it on CUDA tensors and counts the launches, in total
and by route, the backward's apart; ``kernels/ops.py`` checks the operands
and sends CPU tensors to the plain versions instead.  Where a product's
tiles are few, the ``tf32x3`` gradients and the ``mma`` route split its
contraction over a thread-block cluster by a rule that lives in
``csrc/gmm.cuh`` (``split_of``): :func:`launch_config` asks the card what
it launches.

The block sizes keep the reference's divisibility rule, and on the
``tf32x3`` forward ``block_c`` and ``block_d`` pick the variant launched:
:func:`tile` maps them onto the C columns a block and the ring's stages,
and the launch and the registry's launch key both read that one function.
The other routes, and the backward, keep one launch each.  Every kernel
handles ragged edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_C = 128
DEFAULT_BLOCK_F = 256
DEFAULT_BLOCK_D = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"mma": 0, "wgmma": 1, "tf32x3": 2}

LAUNCHES = _build.LaunchCounter()
ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}
BWD_LAUNCHES = _build.LaunchCounter()  # one a backward call, which runs one kernel a gradient asked for
BWD_ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def route(dtype: torch.dtype, shape: dict) -> str:
    """Which kernel a launch takes, by rule and before it.  Where every
    global stride is a multiple of 16 bytes, as a TMA tensor map requires,
    the tensor cores, fed by TMA: ``"wgmma"`` for bf16 operands,
    ``"tf32x3"`` for fp32 ones (three TF32 products a term, fp32-accurate).
    ``"mma"`` (warp-level ``mma.sync`` products fed by ``cp.async``, any
    strides) for the rest.  ``shape`` is a payload dict with ``D`` and
    ``F``."""
    # strides in bytes: x rows D * item and experts C * D * item, w rows
    # F * item and experts D * F * item: D and F decide
    item = 2 if dtype == torch.bfloat16 else 4
    if (shape["D"] * item) % 16 or (shape["F"] * item) % 16:
        return "mma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


MAX_PARTS = 8  # a split's parts, at most (csrc/gmm.cuh, MAX_PARTS)


def tile(shape: dict, config: dict, dtype=torch.float32) -> tuple:
    """The variant a launch at ``shape`` ({"E", "C", "D", "F"}) with the
    reference's block ``config`` and operands of ``dtype`` takes, one of the
    compiled instances of csrc/gmm.cuh's tf32x3::Tile: on the ``tf32x3``
    route (C columns a block, stages), 64 columns where block_c
    is 64 or less, else 128 (a wider block spills the accumulators of its
    two warpgroups), and 2 stages where block_d is 256 or less, else 3, so
    the default (128, 512) takes (128, 3) and a larger block never a smaller
    tile.  The other routes have one variant: ()."""
    if route(dtype, shape) != "tf32x3":
        return ()
    return (64 if config["block_c"] <= 64 else 128, 2 if config["block_d"] <= 256 else 3)


def smem_bytes(columns: int, stages: int) -> int:
    """Dynamic shared memory one block of the tf32x3 variant takes, as
    csrc/gmm.cuh's tf32x3::Tile lays it out: 1024 bytes of alignment, the
    ring of raw stages (a B tile of ``columns`` rows and an A tile of 64,
    32 fp32 deep), the split hi and lo B tiles, and the barriers."""
    b = columns * 32 * 4
    return 1024 + stages * (b + 64 * 32 * 4) + 2 * b + 128


def check_blocks(C: int, D: int, F: int, block_c: int, block_d: int, block_f: int) -> None:
    """The reference's divisibility rule (``moe_gmm.py:53-56``)."""
    bc, bd, bf = min(block_c, C), min(block_d, D), min(block_f, F)
    if C % bc or D % bd or F % bf:
        raise ValueError(f"moe_gmm: blocks (c={bc}, d={bd}, f={bf}) must divide (C, D, F) = ({C}, {D}, {F})")


def moe_gmm(x: torch.Tensor, w: torch.Tensor, config=None) -> torch.Tensor:
    """Launch the CUDA kernel: x (E,C,D) @ w (E,D,F) -> (E,C,F) in x.dtype,
    the variant of the block ``config`` (default the reference's;
    :func:`tile`)."""
    E, C, D = x.shape
    F = w.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm kernel: operands must be on a CUDA device, not {x.device}")
    path = route(x.dtype, {"D": D, "F": F})
    if path != "mma":
        _build.check_aligned("moe_gmm", x, w)
    config = config or {"block_c": DEFAULT_BLOCK_C, "block_f": DEFAULT_BLOCK_F, "block_d": DEFAULT_BLOCK_D}
    variant = tile({"E": E, "C": C, "D": D, "F": F}, config, x.dtype) or (0, 0)
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    fn = _build.function("moe_gmm", "moe_gmm_fwd", _ARGTYPES)
    code = fn(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, D, F,
        DTYPES[x.dtype], ROUTES[path], *variant, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
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
    if path != "mma":
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


LAUNCH_CONFIG_KEYS = ("parts", "blocks", "threads", "smem_bytes", "blocks_per_sm", "warps_per_sm", "active_clusters",
                      "stages", "stages_per_part", "sms", "min_saved")


def launch_config(product: str, E: int, C: int, D: int, F: int, dtype, device, x=None, w=None, dy=None) -> dict | None:
    """How one product (``"forward"``, ``"dx"`` or ``"dw"``) at (E, C, D, F)
    is launched on the CUDA ``device`` on the route :func:`route` gives:
    its parts P (the cluster's blocks, by the rule of ``csrc/gmm.cuh``,
    ``split_of``), blocks, threads and dynamic shared memory a block, what
    the occupancy calculator makes of it (blocks and warps resident an SM,
    clusters of its parts resident at once), the stages and stages a part,
    the SMs, ``min_saved`` (the fewest stages a split must take off a
    block's walk) and ``resident``: the clusters of P blocks resident at
    once, P = 0 .. 8 (0 for P = 0), the table the rule reads.  On the
    ``mma`` route the operands' data pointers (``x``, ``w``, ``dy``;
    omitted: aligned) pick its kernel.  None where the route has no plan
    (``wgmma``; the ``tf32x3`` forward, one block a tile)."""
    path = route(dtype, {"D": D, "F": F})
    if path == "wgmma" or (path, product) == ("tf32x3", "forward"):
        return None
    ptr = lambda t: None if t is None else t.data_ptr()
    out = (ctypes.c_longlong * (len(LAUNCH_CONFIG_KEYS) + MAX_PARTS))()
    dev = torch.device(device).index or 0
    if product == "forward":
        fn = _build.function("moe_gmm", "moe_gmm_fwd_describe", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        code = fn(ptr(x), ptr(w), E, C, D, F, DTYPES[dtype], dev, ctypes.addressof(out))
        _build.check("moe_gmm", code)
    else:
        fn = _build.function("moe_gmm_bwd", "moe_gmm_bwd_describe", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        code = fn(ptr(x), ptr(w), ptr(dy), {"dx": 0, "dw": 1}[product], E, C, D, F, DTYPES[dtype], ROUTES[path], dev,
                  ctypes.addressof(out))
        _build.check("moe_gmm_bwd", code)
    vals = [int(v) for v in out]
    return {"route": path, **dict(zip(LAUNCH_CONFIG_KEYS, vals)), "resident": [0] + vals[len(LAUNCH_CONFIG_KEYS):]}
