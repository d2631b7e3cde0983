"""Flash attention on Hopper: the launchers of ``csrc/flash_attention.cu``
(forward) and of the backward's sources, ``csrc/flash_attention_bwd_wgmma.cu``
(bf16) and ``csrc/flash_attention_bwd_tf32x3.cu`` (TF32 products), with
``csrc/flash_attention_bwd.cu``'s preprocess for a caller without the
forward's LSE.

Counterpart of ``repro/kernels/flash_attention.py``.  The kernels, their
design and what bounds them are described at the top of the CUDA sources.
This module picks one of the four routes by :func:`route`, launches it on
CUDA tensors and counts the launches, in total and by route;
``kernels/ops.py`` checks the operands and sends CPU tensors to the plain
version instead.  Every route runs on the tensor cores: ``wgmma`` (bf16 at
head widths 32 to 256), ``tf32`` (bf16 at 16, one TF32 product a product),
``tf32x3`` (fp32 at 16 to 128, three TF32 products a product) and
``tf32x3_cluster`` (fp32 at 256, the same on two-block clusters that split
the head).  The backward (dq, dk, dv) takes the forward's route, fed by its
LSE (``flash_attention(..., lse=...)``); it has no Pallas counterpart and
counts its launches apart, in ``BWD_LAUNCHES`` and by route in
``BWD_ROUTE_LAUNCHES``: it is not a registry kernel.

The block sizes keep the reference's divisibility rule (``min(block, L)``
must divide ``L``), so a shape the reference rejects is rejected here too.
On the ``tf32x3`` route ``block_k`` also picks the variant launched: the k
rows of a streamed tile (:func:`tile`), which the launch and the registry's
launch key both read.  The other routes keep one launch each.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
# the routes by dtype and the head widths each route's kernels are
# instantiated for, forward and backward (csrc/flash_attention.cu:
# dispatch_wgmma, tf32x3::dispatch; csrc/flash_attention_bwd_wgmma.cu,
# csrc/flash_attention_bwd_tf32x3.cu); 16 is the reduced configs' width, 256
# recurrentgemma-2b's
ROUTE_DIMS = {
    torch.bfloat16: {"wgmma": (32, 64, 128, 256), "tf32": (16,)},
    torch.float32: {"tf32x3": (16, 32, 64, 128), "tf32x3_cluster": (256,)},
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"wgmma": 1, "tf32x3": 2, "tf32": 3, "tf32x3_cluster": 4}
# the backward's source and entry point by route
BWD_ENTRIES = {
    "wgmma": ("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma"),
    "tf32x3": ("flash_attention_bwd_tf32x3", "flash_attention_bwd_tf32x3"),
    "tf32x3_cluster": ("flash_attention_bwd_tf32x3", "flash_attention_bwd_tf32x3"),
    "tf32": ("flash_attention_bwd_tf32x3", "flash_attention_bwd_tf32"),
}
CLUSTER_BLOCKS = {"tf32x3_cluster": 2}  # blocks a cluster that share a block's rows (else 1)

LAUNCHES = _build.LaunchCounter()
ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}

BWD_LAUNCHES = _build.LaunchCounter()
BWD_ROUTE_LAUNCHES = {r: _build.LaunchCounter() for r in ROUTES}
Q_BLOCK_ROWS = 64  # q rows a block of the TF32 forwards
K_TILE_ROWS = 32  # k rows a streamed tile of the TF32 forwards, and of the tf32x3 default variant
# the k rows a streamed tile of the compiled tf32x3 variants (csrc/flash_attention.cu:
# tf32x3::BN, one instance each a head width where it fits SMEM_BUDGET)
TF32X3_K_ROWS = (16, 32, 64)
SMEM_BUDGET = 232448  # the most shared memory one block may opt in to on sm_90
# the fewest k tiles a split of the tf32x3 forward must take off its longest
# q tile: at the registry's tiny tier 2 parts saved 2 and ran 7% slower than
# none (the merge's launch), at smoke 4 parts saved 6 and ran 1.5x faster
# (scripts/attention_fp32_timing.py, NVIDIA H100 80GB HBM3, 700 W)
MIN_TILES_SAVED = 4
KV_BLOCK_ROWS = 64  # k rows a dK/dV block of the tensor-core backwards
STATS_PAD_ROWS = 128  # their row statistics are padded to a multiple of these query rows
# blocks a k tile of 64 rows and a part of its query heads: one dK/dV block
# (wgmma), or a dK and a dV block (the TF32 routes)
KV_ROLES = {"wgmma": 1, "tf32x3": 2, "tf32x3_cluster": 2, "tf32": 2}

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_BWD_LSE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# every backward entry point (BWD_ENTRIES) takes the same arguments
_BWD_TC_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def route(dtype: torch.dtype, shape: dict) -> str:
    """Which kernel a launch takes, by rule and before it, all on the tensor
    cores: for bf16 operands ``"wgmma"`` (fed by TMA) at head widths 32 to
    256 and ``"tf32"`` (one TF32 product a product: bf16 is exact in TF32)
    at 16, narrower than the bf16 kernel's smallest swizzle; for fp32
    ``"tf32x3"`` (three TF32 products a product, at fp32 accuracy) at 16 to
    128 and ``"tf32x3_cluster"`` (the same on two-block clusters that each
    hold half the head) at 256.  ``shape`` is a payload dict with the head
    width ``hd``.  A head width or dtype no kernel is built for raises;
    every one that is gives rows of 16-byte multiples, as TMA tensor maps
    and cp.async copies require."""
    hd = shape["hd"]
    for path, dims in ROUTE_DIMS.get(dtype, {}).items():
        if hd in dims:
            return path
    raise ValueError(
        f"flash_attention kernel: head width {hd} ({dtype}) not in any route's widths "
        f"{ROUTE_DIMS.get(dtype, ROUTE_DIMS)}"
    )


def smem_bytes(hd: int, k_rows: int, dtype=torch.float32, split: int = 1) -> int:
    """Dynamic shared memory one block of the TF32 forward takes at head
    width ``hd`` with ``k_rows`` a streamed tile, as csrc/flash_attention.cu
    lays it out (tf32x3::FwdCfg): 1024 bytes of alignment, the resident Q
    tile, the split K tile and the transposed V tiles (hi and lo for fp32,
    one 32-deep tile each 32 k rows), two raw stages of K and V, and with
    ``split`` blocks a cluster the pair's exchange."""
    w = hd // split
    row = max(32, w)  # floats of a head-wide tile row: whole 128-byte chunks
    isz, tiles = (4, 2) if dtype == torch.float32 else (2, 1)
    q_t, k_t = Q_BLOCK_ROWS * row * 4, k_rows * row * 4
    v_t = w * 128 * -(-k_rows // 32)
    raw = k_rows * w * isz
    xch = 2 * Q_BLOCK_ROWS * k_rows * 4 + 16 if split > 1 else 0
    return 1024 + tiles * (q_t + k_t + v_t) + 2 * 2 * raw + xch


def tile(shape: dict, config: dict, dtype=torch.float32) -> tuple:
    """The variant a launch at ``shape`` (a payload dict with ``hd``) with
    the reference's block ``config`` and operands of ``dtype`` takes: on the
    ``tf32x3`` route (q rows a block, k rows a streamed tile), block_k / 4
    rounded down to a power of two and held to 16 to 64, then halved while
    the block's shared memory (:func:`smem_bytes`) would pass SMEM_BUDGET
    (64 at head width 128); the default 128 takes 32, and a larger block
    never a smaller one.  q rows stay 64, one warpgroup.  The
    other routes have one variant: ()."""
    if route(dtype, shape) != "tf32x3":
        return ()
    k_rows = min(TF32X3_K_ROWS[-1], max(TF32X3_K_ROWS[0], config["block_k"] // 4))
    k_rows = 1 << (k_rows.bit_length() - 1)
    while smem_bytes(shape["hd"], k_rows) > SMEM_BUDGET:
        k_rows //= 2
    return (Q_BLOCK_ROWS, k_rows)


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """Which backward a launch takes: the forward's route (``route``), whose
    forward writes the LSE the backward reads.  Any other width raises."""
    return route(dtype, {"hd": hd})


def kv_parts(b: int, n_kv: int, h: int, lk: int, n_sm: int, roles: int = 1) -> int:
    """How many blocks of the tensor-core backwards share a KV head's
    ``h // n_kv`` query heads: the divisor d of that count whose grid,
    ``roles * ceil(lk / 64) * b * n_kv * d`` blocks of one block an SM each
    (``roles``: 1 dK/dV block a k tile on ``wgmma``, a dK and a dV block on
    the TF32 routes; a two-block cluster counts as one block on ``n_sm``
    halved), takes the fewest waves times heads a block
    (``ceil(blocks / n_sm) * rep / d``), the smallest d on a tie.  With d > 1
    each part sums into an fp32 scratch and a last pass adds them.
    recurrentgemma-2b (B1, KV1, H10, Lk 4096) on 132 SMs, ``wgmma``: 64
    blocks alone, 2 parts give 128; llama3-8b (B2, KV8, H32, Lk 2048): 512
    blocks already, 1 part; the fp32 Lq96 Lk200 case (B1, KV2, H4) on
    ``tf32x3``: 16 blocks alone, 2 parts give 32."""
    rep = h // n_kv
    blocks = roles * -(-lk // KV_BLOCK_ROWS) * b * n_kv

    def cost(d: int) -> tuple:
        return (-(-blocks * d // n_sm)) * (rep // d), d

    return min((d for d in range(1, rep + 1) if rep % d == 0), key=cost)


def fwd_parts(b: int, h: int, lq: int, lk: int, causal: bool, window: Optional[int], n_sm: int) -> int:
    """How many blocks of the ``tf32x3`` forward share a q tile's k tiles
    (on ``tf32x3_cluster`` a two-block cluster counts as one block, on
    ``n_sm`` halved):
    1 where ``ceil(lq / 64) * b * h`` blocks fill half the card or more;
    else the larger of 4 and 2 whose grid still fits the card in one wave
    and takes at least ``MIN_TILES_SAVED`` k tiles (32 rows each) off the
    q tile with the most; else 1.  With d > 1 each block writes its part's
    (m, l, O) and a second kernel merges the parts.  The registry's full
    tier (B1 H8 L512: 64 blocks, 16 k tiles in the last q tile) takes 2,
    smoke (16 blocks, 8) 4, tiny (4 blocks, 4) 1, llama3-8b (2048 blocks)
    1."""
    blocks = -(-lq // Q_BLOCK_ROWS) * b * h
    if 2 * blocks > n_sm:
        return 1
    longest = 0
    for q0 in range(0, lq, Q_BLOCK_ROWS):  # the kernel's k range for each q tile
        lo = max(0, q0 - window + 1) if window is not None else 0
        hi = min(lk, q0 + Q_BLOCK_ROWS) if causal else lk
        first = lo // K_TILE_ROWS * K_TILE_ROWS
        longest = max(longest, -(-(hi - first) // K_TILE_ROWS) if hi > first else 0)
    for d in (4, 2):
        if blocks * d <= n_sm and longest - -(-longest // d) >= MIN_TILES_SAVED:
            return d
    return 1


def stats_rows(lq: int) -> int:
    """The query rows of the tensor-core backwards' row statistics: Lq
    padded to a multiple of ``STATS_PAD_ROWS``."""
    return -(-lq // STATS_PAD_ROWS) * STATS_PAD_ROWS


def check_blocks(lq: int, lk: int, block_q: int, block_k: int) -> None:
    """The reference's divisibility rule (``flash_attention.py:108-110``)."""
    bq, bk = min(block_q, lq), min(block_k, lk)
    if lq % bq or lk % bk:
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}) must divide (Lq, Lk) = ({lq}, {lk})")


def _cluster_sms(path: str, device) -> int:
    """The SMs a route's grid fills, counting a cluster as one block."""
    return torch.cuda.get_device_properties(device).multi_processor_count // CLUSTER_BLOCKS.get(path, 1)


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, hd)
    k: torch.Tensor,  # (B, KV, Lk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    lse: Optional[torch.Tensor] = None,
    config: Optional[dict] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors of one dtype, the
    variant of the block ``config`` (default the reference's; :func:`tile`).
    An fp32 tensor ``lse`` of (B, H, Lq) also receives each query row's
    log-sum-exp in base 2, as the backward reads it."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: operands must be on a CUDA device, not {q.device}")
    path = route(q.dtype, {"hd": hd})
    _build.check_aligned("flash_attention", q, k, v)
    if lse is not None:
        _check_lse(lse, q)
    out = torch.empty_like(q)
    rows = tile({"hd": hd}, config or {"block_q": DEFAULT_BLOCK_Q, "block_k": DEFAULT_BLOCK_K}, q.dtype) or (0, 0)
    parts, scratch = 1, None
    if path in ("tf32x3", "tf32x3_cluster"):
        parts = fwd_parts(b, h, lq, lk, causal, window, _cluster_sms(path, q.device))
        if parts > 1:  # each part's O and (m, l) of every row
            scratch = torch.empty(parts * b * h * lq * (hd + 2), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if lse is not None else None,
        scratch.data_ptr() if scratch is not None else None,
        b, h, n_kv, lq, lk, hd, int(causal), int(window is not None), int(window or 0), parts, *rows,
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
    where it is None the preprocess of ``csrc/flash_attention_bwd.cu``
    computes it first."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel: operands must be on a CUDA device, not {q.device}")
    path = bwd_route(q.dtype, hd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    mask = (int(causal), int(window is not None), int(window or 0))
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
    parts = kv_parts(b, n_kv, h, lk, _cluster_sms(path, q.device), KV_ROLES[path])
    stats = torch.empty((b * h * lq_pad, 2), dtype=torch.float32, device=q.device)
    scratch = torch.empty((2, parts, b, n_kv, lk, hd), dtype=torch.float32, device=q.device) if parts > 1 else None
    source, symbol = BWD_ENTRIES[path]
    fn = _build.function(source, symbol, _BWD_TC_ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        scratch[0].data_ptr() if scratch is not None else None,
        scratch[1].data_ptr() if scratch is not None else None,
        b, h, n_kv, lq, lk, hd, lq_pad, parts, *mask, q.device.index, stream,
    )
    _build.check(source, code)
    BWD_LAUNCHES.bump()
    BWD_ROUTE_LAUNCHES[path].bump()
    return dq, dk, dv
