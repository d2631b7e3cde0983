"""Kernel registry: one shared description of every hand-written kernel.

Counterpart of ``repro/kernels/registry.py``, with the same names, payload
shapes, ``shape_sig`` and ``config_sig`` strings.  Each :class:`KernelDef`
bundles what the rest of the system needs to treat a kernel as brokered work:

  make_args     seeded, deterministic operands on a given device (same seed,
                shape, dtype and device => identical operands)
  call / ref    the routed wrapper in kernels/ops.py (explicit block config;
                the tensors' device picks kernel or plain version) and the
                plain version from kernels/ref.py
  cost          the least work of one call: the operations its inputs need
                and the bytes it must move (each input read once, each output
                written once) -- the two sides of the card's roofline bound
  space         the reference's exhaustive block sweep space for a shape
  tile_cost     the tiling arithmetic of one (shape, config) point: the
                reference's FLOPs, re-fetched tile traffic and grid cells,
                plus the shared memory one block would stage for its tiles,
                which the autotuner prices against Hopper's per-block limit
  launch_key    what a launch actually depends on for a (shape, config,
                dtype): its route and the variant the config picks, the
                launcher module's ``tile`` (the one function the launch
                reads too); the wall-timed sweep times one config per key

``from_jax_args`` carries the reference's operands across, so both packages
compute on the same numbers in the tests.

The tile arithmetic mirrors the reference's BlockSpec tiling exactly: traffic
counts one tile fetch per launched grid cell, FLOPs only the live cells, so
larger attention blocks trade masked FLOPs for fewer cells and less
re-fetched K/V -- the three-way frontier kernels/autotune.py prunes on.  The
hand kernels' fp32 routes compile a few tile variants and each launch takes
the one its config maps to (``tile`` in each launcher module): the scans'
channels a block, the ``tf32x3`` attention's k rows a streamed tile, the
``tf32x3`` GEMM's C columns a block and stages.  Configs that map to one
variant share a launch key; the other routes have one variant each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import selective_scan as _ss

# power-of-two block candidates; a config is admissible only if every block
# divides its dimension (after the kernels' own min(block, dim) clamp)
_BLOCK_CANDIDATES = (32, 64, 128, 256, 512, 1024)


@dataclass(frozen=True)
class Cost:
    """Least work of one call at one shape."""

    flops: float
    hbm_bytes: float

    @property
    def intensity(self) -> float:
        """Operations per byte moved."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0


@dataclass(frozen=True)
class TileCost:
    """Tiling arithmetic of one (shape, config) point."""

    flops: float  # live cells only
    hbm_bytes: float  # one tile fetch per launched cell
    grid_cells: int
    smem_bytes: float  # one block's tiles, staged whole in shared memory

    @property
    def intensity(self) -> float:
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0


@dataclass(frozen=True)
class KernelDef:
    name: str
    params: tuple  # config keys, canonical order
    operands: tuple  # names of make_args' tensors, in order
    defaults: Callable[[dict], dict]
    make_args: Callable[[dict, str, int, Any], tuple]
    call: Callable[[dict, tuple, dict], Any]
    ref: Callable[[dict, tuple], Any]
    cost: Callable[[dict, str], Cost]
    space: Callable[[dict], list]
    tile_cost: Callable[[dict, dict, str], TileCost]
    launch_key: Callable[[dict, dict, str], tuple]
    tiny_shape: dict  # default payload shape for kind="kernel" tasks
    smoke_shape: dict  # CI bench shape
    full_shape: dict  # nightly sweep shape


def _dtype(dtype: str) -> torch.dtype:
    out = getattr(torch, dtype, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _isz(dtype: str) -> int:
    return _dtype(dtype).itemsize


def _divisors(dim: int, candidates=_BLOCK_CANDIDATES) -> list:
    out = [c for c in candidates if c <= dim and dim % c == 0]
    return out or [dim]


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _normal(g, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def _uniform(g, shape, lo, hi, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device, dtype=torch.float32) * (hi - lo) + lo


def shape_sig(shape: dict, dtype: str) -> str:
    """Canonical shape signature used in tune-cache keys: sorted ``k=v``
    pairs + dtype, no spaces (dataset names must be stable strings)."""
    parts = [f"{k}={shape[k]}".lower() for k in sorted(shape)]
    parts.append(f"dtype={dtype}")
    return ",".join(parts)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def _fa_blocks(shape: dict, config: dict) -> tuple:
    lq = shape["L"]
    bq = min(config["block_q"], lq)
    bk = min(config["block_k"], lq)
    return bq, bk, lq // bq, lq // bk


def _fa_live_cells(shape: dict, config: dict) -> int:
    bq, bk, nq, nk = _fa_blocks(shape, config)
    window = shape.get("window")
    live = 0
    for qi in range(nq):
        for ki in range(nk):
            ok = True
            if shape.get("causal", True):
                ok = ki * bk <= qi * bq + bq - 1
            if window is not None:
                ok = ok and (qi * bq - (ki * bk + bk - 1) < window)
            live += ok
    return live


def _fa_live_pairs(shape: dict) -> int:
    """(query, key) pairs the causal and window masks leave live."""
    L, window = shape["L"], shape.get("window")
    causal = shape.get("causal", True)
    live = 0
    for qpos in range(L):
        hi = qpos + 1 if causal else L  # keys < hi
        lo = 0 if window is None else max(0, qpos - window + 1)  # keys >= lo
        live += max(0, hi - lo)
    return live


def _fa_defaults(shape: dict) -> dict:
    return {"block_q": _fa.DEFAULT_BLOCK_Q, "block_k": _fa.DEFAULT_BLOCK_K}


def _fa_make_args(shape: dict, dtype: str, seed: int, device) -> tuple:
    g = _gen(seed, device)
    B, H, KV, L, hd = shape["B"], shape["H"], shape["KV"], shape["L"], shape["hd"]
    dt = _dtype(dtype)
    q = _normal(g, (B, H, L, hd), dt, device)
    k = _normal(g, (B, KV, L, hd), dt, device)
    v = _normal(g, (B, KV, L, hd), dt, device)
    return q, k, v


def _fa_call(shape: dict, args: tuple, config: dict):
    q, k, v = args
    # both blocks clamp to L, as the reference's tune keys assume
    bq, bk, _, _ = _fa_blocks(shape, config)
    return ops.flash_attention(
        q, k, v,
        causal=shape.get("causal", True), window=shape.get("window"),
        block_q=bq, block_k=bk,
    )


def _fa_ref(shape: dict, args: tuple):
    q, k, v = args
    return _ref.attention_ref(
        q, k, v, causal=shape.get("causal", True), window=shape.get("window")
    )


def _fa_cost(shape: dict, dtype: str) -> Cost:
    B, H, KV, L, hd = shape["B"], shape["H"], shape["KV"], shape["L"], shape["hd"]
    # two products (q@k^T and p@v) over every live (query, key) pair
    flops = 4.0 * B * H * _fa_live_pairs(shape) * hd
    # q and k, v read once, the output written once
    hbm = _isz(dtype) * B * hd * L * (2 * H + 2 * KV)
    return Cost(flops, float(hbm))


def _fa_space(shape: dict) -> list:
    divs = _divisors(shape["L"], candidates=(32, 64, 128, 256, 512))
    return [{"block_q": bq, "block_k": bk} for bq in divs for bk in divs]


def _fa_tile_cost(shape: dict, config: dict, dtype: str) -> TileCost:
    B, H, hd = shape["B"], shape["H"], shape["hd"]
    isz = _isz(dtype)
    bq, bk, nq, nk = _fa_blocks(shape, config)
    live = _fa_live_cells(shape, config)
    cells = B * H * nq * nk
    # two products (q@k^T and p@v) per LIVE cell; masked cells skip math
    flops = 4.0 * B * H * live * bq * bk * hd
    # tile traffic per LAUNCHED cell: q, k and v tiles in, the output once
    hbm = isz * B * H * (nq * nk * (bq + 2 * bk) * hd + shape["L"] * hd)
    # q/k/v tiles + fp32 running max, sum and accumulator + output tile
    smem = isz * (bq + 2 * bk) * hd + 4 * bq * (2 + hd) + isz * bq * hd
    return TileCost(flops, float(hbm), cells, float(smem))


def _fa_launch_key(shape: dict, config: dict, dtype: str) -> tuple:
    bq, bk, _, _ = _fa_blocks(shape, config)  # the blocks _fa_call launches with
    return (_fa.route(_dtype(dtype), shape),) + _fa.tile(shape, {"block_q": bq, "block_k": bk}, _dtype(dtype))


# ---------------------------------------------------------------------------
# selective_scan
# ---------------------------------------------------------------------------


def _ss_defaults(shape: dict) -> dict:
    return {"block_d": _ss.DEFAULT_BLOCK_D}


def _ss_make_args(shape: dict, dtype: str, seed: int, device) -> tuple:
    g = _gen(seed, device)
    B, ck, di, N = shape["B"], shape["chunk"], shape["di"], shape["N"]
    x = _normal(g, (B, ck, di), _dtype(dtype), device)
    dt = _uniform(g, (B, ck, di), 0.001, 0.1, device)
    b = _normal(g, (B, ck, N), torch.float32, device)
    c = _normal(g, (B, ck, N), torch.float32, device)
    a = -_uniform(g, (di, N), 0.5, 2.0, device)
    h0 = torch.zeros((B, di, N), dtype=torch.float32, device=device)
    return x, dt, b, c, a, h0


def _ss_call(shape: dict, args: tuple, config: dict):
    return ops.selective_scan_chunk(*args, block_d=config["block_d"])


def _ss_ref(shape: dict, args: tuple):
    return _ref.selective_scan_chunk_ref(*args)


def _ss_cost(shape: dict, dtype: str) -> Cost:
    B, ck, di, N = shape["B"], shape["chunk"], shape["di"], shape["N"]
    # per timestep per channel: exp-discretize + state update + y reduction
    flops = 6.0 * B * ck * di * N
    hbm = (
        _isz(dtype) * B * ck * di + 4 * B * ck * di  # x, dt
        + 4 * (2 * B * ck * N + di * N + B * di * N)  # b, c, a, h0
        + 4 * (B * ck * di + B * di * N)  # y, h_last
    )
    return Cost(flops, float(hbm))


def _ss_space(shape: dict) -> list:
    return [{"block_d": bd} for bd in _divisors(shape["di"])]


def _ss_tile_cost(shape: dict, config: dict, dtype: str) -> TileCost:
    B, ck, di, N = shape["B"], shape["chunk"], shape["di"], shape["N"]
    isz = _isz(dtype)
    bd = min(config["block_d"], di)
    cells = B * (di // bd)
    flops = 6.0 * B * ck * di * N
    # per cell: x/dt in, B/C in (re-fetched per d-block: the config lever),
    # a + h0 in, y + h out
    per_cell = (
        isz * ck * bd + 4 * ck * bd  # x (dtype) + dt (f32)
        + 4 * (2 * ck * N + 2 * bd * N)  # b, c, a, h0
        + 4 * (ck * bd + bd * N)  # y, h_last
    )
    smem = isz * ck * bd + 4 * (2 * ck * bd + 2 * ck * N + 3 * bd * N)
    return TileCost(flops, float(cells * per_cell), cells, float(smem))


def _ss_launch_key(shape: dict, config: dict, dtype: str) -> tuple:
    """The scan has one route; its variant is ``selective_scan.tile``'s."""
    return ("cuda",) + _ss.tile(shape, config, _dtype(dtype))


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------


def _rg_defaults(shape: dict) -> dict:
    return {"block_d": _rg.DEFAULT_BLOCK_D}


def _rg_make_args(shape: dict, dtype: str, seed: int, device) -> tuple:
    g = _gen(seed, device)
    B, L, dr = shape["B"], shape["L"], shape["dr"]
    log_a = -_uniform(g, (B, L, dr), 0.01, 1.0, device)
    gx = _normal(g, (B, L, dr), torch.float32, device)
    h0 = torch.zeros((B, dr), dtype=torch.float32, device=device)
    return log_a, gx, h0


def _rg_call(shape: dict, args: tuple, config: dict):
    return ops.rglru_scan(*args, block_d=config["block_d"])


def _rg_ref(shape: dict, args: tuple):
    return _ref.rglru_ref(*args)


def _rg_cost(shape: dict, dtype: str) -> Cost:
    B, L, dr = shape["B"], shape["L"], shape["dr"]
    # exp + multiply-add per (t, channel); log_a, gx and y touched once
    flops = 3.0 * B * L * dr
    hbm = 4.0 * (3 * B * L * dr + 2 * B * dr)
    return Cost(flops, hbm)


def _rg_space(shape: dict) -> list:
    return [{"block_d": bd} for bd in _divisors(shape["dr"])]


def _rg_launch_key(shape: dict, config: dict, dtype: str) -> tuple:
    """The scan has one route; its variant is ``rglru_scan.tile``'s."""
    return ("cuda",) + _rg.tile(shape, config, _dtype(dtype))


def _rg_tile_cost(shape: dict, config: dict, dtype: str) -> TileCost:
    B, L, dr = shape["B"], shape["L"], shape["dr"]
    bd = min(config["block_d"], dr)
    cells = B * (dr // bd)
    # traffic is config-independent (log_a, gx and y each touched once, the
    # h tiles sum to B*dr), so the frontier collapses to the fewest cells
    flops = 3.0 * B * L * dr
    hbm = 4.0 * (3 * B * L * dr + 2 * B * dr)
    smem = 4.0 * (3 * L * bd + 2 * bd)
    return TileCost(flops, hbm, cells, smem)


# ---------------------------------------------------------------------------
# moe_gmm
# ---------------------------------------------------------------------------


def _gmm_defaults(shape: dict) -> dict:
    return {
        "block_c": _gmm.DEFAULT_BLOCK_C,
        "block_f": _gmm.DEFAULT_BLOCK_F,
        "block_d": _gmm.DEFAULT_BLOCK_D,
    }


def _gmm_make_args(shape: dict, dtype: str, seed: int, device) -> tuple:
    g = _gen(seed, device)
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    scale = 1.0 / (D**0.5)
    x = _normal(g, (E, C, D), _dtype(dtype), device)
    w = (_normal(g, (E, D, F), torch.float32, device) * scale).to(_dtype(dtype))
    return x, w


def _gmm_call(shape: dict, args: tuple, config: dict):
    x, w = args
    return ops.moe_gmm(
        x, w,
        block_c=config["block_c"], block_f=config["block_f"], block_d=config["block_d"],
    )


def _gmm_ref(shape: dict, args: tuple):
    return _ref.moe_gmm_ref(*args)


def _gmm_cost(shape: dict, dtype: str) -> Cost:
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    flops = 2.0 * E * C * D * F
    hbm = _isz(dtype) * E * (C * D + D * F + C * F)
    return Cost(flops, float(hbm))


def _gmm_space(shape: dict) -> list:
    return [
        {"block_c": bc, "block_f": bf, "block_d": bd}
        for bc in _divisors(shape["C"], candidates=(32, 64, 128, 256))
        for bf in _divisors(shape["F"], candidates=(64, 128, 256, 512))
        for bd in _divisors(shape["D"], candidates=(128, 256, 512))
    ]


def _gmm_tile_cost(shape: dict, config: dict, dtype: str) -> TileCost:
    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    isz = _isz(dtype)
    bc, bf, bd = min(config["block_c"], C), min(config["block_f"], F), min(config["block_d"], D)
    nc, nf, nd = C // bc, F // bf, D // bd
    cells = E * nc * nf * nd
    flops = 2.0 * E * C * D * F
    # x tiles re-fetched per f-block, w tiles per c-block, y written per d-block
    hbm = isz * (nf * E * C * D + nc * E * D * F + nd * E * C * F)
    # x, w and y tiles + the fp32 accumulator tile
    smem = isz * (bc * bd + bd * bf + bc * bf) + 4 * bc * bf
    return TileCost(flops, float(hbm), cells, float(smem))


def _gmm_launch_key(shape: dict, config: dict, dtype: str) -> tuple:
    return (_gmm.route(_dtype(dtype), shape),) + _gmm.tile(shape, config, _dtype(dtype))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

KERNELS: dict = {
    k.name: k
    for k in (
        KernelDef(
            name="flash_attention",
            params=("block_q", "block_k"),
            operands=("q", "k", "v"),
            defaults=_fa_defaults,
            make_args=_fa_make_args,
            call=_fa_call,
            ref=_fa_ref,
            cost=_fa_cost,
            space=_fa_space,
            tile_cost=_fa_tile_cost,
            launch_key=_fa_launch_key,
            tiny_shape={"B": 1, "H": 2, "KV": 1, "L": 128, "hd": 32, "causal": True, "window": None},
            smoke_shape={"B": 1, "H": 4, "KV": 2, "L": 256, "hd": 64, "causal": True, "window": None},
            full_shape={"B": 1, "H": 8, "KV": 2, "L": 512, "hd": 64, "causal": True, "window": None},
        ),
        KernelDef(
            name="selective_scan",
            params=("block_d",),
            operands=("x", "dt", "b", "c", "a", "h0"),
            defaults=_ss_defaults,
            make_args=_ss_make_args,
            call=_ss_call,
            ref=_ss_ref,
            cost=_ss_cost,
            space=_ss_space,
            tile_cost=_ss_tile_cost,
            launch_key=_ss_launch_key,
            tiny_shape={"B": 1, "chunk": 32, "di": 128, "N": 8},
            smoke_shape={"B": 2, "chunk": 64, "di": 256, "N": 16},
            full_shape={"B": 2, "chunk": 128, "di": 1024, "N": 16},
        ),
        KernelDef(
            name="rglru_scan",
            params=("block_d",),
            operands=("log_a", "gx", "h0"),
            defaults=_rg_defaults,
            make_args=_rg_make_args,
            call=_rg_call,
            ref=_rg_ref,
            cost=_rg_cost,
            space=_rg_space,
            tile_cost=_rg_tile_cost,
            launch_key=_rg_launch_key,
            tiny_shape={"B": 1, "L": 64, "dr": 128},
            smoke_shape={"B": 2, "L": 128, "dr": 512},
            full_shape={"B": 2, "L": 256, "dr": 1024},
        ),
        KernelDef(
            name="moe_gmm",
            params=("block_c", "block_f", "block_d"),
            operands=("x", "w"),
            defaults=_gmm_defaults,
            make_args=_gmm_make_args,
            call=_gmm_call,
            ref=_gmm_ref,
            cost=_gmm_cost,
            space=_gmm_space,
            tile_cost=_gmm_tile_cost,
            launch_key=_gmm_launch_key,
            tiny_shape={"E": 2, "C": 64, "D": 128, "F": 128},
            smoke_shape={"E": 4, "C": 128, "D": 256, "F": 512},
            full_shape={"E": 8, "C": 256, "D": 512, "F": 512},
        ),
    )
}


def get_kernel(name: str) -> KernelDef:
    kdef = KERNELS.get(name)
    if kdef is None:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(KERNELS)}"
        )
    return kdef


def config_sig(config: dict) -> str:
    """Canonical ``k=v`` string of a block config (event attrs, payloads)."""
    return ",".join(f"{k}={config[k]}" for k in sorted(config))


def from_jax_args(name: str, arrays, device="cpu") -> tuple:
    """The reference's operands (as numpy arrays) as the port's tensors on
    ``device``, so both packages compute on the same numbers.  A bfloat16
    array goes through float32, because ``torch.from_numpy`` does not take
    ``ml_dtypes.bfloat16``; every bfloat16 value is exact in float32, so the
    round trip is exact."""
    kdef = get_kernel(name)
    arrays = list(arrays)
    if len(arrays) != len(kdef.operands):
        raise ValueError(f"{name} takes {len(kdef.operands)} operands {kdef.operands}, got {len(arrays)}")
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32, order="C")).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
        out.append(t.to(device))
    return tuple(out)


def max_abs_err(a, b) -> float:
    """Max elementwise |a - b| over a pair of tensors or tensor tuples."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


__all__ = [
    "Cost",
    "TileCost",
    "KernelDef",
    "KERNELS",
    "get_kernel",
    "shape_sig",
    "config_sig",
    "from_jax_args",
    "max_abs_err",
]
