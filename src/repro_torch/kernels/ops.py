"""Public wrappers over the hand-written kernels: check, resolve, route.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper keeps the reference's
signature and

  1. checks the operands: all on one device, the dtypes the kernel takes,
     the shapes it expects, contiguous memory, and the reference's block
     divisibility rule;
  2. resolves the block config: explicit caller argument > the kernel's
     committed default (the tuned-cache step of the reference arrives with
     the autotuner, see ROADMAP.md);
  3. routes by device: a CPU tensor goes to the plain version in
     ``kernels/ref.py``; a CUDA tensor goes to the kernel, which launches
     or raises.  Nothing falls back from the card to the plain version.

Every kernel module counts its own launches; ``launch_counts`` reads them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import selective_scan as _ss

_F32 = (torch.float32,)
_FLOATS = (torch.float32, torch.bfloat16)

LAUNCHES = {
    "flash_attention": _fa.LAUNCHES,
    "selective_scan": _ss.LAUNCHES,
    "rglru_scan": _rg.LAUNCHES,
    "moe_gmm": _gmm.LAUNCHES,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by registry name."""
    return {name: c.value for name, c in LAUNCHES.items()}


def reset_launch_counts() -> None:
    for c in LAUNCHES.values():
        c.reset()


def _on_card(kernel: str, operands: dict, dtypes: dict, shapes: dict) -> bool:
    """Check every operand; True when they lie on a CUDA device.  ``dtypes``
    maps an operand to the dtypes it may take; ``shapes`` to its expected
    shape (an int entry must match, None matches anything)."""
    device = next(iter(operands.values())).device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: operands on {device}; expected a CPU or CUDA device")
    for arg, t in operands.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {arg} is a {type(t).__name__}, not a tensor")
        if t.device != device:
            raise ValueError(f"{kernel}: {arg} is on {t.device}, the other operands on {device}")
        if t.dtype not in dtypes[arg]:
            raise TypeError(f"{kernel}: {arg} has dtype {t.dtype}, expected one of {dtypes[arg]}")
        want = shapes[arg]
        if t.dim() != len(want) or any(w is not None and w != s for w, s in zip(want, t.shape)):
            raise ValueError(f"{kernel}: {arg} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {arg} is not contiguous")
    return device.type == "cuda"


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
):
    """q (B,H,Lq,hd); k,v (B,KV,Lk,hd) -> (B,H,Lq,hd) in q.dtype."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    dt = (q.dtype,) if q.dtype in _FLOATS else _FLOATS
    on_card = _on_card(
        "flash_attention", {"q": q, "k": k, "v": v},
        {"q": _FLOATS, "k": dt, "v": dt},
        {"q": (b, h, lq, hd), "k": (b, n_kv, lk, hd), "v": (b, n_kv, lk, hd)},
    )
    if h % n_kv:
        raise ValueError(f"flash_attention: {h} query heads do not group over {n_kv} KV heads")
    _fa.check_blocks(
        lq, lk,
        _fa.DEFAULT_BLOCK_Q if block_q is None else block_q,
        _fa.DEFAULT_BLOCK_K if block_k is None else block_k,
    )
    if not on_card:
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def selective_scan_chunk(x, dt, b, c, a, h0, *, block_d: Optional[int] = None):
    """One SSM chunk: returns (y (B,chunk,di) f32, h_last (B,di,N) f32)."""
    B, chunk, di = x.shape
    N = b.shape[-1]
    on_card = _on_card(
        "selective_scan_chunk", {"x": x, "dt": dt, "b": b, "c": c, "a": a, "h0": h0},
        {"x": _FLOATS, "dt": _F32, "b": _F32, "c": _F32, "a": _F32, "h0": _F32},
        {
            "x": (B, chunk, di), "dt": (B, chunk, di), "b": (B, chunk, N),
            "c": (B, chunk, N), "a": (di, N), "h0": (B, di, N),
        },
    )
    _ss.check_blocks(di, _ss.DEFAULT_BLOCK_D if block_d is None else block_d)
    if not on_card:
        return ref.selective_scan_chunk_ref(x, dt, b, c, a, h0)
    return _ss.selective_scan_chunk(x, dt, b, c, a, h0)


def rglru_scan(log_a, gx, h0=None, *, block_d: Optional[int] = None):
    """RG-LRU over a sequence: returns (y (B,L,dr) f32, h_last (B,dr) f32)."""
    B, L, dr = log_a.shape
    if h0 is None:
        h0 = torch.zeros((B, dr), dtype=torch.float32, device=log_a.device)
    on_card = _on_card(
        "rglru_scan", {"log_a": log_a, "gx": gx, "h0": h0},
        {"log_a": _F32, "gx": _F32, "h0": _F32},
        {"log_a": (B, L, dr), "gx": (B, L, dr), "h0": (B, dr)},
    )
    _rg.check_blocks(dr, _rg.DEFAULT_BLOCK_D if block_d is None else block_d)
    if not on_card:
        return ref.rglru_ref(log_a, gx, h0)
    return _rg.rglru_scan(log_a, gx, h0)


def moe_gmm(
    x, w, *,
    block_c: Optional[int] = None,
    block_f: Optional[int] = None,
    block_d: Optional[int] = None,
):
    """Grouped expert matmul: x (E,C,D) @ w (E,D,F) -> (E,C,F) in x.dtype."""
    E, C, D = x.shape
    F = w.shape[-1]
    same = (x.dtype,) if x.dtype in _FLOATS else _FLOATS
    on_card = _on_card(
        "moe_gmm", {"x": x, "w": w}, {"x": _FLOATS, "w": same},
        {"x": (E, C, D), "w": (E, D, F)},
    )
    _gmm.check_blocks(
        C, D, F,
        _gmm.DEFAULT_BLOCK_C if block_c is None else block_c,
        _gmm.DEFAULT_BLOCK_D if block_d is None else block_d,
        _gmm.DEFAULT_BLOCK_F if block_f is None else block_f,
    )
    if not on_card:
        return ref.moe_gmm_ref(x, w)
    return _gmm.moe_gmm(x, w)
