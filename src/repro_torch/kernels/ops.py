"""Public wrappers over the hand-written kernels: check, resolve, route.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper keeps the reference's
signature and

  1. checks the operands: all on one device, the dtypes the kernel takes,
     the shapes it expects, contiguous memory, and the reference's block
     divisibility rule;
  2. resolves the block config as the reference does: explicit caller
     argument > the autotuned cache for the operands' device type
     (``HYDRA_AUTOTUNE=1`` only, kernels/autotune.py) > the kernel's
     committed default.  The kernels keep only the blocks' divisibility
     rule and pick their own tiles, so the config decides what is checked
     and what a kernel task reports, not the launch;
  3. routes by device: a CPU tensor goes to the plain version in
     ``kernels/ref.py``; a CUDA tensor goes to the kernel, which launches
     or raises.  Nothing falls back from the card to the plain version.

Every kernel module counts its own launches; ``launch_counts`` reads them.
The two kernels with two routes (``flash_attention`` and ``moe_gmm``: a
tensor-core kernel for bf16, a CUDA-core one for fp32) also count by route;
``route_launch_counts`` reads those.

Gradients.  On the card ``flash_attention`` and ``rglru_scan`` run through
``torch.autograd.Function``s whose backward is a hand-written kernel too
(``flash_attention_bwd``, ``rglru_scan_bwd``: public wrappers that check and
route like the others, CPU tensors to the plain versions in ``ref``).  The
backwards have no Pallas counterpart and no registry entry: they count their
launches apart (``backward_launch_counts``), so the registry kernels' counts
mean what they meant.  ``selective_scan_chunk`` and ``moe_gmm`` have no
backward kernel yet: on the card they raise ``BackwardNotPorted`` when grad
mode is on and an operand requires grad, rather than hand back an output
with no gradient path.  On CPU tensors every wrapper runs its plain version,
which autograd differentiates.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune as _autotune
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


BACKWARD_LAUNCHES = {
    "flash_attention_bwd": _fa.BWD_LAUNCHES,
    "rglru_scan_bwd": _rg.BWD_LAUNCHES,
}


def backward_launch_counts() -> dict[str, int]:
    """Backward-kernel launches so far (one a wrapper call: the attention
    backward's call runs its three kernels)."""
    return {name: c.value for name, c in BACKWARD_LAUNCHES.items()}


ROUTE_LAUNCHES = {
    "flash_attention": _fa.ROUTE_LAUNCHES,
    "moe_gmm": _gmm.ROUTE_LAUNCHES,
}


def route_launch_counts() -> dict[str, dict[str, int]]:
    """Launches so far by kernel and route (``wgmma`` / ``simt``)."""
    return {name: {r: c.value for r, c in by.items()} for name, by in ROUTE_LAUNCHES.items()}


def reset_launch_counts() -> None:
    """Zero every count: forward, by route and backward."""
    for c in (*LAUNCHES.values(), *BACKWARD_LAUNCHES.values()):
        c.reset()
    for by in ROUTE_LAUNCHES.values():
        for c in by.values():
            c.reset()


class BackwardNotPorted(NotImplementedError):
    """A kernel without a backward kernel was asked, on the card, for an
    output that gradients must flow through."""


_NO_BACKWARD = {  # kernel -> the ROADMAP.md item its backward waits for
    "selective_scan_chunk": "queue 2 ('Kernel work still open on the H100'), item 1.1: the selective_scan backward",
    "moe_gmm": "'Modules to port', item 4b: the moe family, with the moe_gmm backward (queue 2, item 1.2)",
}


def _refuse_grad(kernel: str, operands: dict) -> None:
    """Raise ``BackwardNotPorted`` when grad mode is on and an operand
    requires grad: the kernel's output would carry no gradient back."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands.values()):
        raise BackwardNotPorted(
            f"{kernel}: its backward kernel is not ported yet, so on a CUDA device it runs only where no "
            f"gradient flows through it (ROADMAP.md, {_NO_BACKWARD[kernel]}); on the CPU it trains through "
            f"its plain version"
        )


def _resolve(kernel: str, shape: dict, dtype: torch.dtype, device: torch.device, defaults: dict, explicit: dict) -> dict:
    """explicit arg > tuned cache (env-gated) > committed default."""
    if all(v is not None for v in explicit.values()):
        return explicit
    dtype_name = str(dtype).removeprefix("torch.")
    tuned = _autotune.tuned_config(kernel, shape, dtype_name, device.type) or {}
    return {k: v if v is not None else tuned.get(k, defaults[k]) for k, v in explicit.items()}


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
    cfg = _resolve(
        "flash_attention",
        {"B": b, "H": h, "KV": n_kv, "L": lq, "hd": hd, "causal": causal, "window": window},
        q.dtype, q.device,
        {"block_q": _fa.DEFAULT_BLOCK_Q, "block_k": _fa.DEFAULT_BLOCK_K},
        {"block_q": block_q, "block_k": block_k},
    )
    _fa.check_blocks(lq, lk, cfg["block_q"], cfg["block_k"])
    if not on_card:
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, causal, window)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = _fa.flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, window: Optional[int] = None):
    """Gradients of ``flash_attention`` from its output ``o`` and the output's
    gradient ``do`` (B,H,Lq,hd): returns (dq, dk, dv), each in its operand's
    dtype.  All five operands share one dtype."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    dt = (q.dtype,) if q.dtype in _FLOATS else _FLOATS
    on_card = _on_card(
        "flash_attention_bwd", {"q": q, "k": k, "v": v, "o": o, "do": do},
        {"q": _FLOATS, "k": dt, "v": dt, "o": dt, "do": dt},
        {"q": (b, h, lq, hd), "k": (b, n_kv, lk, hd), "v": (b, n_kv, lk, hd), "o": (b, h, lq, hd), "do": (b, h, lq, hd)},
    )
    if h % n_kv:
        raise ValueError(f"flash_attention_bwd: {h} query heads do not group over {n_kv} KV heads")
    if not on_card:
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    return _fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)


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
    cfg = _resolve(
        "selective_scan", {"B": B, "chunk": chunk, "di": di, "N": N}, x.dtype, x.device,
        {"block_d": _ss.DEFAULT_BLOCK_D}, {"block_d": block_d},
    )
    _ss.check_blocks(di, cfg["block_d"])
    if not on_card:
        return ref.selective_scan_chunk_ref(x, dt, b, c, a, h0)
    _refuse_grad("selective_scan_chunk", {"x": x, "dt": dt, "b": b, "c": c, "a": a, "h0": h0})
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
    cfg = _resolve(
        "rglru_scan", {"B": B, "L": L, "dr": dr}, log_a.dtype, log_a.device,
        {"block_d": _rg.DEFAULT_BLOCK_D}, {"block_d": block_d},
    )
    _rg.check_blocks(dr, cfg["block_d"])
    if not on_card:
        return ref.rglru_ref(log_a, gx, h0)
    return _RGLRUScan.apply(log_a, gx, h0)


class _RGLRUScan(torch.autograd.Function):
    """The forward scan, with the reverse-time scan kernel as its gradient."""

    @staticmethod
    def forward(ctx, log_a, gx, h0):
        y, h_last = _rg.rglru_scan(log_a, gx, h0)
        ctx.save_for_backward(log_a, h0, y)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        log_a, h0, y = ctx.saved_tensors
        return rglru_scan_bwd(log_a, h0, y, dy.contiguous(), dh_last.contiguous())


def rglru_scan_bwd(log_a, h0, y, dy, dh_last):
    """Gradients of ``rglru_scan`` from its inputs' ``log_a`` and ``h0``, its
    output ``y`` and the gradients ``dy`` (B,L,dr) and ``dh_last`` (B,dr) of
    its two outputs: returns (dlog_a, dgx, dh0), all fp32."""
    B, L, dr = log_a.shape
    on_card = _on_card(
        "rglru_scan_bwd", {"log_a": log_a, "h0": h0, "y": y, "dy": dy, "dh_last": dh_last},
        {"log_a": _F32, "h0": _F32, "y": _F32, "dy": _F32, "dh_last": _F32},
        {"log_a": (B, L, dr), "h0": (B, dr), "y": (B, L, dr), "dy": (B, L, dr), "dh_last": (B, dr)},
    )
    if not on_card:
        return ref.rglru_bwd_ref(log_a, h0, y, dy, dh_last)
    return _rg.rglru_scan_bwd(log_a, h0, y, dy, dh_last)


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
    cfg = _resolve(
        "moe_gmm", {"E": E, "C": C, "D": D, "F": F}, x.dtype, x.device,
        {"block_c": _gmm.DEFAULT_BLOCK_C, "block_f": _gmm.DEFAULT_BLOCK_F, "block_d": _gmm.DEFAULT_BLOCK_D},
        {"block_c": block_c, "block_f": block_f, "block_d": block_d},
    )
    _gmm.check_blocks(C, D, F, cfg["block_c"], cfg["block_d"], cfg["block_f"])
    if not on_card:
        return ref.moe_gmm_ref(x, w)
    _refuse_grad("moe_gmm", {"x": x, "w": w})
    return _gmm.moe_gmm(x, w)
