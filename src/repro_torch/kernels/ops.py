"""Public wrappers over the hand-written kernels: check, resolve, route.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper keeps the reference's
signature and

  1. checks the operands: all on one device, the dtypes the kernel takes,
     the shapes it expects, contiguous memory, and the reference's block
     divisibility rule;
  2. resolves the block config as the reference does: explicit caller
     argument > the autotuned cache for the operands' device type
     (``HYDRA_AUTOTUNE=1`` only, kernels/autotune.py) > the kernel's
     committed default.  The config is checked by the reference's
     divisibility rule and handed to the launcher, whose ``tile`` maps it
     onto the variant launched on the fp32 routes (the scans' channels a
     block, the ``tf32x3`` attention's k rows a tile, the ``tf32x3`` GEMM's
     C columns a block and stages); the other routes have one variant;
  3. routes by device: a CPU tensor goes to the plain version in
     ``kernels/ref.py``; a CUDA tensor goes to the kernel, which launches
     or raises.  Nothing falls back from the card to the plain version.
     A meta tensor (the dry run, ``launch/dryrun.py``) runs neither: the
     wrapper returns outputs of the kernel's shapes and dtypes and adds the
     kernel's own flops and bytes (``roofline/count.py``), forward and
     backward, through the same autograd Functions as the card.

Every kernel module counts its own launches; ``launch_counts`` reads them.
The two kernels with several routes also count by route:
``flash_attention`` (all on the tensor cores: bf16 on ``wgmma`` from head
width 32 and on one TF32 product a product, ``tf32``, at 16; fp32 as three
TF32 products a product, ``tf32x3``, up to 128 and on two-block clusters,
``tf32x3_cluster``, at 256) and ``moe_gmm`` (tensor-core kernels for bf16
and, as three TF32 products, for fp32; warp-level ``mma`` where TMA cannot
describe the strides).  ``route_launch_counts`` reads those, and
``backward_route_launch_counts`` the attention and GEMM backwards', each on
its forward's route.

Gradients.  On the card every kernel runs through a
``torch.autograd.Function`` whose backward is a hand-written kernel too
(``flash_attention_bwd``, ``selective_scan_chunk_bwd``, ``rglru_scan_bwd``,
``moe_gmm_bwd``: public wrappers that check and route like the others, CPU
tensors to the plain versions in ``ref``).  The backwards have no Pallas
counterpart and no registry entry: they count their launches apart
(``backward_launch_counts``), so the registry kernels' counts mean what they
meant.  The attention forward also writes each row's log-sum-exp when a
gradient will be taken, and the backward reads it.  On CPU tensors every
wrapper runs its plain version, which autograd differentiates.
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
from repro_torch.roofline import count as _count

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
    "selective_scan_bwd": _ss.BWD_LAUNCHES,
    "rglru_scan_bwd": _rg.BWD_LAUNCHES,
    "moe_gmm_bwd": _gmm.BWD_LAUNCHES,
}


def backward_launch_counts() -> dict[str, int]:
    """Backward-kernel launches so far (one a wrapper call: the attention
    backward's call runs two to four kernels, the selective-scan backward's
    two, the RG-LRU backward's one, the GEMM backward's one a gradient asked
    for)."""
    return {name: c.value for name, c in BACKWARD_LAUNCHES.items()}


ROUTE_LAUNCHES = {
    "flash_attention": _fa.ROUTE_LAUNCHES,
    "moe_gmm": _gmm.ROUTE_LAUNCHES,
}


def route_launch_counts() -> dict[str, dict[str, int]]:
    """Launches so far by kernel and route (attention: ``wgmma`` /
    ``tf32x3`` / ``tf32`` / ``tf32x3_cluster``; GEMM: ``mma`` / ``wgmma`` /
    ``tf32x3``)."""
    return {name: {r: c.value for r, c in by.items()} for name, by in ROUTE_LAUNCHES.items()}


BACKWARD_ROUTE_LAUNCHES = {"flash_attention_bwd": _fa.BWD_ROUTE_LAUNCHES, "moe_gmm_bwd": _gmm.BWD_ROUTE_LAUNCHES}


def backward_route_launch_counts() -> dict[str, dict[str, int]]:
    """Backward launches so far by kernel and route (the forward's
    routes)."""
    return {name: {r: c.value for r, c in by.items()} for name, by in BACKWARD_ROUTE_LAUNCHES.items()}


def reset_launch_counts() -> None:
    """Zero every count: forward, backward, and both by route."""
    for c in (*LAUNCHES.values(), *BACKWARD_LAUNCHES.values()):
        c.reset()
    for by in (*ROUTE_LAUNCHES.values(), *BACKWARD_ROUTE_LAUNCHES.values()):
        for c in by.values():
            c.reset()


def block_dividing(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is at most ``cap``."""
    b = min(cap, n)
    while n % b:
        b -= 1
    return b


def _resolve(
    kernel: str, shape: dict, dtype: torch.dtype, device: torch.device, defaults: dict, explicit: dict,
    widths: Optional[dict] = None,
) -> dict:
    """explicit arg > tuned cache (env-gated) > committed default.  A block
    that was not given and does not divide its width in ``widths`` (block
    name -> dim) falls back to the largest divisor below it: a rank's share
    of the channels under tensor parallelism need not be a multiple of the
    default (recurrentgemma-2b's 2560 / 2 against 512).  A given block is
    kept, and the kernel's check refuses it where it does not divide."""
    if all(v is not None for v in explicit.values()):
        return explicit
    dtype_name = str(dtype).removeprefix("torch.")
    tuned = _autotune.tuned_config(kernel, shape, dtype_name, device.type) or {}
    widths = widths or {}
    cfg = {}
    for k, v in explicit.items():
        if v is None:
            v = tuned.get(k, defaults[k])
            if k in widths:
                v = block_dividing(widths[k], v)
        cfg[k] = v
    return cfg


def _on_card(kernel: str, operands: dict, dtypes: dict, shapes: dict) -> bool:
    """Check every operand; True when they lie on a CUDA device.  ``dtypes``
    maps an operand to the dtypes it may take; ``shapes`` to its expected
    shape (an int entry must match, None matches anything)."""
    device = next(iter(operands.values())).device
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{kernel}: operands on {device}; expected a CPU or CUDA device (or meta, for the dry run)")
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
    return device.type in ("cuda", "meta")


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
    # the forward keeps each row's LSE where a gradient will be taken: the
    # backward reads it
    keep_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window, keep_lse, cfg)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (the variant of the block ``config``), with the
    backward kernel as its gradient; with ``keep_lse`` the forward also
    writes the rows' LSE for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, keep_lse, config=None):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if keep_lse else None
        if q.is_meta:
            (b, h, lq, hd), (n_kv, lk) = q.shape, k.shape[1:3]
            _count.add_kernel("flash_attention", _count.attention_fwd(b, h, n_kv, lq, lk, hd, causal, window, q.element_size()))
            o = torch.empty_like(q)
        else:
            o = _fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse, config=config)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), causal=ctx.causal, window=ctx.window, lse=lse)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, window: Optional[int] = None, lse=None):
    """Gradients of ``flash_attention`` from its output ``o`` and the output's
    gradient ``do`` (B,H,Lq,hd): returns (dq, dk, dv), each in its operand's
    dtype.  All five operands share one dtype.  ``lse`` (B,H,Lq) fp32, the
    forward's log-sum-exp of each row in base 2, is optional: the train
    step's autograd Function passes the forward's; without it the kernel
    computes it first with a preprocess."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    dt = (q.dtype,) if q.dtype in _FLOATS else _FLOATS
    operands = {"q": q, "k": k, "v": v, "o": o, "do": do}
    dtypes = {"q": _FLOATS, "k": dt, "v": dt, "o": dt, "do": dt}
    shapes = {"q": (b, h, lq, hd), "k": (b, n_kv, lk, hd), "v": (b, n_kv, lk, hd), "o": (b, h, lq, hd), "do": (b, h, lq, hd)}
    if lse is not None:
        operands["lse"], dtypes["lse"], shapes["lse"] = lse, _F32, (b, h, lq)
    on_card = _on_card("flash_attention_bwd", operands, dtypes, shapes)
    if h % n_kv:
        raise ValueError(f"flash_attention_bwd: {h} query heads do not group over {n_kv} KV heads")
    if not on_card:
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, lse=lse)
    if q.is_meta:
        _count.add_kernel("flash_attention_bwd", _count.attention_bwd(b, h, n_kv, lq, lk, hd, causal, window, q.element_size()))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _fa.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)


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
        {"block_d": _ss.DEFAULT_BLOCK_D}, {"block_d": block_d}, {"block_d": di},
    )
    _ss.check_blocks(di, cfg["block_d"])
    if not on_card:
        return ref.selective_scan_chunk_ref(x, dt, b, c, a, h0)
    return _SelectiveScanChunk.apply(x, dt, b, c, a, h0, cfg)


class _SelectiveScanChunk(torch.autograd.Function):
    """The forward chunk kernel, with the backward kernel as its gradient.
    It keeps its operands, not its states: the backward recomputes them.
    ``a`` and ``h0`` are kept by reference (``h0`` is the previous chunk's
    ``h_last``, so the chunks' gradients chain through it).  Where an output
    is unused (in training the last chunk's ``h_last``) autograd hands its
    gradient in as zeros."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, h0, config=None):
        ctx.save_for_backward(x, dt, b, c, a, h0)
        if x.is_meta:
            (B, chunk, di), N = x.shape, b.shape[-1]
            _count.add_kernel("selective_scan", _count.selective_scan_fwd(B, chunk, di, N, x.element_size()))
            return torch.empty(x.shape, dtype=torch.float32, device="meta"), torch.empty_like(h0)
        return _ss.selective_scan_chunk(x, dt, b, c, a, h0, config=config)

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, b, c, a, h0 = ctx.saved_tensors
        return *selective_scan_chunk_bwd(x, dt, b, c, a, h0, dy.contiguous(), dh_last.contiguous()), None


def selective_scan_chunk_bwd(x, dt, b, c, a, h0, dy, dh_last):
    """Gradients of ``selective_scan_chunk`` from its operands and the
    gradients dy (B,chunk,di) and dh_last (B,di,N) of its two outputs:
    returns (dx, ddt, db, dc, da, dh0), dx in x's dtype and the rest fp32."""
    B, chunk, di = x.shape
    N = b.shape[-1]
    on_card = _on_card(
        "selective_scan_chunk_bwd",
        {"x": x, "dt": dt, "b": b, "c": c, "a": a, "h0": h0, "dy": dy, "dh_last": dh_last},
        {"x": _FLOATS, "dt": _F32, "b": _F32, "c": _F32, "a": _F32, "h0": _F32, "dy": _F32, "dh_last": _F32},
        {
            "x": (B, chunk, di), "dt": (B, chunk, di), "b": (B, chunk, N), "c": (B, chunk, N), "a": (di, N),
            "h0": (B, di, N), "dy": (B, chunk, di), "dh_last": (B, di, N),
        },
    )
    if not on_card:
        return ref.selective_scan_chunk_bwd_ref(x, dt, b, c, a, h0, dy, dh_last)
    if x.is_meta:
        _count.add_kernel("selective_scan_bwd", _count.selective_scan_bwd(B, chunk, di, N, x.element_size()))
        return tuple(torch.empty_like(t) for t in (x, dt, b, c, a, h0))
    return _ss.selective_scan_chunk_bwd(x, dt, b, c, a, h0, dy, dh_last)


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
        {"block_d": _rg.DEFAULT_BLOCK_D}, {"block_d": block_d}, {"block_d": dr},
    )
    _rg.check_blocks(dr, cfg["block_d"])
    if not on_card:
        return ref.rglru_ref(log_a, gx, h0)
    return _RGLRUScan.apply(log_a, gx, h0, cfg)


class _RGLRUScan(torch.autograd.Function):
    """The forward scan (the variant of the block ``config``), with the
    reverse-time scan kernel as its gradient."""

    @staticmethod
    def forward(ctx, log_a, gx, h0, config=None):
        if log_a.is_meta:
            _count.add_kernel("rglru_scan", _count.rglru_fwd(*log_a.shape))
            y, h_last = torch.empty_like(log_a), torch.empty_like(h0)
        else:
            y, h_last = _rg.rglru_scan(log_a, gx, h0, config=config)
        ctx.save_for_backward(log_a, h0, y)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        log_a, h0, y = ctx.saved_tensors
        return *rglru_scan_bwd(log_a, h0, y, dy.contiguous(), dh_last.contiguous()), None


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
    if log_a.is_meta:
        _count.add_kernel("rglru_scan_bwd", _count.rglru_bwd(B, L, dr))
        return torch.empty_like(log_a), torch.empty_like(log_a), torch.empty_like(h0)
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
        {"block_c": block_c, "block_f": block_f, "block_d": block_d}, {"block_c": C, "block_f": F, "block_d": D},
    )
    _gmm.check_blocks(C, D, F, cfg["block_c"], cfg["block_d"], cfg["block_f"])
    if not on_card:
        return ref.moe_gmm_ref(x, w)
    return _MoeGmm.apply(x, w, cfg)


class _MoeGmm(torch.autograd.Function):
    """The forward kernel (the variant of the block ``config``), with the
    backward kernel as its gradient: each of dx and dw only where autograd
    asks for it."""

    @staticmethod
    def forward(ctx, x, w, config=None):
        ctx.save_for_backward(x, w)
        if x.is_meta:
            (E, C, D), F = x.shape, w.shape[-1]
            _count.add_kernel("moe_gmm", _count.gmm_fwd(E, C, D, F, x.element_size()))
            return torch.empty((E, C, F), dtype=x.dtype, device="meta")
        return _gmm.moe_gmm(x, w, config=config)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        return *moe_gmm_bwd(x, w, dy.contiguous(), need_dx=need_dx, need_dw=need_dw), None


def moe_gmm_bwd(x, w, dy, *, need_dx: bool = True, need_dw: bool = True):
    """Gradients of ``moe_gmm`` from its operands x (E,C,D) and w (E,D,F) and
    its output's gradient dy (E,C,F): returns (dx (E,C,D), dw (E,D,F)) in the
    operands' dtype, each None where not asked for."""
    E, C, D = x.shape
    F = w.shape[-1]
    same = (x.dtype,) if x.dtype in _FLOATS else _FLOATS
    on_card = _on_card(
        "moe_gmm_bwd", {"x": x, "w": w, "dy": dy}, {"x": _FLOATS, "w": same, "dy": same},
        {"x": (E, C, D), "w": (E, D, F), "dy": (E, C, F)},
    )
    if not on_card:
        return ref.moe_gmm_bwd_ref(x, w, dy, need_dx, need_dw)
    if x.is_meta:
        _count.add_kernel("moe_gmm_bwd", _count.gmm_bwd(E, C, D, F, x.element_size(), need_dx, need_dw))
        return torch.empty_like(x) if need_dx else None, torch.empty_like(w) if need_dw else None
    return _gmm.moe_gmm_bwd(x, w, dy, need_dx, need_dw)
