"""GQA attention: the prefill path on the flash kernel, and the decode step.

Counterpart of ``repro/models/attention.py``.  The reference's blockwise
``attention`` is an XLA lowering of the same algorithm as its Pallas flash
kernel; here it is that kernel: ``attention`` calls ``ops.flash_attention``,
which launches ``csrc/flash_attention.cu`` on CUDA tensors and runs the plain
version (``kernels/ref.py``) on CPU tensors.  The models keep the reference's
(B, L, H, hd) layout; the kernel takes (B, H, L, hd), so the operands are
transposed into contiguous copies and the output back.

``decode_attention`` (one token against a cache) is plain PyTorch, as it is
an XLA computation and not a Pallas kernel in the reference.  Its
distributed flash-decode twin waits for sharding (ROADMAP.md, "Modules to
port", item 6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

_NEG = -1e30
MAX_BLOCK = 128  # the reference's default flash blocks (kernels/flash_attention.py)


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, L, KV, hd) -> (B, L, H, hd)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def block_for(length: int) -> int:
    """The largest divisor of ``length`` that is at most 128, as the
    reference's chunk fallback picks one (``attention.py:48-50``), so any
    prompt length meets the kernel's divisibility rule."""
    b = min(MAX_BLOCK, length)
    while length % b:
        b -= 1
    return b


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention.  q (B,Lq,H,hd); k,v (B,Lk,KV,hd) -> (B,Lq,H,hd).

    The reference's ``q_offset`` (queries that start past key 0) has no
    kernel counterpart and no prefill uses it, so it is not taken."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.flash_attention(
        qt, kt, vt, causal=causal, window=window,
        block_q=block_for(q.shape[1]), block_k=block_for(k.shape[1]),
    )
    return out.transpose(1, 2)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    cache_positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention against a cache.

    q (B, 1, H, hd); k_cache/v_cache (B, Lc, KV, hd); pos (B,) current position.
    ``cache_positions`` (B, Lc): absolute position stored at each cache slot
    (ring buffers for windowed attention); defaults to arange for linear caches.
    Products in fp32, as the reference asks with ``preferred_element_type``.
    """
    b, _, h, hd = q.shape
    lc = k_cache.shape[1]
    kr = repeat_kv(k_cache, h)
    vr = repeat_kv(v_cache, h)
    scale = 1.0 / (hd**0.5)
    s = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), kr.float()) * scale  # (B, H, Lc)
    if cache_positions is None:
        cache_positions = torch.arange(lc, device=q.device)[None, :].expand(b, lc)
    valid = cache_positions <= pos[:, None]
    if window is not None:
        valid &= cache_positions > (pos[:, None] - window)
    valid &= cache_positions >= 0
    s = torch.where(valid[:, None, :], s, torch.tensor(_NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", p, vr.float())
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# Projections (shared by all attention layers)
# ---------------------------------------------------------------------------


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,L,D) @ w (D, n, hd) -> (B, L, n, hd): the reference's
    ``einsum("bld,dhk->blhk")``, one matrix product with no batch dims."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).unflatten(-1, (n, hd))


def qkv_proj(x: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,L,D) -> q (B,L,H,hd), k/v (B,L,KV,hd) using 3D weights."""
    return proj(x, p["wq"]), proj(x, p["wk"]), proj(x, p["wv"])


def out_proj(attn_out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, L, H, hd) @ wo (H, hd, D) -> (B, L, D)."""
    h, hd, d = wo.shape
    return attn_out.flatten(-2) @ wo.reshape(h * hd, d)
