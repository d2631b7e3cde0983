"""Core layer primitives shared by every model family (plain PyTorch).

Counterpart of ``repro/models/layers.py``, with the same fp32 upcasts.  The
reference's ``shard_x`` annotations are dropped (one device; sharding is
ROADMAP.md, "Modules to port", item 6), and its ``scan_layers`` becomes a
plain loop over the layer index of the stacked leaves (``models/spec.py``:
``layer``, ``stack_layers``).  Rematerialisation is a training matter and
waits for the train slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def geglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    return (gelu(x @ w_gate) * (x @ w_up)) @ w_down


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ head (D, V) -> (..., V)."""
    return x @ head


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the seq dim.  x (B, L, C), w (C, K)."""
    k = w.shape[-1]
    L = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # K shifted views, summed in the reference's order (small K, 4)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i : i + L, :] * w[:, i]
    if bias is not None:
        out = out + bias
    return out


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, bias=None):
    """One decode step of causal depthwise conv.
    x_t (B, C); conv_state (B, K-1, C) holds the previous K-1 inputs."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,ck->bc", window, w)
    if bias is not None:
        out = out + bias
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., L, n_heads, head_dim) (or L==1 decode), pos broadcastable (..., L)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = pos[..., None].float() * freqs  # (..., L, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]  # (..., L, 1, hd/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
