"""Plain PyTorch versions of every hand-written kernel (exact, unblocked math).

They repeat the arithmetic of ``repro/kernels/ref.py`` with a Python loop
over time for the two scans.  The CPU route of ``kernels/ops.py`` runs them,
and ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, Lq, hd)
    k: torch.Tensor,  # (B, KV, Lk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    rep = h // n_kv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / (hd**0.5)
    q_pos = torch.arange(lq, device=q.device)[:, None]
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def selective_scan_chunk_ref(x, dt, b, c, a, h0):
    """Sequential reference of the SSM chunk recurrence (fp32)."""
    chunk = x.shape[1]
    h = h0.float()
    a = a.float()
    ys = []
    for t in range(chunk):
        dt_t = dt[:, t, :].float()  # (B, di)
        x_t = x[:, t, :].float()
        b_t = b[:, t, :].float()  # (B, N)
        c_t = c[:, t, :].float()
        da = torch.exp(dt_t[..., None] * a[None])  # (B, di, N)
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        ys.append(torch.sum(h * c_t[:, None, :], dim=-1))  # (B, di)
    return torch.stack(ys, dim=1), h  # (B, chunk, di), (B, di, N)


def rglru_ref(log_a, gx, h0=None):
    B, L, dr = log_a.shape
    h = torch.zeros((B, dr), dtype=torch.float32, device=log_a.device) if h0 is None else h0.float()
    ys = []
    for t in range(L):
        h = torch.exp(log_a[:, t, :].float()) * h + gx[:, t, :].float()
        ys.append(h)
    return torch.stack(ys, dim=1), h


def moe_gmm_ref(x, w):
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
