"""Plain PyTorch versions of every hand-written kernel (exact, unblocked math).

They repeat the arithmetic of ``repro/kernels/ref.py`` with a Python loop
over time for the two scans.  The CPU route of ``kernels/ops.py`` runs them,
and ``chip_smoke.py`` holds each kernel against them on the card.

The four backward kernels (attention, both scans and ``moe_gmm``) have no
Pallas counterpart; their plain versions below are written from
the explicit gradient formulas, not by calling autograd, so that the tests
can hold them against autodiff of the forward (``jax.vjp`` and torch's
autograd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LOG2E = 1.0 / math.log(2.0)


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
    mask = attention_mask(lq, lk, causal, window, q.device)
    s = torch.where(mask[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_mask(lq: int, lk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(Lq, Lk) bool: which keys each query sees (positions from 0 on both)."""
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = torch.arange(lk, device=device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def _masked_scores(q, kf, causal, window):
    """(S, mask): S = scale * Q K^T in fp32 (B,H,Lq,Lk), -inf where masked;
    kf is K already repeated to the query heads, in fp32."""
    lq, hd, lk = q.shape[2], q.shape[3], kf.shape[2]
    mask = attention_mask(lq, lk, causal, window, q.device)[None, None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (1.0 / (hd**0.5))
    return torch.where(mask, s, torch.tensor(float("-inf"), device=q.device)), mask


def attention_lse_ref(q, k, *, causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """(B,H,Lq) fp32: each query row's log-sum-exp of its live scaled scores
    in base 2, log2(sum_k 2^(S log2 e)) = LSE * log2(e), as the forward
    kernel writes it for the backward; -inf for a row with no live key."""
    rep = q.shape[1] // k.shape[1]
    s, _ = _masked_scores(q, k.float().repeat_interleave(rep, dim=1), causal, window)
    return torch.logsumexp(s, dim=-1) * LOG2E


def attention_bwd_ref(q, k, v, o, do, *, causal: bool = True, window: Optional[int] = None, lse=None):
    """Gradients of ``attention_ref`` from its output ``o`` and the output's
    gradient ``do``, by the FlashAttention-2 formulas, in fp32: with
    S = scale * Q K^T under the mask and P = exp(S - LSE) (0 where masked),
    D = rowsum(dO * O), dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
    dQ = scale * dS K, dK = scale * dS^T Q.  GQA sums dK and dV over the
    query heads that share a KV head.  A query row with no live key gets
    zero gradients (the kernel's forward writes zeros there).  ``lse``
    (B,H,Lq), in base 2 as ``attention_lse_ref`` gives it, is used where
    given (P = 2^(S log2 e - lse)); else LSE is computed here.
    Returns (dq, dk, dv) in the operands' dtype."""
    b, h, lq, hd = q.shape
    n_kv, lk = k.shape[1], k.shape[2]
    rep = h // n_kv
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = 1.0 / (hd**0.5)
    s, mask = _masked_scores(q, kf, causal, window)
    if lse is None:
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    else:
        p = torch.exp2(s * LOG2E - lse.float()[..., None])
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    d = torch.sum(dof * of, dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - d)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, n_kv, rep, lk, hd).sum(dim=2)
    dv = dv.reshape(b, n_kv, rep, lk, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def selective_scan_chunk_bwd_ref(x, dt, b, c, a, h0, dy, dh_last):
    """Gradients of ``selective_scan_chunk_ref`` by an explicit reverse-time
    walk.  The forward is h_t = e_t h_{t-1} + (dt_t x_t) b_t with
    e_t = exp(dt_t a), y_t = sum_n h_t c_t.  From g = dh_last, for t from the
    chunk's end down to 0: g += dy_t c_t (now the gradient reaching h_t);
    dx_t = dt_t sum_n g b_t; ddt_t = sum_n g (a e_t h_{t-1} + x_t b_t);
    db_t = sum_d g dt_t x_t; dc_t = sum_d dy_t h_t; da += g dt_t e_t h_{t-1};
    then g = e_t g.  After the walk dh0 = g.  The states h_t come from a
    forward walk from h0.  Returns (dx, ddt, db, dc, da, dh0): dx in x's
    dtype, the rest fp32."""
    chunk = x.shape[1]
    a = a.float()
    xf, dtf, bf, cf, dyf = x.float(), dt.float(), b.float(), c.float(), dy.float()
    hs = [h0.float()]  # hs[t + 1] = h_t
    for t in range(chunk):
        e = torch.exp(dtf[:, t, :, None] * a[None])
        hs.append(e * hs[-1] + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
    dx, ddt = torch.empty_like(dtf), torch.empty_like(dtf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(a)
    g = dh_last.float()
    for t in range(chunk - 1, -1, -1):
        e = torch.exp(dtf[:, t, :, None] * a[None])  # (B, di, N)
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        s1 = torch.sum(g * bf[:, t, None, :], dim=-1)  # (B, di)
        p = g * e * hs[t]  # the gradient reaching e_t, times e_t
        dx[:, t] = dtf[:, t] * s1
        ddt[:, t] = torch.sum(a[None] * p, dim=-1) + xf[:, t] * s1
        db[:, t] = torch.sum(g * (dtf[:, t] * xf[:, t])[..., None], dim=1)
        dc[:, t] = torch.sum(dyf[:, t, :, None] * hs[t + 1], dim=1)
        da = da + torch.sum(dtf[:, t, :, None] * p, dim=0)
        g = e * g
    return dx.to(x.dtype), ddt, db, dc, da, g


def rglru_ref(log_a, gx, h0=None):
    B, L, dr = log_a.shape
    h = torch.zeros((B, dr), dtype=torch.float32, device=log_a.device) if h0 is None else h0.float()
    ys = []
    for t in range(L):
        h = torch.exp(log_a[:, t, :].float()) * h + gx[:, t, :].float()
        ys.append(h)
    return torch.stack(ys, dim=1), h


def rglru_bwd_ref(log_a, h0, y, dy, dh_last):
    """Gradients of ``rglru_ref`` from its saved outputs, by a reverse-time
    scan: g_t = dy_t + exp(log_a_{t+1}) g_{t+1} from g_{L-1} = dy_{L-1} +
    dh_last; dgx_t = g_t; dlog_a_t = g_t exp(log_a_t) h_{t-1}, with
    h_{-1} = h0 (zeros when None) and h_{t-1} = y_{t-1}; dh0 = exp(log_a_0) g_0.
    All fp32.  Returns (dlog_a, dgx, dh0)."""
    B, L, dr = log_a.shape
    a = torch.exp(log_a.float())
    h0 = torch.zeros((B, dr), dtype=torch.float32, device=log_a.device) if h0 is None else h0.float()
    dy = dy.float()
    g = torch.empty_like(a)
    carry = dh_last.float()  # exp(log_a_{t+1}) g_{t+1}, the gradient reaching h_t from h_{t+1}
    for t in range(L - 1, -1, -1):
        g_t = dy[:, t] + carry
        g[:, t] = g_t
        carry = a[:, t] * g_t
    h_prev = torch.cat([h0[:, None], y[:, :-1].float()], dim=1)
    return g * a * h_prev, g, carry


def moe_gmm_ref(x, w):
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gmm_bwd_ref(x, w, dy, need_dx=True, need_dw=True):
    """The gradients of ``moe_gmm_ref`` from the output's gradient dy
    (E,C,F): (dx = dy @ w^T, dw = x^T @ dy), fp32 sums cast to the operands'
    dtypes, None where not asked."""
    dx = torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(x.dtype) if need_dx else None
    dw = torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(w.dtype) if need_dw else None
    return dx, dw
