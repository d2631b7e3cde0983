"""GQA attention: the prefill path on the flash kernel, and the decode step.

Counterpart of ``repro/models/attention.py``.  The reference's blockwise
``attention`` is an XLA lowering of the same algorithm as its Pallas flash
kernel; here it is that kernel: ``attention`` calls ``ops.flash_attention``,
which launches ``csrc/flash_attention.cu`` on CUDA tensors and runs the plain
version (``kernels/ref.py``) on CPU tensors.  The models keep the reference's
(B, L, H, hd) layout; the kernel takes (B, H, L, hd), so the operands are
transposed into contiguous copies and the output back.

``decode_attention`` (one token against a cache) is plain PyTorch, as it is
an XLA computation and not a Pallas kernel in the reference.  The decode
blocks of every family reach it through ``cached_attention`` (and
``decode_self_attention``, ``decode_cross_attention``): under tensor
parallelism q holds the rank's query heads and the cache the KV heads they
read, as the prefill leaves it (``cache_kv_heads``).  Under a
strategy with ``flash_decode`` (``parallel/sharding.py``) it takes the
distributed flash-decode path (``attention.py:145-225``): the ranks of the
"model" group each attend to their slice of the cache's sequence and
combine their partial softmax states with two all-reduces.

Under tensor parallelism (``heads_qkv`` and ``heads_out``, the train and
prefill steps' projections) a rank holds query heads ``[r H/m, (r+1) H/m)``
where the rules split "heads", and the key and value heads that serve them:
its own slice where "kv_heads" splits, else the whole K and V (computed by a
row-parallel ``wk`` and ``wv`` where the rules spilled "model" onto their
"embed" dim) from which it takes the heads its query heads map to.  Where
"heads" does not split (the spill lands on "embed"), q is whole on every
rank and ``wo`` is column-parallel on d_model, its result gathered.  The
flash kernel runs at the local head counts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, linears, whole
from repro_torch.parallel import tensor as tp

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
    q_outer: Optional[int] = None,
    n_kv: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention against a cache.

    q (B, 1, H, hd); k_cache/v_cache (B, Lc, KV, hd); pos (B,) current position.
    ``cache_positions`` (B, Lc): absolute position stored at each cache slot
    (ring buffers for windowed attention); defaults to arange for linear caches.
    Products in fp32, as the reference asks with ``preferred_element_type``.

    When the active strategy enables flash_decode, dispatches to the
    distributed flash-decode path (each rank of the "model" group attends to
    its slice of the cache; the partial softmax states combine with an
    LSE-rescaled sum - no cache gather).  Under tensor parallelism q holds
    the rank's query heads (``q_outer``: their outer over "model", None
    where q is whole) and the cache the KV heads they read; the sequence
    split then runs where that cache holds every one of the config's
    ``n_kv`` KV heads (the reference's case: KV heads that "model" does not
    divide, the cache's sequence cut in their place), on q made whole over
    "model", whose output is split back to the rank's heads.  Where the
    rank's cache holds its own KV heads, its query heads read only them and
    the attention runs on the rank alone.
    """
    from repro_torch.parallel.sharding import current_mesh, flash_decode_enabled

    b, lc = q.shape[0], k_cache.shape[1]
    if cache_positions is None:
        cache_positions = torch.arange(lc, device=q.device)[None, :].expand(b, lc)
    if flash_decode_enabled() and (q_outer is None or k_cache.shape[2] == n_kv):
        if q_outer is None:
            return _decode_attention_distributed(q, k_cache, v_cache, pos, cache_positions, window, current_mesh())
        whole_q = tp.gather(q, 2, q_outer)
        out = _decode_attention_distributed(whole_q, k_cache, v_cache, pos, cache_positions, window, current_mesh())
        return tp.split(out, 2, q_outer)
    s, _ = _masked_scores(q, k_cache, pos, cache_positions, window)  # (B, H, Lc)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", p, repeat_kv(v_cache, q.shape[2]).float())
    return out[:, None].to(q.dtype)


def _masked_scores(q, k, pos, cache_positions, window):
    """The fp32 scores (B, H, Lc) of the query token q (B, 1, H, hd) against
    the keys k (B, Lc, KV, hd), with each slot that is not attended to (past
    ``pos``, out of the ``window``, or at position -1) at -inf's stand-in,
    and the mask of the attended slots (B, Lc)."""
    h, hd = q.shape[2], q.shape[3]
    s = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), repeat_kv(k, h).float()) * (1.0 / (hd**0.5))
    valid = cache_positions <= pos[:, None]
    if window is not None:
        valid &= cache_positions > (pos[:, None] - window)
    valid &= cache_positions >= 0
    return torch.where(valid[:, None, :], s, torch.tensor(_NEG, device=q.device)), valid


def _decode_attention_distributed(q, k_cache, v_cache, pos, cache_positions, window, mesh) -> torch.Tensor:
    """Distributed flash-decode: the cache's sequence is padded to a
    multiple of the "model" group's size (padded slots at position -1, which
    the validity test masks) and split in even slices; this rank computes
    the partial (m, l, acc) of its slice in fp32, and the group combines
    them: m_g = max over ranks, l = sum of l e^(m - m_g), acc likewise.
    Every rank of the group holds the whole cache of its batch shard and
    returns the whole output."""
    lc = k_cache.shape[1]
    n_model, r = mesh.axis_size("model"), mesh.coordinate("model")
    pad = (-lc) % n_model
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, 0, 0, pad))
        cache_positions = torch.nn.functional.pad(cache_positions, (0, pad), value=-1)
    part = (lc + pad) // n_model
    sl = slice(r * part, (r + 1) * part)
    s, valid = _masked_scores(q, k_cache[:, sl], pos, cache_positions[:, sl], window)
    m = torch.amax(s, dim=-1)  # (B, H)
    p = torch.exp(s - m[..., None]) * valid[:, None, :]
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhl,blhd->bhd", p, repeat_kv(v_cache[:, sl], q.shape[2]).float())
    # combine the partial softmax states across the cache's slices
    m_g = tp.all_reduce(m.clone(), mesh, "model", "max")
    corr = torch.exp(m - m_g)
    l_g = tp.all_reduce(l * corr, mesh, "model")
    acc_g = tp.all_reduce(acc * corr[..., None], mesh, "model")
    out = acc_g / torch.clamp(l_g, min=1e-37)[..., None]
    return out[:, None].to(q.dtype)


def write_cache(cache_k, cache_v, k_t, v_t, pos):
    """Write one token's k/v into the cache at per-batch positions.  Returns
    new caches; the inputs are left as they were, as in the reference."""
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k, cache_v = cache_k.clone(), cache_v.clone()
    cache_k[rows, pos.long()] = k_t[:, 0]
    cache_v[rows, pos.long()] = v_t[:, 0]
    return cache_k, cache_v


def ring_positions(pos: torch.Tensor, window: int) -> torch.Tensor:
    """Absolute position stored at each ring-buffer slot given current pos (B,).

    Slot j holds the largest p <= pos with p % W == j (negative => empty).
    """
    j = torch.arange(window, device=pos.device)[None, :]
    return pos[:, None] - torch.remainder(pos[:, None] - j, window)


def q_heads_outer(cfg) -> Optional[int]:
    """The outer of the rank's query heads over "model" (``_rank_kv``'s
    blocks), or None where q is whole on every rank."""
    s = tp.weight_split(("embed", "heads", None), (cfg.d_model, cfg.n_heads, cfg.hd))
    return s[1] if s is not None and s[0] == 1 else None


def cached_attention(cfg, q, k_cache, v_cache, pos, *, kv_t=None, ring: bool = False, window: Optional[int] = None):
    """One decode token's attention against the rank's cache: q (B, 1, Hl,
    hd) at the rank's query heads, the cache (Bc, Lc, KVl, hd) at the KV
    heads they read (as the tensor-parallel prefill leaves it).  With
    ``kv_t`` the token's (k, v) are written first, at ``pos`` (a ring
    buffer's slot ``pos % Lc`` with ``ring``, its slots' positions from
    ``ring_positions``).  Under "serve_2dtp" the step replicates the batch
    over "data" while the cache holds the rank's rows: the token's q, k, v
    and positions are cut to them and the output joined again
    (``tp.batch_part``, ``tp.batch_whole``).  Returns (out (B, 1, Hl, hd),
    k_cache, v_cache)."""
    q, pos = tp.batch_part(q), tp.batch_part(pos)
    cpos = None
    if kv_t is not None:
        k_t, v_t = (tp.batch_part(t) for t in kv_t)
        k_cache, v_cache = write_cache(k_cache, v_cache, k_t, v_t, pos % k_cache.shape[1] if ring else pos)
    if ring:
        cpos = ring_positions(pos, k_cache.shape[1])
    a = decode_attention(q, k_cache, v_cache, pos, cache_positions=cpos, window=window, q_outer=q_heads_outer(cfg),
                         n_kv=cfg.n_kv_heads)
    return tp.batch_whole(a), k_cache, v_cache


def decode_self_attention(cfg, p: dict, h: torch.Tensor, k_cache, v_cache, pos, *, ring: bool = False,
                          window: Optional[int] = None):
    """A decode step's self attention of the normed token ``h`` (B, 1, D)
    with its attention weights ``p``: q, k and v at the rank's heads, the
    rotary embedding at ``pos``, ``cached_attention``, and the output
    projection.  Returns (out (B, 1, D) whole, k_cache, v_cache)."""
    q, k_t, v_t, q_split = heads_qkv(cfg, p, h)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_t = apply_rope(k_t, pos[:, None], cfg.rope_theta)
    a, k_cache, v_cache = cached_attention(cfg, q, k_cache, v_cache, pos, kv_t=(k_t, v_t), ring=ring, window=window)
    return heads_out(cfg, a, p["wo"], q_split), k_cache, v_cache


def decode_cross_attention(cfg, p: dict, h: torch.Tensor, k_cache, v_cache) -> torch.Tensor:
    """A decode step's attention of the normed token ``h`` to the cross K/V
    its prefill cached (every slot valid), with the output projection:
    (B, 1, D) whole."""
    q, q_split = heads_q(cfg, p, h)
    pos_full = torch.full((h.shape[0],), k_cache.shape[1] - 1, dtype=torch.int32, device=h.device)
    a, _, _ = cached_attention(cfg, q, k_cache, v_cache, pos_full)
    return heads_out(cfg, a, p["wo"], q_split)


# ---------------------------------------------------------------------------
# Projections (every attention layer; tensor-parallel in train, prefill and decode)
# ---------------------------------------------------------------------------


def _rank_heads(n: int, outer: int) -> list:
    """The global ids of a rank's part of ``n`` heads split over "model":
    block ``j m + r`` of ``outer m`` for each j < outer (under "fsdp"
    "heads" splits over ("data", "model"): ``outer`` is the data axis's
    size)."""
    m, r = tp.model_size(), tp.model_rank()
    size = n // (outer * m)
    return [(j * m + r) * size + t for j in range(outer) for t in range(size)]


def _kv_of_heads(n_heads: int, n_kv: int, outer: int) -> tuple[list, bool]:
    """The KV heads a rank's query heads read (global query head h reads KV
    head h KV / H), and whether they are a contiguous range the kernel
    maps local query head j to as j / (Hl / n): then each once, else one
    a query head."""
    idx = [h * n_kv // n_heads for h in _rank_heads(n_heads, outer)]
    hl, lo = len(idx), idx[0]
    n = idx[-1] + 1 - lo
    if hl % n == 0 and all(idx[j] == lo + j // (hl // n) for j in range(hl)):
        return list(range(lo, lo + n)), True
    return idx, False


def _rank_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, n_kv: int, outer: int = 1):
    """From whole k and v (B, L, KV, hd), the heads this rank's query heads
    read (``_kv_of_heads``).  The whole k and v are replicated and read
    here by rank-specific work, so they ``enter`` first."""
    idx, contiguous = _kv_of_heads(n_heads, n_kv, outer)
    k, v = tp.enter(k), tp.enter(v)
    if contiguous:
        return k[:, :, idx[0]:idx[-1] + 1], v[:, :, idx[0]:idx[-1] + 1]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def cache_kv_heads(cfg) -> Optional[list]:
    """The global KV heads a rank's cache holds in a tensor-parallel step
    (those ``heads_qkv`` gives it: its own where "kv_heads" splits, else
    those its query heads read), or None where it holds every one."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ks = tp.weight_split(("embed", "kv_heads", None), (D, KV, hd))
    if ks is not None and ks[0] == 1:
        return _rank_heads(KV, ks[1])
    q_outer = q_heads_outer(cfg)
    return None if q_outer is None else _kv_of_heads(H, KV, q_outer)[0]


def _weights(cfg, p: dict, names) -> list:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": (("embed", "heads", None), (D, H, hd)), "wk": (("embed", "kv_heads", None), (D, KV, hd)),
              "wv": (("embed", "kv_heads", None), (D, KV, hd))}
    return [(p[n],) + shapes[n] for n in names]


def _at_rank(cfg, q_split, k, v, ks):
    """k and v of ``linears`` as (B, L, KVl, hd), at the heads this rank's
    query heads read (``q_split``: the outer of q's heads where they split
    over "model", else None)."""
    k, v = (t.unflatten(-1, (-1, cfg.hd)) for t in (k, v))
    if q_split is not None and ks is None:
        k, v = _rank_kv(k, v, cfg.n_heads, cfg.n_kv_heads, q_split)
    return k, v


def heads_q(cfg, p: dict, h: torch.Tensor, *, seq: bool = False):
    """q (B, L, Hl, hd) from ``h`` at this rank's head count, and whether
    it is split over "model" (``heads_out`` reads it).  ``seq``: ``h`` is
    the rank's slice of the sequence, q covers the whole of it."""
    [(q, qs)] = linears(h, _weights(cfg, p, ("wq",)), seq_in=seq)
    return q.unflatten(-1, (-1, cfg.hd)), qs is not None


def heads_kv(cfg, p: dict, kv_in: torch.Tensor, *, seq: bool = False):
    """k and v (B, Lk, KVl, hd) from ``kv_in`` at the heads this rank's
    query heads read (a cross attention's, or a prefill's cross cache);
    ``seq``: ``kv_in`` is the rank's slice of its sequence."""
    wq_split = tp.weight_split(*_weights(cfg, p, ("wq",))[0][1:])
    (k, ks), (v, _) = linears(kv_in, _weights(cfg, p, ("wk", "wv")), seq_in=seq)
    q_heads = wq_split[1] if wq_split is not None and wq_split[0] == 1 else None  # q split on its heads
    return _at_rank(cfg, q_heads, k, v, ks)


def heads_qkv(cfg, p: dict, h: torch.Tensor, kv_in: Optional[torch.Tensor] = None, *, seq: bool = False,
              kv_seq: bool = False):
    """``heads_q`` of ``h`` and ``heads_kv`` of ``kv_in`` (``h`` itself for
    self attention, its three products reading ``h`` through one move):
    (q, k, v, whether q is split).  ``seq`` and ``kv_seq``: ``h`` and
    ``kv_in`` are the rank's slices of their sequences (the residual
    streams of a sequence-parallel step); q, k and v cover the whole."""
    if kv_in is not None:
        q, q_split = heads_q(cfg, p, h, seq=seq)
        return (q,) + heads_kv(cfg, p, kv_in, seq=kv_seq) + (q_split,)
    (q, qs), (k, ks), (v, _) = linears(h, _weights(cfg, p, ("wq", "wk", "wv")), seq_in=seq)
    k, v = _at_rank(cfg, qs, k, v, ks)
    return q.unflatten(-1, (-1, cfg.hd)), k, v, qs is not None


def heads_out(cfg, a: torch.Tensor, wo: torch.Tensor, q_split: bool, *, seq: bool = False) -> torch.Tensor:
    """(B, L, Hl, hd) @ wo -> (B, L, D), whole: row-parallel over the rank's
    heads (reduced), or, where q was whole, column-parallel on d_model
    (gathered) or replicated, as the rules split ``wo``.  ``seq``: the
    rank's slice of the sequence (B, L / m, D), for the residual stream."""
    [(y, split)] = linears(a.flatten(-2), [(wo, ("heads", None, "embed"), (cfg.n_heads, cfg.hd, cfg.d_model))],
                           k=2, x_split=q_split, seq_out=seq)
    return whole(y, split)
