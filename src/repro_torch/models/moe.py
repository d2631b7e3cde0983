"""Mixture-of-Experts FFN with capacity-based grouped dispatch (Switch/MaxText
style) + optional parallel dense residual (arctic).

Counterpart of ``repro/models/moe.py``.  Tokens are processed in groups of
``moe_group_size``; each group computes a local top-k dispatch with capacity
C = ceil(g * k * cf / E).  The routing is fp32 throughout, as in the
reference.  The dispatch and combine einsums stay plain products; the three
expert products (``moe.py:131-135``) run on the grouped GEMM kernel
(``ops.moe_gmm``): the dispatched tokens are laid out (E, G * C, D), each
expert's rows of every group together, so one launch multiplies every
expert's rows by its weights.  On the card its gradient is the hand-written
``moe_gmm`` backward.  The reference's ``shard_x`` annotations are dropped:
each rank computes on its own shard, which the steps cut (``train/step.py``).
Under tensor parallelism the expert weights' split is read from the rules
(``parallel/tensor.py``, ``weight_split``), two cases:

  * "experts" over "model" (arctic): a rank holds E/m experts and runs the
    GEMM on their slots of every token; the router and the dispatch stay
    replicated, and the ranks' combined outputs are summed (``reduce``);
  * "mlp" over "model" (grok-1's default, ``expert_mlp``): each expert's
    FFN is split inside, gate and up column-parallel and down row-parallel,
    the GEMM at F/m, its partial outputs summed before the combine.

Layers are a loop over the stacked leaves, each one call of
``layers.remat``.  Under sequence parallelism the routing sees the whole
sequence: the block gathers it (``tp.gather``), and its output leaves for
the residual stream as the rank's slice (``seq_leave`` of the experts'
partial sums, a whole result cut).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_rope, mlp, remat, rms_norm
from repro_torch.models.spec import ParamSpec, dense, layer, layers, stacked
from repro_torch.models.transformer import _positions, attn_specs, embed, head, logits, n_stacked
from repro_torch.models.transformer import cache_specs as dense_cache_specs
from repro_torch.parallel import tensor as tp

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-3


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def moe_specs(cfg: ArchConfig, dt: str) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    tree = {
        "router": dense((D, E), ("embed", None), dt, scale=0.02),
        "w_gate": dense((E, D, F_), ("experts", "embed", "mlp"), dt),
        "w_up": dense((E, D, F_), ("experts", "embed", "mlp"), dt),
        "w_down": dense((E, F_, D), ("experts", "mlp", "embed"), dt),
    }
    if cfg.moe_dense_residual:
        tree["dense"] = {
            "w_gate": dense((D, F_), ("embed", "mlp"), dt),
            "w_up": dense((D, F_), ("embed", "mlp"), dt),
            "w_down": dense((F_, D), ("mlp", "embed"), dt),
        }
    return tree


def block_specs(cfg: ArchConfig, dt: str) -> dict:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "attn": attn_specs(cfg, dt),
        "ln_mlp": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "moe": moe_specs(cfg, dt),
    }


def specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    return {
        "embed": dense((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), dt, scale=0.02),
        "blocks": stacked(cfg.n_layers, block_specs(cfg, dt)),
        "ln_f": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "lm_head": dense((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt),
    }


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def capacity(cfg: ArchConfig, group: int) -> int:
    return max(1, math.ceil(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def topk(probs: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices, ties
    broken towards the lower index, as ``jax.lax.top_k`` breaks them (a
    stable descending sort keeps equal values in index order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(cfg: ArchConfig, logits: torch.Tensor):
    """logits (G, g, E) -> (dispatch (G,g,E,C), combine (G,g,E,C), aux, z),
    all fp32.  First-choice slots get capacity priority over second choices
    (Switch).  A request past its expert's capacity (pos >= C) gets no slot:
    its row of the one-hot is zero, as ``jax.nn.one_hot`` gives it."""
    G, g, E = logits.shape
    C = capacity(cfg, g)
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    top_v, top_i = topk(probs, cfg.top_k)  # (G, g, k)
    top_v = top_v / torch.clamp(torch.sum(top_v, -1, keepdim=True), min=1e-9)

    onehot = F.one_hot(top_i, E).float()  # (G, g, k, E)
    # priority order: all 1st choices before any 2nd choice within the group
    oh = onehot.transpose(1, 2).reshape(G, cfg.top_k * g, E)
    pos = torch.cumsum(oh, dim=1) - oh  # position of each request in its expert queue
    keep = (pos < C).float() * oh
    slot = (pos[..., None] == torch.arange(C, dtype=pos.dtype, device=pos.device)).float() * keep[..., None]
    slot = slot.reshape(G, cfg.top_k, g, E, C).transpose(1, 2)  # (G, g, k, E, C)
    dispatch = torch.sum(slot, dim=2)  # (G, g, E, C)
    combine = torch.sum(slot * top_v[..., None, None], dim=2)  # (G, g, E, C)

    # load-balancing aux loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e)
    frac = torch.mean(onehot[:, :, 0, :], dim=1)  # first-choice fraction (G, E)
    mean_p = torch.mean(probs, dim=1)  # (G, E)
    aux = E * torch.mean(torch.sum(frac * mean_p, dim=-1))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return dispatch, combine, aux, z


def _rank_experts(n_local: int, outer: int) -> list:
    """The global ids of the rank's experts: block ``j m + r`` of ``outer m``
    for each j < outer."""
    m, r, size = tp.model_size(), tp.model_rank(), n_local // outer
    return [(j * m + r) * size + t for j in range(outer) for t in range(size)]


def moe_ffn(cfg: ArchConfig, x: torch.Tensor, p: dict, *, seq: bool = False):
    """x (B, L, D) -> (y (B, L, D), aux_metrics dict).  ``seq``: x and y are
    the rank's slices of the sequence, the routing runs on the whole."""
    x_in = x
    if seq:
        x = tp.gather(x, 1)
    B, L, D = x.shape
    T = B * L
    g = min(cfg.moe_group_size, T)
    while T % g:  # fall back to the largest divisor of T (odd test lengths)
        g -= 1
    G = T // g
    xg = x.reshape(G, g, D)

    E, F_ = cfg.n_experts, cfg.d_ff
    # under "serve_2dtp" the router's and the experts' d_model dims are cut
    # over "data": each product reads the rank's "data" block of its input
    # and sums its partial results over "data"; the down product's result is
    # cut over "data" and gathered after the combine
    two_d = tp.data_split(("embed", None), (D, E)) is not None
    if two_d and tp.data_split(("experts", "embed", "mlp"), (E, D, F_)) != (1, 1):
        raise NotImplementedError("expert weights cut over 'data' off their d_model dim")
    scores = torch.einsum("Ggd,de->Gge", (tp.split(xg, -1, axis="data") if two_d else xg).float(), p["router"].float())
    dispatch, combine, aux, z = route(cfg, tp.reduce(scores, axis="data") if two_d else scores)
    dispatch = dispatch.to(x.dtype)
    C = dispatch.shape[3]

    by_expert = tp.weight_split(("experts", "embed", "mlp"), (E, D, F_))
    if by_expert is not None and by_expert[0] not in (0, 2):
        raise NotImplementedError(f"expert weights (E, D, F) split over 'model' as (dim, outer) {by_expert}")
    experts = by_expert is not None and by_expert[0] == 0
    if experts:
        # this rank's experts, over the slots of every token
        El = p["w_gate"].shape[0]
        xg, combine = tp.enter(xg), tp.enter(combine)
        if by_expert[1] == 1:
            lo = tp.model_rank() * El
            dispatch, combine = dispatch[:, :, lo:lo + El], combine[:, :, lo:lo + El]
        else:
            sel = torch.tensor(_rank_experts(El, by_expert[1]), device=x.device)
            dispatch, combine = dispatch.index_select(2, sel), combine.index_select(2, sel)
        E = El
    # each expert's rows of every group together: (E, G * C, D)
    xe = torch.einsum("Ggd,Ggec->eGcd", xg, dispatch).contiguous().reshape(E, G * C, D)
    inner = by_expert is not None and by_expert[0] == 2
    if inner:  # each expert's FFN split over "model": gate and up column-, down row-parallel
        xe = tp.enter(xe)
    # the grouped GEMM kernel; its wrapper picks blocks that divide the shapes
    if two_d:
        xe = tp.split(xe, -1, axis="data")
        h = F.silu(tp.reduce(ops.moe_gmm(xe, p["w_gate"]), axis="data")) * tp.reduce(ops.moe_gmm(xe, p["w_up"]), axis="data")
    else:
        h = F.silu(ops.moe_gmm(xe, p["w_gate"])) * ops.moe_gmm(xe, p["w_up"])
    ye = ops.moe_gmm(tp.enter(h, axis="data") if two_d else h, p["w_down"])
    if inner:
        ye = tp.reduce(ye)
    if two_d:  # the combine reads the rank's "data" cut of d_model: its gradient summed over "data"
        combine = tp.enter(combine, axis="data")
    y = torch.einsum("eGcd,Ggec->Ggd", ye.reshape(E, G, C, -1).float(), combine)
    y = y.reshape(B, L, -1)
    if experts:  # the ranks' experts' partial sums
        y = tp.seq_leave(y) if seq else tp.reduce(y)
    elif seq:
        y = tp.split(y, 1)
    if two_d:
        y = tp.gather(y, -1, axis="data")
    y = y.to(x.dtype)
    if "dense" in p:  # arctic: parallel dense residual MLP
        y = y + mlp(x_in, p["dense"], F_, F.silu, seq=seq)
    return y, {"aux_loss": aux, "z_loss": z}


# ---------------------------------------------------------------------------
# Blocks / model passes
# ---------------------------------------------------------------------------


def _attn(cfg: ArchConfig, x, p, pos, seq: bool = False):
    """The attention half of a block: (x after it, (k, v))."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["attn"], h, seq=seq)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn.attention(q, k, v, causal=True)
    return x + attn.heads_out(cfg, a, p["attn"]["wo"], q_split, seq=seq), (k, v)


def moe_block(cfg: ArchConfig, x, p, pos, seq: bool = False):
    x, _ = _attn(cfg, x, p, pos, seq)
    y, aux = moe_ffn(cfg, rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq), p["moe"], seq=seq)
    return x + y, aux


def forward(cfg: ArchConfig, params, tokens, extras=None, *, gather: bool = True):
    """Returns (logits, moe_metrics): the aux and z losses averaged over the
    layers, each layer gathered and rematerialised by ``cfg.remat``.  With
    ``gather`` False the logits are ``_head``'s (logits, vocab split) pair."""
    seq = tp.seq_split(tokens.shape[1])
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)

    def body(x, p):
        x, aux = moe_block(cfg, x, tp.fsdp(p), pos, seq)
        return x, aux["aux_loss"], aux["z_loss"]

    n = n_stacked(params["blocks"])
    aux_sum = z_sum = 0.0
    for p in layers(params["blocks"]):
        x, aux, z = remat(body, x, p, policy=cfg.remat)
        aux_sum, z_sum = aux_sum + aux, z_sum + z
    return logits(cfg, params, x, tokens.shape[1], gather=gather), {"aux_loss": aux_sum / n, "z_loss": z_sum / n}


def aux_loss(metrics: dict) -> torch.Tensor:
    return AUX_LOSS_WEIGHT * metrics["aux_loss"] + Z_LOSS_WEIGHT * metrics["z_loss"]


cache_specs = dense_cache_specs


def _decode_block(cfg, x, p, layer_cache, pos):
    """One decode token through a moe block (x (B, 1, D) whole; the layer's
    cache as the prefill leaves it): the experts at the rank's shard, as
    ``moe_ffn`` splits them.  The token's k and v are written into the
    cache in place."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a = attn.decode_self_attention(cfg, p["attn"], h, layer_cache["k"], layer_cache["v"], pos)
    x = x + a
    y, _ = moe_ffn(cfg, rms_norm(x, p["ln_mlp"], cfg.norm_eps), p["moe"])
    return x + y


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len=None):
    """Full-sequence forward that also returns the KV cache.
    Returns (last-token logits (B, 1, V), cache)."""
    B, L = tokens.shape
    cache_len = cache_len or L
    seq = tp.seq_split(L)
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    ks, vs = [], []
    for i in range(n_stacked(params["blocks"])):
        p = tp.fsdp(layer(params["blocks"], i))
        x, (k, v) = _attn(cfg, x, p, pos, seq)
        y, _ = moe_ffn(cfg, rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq), p["moe"], seq=seq)
        x = x + y
        if cache_len > L:
            k, v = (F.pad(t, (0, 0, 0, 0, 0, cache_len - L)) for t in (k, v))
        ks.append(k)
        vs.append(v)
    return head(cfg, params, x, seq=seq), {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step.  tokens (B, 1), pos (B,).  Returns (logits, cache),
    the token written into ``cache`` in place (``attention.write_cache``);
    each layer gathered where it runs (``tp.fsdp``)."""
    x = embed(cfg, params, tokens, False)
    for i in range(n_stacked(params["blocks"])):
        x = _decode_block(cfg, x, tp.fsdp(layer(params["blocks"], i)), layer(cache["layers"], i), pos)
    return head(cfg, params, x), {"layers": cache["layers"]}
