"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local (sliding
window) MQA attention in a repeating (rec, rec, attn) pattern.

Counterpart of ``repro/models/rglru.py``.  Over a full sequence the RG-LRU
recurrence runs on the ``rglru_scan`` kernel (``ops.rglru_scan``) and the
local attention on the flash kernel, windowed; on CPU tensors both run their
plain versions.  The decode step (``rglru_step``, one-token attention against
the ring buffer) is plain PyTorch, as in the reference.  A stack that is not
a whole number of superblocks ends in recurrent layers (``_layout``:
recurrentgemma-2b's 26 = 8 x 3 + 2).

Under tensor parallelism (the train, prefill and decode passes) the recurrent
channels split over "model" where the rules split "rnn": ``w_x`` and
``w_gate`` column-parallel, the conv and ``rglru_scan`` at dr / m, ``w_out``
row-parallel.  The gates' block-diagonal weights (nb, bd, bd) split with
them where m divides nb.  Where it does not, the gate blocks stay whole and
a rank's channels straddle a block boundary (dr 48 in 16 blocks of 3 on
m = 3: rank 1 holds channels 16 to 31, blocks 5 to 10 in part), so the
gates run on the whole activation, gathered over "model", and the rank
takes its channels of their outputs.  (recurrentgemma-2b's 2560 channels
form 16 blocks of 160, which any m up to 16 that divides 2560 splits on
block boundaries.)  Under sequence parallelism ``w_x`` and ``w_gate`` read
the whole sequence (``seq_enter``) and ``w_out`` leaves through
``seq_leave``: the conv and the scan see the whole sequence.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_rope, causal_conv1d, conv1d_step, gelu, linears, mlp, remat, rms_norm, whole
from repro_torch.models.spec import ParamSpec, dense, layer, layers, stack_layers, stacked
from repro_torch.models.transformer import _positions, attn_specs, embed, head, logits, n_stacked
from repro_torch.parallel import tensor as tp

N_GATE_BLOCKS = 16  # block-diagonal gate blocks == model-axis size
LRU_C = 8.0


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _gate_blocks(cfg: ArchConfig) -> int:
    nb = N_GATE_BLOCKS
    while cfg.rnn_dim % nb:
        nb //= 2
    return max(nb, 1)


def rec_specs(cfg: ArchConfig, dt: str) -> dict:
    D, dr, K = cfg.d_model, cfg.rnn_dim, 4
    nb = _gate_blocks(cfg)
    bd = dr // nb
    return {
        "ln": ParamSpec((D,), ("norm",), dt, "zeros"),
        "w_x": dense((D, dr), ("embed", "rnn"), dt),
        "w_gate": dense((D, dr), ("embed", "rnn"), dt),
        "conv_w": dense((dr, K), ("rnn", "conv"), dt, scale=0.5),
        "conv_b": ParamSpec((dr,), ("rnn",), dt, "zeros"),
        "w_rec_gate": dense((nb, bd, bd), ("rnn", None, None), dt),
        "b_rec_gate": ParamSpec((dr,), ("rnn",), dt, "zeros"),
        "w_in_gate": dense((nb, bd, bd), ("rnn", None, None), dt),
        "b_in_gate": ParamSpec((dr,), ("rnn",), dt, "zeros"),
        "lam": ParamSpec((dr,), ("rnn",), "float32", "rglru_lambda"),
        "w_out": dense((dr, D), ("rnn", "embed"), dt),
        "ln_mlp": ParamSpec((D,), ("norm",), dt, "zeros"),
        "mlp": {
            "w_gate": dense((D, cfg.d_ff), ("embed", "mlp"), dt),
            "w_up": dense((D, cfg.d_ff), ("embed", "mlp"), dt),
            "w_down": dense((cfg.d_ff, D), ("mlp", "embed"), dt),
        },
    }


def attn_block_specs(cfg: ArchConfig, dt: str) -> dict:
    return {
        "ln": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "attn": attn_specs(cfg, dt),
        "ln_mlp": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "mlp": {
            "w_gate": dense((cfg.d_model, cfg.d_ff), ("embed", "mlp"), dt),
            "w_up": dense((cfg.d_model, cfg.d_ff), ("embed", "mlp"), dt),
            "w_down": dense((cfg.d_ff, cfg.d_model), ("mlp", "embed"), dt),
        },
    }


def _layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_superblocks, n_tail_rec_layers)."""
    p = len(cfg.block_pattern or ("rec", "rec", "attn"))
    return cfg.n_layers // p, cfg.n_layers % p


def specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    n_super, n_tail = _layout(cfg)
    tree: dict[str, Any] = {
        "embed": dense((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), dt, scale=0.02),
        "superblocks": stacked(
            n_super,
            {
                "rec1": rec_specs(cfg, dt),
                "rec2": rec_specs(cfg, dt),
                "attn": attn_block_specs(cfg, dt),
            },
        ),
        "ln_f": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "lm_head": dense((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt),
    }
    if n_tail:
        tree["tail"] = stacked(n_tail, rec_specs(cfg, dt))
    return tree


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _block_diag(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u (..., dr) @ block-diagonal w (nb, bd, bd) + b."""
    nb, bd, _ = w.shape
    ub = u.reshape(u.shape[:-1] + (nb, bd))
    out = torch.einsum("...kd,kde->...ke", ub, w)
    return out.reshape(u.shape) + b


class _OneMinusExp(torch.autograd.Function):
    """1 - exp(x) = -expm1(x), with the derivative -exp(x) taken as such.
    The default expm1 derivative of torch, and of JAX (the reference's),
    forms exp(x) as expm1(x) + 1, which keeps few digits of exp(x) where it
    is small against 1 and none below fp32's resolution (x < -17).  The
    gates' log_a reaches there at init, and the gradient of lam and of the
    recurrence gate then loses ~1e-4 of its scale (tests/test_torch_train.py
    measures it against a float64 evaluation)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return -torch.expm1(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return -grad * torch.exp(x)


def _lru_gates(p: dict, u: torch.Tensor):
    """Returns (log_a (..., dr) f32, gated_input (..., dr) f32)."""
    r = torch.sigmoid(_block_diag(u, p["w_rec_gate"], p["b_rec_gate"]).float())
    i = torch.sigmoid(_block_diag(u, p["w_in_gate"], p["b_in_gate"]).float())
    log_a = -LRU_C * r * F.softplus(p["lam"].float())
    beta = torch.sqrt(_OneMinusExp.apply(2.0 * log_a))  # sqrt(1 - a^2), stable
    return log_a, beta * i * u.float()


def _gates_of_split(cfg: ArchConfig, p: dict, u: torch.Tensor, outer: int = 1):
    """``_lru_gates`` of the rank's channels ``u`` (B, L, dr / m) where the
    gate blocks are whole on every rank: the gates run on the whole
    activation and the gate vectors, gathered over "model" (the channels'
    ``outer`` blocks), and the rank takes its channels of log_a and the
    gated input."""
    nb = _gate_blocks(cfg)
    bd = cfg.rnn_dim // nb
    if tp.weight_split(("rnn", None, None), (nb, bd, bd)) is not None:
        return _lru_gates(p, u)  # the rank holds the blocks of its channels
    full = {k: tp.gather(p[k], -1, outer) for k in ("b_rec_gate", "b_in_gate", "lam")}
    log_a, gx = _lru_gates({**p, **full}, tp.gather(u, -1, outer))
    return tp.split(log_a, -1, outer), tp.split(gx, -1, outer)


def rglru_seq(p: dict, u: torch.Tensor, h0=None, cfg: Optional[ArchConfig] = None, split=None):
    """RG-LRU over a full sequence on the ``rglru_scan`` kernel.
    u (B, L, dr) -> (y, h_last (B, dr) f32).  With ``split`` (u holds the
    rank's channels, ``split`` their outer) the gates as ``_gates_of_split``
    runs them."""
    log_a, gx = _lru_gates(p, u) if split is None else _gates_of_split(cfg, p, u, split)
    y, h_last = ops.rglru_scan(log_a.contiguous(), gx.contiguous(), h0)
    return y.to(u.dtype), h_last


def rglru_step(p: dict, u_t: torch.Tensor, h: torch.Tensor, cfg: Optional[ArchConfig] = None, split=None):
    """One decode step.  u_t (B, dr); h (B, dr) f32.  With ``split`` (u_t and
    h hold the rank's channels, ``split`` their outer) the gates as
    ``_gates_of_split`` runs them."""
    log_a, gx = _lru_gates(p, u_t) if split is None else _gates_of_split(cfg, p, u_t, split)
    h_new = torch.exp(log_a) * h + gx
    return h_new.to(u_t.dtype), h_new


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def rec_block(cfg: ArchConfig, x, p, h0=None, seq: bool = False):
    """Full-seq recurrent block.  Returns (x, (h_last, conv_tail)); ``seq``:
    x is the rank's slice of the sequence."""
    D, dr = cfg.d_model, cfg.rnn_dim
    h_in = rms_norm(x, p["ln"], cfg.norm_eps, seq=seq)
    (u_pre, split), (g, _) = linears(h_in, [(p[n], ("embed", "rnn"), (D, dr)) for n in ("w_x", "w_gate")], seq_in=seq)
    g = gelu(g)
    u = causal_conv1d(u_pre, p["conv_w"], p["conv_b"])
    y, h_last = rglru_seq(p, u, h0, cfg, split)
    [(out, os_)] = linears(y * g, [(p["w_out"], ("rnn", "embed"), (dr, D))], x_split=split is not None, seq_out=seq)
    x = x + whole(out, os_)
    h2 = rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq)
    x = x + mlp(h2, p["mlp"], cfg.d_ff, gelu, seq=seq)
    conv_tail = u_pre[:, -3:, :]
    return x, (h_last, conv_tail)


def attn_block(cfg: ArchConfig, x, p, pos, seq: bool = False):
    """Local-window MQA block.  Returns (x, (k, v))."""
    h = rms_norm(x, p["ln"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["attn"], h, seq=seq)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn.attention(q, k, v, causal=True, window=cfg.local_window)
    x = x + attn.heads_out(cfg, a, p["attn"]["wo"], q_split, seq=seq)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq)
    x = x + mlp(h, p["mlp"], cfg.d_ff, gelu, seq=seq)
    return x, (k, v)


# ---------------------------------------------------------------------------
# Model passes
# ---------------------------------------------------------------------------


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Hidden states before the LM head; each superblock, and each tail
    layer, gathered and rematerialised by ``cfg.remat`` when gradients are
    taken (the reference's scan steps)."""
    seq = tp.seq_split(tokens.shape[1])
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)

    def super_body(x, p):
        p = tp.fsdp(p)
        x, _ = rec_block(cfg, x, p["rec1"], seq=seq)
        x, _ = rec_block(cfg, x, p["rec2"], seq=seq)
        return attn_block(cfg, x, p["attn"], pos, seq)[0]

    for p in layers(params["superblocks"]):
        x = remat(super_body, x, p, policy=cfg.remat)
    if "tail" in params:
        for p in layers(params["tail"]):
            x = remat(lambda x, p: rec_block(cfg, x, tp.fsdp(p), seq=seq)[0], x, p, policy=cfg.remat)
    return x


def forward(cfg: ArchConfig, params, tokens, extras=None):
    return logits(cfg, params, backbone(cfg, params, tokens, extras), tokens.shape[1])


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    """LRU states + conv windows + ring-buffer attention caches."""
    n_super, n_tail = _layout(cfg)
    W = min(cfg.local_window, cache_len)
    dr, KV, hd = cfg.rnn_dim, cfg.n_kv_heads, cfg.hd
    ct = cfg.compute_dtype
    sb = {
        "rec1_h": ParamSpec((n_super, batch, dr), ("layers", "cache_batch", "rnn_act"), "float32", "zeros"),
        "rec1_conv": ParamSpec((n_super, batch, 3, dr), ("layers", "cache_batch", None, "rnn_act"), ct, "zeros"),
        "rec2_h": ParamSpec((n_super, batch, dr), ("layers", "cache_batch", "rnn_act"), "float32", "zeros"),
        "rec2_conv": ParamSpec((n_super, batch, 3, dr), ("layers", "cache_batch", None, "rnn_act"), ct, "zeros"),
        "k": ParamSpec(
            (n_super, batch, W, KV, hd), ("layers", "cache_batch", "cache_seq", "kv_heads_act", None), ct, "zeros"
        ),
        "v": ParamSpec(
            (n_super, batch, W, KV, hd), ("layers", "cache_batch", "cache_seq", "kv_heads_act", None), ct, "zeros"
        ),
    }
    tree = {"superblocks": sb}
    if n_tail:
        tree["tail"] = {
            "h": ParamSpec((n_tail, batch, dr), ("layers", "cache_batch", "rnn_act"), "float32", "zeros"),
            "conv": ParamSpec((n_tail, batch, 3, dr), ("layers", "cache_batch", None, "rnn_act"), ct, "zeros"),
        }
    return tree


def ring_from_seq(k: torch.Tensor, window: int) -> torch.Tensor:
    """(B, L, KV, hd) -> ring (B, W, KV, hd): token t at slot t % W, the
    last W tokens kept (``rglru.py:299-307``)."""
    B, L = k.shape[:2]
    if L >= window:
        slots = torch.arange(L - window, L, device=k.device) % window
        ring = torch.zeros((B, window) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
        ring[:, slots] = k[:, -window:]
        return ring
    return F.pad(k, (0, 0, 0, 0, 0, window - L))


def _rec_step(cfg, x, p, h, conv_state):
    """x (B, 1, D) decode step of a recurrent block.  Under tensor
    parallelism as the prefill's block: ``w_x`` and ``w_gate``
    column-parallel to the rank's channels, which ``h`` and ``conv_state``
    hold, the gates on gathered channels where the rank's straddle their
    blocks (``_gates_of_split``), ``w_out`` row-parallel.  Under
    "serve_2dtp" the states hold the rank's rows of the batch: the conv
    step and the recurrence run on them (``tp.batch_part``)."""
    D, dr = cfg.d_model, cfg.rnn_dim
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    (u_pre, split), (g, _) = linears(h_in, [(p[n], ("embed", "rnn"), (D, dr)) for n in ("w_x", "w_gate")])
    u_pre, g = tp.batch_part(u_pre), tp.batch_part(gelu(g))
    u, conv_state = conv1d_step(u_pre, conv_state, p["conv_w"], p["conv_b"])
    y, h_new = rglru_step(p, u, h, cfg, split)
    [(out, os_)] = linears(tp.batch_whole(y * g), [(p["w_out"], ("rnn", "embed"), (dr, D))], x_split=split is not None)
    x = x + whole(out, os_)[:, None, :]
    h2 = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    x = x + mlp(h2, p["mlp"], cfg.d_ff, gelu)
    return x, h_new, conv_state


def _attn_step(cfg, x, p, k_cache, v_cache, pos):
    """The local attention block's decode step on its ring-buffer cache
    (the rank's KV heads under tensor parallelism)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    a, ck, cv = attn.decode_self_attention(cfg, p["attn"], h, k_cache, v_cache, pos, ring=True, window=cfg.local_window)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    x = x + mlp(h, p["mlp"], cfg.d_ff, gelu)
    return x, ck, cv


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len=None):
    B, L = tokens.shape
    cache_len = cache_len or L
    W = min(cfg.local_window, cache_len)
    seq = tp.seq_split(L)
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    sb = []
    for i in range(n_stacked(params["superblocks"])):
        p = tp.fsdp(layer(params["superblocks"], i))
        x, (h1, cv1) = rec_block(cfg, x, p["rec1"], seq=seq)
        x, (h2, cv2) = rec_block(cfg, x, p["rec2"], seq=seq)
        x, (k, v) = attn_block(cfg, x, p["attn"], pos, seq)
        sb.append({
            "rec1_h": h1, "rec1_conv": cv1,
            "rec2_h": h2, "rec2_conv": cv2,
            "k": ring_from_seq(k, W), "v": ring_from_seq(v, W),
        })
    cache = {"superblocks": stack_layers(sb)}
    if "tail" in params:
        tail = []
        for i in range(n_stacked(params["tail"])):
            x, (h, cv) = rec_block(cfg, x, tp.fsdp(layer(params["tail"], i)), seq=seq)
            tail.append({"h": h, "conv": cv})
        cache["tail"] = stack_layers(tail)
    return head(cfg, params, x, seq=seq), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step; each superblock and tail layer gathered where it
    runs (``tp.fsdp``)."""
    x = embed(cfg, params, tokens, False)
    sb = []
    for i in range(n_stacked(params["superblocks"])):
        p, lc = tp.fsdp(layer(params["superblocks"], i)), layer(cache["superblocks"], i)
        x, h1, cv1 = _rec_step(cfg, x, p["rec1"], lc["rec1_h"], lc["rec1_conv"])
        x, h2, cv2 = _rec_step(cfg, x, p["rec2"], lc["rec2_h"], lc["rec2_conv"])
        x, ck, cvv = _attn_step(cfg, x, p["attn"], lc["k"], lc["v"], pos)
        sb.append({
            "rec1_h": h1, "rec1_conv": cv1,
            "rec2_h": h2, "rec2_conv": cv2,
            "k": ck, "v": cvv,
        })
    new_cache = {"superblocks": stack_layers(sb)}
    if "tail" in params:
        tail = []
        for i in range(n_stacked(params["tail"])):
            x, h, cv = _rec_step(cfg, x, tp.fsdp(layer(params["tail"], i)), *(layer(cache["tail"], i)[k] for k in ("h", "conv")))
            tail.append({"h": h, "conv": cv})
        new_cache["tail"] = stack_layers(tail)
    return head(cfg, params, x), new_cache
