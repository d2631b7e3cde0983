"""VLM backbone (llama-3.2-vision-11b): a dense GQA decoder with a gated
cross-attention image layer every ``cross_attn_period`` layers.

Counterpart of ``repro/models/vision.py``.  The vision frontend is a stub, as
in the reference: the batch carries precomputed patch embeddings
``img_embeds`` (B, n_img_tokens, D).  Layers come in superblocks of
``period`` (period - 1 self layers, then one gated cross layer), stacked
twice: ``superblocks.self`` has a leading (n_super, period - 1) pair of axes.
Every prefill attention runs on the flash kernel (``models/attention.py``):
the causal self attention and the non-causal cross attention of the text
(Lq) to the image tokens (Lk).  The decode step is plain PyTorch, as in the
reference.  The cross layer's two residuals are gated by tanh of an fp32
scalar that starts at zero, so a fresh model's image path adds nothing
until training opens the gates.  Under tensor parallelism the self and
cross attentions and the MLPs split as the dense family's; the gates are
replicated scalars applied to whole branch outputs (under sequence
parallelism to the rank's slice of the sequence, their gradients summed
over "model").
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, remat, rms_norm
from repro_torch.models.spec import ParamSpec, dense, layer, layers, stack_layers, stacked, torch_dtype
from repro_torch.models.transformer import (
    _positions,
    embed,
    head,
    logits,
    attn_specs,
    block_specs as dense_block_specs,
    mlp_specs,
    n_stacked,
    self_attn_block,
    self_attn_block_decode,
)
from repro_torch.parallel import tensor as tp


def xattn_block_specs(cfg: ArchConfig, dt: str) -> dict:
    return {
        "ln": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "cross": attn_specs(cfg, dt),
        "gate_attn": ParamSpec((), (), "float32", "zeros"),  # tanh-gated, starts closed
        "ln_mlp": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "mlp": mlp_specs(cfg, dt),
        "gate_mlp": ParamSpec((), (), "float32", "zeros"),
    }


def _layout(cfg: ArchConfig) -> tuple[int, int]:
    period = cfg.cross_attn_period
    assert period >= 2 and cfg.n_layers % period == 0, (cfg.n_layers, period)
    return cfg.n_layers // period, period


def specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    n_super, period = _layout(cfg)
    return {
        "embed": dense((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), dt, scale=0.02),
        "superblocks": stacked(
            n_super,
            {
                "self": stacked(period - 1, dense_block_specs(cfg, dt)),
                "xattn": xattn_block_specs(cfg, dt),
            },
        ),
        "ln_f": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "lm_head": dense((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt),
    }


def _gated(x, gate, y, dtype):
    """(x + tanh(gate) * y) in fp32, cast to ``dtype``: the residual of a
    gated branch in the reference's order (its fp32 gate promotes the sum)."""
    return (x + torch.tanh(gate) * y.float()).to(dtype)


def _xattn_tail(cfg: ArchConfig, x, p, attn_out, seq: bool = False):
    """The gated attention residual of ``attn_out`` (B, L, D) and the gated
    MLP; ``seq``: x and attn_out are the rank's slices of the sequence."""
    dtype = x.dtype
    gate_attn, gate_mlp = (tp.enter(p[k]) if seq else p[k] for k in ("gate_attn", "gate_mlp"))
    x = _gated(x, gate_attn, attn_out, dtype)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq)
    m = mlp(h, p["mlp"], cfg.d_ff, F.silu, seq=seq)
    return _gated(x, gate_mlp, m, dtype)


def xattn_block(cfg: ArchConfig, x, p, img: torch.Tensor, seq: bool = False):
    """Gated cross attention to the image embeddings (B, n_img, D)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["cross"], h, img, seq=seq)
    a = attn.attention(q, k, v, causal=False)
    return _xattn_tail(cfg, x, p, attn.heads_out(cfg, a, p["cross"]["wo"], q_split, seq=seq), seq)


def _xattn_block_cached(cfg: ArchConfig, x, p, ck, cv):
    """Decode-time gated cross attention against the cached image K/V (the
    rank's heads and rows, as the prefill leaves them)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return _xattn_tail(cfg, x, p, attn.decode_cross_attention(cfg, p["cross"], h, ck, cv))


def _images(cfg: ArchConfig, extras) -> torch.Tensor:
    return extras["img_embeds"].to(torch_dtype(cfg.compute_dtype))


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Hidden states before the LM head: each superblock gathered and one
    ``remat`` by ``cfg.remat``, its self layers inside it without one of
    their own (``vision.py:105,109``).  The image embeddings go into each
    superblock's ``remat`` as an argument."""
    img = _images(cfg, extras)
    seq = tp.seq_split(tokens.shape[1])
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)

    def super_body(x, p, img):
        p = tp.fsdp(p)
        for q in layers(p["self"]):
            x = self_attn_block(cfg, x, q, pos, seq=seq)[0]
        return xattn_block(cfg, x, p["xattn"], img, seq)

    for p in layers(params["superblocks"]):
        x = remat(super_body, x, p, img, policy=cfg.remat)
    return x


def forward(cfg: ArchConfig, params, tokens, extras=None):
    return logits(cfg, params, backbone(cfg, params, tokens, extras), tokens.shape[1])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    n_super, period = _layout(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd
    ct = cfg.compute_dtype
    ax5 = ("layers", None, "cache_batch", "cache_seq", "kv_heads_act", None)
    ax4 = ("layers", "cache_batch", "cache_seq", "kv_heads_act", None)
    return {
        "superblocks": {
            "k": ParamSpec((n_super, period - 1, batch, cache_len, KV, hd), ax5, ct, "zeros"),
            "v": ParamSpec((n_super, period - 1, batch, cache_len, KV, hd), ax5, ct, "zeros"),
            "img_k": ParamSpec((n_super, batch, cfg.n_img_tokens, KV, hd), ax4, ct, "zeros"),
            "img_v": ParamSpec((n_super, batch, cfg.n_img_tokens, KV, hd), ax4, ct, "zeros"),
        }
    }


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len: Optional[int] = None):
    """Returns (last-token logits (B, 1, V), cache): the self k and v of
    (n_super, period - 1, B, cache_len, KV, hd), the image k and v of
    (n_super, B, n_img, KV, hd)."""
    img = _images(cfg, extras)
    B, L = tokens.shape
    cache_len = cache_len or L
    seq = tp.seq_split(L)
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    supers = []
    for i in range(n_stacked(params["superblocks"])):
        p = tp.fsdp(layer(params["superblocks"], i))
        selfs = []
        for j in range(n_stacked(p["self"])):
            x, (k, v) = self_attn_block(cfg, x, layer(p["self"], j), pos, seq=seq)
            if cache_len > L:
                k, v = (F.pad(t, (0, 0, 0, 0, 0, cache_len - L)) for t in (k, v))
            selfs.append({"k": k, "v": v})
        x = xattn_block(cfg, x, p["xattn"], img, seq)
        sb = stack_layers(selfs)
        sb["img_k"], sb["img_v"] = attn.heads_kv(cfg, p["xattn"]["cross"], img)
        supers.append(sb)
    return head(cfg, params, x, seq=seq), {"superblocks": stack_layers(supers)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step.  tokens (B, 1), pos (B,).  The self caches are
    written into copies; the image K/V pass through unchanged.  Each
    superblock gathered where it runs (``tp.fsdp``)."""
    x = embed(cfg, params, tokens, False)
    sbs = cache["superblocks"]
    ks, vs = [], []  # every self layer's new cache, stacked once at the end
    for i in range(n_stacked(params["superblocks"])):
        p, lc = tp.fsdp(layer(params["superblocks"], i)), layer(sbs, i)
        for j in range(n_stacked(p["self"])):
            x, c = self_attn_block_decode(cfg, x, layer(p["self"], j), {"k": lc["k"][j], "v": lc["v"][j]}, pos)
            ks.append(c["k"])
            vs.append(c["v"])
        x = _xattn_block_cached(cfg, x, p["xattn"], lc["img_k"], lc["img_v"])
    grid = tuple(sbs["k"].shape[:2])  # (n_super, period - 1)
    out = {"k": torch.stack(ks).unflatten(0, grid), "v": torch.stack(vs).unflatten(0, grid),
           "img_k": sbs["img_k"], "img_v": sbs["img_v"]}
    return head(cfg, params, x), {"superblocks": out}
