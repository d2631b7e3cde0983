"""Encoder-decoder transformer backbone (seamless-m4t-medium).

Counterpart of ``repro/models/encdec.py``.  The multimodal frontend is a stub,
as in the reference: the batch carries precomputed frame embeddings
``enc_frames`` (B, Le, D).  A bidirectional encoder feeds a causal decoder
whose every layer also attends to the encoder's output.  Every prefill
attention runs on the flash kernel (``models/attention.py``): the encoder's
non-causal self attention, the decoder's causal self attention and its
non-causal cross attention (Lq the prompt, Lk the frames).  The decode step
is plain PyTorch, as in the reference: self attention against the cache and
cross attention against the encoder K/V the prefill cached.  Layers are a
loop over the stacked leaves, each one call of ``remat``.  Under tensor
parallelism every attention (the encoder's, the decoder's self and cross
attention, its keys and values from the whole encoder output) and every MLP
splits as the dense family's (``models/attention.py``, ``models/layers.py``).
Under sequence parallelism the encoder's and the decoder's residual streams
each run on the rank's slice of their sequence where "model" divides its
length, and the cross attention's keys and values read the encoder output
through ``seq_enter``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_rope, mlp, remat, rms_norm
from repro_torch.models.spec import ParamSpec, dense, layer, layers, stack_layers, stacked, torch_dtype
from repro_torch.models.transformer import _positions, attn_specs, embed, head, logits, mlp_specs, n_stacked
from repro_torch.parallel import tensor as tp


def enc_block_specs(cfg: ArchConfig, dt: str) -> dict:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "attn": attn_specs(cfg, dt),
        "ln_mlp": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "mlp": mlp_specs(cfg, dt),
    }


def dec_block_specs(cfg: ArchConfig, dt: str) -> dict:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "attn": attn_specs(cfg, dt),
        "ln_cross": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "cross": attn_specs(cfg, dt),
        "ln_mlp": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "mlp": mlp_specs(cfg, dt),
    }


def specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    return {
        "embed": dense((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), dt, scale=0.02),
        "enc_blocks": stacked(cfg.n_enc_layers, enc_block_specs(cfg, dt)),
        "enc_ln_f": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "dec_blocks": stacked(cfg.n_layers, dec_block_specs(cfg, dt)),
        "ln_f": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "lm_head": dense((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def enc_block(cfg: ArchConfig, x, p, pos, seq: bool = False):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["attn"], h, seq=seq)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn.attention(q, k, v, causal=False)
    x = x + attn.heads_out(cfg, a, p["attn"]["wo"], q_split, seq=seq)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq)
    return x + mlp(h, p["mlp"], cfg.d_ff, F.silu, seq=seq)


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, Le, D) stub embeddings -> encoder output (B, Le, D), or
    under sequence parallelism the rank's slice of it; each layer gathered
    and rematerialised by ``cfg.remat`` when gradients are taken."""
    seq = tp.seq_split(frames.shape[1])
    x = frames.to(torch_dtype(cfg.compute_dtype))
    if seq:
        x = tp.split(x, 1)
    pos = torch.arange(frames.shape[1], device=x.device)[None, :]
    body = lambda x, p: enc_block(cfg, x, tp.fsdp(p), pos, seq)
    for p in layers(params["enc_blocks"]):
        x = remat(body, x, p, policy=cfg.remat)
    return rms_norm(x, tp.fsdp(params["enc_ln_f"]), cfg.norm_eps, seq=seq)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _cross_attn(cfg, x, p, enc_out, seq: bool = False, enc_seq: bool = False):
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["cross"], h, enc_out, seq=seq, kv_seq=enc_seq)
    a = attn.attention(q, k, v, causal=False)
    return x + attn.heads_out(cfg, a, p["cross"]["wo"], q_split, seq=seq)


def _cross_attn_cached(cfg, x, p, ck, cv):
    """Decode-time cross attention against the encoder K/V of the prefill
    (the rank's heads and rows, as the prefill leaves them)."""
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    return x + attn.decode_cross_attention(cfg, p["cross"], h, ck, cv)


def dec_block(cfg: ArchConfig, x, p, pos, enc_out, seq: bool = False, enc_seq: bool = False):
    """Returns (x, (k, v)): the layer's output and its self-attention cache.
    ``seq`` and ``enc_seq``: x and the encoder output are the rank's slices
    of their sequences."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["attn"], h, seq=seq)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn.attention(q, k, v, causal=True)
    x = x + attn.heads_out(cfg, a, p["attn"]["wo"], q_split, seq=seq)
    x = _cross_attn(cfg, x, p, enc_out, seq, enc_seq)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq)
    x = x + mlp(h, p["mlp"], cfg.d_ff, F.silu, seq=seq)
    return x, (k, v)


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Decoder hidden states; extras["enc_frames"] (B, Le, D) are the stub
    frame embeddings.  The encoder's output goes into each decoder layer's
    ``remat`` as an argument, so its gradient flows back to the encoder
    through the checkpoint's inputs."""
    enc_out = encode(cfg, params, extras["enc_frames"])
    seq, enc_seq = tp.seq_split(tokens.shape[1]), tp.seq_split(extras["enc_frames"].shape[1])
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    body = lambda x, p, enc_out: dec_block(cfg, x, tp.fsdp(p), pos, enc_out, seq, enc_seq)[0]
    for p in layers(params["dec_blocks"]):
        x = remat(body, x, p, enc_out, policy=cfg.remat)
    return x


def forward(cfg: ArchConfig, params, tokens, extras=None):
    return logits(cfg, params, backbone(cfg, params, tokens, extras), tokens.shape[1])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    KV, hd, L, Le = cfg.n_kv_heads, cfg.hd, cfg.n_layers, cfg.enc_len_serve
    ct = cfg.compute_dtype
    ax = ("layers", "cache_batch", "cache_seq", "kv_heads_act", None)
    return {
        "layers": {
            "k": ParamSpec((L, batch, cache_len, KV, hd), ax, ct, "zeros"),
            "v": ParamSpec((L, batch, cache_len, KV, hd), ax, ct, "zeros"),
            "cross_k": ParamSpec((L, batch, Le, KV, hd), ax, ct, "zeros"),
            "cross_v": ParamSpec((L, batch, Le, KV, hd), ax, ct, "zeros"),
        }
    }


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len: Optional[int] = None):
    """Returns (last-token logits (B, 1, V), cache): the self k and v padded
    to ``cache_len``, the cross k and v over the Le frames."""
    enc_out = encode(cfg, params, extras["enc_frames"])
    B, L = tokens.shape
    cache_len = cache_len or L
    seq, enc_seq = tp.seq_split(L), tp.seq_split(extras["enc_frames"].shape[1])
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    layers = []
    for i in range(n_stacked(params["dec_blocks"])):
        p = tp.fsdp(layer(params["dec_blocks"], i))
        x, (k, v) = dec_block(cfg, x, p, pos, enc_out, seq, enc_seq)
        if cache_len > L:
            k, v = (F.pad(t, (0, 0, 0, 0, 0, cache_len - L)) for t in (k, v))
        xk, xv = attn.heads_kv(cfg, p["cross"], enc_out, seq=enc_seq)
        layers.append({"k": k, "v": v, "cross_k": xk, "cross_v": xv})
    return head(cfg, params, x, seq=seq), {"layers": stack_layers(layers)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step.  tokens (B, 1), pos (B,).  The token is written into
    the self caches in place (``write_cache``), and the cache returned is
    ``cache``; the cross K/V pass through unchanged.  Each layer gathered
    where it runs (``tp.fsdp``)."""
    x = embed(cfg, params, tokens, False)
    lcs = cache["layers"]
    for i in range(n_stacked(params["dec_blocks"])):
        p, lc = tp.fsdp(layer(params["dec_blocks"], i)), layer(lcs, i)
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a = attn.decode_self_attention(cfg, p["attn"], h, lc["k"], lc["v"], pos)
        x = x + a
        x = _cross_attn_cached(cfg, x, p, lc["cross_k"], lc["cross_v"])
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        x = x + mlp(h, p["mlp"], cfg.d_ff, F.silu)
    return head(cfg, params, x), {"layers": lcs}
