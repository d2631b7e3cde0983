"""Dense decoder-only GQA transformer (llama3 / internlm2 / granite family).

Counterpart of ``repro/models/transformer.py``.  Its prefill attention runs
on the flash kernel (``models/attention.py``); its decode step is plain
PyTorch, as in the reference.  Layers are a loop over the stacked leaves.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_rope, embed_tokens, lm_logits, remat, rms_norm, swiglu
from repro_torch.models.spec import ParamSpec, dense, layer, stack_layers, stacked, torch_dtype


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ArchConfig, dt: str) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense((D, H, hd), ("embed", "heads", None), dt),
        "wk": dense((D, KV, hd), ("embed", "kv_heads", None), dt),
        "wv": dense((D, KV, hd), ("embed", "kv_heads", None), dt),
        "wo": dense((H, hd, D), ("heads", None, "embed"), dt),
    }


def mlp_specs(cfg: ArchConfig, dt: str) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense((D, F), ("embed", "mlp"), dt),
        "w_up": dense((D, F), ("embed", "mlp"), dt),
        "w_down": dense((F, D), ("mlp", "embed"), dt),
    }


def block_specs(cfg: ArchConfig, dt: str) -> dict:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "attn": attn_specs(cfg, dt),
        "ln_mlp": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
        "mlp": mlp_specs(cfg, dt),
    }


def specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    tree: dict[str, Any] = {
        "embed": dense((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), dt, scale=0.02),
        "blocks": stacked(cfg.n_layers, block_specs(cfg, dt)),
        "ln_f": ParamSpec((cfg.d_model,), ("norm",), dt, "zeros"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dt)
    return tree


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def self_attn_block(cfg: ArchConfig, x, p, pos, *, window=None):
    """Returns (x, (k, v)): the layer's output and its (k, v) cache."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_proj(h, p["attn"])
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn.attention(q, k, v, causal=True, window=window)
    x = x + attn.out_proj(a, p["attn"]["wo"])
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    x = x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
    return x, (k, v)


def write_cache(cache_k, cache_v, k_t, v_t, pos):
    """Write one token's k/v into the cache at per-batch positions.  Returns
    new caches; the inputs are left as they were, as in the reference."""
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k, cache_v = cache_k.clone(), cache_v.clone()
    cache_k[rows, pos.long()] = k_t[:, 0]
    cache_v[rows, pos.long()] = v_t[:, 0]
    return cache_k, cache_v


def self_attn_block_decode(cfg: ArchConfig, x, p, layer_cache, pos, *, window=None, cache_positions=None):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k_t, v_t = attn.qkv_proj(h, p["attn"])
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_t = apply_rope(k_t, pos[:, None], cfg.rope_theta)
    write_pos = pos if window is None else pos % layer_cache["k"].shape[1]
    ck, cv = write_cache(layer_cache["k"], layer_cache["v"], k_t, v_t, write_pos)
    a = attn.decode_attention(q, ck, cv, pos, cache_positions=cache_positions, window=window)
    x = x + attn.out_proj(a, p["attn"]["wo"])
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    x = x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
    return x, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Full model passes
# ---------------------------------------------------------------------------


def n_stacked(tree) -> int:
    """The length of the leading layer axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree.shape[0]


def _head(cfg: ArchConfig, params, x):
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return lm_logits(x, head.to(x.dtype))


def _positions(tokens):
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Hidden states before the LM head; each layer rematerialised by
    ``cfg.remat`` when gradients are taken."""
    x = embed_tokens(tokens, params["embed"], torch_dtype(cfg.compute_dtype))
    pos = _positions(tokens)
    body = lambda x, p: self_attn_block(cfg, x, p, pos)[0]
    for i in range(n_stacked(params["blocks"])):
        x = remat(body, x, layer(params["blocks"], i), policy=cfg.remat)
    return x


def forward(cfg: ArchConfig, params, tokens, extras=None):
    """Teacher-forced full-sequence forward -> logits (B, L, V)."""
    return _head(cfg, params, backbone(cfg, params, tokens, extras))


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    KV, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    dt = cfg.compute_dtype
    return {
        "layers": {
            "k": ParamSpec(
                (L, batch, cache_len, KV, hd), ("layers", "cache_batch", "cache_seq", "kv_heads_act", None), dt, "zeros"
            ),
            "v": ParamSpec(
                (L, batch, cache_len, KV, hd), ("layers", "cache_batch", "cache_seq", "kv_heads_act", None), dt, "zeros"
            ),
        }
    }


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len: Optional[int] = None):
    """Full-sequence forward that also returns the KV cache.

    Returns (last-token logits (B, 1, V), cache).
    """
    B, L = tokens.shape
    cache_len = cache_len or L
    x = embed_tokens(tokens, params["embed"], torch_dtype(cfg.compute_dtype))
    pos = _positions(tokens)
    ks, vs = [], []
    for i in range(n_stacked(params["blocks"])):
        x, (k, v) = self_attn_block(cfg, x, layer(params["blocks"], i), pos)
        if cache_len > L:
            k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cache_len - L)) for t in (k, v))
        ks.append(k)
        vs.append(v)
    logits = _head(cfg, params, x[:, -1:, :])
    return logits, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step.  tokens (B, 1), pos (B,).  Returns (logits, cache)."""
    x = embed_tokens(tokens, params["embed"], torch_dtype(cfg.compute_dtype))
    new = []
    for i in range(n_stacked(params["blocks"])):
        x, lc = self_attn_block_decode(cfg, x, layer(params["blocks"], i), layer(cache["layers"], i), pos)
        new.append(lc)
    return _head(cfg, params, x), {"layers": stack_layers(new)}
