"""Dense decoder-only GQA transformer (llama3 / internlm2 / granite family).

Counterpart of ``repro/models/transformer.py``.  Its prefill attention runs
on the flash kernel (``models/attention.py``); its decode step is plain
PyTorch, as in the reference.  Layers are a loop over the stacked leaves.
The train and prefill passes take a rank's shards inside a sharded step:
each layer's gathered over the dp axes inside its ``remat`` (``tp.fsdp``),
the embedding and the head where they are used, the "model" shards
computed on under tensor parallelism, and under sequence parallelism the
residual stream on the rank's slice of the sequence (``models/layers.py``);
the decode step takes the same shards and the rank's cache as the prefill
leaves it (``attention.decode_self_attention``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_rope, embed_tokens, last_token, lm_logits, mlp, post_collective, remat, rms_norm,
)
from repro_torch.models.spec import ParamSpec, dense, layer, layers, stacked, torch_dtype
from repro_torch.parallel import tensor as tp


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


def self_attn_block(cfg: ArchConfig, x, p, pos, *, window=None, seq: bool = False):
    """Returns (x, (k, v)): the layer's output and its (k, v) cache.  The
    two branch outputs are tagged ``post_collective`` where the reference
    tags them (``transformer.py:86,88``), for remat "collectives".  ``seq``:
    ``x`` is the rank's slice of the sequence (``pos`` the whole's)."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps, seq=seq)
    q, k, v, q_split = attn.heads_qkv(cfg, p["attn"], h, seq=seq)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn.attention(q, k, v, causal=True, window=window)
    x = x + post_collective(attn.heads_out(cfg, a, p["attn"]["wo"], q_split, seq=seq), cfg.remat)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps, seq=seq)
    x = x + post_collective(mlp(h, p["mlp"], cfg.d_ff, F.silu, seq=seq), cfg.remat)
    return x, (k, v)


def self_attn_block_decode(cfg: ArchConfig, x, p, layer_cache, pos, *, window=None, ring: bool = False):
    """One decode token through a dense block: x (B, 1, D) whole; the
    layer's cache as the prefill leaves it (the rank's rows and KV heads
    under tensor parallelism, ``attention.cached_attention``), which takes
    the token's k and v in place; with ``ring`` the cache is a ring buffer
    of the last ``window`` positions."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    x = x + attn.decode_self_attention(cfg, p["attn"], h, layer_cache["k"], layer_cache["v"], pos, ring=ring,
                                       window=window)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + mlp(h, p["mlp"], cfg.d_ff, F.silu)


# ---------------------------------------------------------------------------
# Full model passes
# ---------------------------------------------------------------------------


def n_stacked(tree) -> int:
    """The length of the leading layer axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree.shape[0]


def head_params(params) -> dict:
    """The leaves the LM head reads: the final norm and the untied head, or
    the embedding table it is tied to (for ``tp.fsdp`` to gather)."""
    return {k: params[k] for k in ("ln_f", "lm_head" if "lm_head" in params else "embed")}


def head_split(cfg: ArchConfig, params):
    """The LM head (D, V), untied or the embedding table's transpose, and
    its ``weight_split`` under tensor parallelism."""
    head = params.get("lm_head")
    if head is not None:
        return head, tp.weight_split(("embed", "vocab"), (cfg.d_model, cfg.vocab_size))
    split = tp.weight_split(("vocab", "embed_table"), (cfg.vocab_size, cfg.d_model))
    return params["embed"].T, None if split is None else (1 - split[0], split[1])


def _head(cfg: ArchConfig, params, x, *, gather: bool = True, seq: bool = False):
    """Final norm and LM head; ``params`` holds ``head_params``' leaves,
    gathered.  Under tensor parallelism a head split on the vocab gives the
    rank's vocab range of the logits, gathered whole unless ``gather`` is
    False (the loss's vocab-parallel cross entropy): then (logits, their
    vocab split or None).  ``seq``: ``x`` is the rank's slice of the
    sequence, and the logits cover the whole of it.  Under "serve_2dtp" an
    untied head's d_model rows are cut over "data" (``lm_logits``'
    ``data_cut``)."""
    x = rms_norm(x, params["ln_f"], cfg.norm_eps, seq=seq)
    head, split = head_split(cfg, params)
    data_cut = "lm_head" in params and tp.data_split(("embed", "vocab"), (cfg.d_model, cfg.vocab_size)) is not None
    logits = lm_logits(x, head.to(x.dtype), split, seq=seq, data_cut=data_cut)
    vocab_split = split is not None and split[0] == 1
    if not gather:
        return logits, split if vocab_split else None
    return tp.gather(logits, -1, split[1]) if vocab_split else logits


def head(cfg: ArchConfig, params, x, *, seq: bool = False):
    """``_head`` of the last token of ``x`` (a prefill's logits), the head's
    leaves gathered here."""
    return _head(cfg, tp.fsdp(head_params(params)), last_token(x, seq))


def _positions(tokens):
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def embed(cfg: ArchConfig, params, tokens, seq: bool):
    """The token embeddings (the table gathered where it is used); ``seq``:
    the rank's slice of the sequence."""
    return embed_tokens(tokens, tp.fsdp(params["embed"]), torch_dtype(cfg.compute_dtype), cfg.vocab_size, seq=seq)


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Hidden states before the LM head (under sequence parallelism the
    rank's slice of the sequence); each layer gathered and rematerialised
    by ``cfg.remat`` when gradients are taken."""
    seq = tp.seq_split(tokens.shape[1])
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    body = lambda x, p: self_attn_block(cfg, x, tp.fsdp(p), pos, seq=seq)[0]
    for p in layers(params["blocks"]):
        x = remat(body, x, p, policy=cfg.remat)
    return x


def logits(cfg: ArchConfig, params, hidden, length: int, *, gather: bool = True):
    """``_head`` of a backbone's hidden states for a sequence of ``length``
    (the head's leaves gathered here)."""
    return _head(cfg, tp.fsdp(head_params(params)), hidden, gather=gather, seq=tp.seq_split(length))


def forward(cfg: ArchConfig, params, tokens, extras=None):
    """Teacher-forced full-sequence forward -> logits (B, L, V)."""
    return logits(cfg, params, backbone(cfg, params, tokens, extras), tokens.shape[1])


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
    seq = tp.seq_split(L)
    x = embed(cfg, params, tokens, seq)
    pos = _positions(tokens)
    ks, vs = [], []
    for i in range(n_stacked(params["blocks"])):
        x, (k, v) = self_attn_block(cfg, x, tp.fsdp(layer(params["blocks"], i)), pos, seq=seq)
        if cache_len > L:
            k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cache_len - L)) for t in (k, v))
        ks.append(k)
        vs.append(v)
    return head(cfg, params, x, seq=seq), {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step.  tokens (B, 1), pos (B,).  Returns (logits, cache):
    the token is written into ``cache`` in place, which is returned
    (``attention.write_cache``).  Inside a sharded step each layer's dp
    shards are gathered where it runs (``tp.fsdp``; nothing under
    "serve_2dtp"), the embedding and the head where they are used, and the
    "model" shards computed on."""
    x = embed(cfg, params, tokens, False)
    for i in range(n_stacked(params["blocks"])):
        x = self_attn_block_decode(cfg, x, tp.fsdp(layer(params["blocks"], i)), layer(cache["layers"], i), pos)
    return head(cfg, params, x), {"layers": cache["layers"]}
