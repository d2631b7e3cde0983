"""Mamba1 selective-SSM stack (falcon-mamba-7b) -- attention-free.

Counterpart of ``repro/models/ssm.py``.  Over a full sequence the scan runs
chunk by chunk on the ``selective_scan`` kernel (``ops.selective_scan_chunk``),
carrying the (B, d_inner, N) state from one chunk to the next; on CPU tensors
each chunk runs the plain version.  The reference's two XLA lowerings of the
chunk (``ssm_scan="assoc"`` and ``"seq"``) compute the same function, and the
tests hold the port against both.  Decode is a single-token recurrence with
O(1) state, plain PyTorch as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, conv1d_step, embed_tokens, remat, rms_norm
from repro_torch.models.spec import ParamSpec, dense, layer, stack_layers, stacked, torch_dtype
from repro_torch.models.transformer import _head, n_stacked


def block_specs(cfg: ArchConfig, dt: str) -> dict:
    D, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {
        "ln": ParamSpec((D,), ("norm",), dt, "zeros"),
        "w_in_x": dense((D, di), ("embed", "ssm_inner"), dt),
        "w_in_z": dense((D, di), ("embed", "ssm_inner"), dt),
        "conv_w": dense((di, K), ("ssm_inner", "conv"), dt, scale=0.5),
        "conv_b": ParamSpec((di,), ("ssm_inner",), dt, "zeros"),
        "w_x_dt": dense((di, R), ("ssm_inner", "dt_rank"), dt),
        "w_x_b": dense((di, N), ("ssm_inner", "ssm_state"), dt),
        "w_x_c": dense((di, N), ("ssm_inner", "ssm_state"), dt),
        "w_dt": dense((R, di), ("dt_rank", "ssm_inner"), dt),
        "b_dt": ParamSpec((di,), ("ssm_inner",), "float32", "ssm_dt_bias"),
        "a_log": ParamSpec((di, N), ("ssm_inner", "ssm_state"), "float32", "ssm_a_log"),
        "d_skip": ParamSpec((di,), ("ssm_inner",), "float32", "ones"),
        "w_out": dense((di, D), ("ssm_inner", "embed"), dt),
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
# Selective scan (chunked)
# ---------------------------------------------------------------------------


def _ssm_inputs(cfg: ArchConfig, p: dict, xb: torch.Tensor):
    """xb (B, L, di) post-conv -> dt (B,L,di) f32, Bm/Cm (B,L,N) f32."""
    dt = ((xb @ p["w_x_dt"]) @ p["w_dt"]).float()
    dt = F.softplus(dt + p["b_dt"].float())
    bm = (xb @ p["w_x_b"]).float()
    cm = (xb @ p["w_x_c"]).float()
    return dt, bm, cm


def chunk_len(cfg: ArchConfig, L: int) -> int:
    """The reference's chunk: ``ssm_chunk``, or the largest divisor of L below it."""
    ck = min(cfg.ssm_chunk, L)
    while L % ck:
        ck -= 1
    return ck


def selective_scan_chunked(cfg: ArchConfig, p, xb, dt, bm, cm, h0=None):
    """Evaluate the selective scan over the full sequence in chunks, one
    kernel launch a chunk.

    xb (B, L, di) in the compute dtype; dt (B, L, di), bm, cm (B, L, N) fp32.
    Returns (y (B, L, di) fp32, h_last (B, di, N) fp32).
    """
    B, L, di = xb.shape
    N = bm.shape[-1]
    ck = chunk_len(cfg, L)
    n_chunks = L // ck
    a = -torch.exp(p["a_log"].float()).contiguous()  # (di, N)

    def to_chunks(t):  # (B, L, ...) -> (n, B, ck, ...), each chunk contiguous
        return t.reshape((B, n_chunks, ck) + tuple(t.shape[2:])).transpose(0, 1).contiguous()

    xs, dts, bs, cs = (to_chunks(t) for t in (xb, dt, bm, cm))
    h = torch.zeros((B, di, N), dtype=torch.float32, device=xb.device) if h0 is None else h0
    ys = []
    for i in range(n_chunks):
        y, h = ops.selective_scan_chunk(xs[i], dts[i], bs[i], cs[i], a, h)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, L, di), h


def _mixer(cfg: ArchConfig, x, p):
    """The block's full-sequence mixer.  Returns (x + out, (h_last, conv_tail))."""
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xb_pre = h_in @ p["w_in_x"]
    z = h_in @ p["w_in_z"]
    xb = F.silu(causal_conv1d(xb_pre, p["conv_w"], p["conv_b"]))
    dt, bm, cm = _ssm_inputs(cfg, p, xb)
    y, h_last = selective_scan_chunked(cfg, p, xb, dt, bm, cm)
    y = (y + p["d_skip"].float() * xb.float()).to(x.dtype)
    y = y * F.silu(z)
    conv_tail = xb_pre[:, -(cfg.ssm_conv - 1):, :]  # last K-1 *pre-conv* inputs
    return x + y @ p["w_out"], (h_last, conv_tail)


def mamba_block(cfg: ArchConfig, x, p):
    """One Mamba block (full-sequence). x (B, L, D)."""
    return _mixer(cfg, x, p)[0]


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Hidden states before the LM head; each layer rematerialised by
    ``cfg.remat`` when gradients are taken."""
    x = embed_tokens(tokens, params["embed"], torch_dtype(cfg.compute_dtype))
    for i in range(n_stacked(params["blocks"])):
        x = remat(lambda x, p: mamba_block(cfg, x, p), x, layer(params["blocks"], i), policy=cfg.remat)
    return x


def forward(cfg: ArchConfig, params, tokens, extras=None):
    return _head(cfg, params, backbone(cfg, params, tokens, extras))


# ---------------------------------------------------------------------------
# Decode (recurrent state; O(1) in sequence length)
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    """Recurrent state: SSM state + conv window per layer.  cache_len unused."""
    di, N, K, L = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.n_layers
    return {
        "layers": {
            "h": ParamSpec((L, batch, di, N), ("layers", "cache_batch", "ssm_inner_act", None), "float32", "zeros"),
            "conv": ParamSpec(
                (L, batch, K - 1, di), ("layers", "cache_batch", None, "ssm_inner_act"), cfg.compute_dtype, "zeros"
            ),
        }
    }


def mamba_decode_block(cfg: ArchConfig, x, p, layer_cache):
    """x (B, 1, D) one token."""
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)  # (B, D)
    xb = h_in @ p["w_in_x"]
    z = h_in @ p["w_in_z"]
    xb, conv_state = conv1d_step(xb, layer_cache["conv"], p["conv_w"], p["conv_b"])
    xb = F.silu(xb)
    dt = F.softplus(((xb @ p["w_x_dt"]) @ p["w_dt"]).float() + p["b_dt"].float())  # (B, di)
    bm = (xb @ p["w_x_b"]).float()  # (B, N)
    cm = (xb @ p["w_x_c"]).float()
    a = -torch.exp(p["a_log"].float())  # (di, N)
    da = torch.exp(dt[..., None] * a)  # (B, di, N)
    db = (dt * xb.float())[..., None] * bm[:, None, :]
    h = da * layer_cache["h"] + db  # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, cm)
    y = y + p["d_skip"].float() * xb.float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return x + y[:, None, :], {"h": h, "conv": conv_state}


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len=None):
    """Full forward, returning the recurrent state after the last token."""
    x = embed_tokens(tokens, params["embed"], torch_dtype(cfg.compute_dtype))
    states = []
    for i in range(n_stacked(params["blocks"])):
        x, (h, conv) = _mixer(cfg, x, layer(params["blocks"], i))
        states.append({"h": h, "conv": conv})
    logits = _head(cfg, params, x[:, -1:, :])
    return logits, {"layers": stack_layers(states)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    x = embed_tokens(tokens, params["embed"], torch_dtype(cfg.compute_dtype))
    new = []
    for i in range(n_stacked(params["blocks"])):
        x, lc = mamba_decode_block(cfg, x, layer(params["blocks"], i), layer(cache["layers"], i))
        new.append(lc)
    return _head(cfg, params, x), {"layers": stack_layers(new)}
