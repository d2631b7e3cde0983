"""Mamba1 selective-SSM stack (falcon-mamba-7b) -- attention-free.

Counterpart of ``repro/models/ssm.py``.  Over a full sequence the scan runs
chunk by chunk on the ``selective_scan`` kernel (``ops.selective_scan_chunk``),
carrying the (B, d_inner, N) state from one chunk to the next; on CPU tensors
each chunk runs the plain version.  On the card each chunk is an autograd
Function whose gradient is the ``selective_scan_bwd`` kernel: since the
chunks chain through ``h``, autograd hands chunk i the gradient of its
``h_last`` from chunk i + 1 (zeros for the last chunk), and under
``remat="dots"`` the layer's recompute replays every chunk's forward launch
before its backward.  The reference's two XLA lowerings of the
chunk (``ssm_scan="assoc"`` and ``"seq"``) compute the same function, and the
tests hold the port against both.  Decode is a single-token recurrence with
O(1) state, plain PyTorch as in the reference.

Under tensor parallelism (the train, prefill and decode passes) the inner channels
split over "model" where the rules split "ssm_inner": ``in_proj`` (``w_in_x``,
``w_in_z``) column-parallel, the conv on the rank's channels, ``x_proj``
(``w_x_dt``, ``w_x_b``, ``w_x_c``) row-parallel with dt, B and C reduced,
``dt_proj`` column-parallel back to the rank's channels, the scan kernel at
d_inner / m, and ``out_proj`` row-parallel.  Under sequence parallelism
``in_proj`` reads the whole sequence (``seq_enter``) and ``out_proj``
leaves through ``seq_leave``: the conv and the scan see the whole sequence.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, conv1d_step, linears, remat, rms_norm, whole
from repro_torch.models.spec import ParamSpec, dense, layer, layers, stack_layers, stacked
from repro_torch.models.transformer import embed, head, logits, n_stacked
from repro_torch.parallel import tensor as tp


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


def _mixer_inputs(cfg: ArchConfig, p: dict, xb: torch.Tensor, split) -> tuple:
    """``_ssm_inputs`` under tensor parallelism, where xb holds the rank's
    channels (``split``, from ``in_proj``): x_proj row-parallel, dt, B and C
    reduced, dt_proj column-parallel back to the rank's channels; B and C
    enter the rank's scan."""
    di, R, N = cfg.d_inner, cfg.dt_rank, cfg.ssm_state
    xs = split is not None
    (dt_low, _), (bm, _), (cm, _) = linears(xb, [
        (p["w_x_dt"], ("ssm_inner", "dt_rank"), (di, R)),
        (p["w_x_b"], ("ssm_inner", "ssm_state"), (di, N)),
        (p["w_x_c"], ("ssm_inner", "ssm_state"), (di, N)),
    ], x_split=xs)
    [(dt, ds)] = linears(dt_low, [(p["w_dt"], ("dt_rank", "ssm_inner"), (R, di))])
    if (ds is None) != (split is None):
        raise NotImplementedError("dt_proj and in_proj split the inner channels differently")
    dt = F.softplus(dt.float() + p["b_dt"].float())
    bm, cm = bm.float(), cm.float()
    if xs:
        bm, cm = tp.enter(bm), tp.enter(cm)
    return dt, bm, cm


def _mixer(cfg: ArchConfig, x, p, seq: bool = False):
    """The block's full-sequence mixer.  Returns (x + out, (h_last,
    conv_tail)); ``seq``: x is the rank's slice of the sequence."""
    D, di = cfg.d_model, cfg.d_inner
    h_in = rms_norm(x, p["ln"], cfg.norm_eps, seq=seq)
    (xb_pre, split), (z, _) = linears(h_in, [(p[n], ("embed", "ssm_inner"), (D, di)) for n in ("w_in_x", "w_in_z")],
                                      seq_in=seq)
    xb = F.silu(causal_conv1d(xb_pre, p["conv_w"], p["conv_b"]))
    dt, bm, cm = _mixer_inputs(cfg, p, xb, split)
    y, h_last = selective_scan_chunked(cfg, p, xb, dt, bm, cm)
    y = (y + p["d_skip"].float() * xb.float()).to(x.dtype)
    y = y * F.silu(z)
    conv_tail = xb_pre[:, -(cfg.ssm_conv - 1):, :]  # last K-1 *pre-conv* inputs
    [(out, os_)] = linears(y, [(p["w_out"], ("ssm_inner", "embed"), (di, D))], x_split=split is not None, seq_out=seq)
    return x + whole(out, os_), (h_last, conv_tail)


def mamba_block(cfg: ArchConfig, x, p, seq: bool = False):
    """One Mamba block (full-sequence). x (B, L, D)."""
    return _mixer(cfg, x, p, seq)[0]


def backbone(cfg: ArchConfig, params, tokens, extras=None):
    """Hidden states before the LM head; each layer gathered and
    rematerialised by ``cfg.remat`` when gradients are taken."""
    seq = tp.seq_split(tokens.shape[1])
    x = embed(cfg, params, tokens, seq)
    for p in layers(params["blocks"]):
        x = remat(lambda x, p: mamba_block(cfg, x, tp.fsdp(p), seq), x, p, policy=cfg.remat)
    return x


def forward(cfg: ArchConfig, params, tokens, extras=None):
    return logits(cfg, params, backbone(cfg, params, tokens, extras), tokens.shape[1])


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
    """x (B, 1, D) one token.  Under tensor parallelism as the prefill's
    mixer: ``in_proj`` column-parallel to the rank's inner channels, which
    the cache's ``h`` and ``conv`` hold (the prefill leaves them so), the
    conv step and the recurrence on them, ``x_proj`` row-parallel with dt,
    B and C reduced, ``dt_proj`` column-parallel, ``out_proj``
    row-parallel.  Under "serve_2dtp" the recurrent state holds the rank's
    rows of the batch: the conv step and the recurrence run on them
    (``tp.batch_part``) and their output is joined before ``out_proj``."""
    D, di = cfg.d_model, cfg.d_inner
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)  # (B, D)
    (xb, split), (z, _) = linears(h_in, [(p[n], ("embed", "ssm_inner"), (D, di)) for n in ("w_in_x", "w_in_z")])
    xb, z = tp.batch_part(xb), tp.batch_part(z)
    xb, conv_state = conv1d_step(xb, layer_cache["conv"], p["conv_w"], p["conv_b"])
    xb = F.silu(xb)
    dt, bm, cm = _mixer_inputs(cfg, p, xb, split)  # dt (B, di) fp32, bm and cm (B, N)
    a = -torch.exp(p["a_log"].float())  # (di, N)
    da = torch.exp(dt[..., None] * a)  # (B, di, N)
    db = (dt * xb.float())[..., None] * bm[:, None, :]
    h = da * layer_cache["h"] + db  # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, cm)
    y = y + p["d_skip"].float() * xb.float()
    y = tp.batch_whole(y.to(x.dtype) * F.silu(z))
    [(out, os_)] = linears(y, [(p["w_out"], ("ssm_inner", "embed"), (di, D))], x_split=split is not None)
    return x + whole(out, os_)[:, None, :], {"h": h, "conv": conv_state}


def prefill(cfg: ArchConfig, params, tokens, extras=None, cache_len=None):
    """Full forward, returning the recurrent state after the last token
    (under tensor parallelism, of the rank's channels)."""
    seq = tp.seq_split(tokens.shape[1])
    x = embed(cfg, params, tokens, seq)
    states = []
    for i in range(n_stacked(params["blocks"])):
        x, (h, conv) = _mixer(cfg, x, tp.fsdp(layer(params["blocks"], i)), seq)
        states.append({"h": h, "conv": conv})
    return head(cfg, params, x, seq=seq), {"layers": stack_layers(states)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, extras=None):
    """One decode step; each layer gathered where it runs (``tp.fsdp``)."""
    x = embed(cfg, params, tokens, False)
    new = []
    for i in range(n_stacked(params["blocks"])):
        x, lc = mamba_decode_block(cfg, x, tp.fsdp(layer(params["blocks"], i)), layer(cache["layers"], i))
        new.append(lc)
    return head(cfg, params, x), {"layers": stack_layers(new)}
