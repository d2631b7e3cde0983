"""Core layer primitives shared by every model family (plain PyTorch).

Counterpart of ``repro/models/layers.py``, with the same fp32 upcasts.  The
reference's ``shard_x`` annotations are dropped: each rank computes on its
own shard, which the steps cut (``train/step.py``).  Under tensor
parallelism a rank holds its "model" shard of each weight; ``linears``,
``mlp``, ``embed_tokens``, ``lm_logits`` and ``vocab_cross_entropy`` read
each weight's split from the strategy's rules (``parallel/tensor.py``,
``weight_split``) and move the activations over "model" as GSPMD would:
a weight split on its output dim is column-parallel (its result split), one
split on its contraction dim row-parallel (partial sums, then ``reduce``),
one split on neither replicated.  Norms run on replicated activations.
Under sequence parallelism (``tp.seq_split``: the "_sp" strategies) the
residual stream holds the rank's slice of the sequence: a block's
column-parallel products read it through ``seq_enter`` (the whole
sequence), its last row-parallel product leaves through ``seq_leave``, and
a norm's scale, which then sees the rank's tokens only, has its gradient
summed over "model" (``enter``).  Under "serve_2dtp" a weight's d_model dim is cut over
"data" too (``tp.data_split``): ``linears`` and ``lm_logits`` sum partial
products over "data" and gather results cut over it.  Outside a
tensor-parallel step no weight reads as split and each helper is the plain
product.  Its ``scan_layers``
becomes a plain loop over the layer index of the stacked leaves
(``models/spec.py``: ``layer``, ``stack_layers``), each layer one call of
:func:`remat`, which rematerialises it by the config's policy, as
``jax.checkpoint`` does in the reference's scan body; inside it the models
gather the layer's dp shards (``tp.fsdp``), so the replay gathers them
again and no policy saves a gathered weight.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.parallel import tensor as tp


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *, seq: bool = False) -> torch.Tensor:
    """``seq``: ``x`` holds the rank's slice of the sequence, so the
    scale's gradient is summed over "model"."""
    if seq:
        scale = tp.enter(scale)
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def linears(x: torch.Tensor, weights: list, *, k: int = 1, x_split: bool = False, seq_in: bool = False,
            seq_out: bool = False) -> list:
    """``x`` (..., K) times each weight of ``weights``, a list of (w, logical
    axes, global shape), its first ``k`` dims contracted (flattened to K)
    and the rest flattened to the output.  Returns one (y, split) a weight:
    ``split`` is None where y is whole on every rank, else the ``outer`` of
    y's last dim, split over "model" (a column-parallel weight).

    A row-parallel weight reads the rank's part of ``x`` (``x`` itself with
    ``x_split``: x already holds the part its contraction split asks for)
    and its partial sums are reduced; the column-parallel weights read ``x``
    through one shared ``enter``.

    Under "serve_2dtp" (2D tensor parallelism, ``tp.data_split``) a weight
    cut over "data" on its contraction reads the rank's "data" block of
    ``x``, and its partial sums are reduced over "data" (with those over
    "model" in one all-reduce where both cut the contraction); one cut over
    "data" on its output reads ``x`` through ``enter`` over "data" and has
    its result gathered over "data", whole.

    Under sequence parallelism, ``seq_in``: ``x`` (B, L / m, K) holds the
    rank's slice of the sequence, which the column-parallel weights read
    through one ``seq_enter`` and the others gathered (``tp.gather``: the
    whole sequence, whose gradient is whole on every rank); ``seq_out``:
    the results go back to the residual stream as the rank's slice of the
    sequence, a row-parallel product's partial sums through ``seq_leave``,
    a whole result cut (``tp.split``), each with split None."""
    out, reads = [], {}

    def read(key, make):  # what the weights read of x, each move made once
        if key not in reads:
            reads[key] = make()
        return reads[key]

    for w, axes, shape in weights:
        wf = w.reshape(math.prod(w.shape[:k]), -1)
        s, ds = tp.weight_split(axes, shape), tp.data_split(axes, shape)
        if s is not None and s[0] >= k and x_split:
            raise ValueError(f"a column-parallel weight {tuple(shape)} ({axes}) after an input split over 'model'")
        if s is None and x_split:
            raise ValueError(f"a whole weight {tuple(shape)} ({axes}) after an input split over 'model'")
        d_in = ds is not None and ds[0] < k
        if d_in and (x_split or seq_in or seq_out):
            raise ValueError(f"a weight {tuple(shape)} ({axes}) cut over 'data' on its contraction after a split input")
        if ds is None:
            xkey, xw = None, x
        elif d_in:  # the contraction cut over "data": the rank's block of x
            xkey = ("data", ds[1] * math.prod(shape[:ds[0]]))
            xw = read(xkey, lambda: tp.split(x, -1, xkey[1], axis="data"))
        else:  # the result cut over "data": x read whole, its gradient summed over "data"
            xkey = ("data", "enter")
            xw = read(xkey, lambda: tp.enter(x, axis="data"))
        if s is None or s[0] < k:
            full = None if x_split else read(("full", xkey), lambda: tp.gather(xw, 1) if seq_in else xw)
        if s is None:
            y, ys = full @ wf, None
        elif s[0] < k:  # row-parallel: the contraction is split
            d, outer = s
            o = outer * math.prod(shape[:d])
            partial = (xw if x_split else read(("part", xkey, o), lambda: tp.split(full, -1, o))) @ wf
            if seq_out:
                out.append((tp.seq_leave(partial), None))
                continue
            y, ys, d_in = tp.reduce(partial, axis=("data", "model") if d_in else "model"), None, False
        else:
            d, outer = s
            entered = read(("enter", xkey), lambda: tp.seq_enter(xw) if seq_in else tp.enter(xw))
            y, ys = entered @ wf, outer * math.prod(shape[k:d])
        if d_in:
            y = tp.reduce(y, axis="data")
        if ds is not None and ds[0] >= k:  # the result cut over "data": made whole
            y, ys = tp.gather(whole(y, ys), -1, ds[1] * math.prod(shape[k:ds[0]]), axis="data"), None
        out.append((tp.split(whole(y, ys), 1), None) if seq_out else (y, ys))
    return out


def whole(y: torch.Tensor, split) -> torch.Tensor:
    """``y`` of ``linears``, its last dim gathered where it is split."""
    return y if split is None else tp.gather(y, -1, split)


def mlp(x: torch.Tensor, p: dict, d_ff: int, act: Callable, *, seq: bool = False) -> torch.Tensor:
    """down(act(x @ gate) * (x @ up)): SwiGLU with ``act`` silu, GeGLU with
    ``gelu``.  Gate and up are column-parallel over "mlp" and down
    row-parallel where the rules split "mlp"; the result whole, or with
    ``seq`` (x the rank's slice of the sequence) the rank's slice."""
    D = x.shape[-1]
    (g, split), (u, _) = linears(x, [(p["w_gate"], ("embed", "mlp"), (D, d_ff)), (p["w_up"], ("embed", "mlp"), (D, d_ff))],
                                 seq_in=seq)
    [(y, ys)] = linears(act(g) * u, [(p["w_down"], ("mlp", "embed"), (d_ff, D))], x_split=split is not None, seq_out=seq)
    return whole(y, ys)


def _vocab_local(ids: torch.Tensor, n_local: int, split) -> tuple[torch.Tensor, torch.Tensor]:
    """(the row of each global id in the rank's part of a vocab dim split
    over "model" as ``split`` (dim, outer) says, clamped into it; whether the
    rank holds it).  The rank holds block ``j m + r`` of ``outer m`` blocks
    for each j < outer (the ``(outer, m, rest)`` layout)."""
    m, r = tp.model_size(), tp.model_rank()
    size = n_local // split[1]
    block, within = ids // size, ids % size
    inside = block % m == r
    return ((block // m) * size + within).clamp(0, n_local - 1), inside


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, compute_dtype: torch.dtype,
                 vocab_size: Optional[int] = None, *, seq: bool = False) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens``.  With the global
    ``vocab_size`` given, a table split over "model" on its vocab dim looks
    up only the ids in the rank's range (the rest read zeros) and the ranks'
    rows are summed.  ``seq``: the rows come back as the rank's slice of the
    sequence (the ranks' rows through ``seq_leave``, whole rows cut)."""
    split = tp.weight_split(("vocab", "embed_table"), (vocab_size, table.shape[1])) if vocab_size else None
    if split is None:
        rows = table[tokens.long()].to(compute_dtype)
        return tp.split(rows, 1) if seq else rows
    ids, inside = _vocab_local(tokens.long(), table.shape[0], split)
    rows = table[ids] * inside[..., None].to(table.dtype)
    return (tp.seq_leave(rows) if seq else tp.reduce(rows)).to(compute_dtype)


def lm_logits(x: torch.Tensor, head: torch.Tensor, split=None, *, seq: bool = False, data_cut: bool = False) -> torch.Tensor:
    """x (..., D) @ head (D, V) -> (..., V).  ``split`` is the head's
    ``weight_split``: split on V the logits come out split (the rank's
    vocab range), split on D the partial logits are reduced.  ``seq``: x
    (B, L / m, D) holds the rank's slice of the sequence and the logits
    cover the whole of it.  ``data_cut`` (2D tensor parallelism): the
    head's D rows are the rank's "data" block, which x is cut to, and the
    partial logits are reduced over "data"."""
    if data_cut:
        return tp.reduce(lm_logits(tp.split(x, -1, axis="data"), head, split), axis="data")
    if split is None:
        return (tp.gather(x, 1) if seq else x) @ head
    if split[0] == 1:
        return (tp.seq_enter(x) if seq else tp.enter(x)) @ head
    return tp.reduce(tp.split(tp.gather(x, 1) if seq else x, -1, split[1]) @ head)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, split) -> torch.Tensor:
    """The mean next-token NLL of logits whose vocab dim is split over
    "model" (``lm_logits`` of a head split on V): each row's max and sum of
    exp reduced over the ranks, the label's logit picked on the rank that
    owns it.  Equal to the whole-vocab logsumexp minus the label's logit,
    and so is its gradient."""
    logits32 = logits.float()
    shift = tp.reduce(torch.amax(logits32, dim=-1), "max")
    lse = shift + torch.log(tp.reduce(torch.sum(torch.exp(logits32 - shift[..., None]), dim=-1)))
    ids, inside = _vocab_local(labels.long(), logits.shape[-1], split)
    picked = torch.gather(logits32, -1, ids[..., None])[..., 0] * inside
    return torch.mean(lse - tp.reduce(picked))


def last_token(x: torch.Tensor, seq: bool) -> torch.Tensor:
    """x[:, -1:] of the whole sequence: with ``seq`` (x the rank's slice)
    each rank's last token gathered and the last rank's kept."""
    return tp.gather(x[:, -1:], 1)[:, -1:] if seq else x[:, -1:]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the seq dim.  x (B, L, C), w (C, K)."""
    k = w.shape[-1]
    L = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # K shifted views, summed in the reference's order (small K, 4)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i : i + L, :] * w[:, i]
    if bias is not None:
        out = out + bias
    return out


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, bias=None):
    """One decode step of causal depthwise conv.
    x_t (B, C); conv_state (B, K-1, C) holds the previous K-1 inputs.  Under
    tensor parallelism C is the rank's channels: x_t, the state, ``w`` and
    ``bias`` all hold the same ones (the conv is per channel)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,ck->bc", window, w)
    if bias is not None:
        out = out + bias
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., L, n_heads, head_dim) (or L==1 decode), pos broadcastable (..., L)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = pos[..., None].float() * freqs  # (..., L, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]  # (..., L, 1, hd/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

# The matrix products with no batch dims: what the reference's "dots" policy
# (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``) saves.
# ``x @ w`` with x (B, L, D) and w (D, F) reaches the dispatcher as ``mm``
# (``addmm`` with a bias); an einsum with batch dims is ``bmm`` and is
# recomputed, as the reference recomputes its batched dot_generals.
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@torch.library.custom_op("repro_torch::post_collective", mutates_args=())
def _post_collective(x: torch.Tensor) -> torch.Tensor:
    return x.clone()  # a custom op's output may not alias its input


@_post_collective.register_fake
def _(x):
    return torch.empty_like(x)


_post_collective.register_autograd(lambda ctx, grad: grad)


def post_collective(x: torch.Tensor, remat: str) -> torch.Tensor:
    """Tag an activation produced right after a tensor-parallel collective
    (``layers.py:136-141``) for the remat policy ``remat``: under
    "collectives" with grad mode on, an identity op,
    ``repro_torch::post_collective`` (a copy), whose output the policy
    saves; otherwise ``x`` itself, as no other policy reads the tag."""
    if remat != "collectives" or not torch.is_grad_enabled():
        return x
    return _post_collective(x)


def _collectives_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.repro_torch.post_collective.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: str) -> Optional[Callable]:
    """The ``context_fn`` that ``torch.utils.checkpoint`` takes for a policy
    name, as the reference's ``remat_policy`` (``layers.py:121-137``) maps a
    name to a ``jax.checkpoint`` policy: ``"none"`` checkpoints nothing
    (None), ``"full"`` saves nothing but the inputs (the default context),
    ``"dots"`` saves the outputs of ``mm``/``addmm``, ``"collectives"``
    saves only the activations tagged by :func:`post_collective` (JAX's
    ``save_only_these_names("post_collective")``)."""
    if name == "none":
        return None
    if name == "full":
        return _ckpt.noop_context_fn
    if name == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts, _dots_policy)
    if name == "collectives":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts, _collectives_policy)
    raise ValueError(name)


def remat(fn: Callable, *args, policy: str = "dots"):
    """``fn(*args)`` rematerialised by ``policy``: under ``"none"``, or with
    grad mode off, a plain call; else one non-reentrant checkpoint, so the
    backward recomputes what the policy did not save.  The models call it
    once a layer (a superblock for the hybrid), as ``scan_layers`` does."""
    context_fn = remat_policy(policy)
    if context_fn is None or not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
