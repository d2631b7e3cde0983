"""Core layer primitives shared by every model family (plain PyTorch).

Counterpart of ``repro/models/layers.py``, with the same fp32 upcasts.  The
reference's ``shard_x`` annotations are dropped: each rank computes on its
own shard, which the steps cut (``train/step.py``).  Its ``scan_layers``
becomes a plain loop over the layer index of the stacked leaves
(``models/spec.py``: ``layer``, ``stack_layers``), each layer one call of
:func:`remat`, which rematerialises it by the config's policy, as
``jax.checkpoint`` does in the reference's scan body.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def geglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    return (gelu(x @ w_gate) * (x @ w_up)) @ w_down


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ head (D, V) -> (..., V)."""
    return x @ head


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
    x_t (B, C); conv_state (B, K-1, C) holds the previous K-1 inputs."""
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
