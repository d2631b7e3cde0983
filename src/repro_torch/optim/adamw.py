"""AdamW with fp32 state over bf16 params, global-norm clipping, and
ZeRO-1 optimizer-state specs.

Counterpart of ``repro/optim/adamw.py`` (``:19-107``), with the same
schedule, clipping and update arithmetic: the moments m and v are fp32, the
update is done in fp32 and cast back to each parameter's dtype.  Trees are
the nested dicts of ``models/spec.py``.

Unlike the reference's pure function, ``apply_updates`` writes the new
parameters and moments into the tensors it is given, under
``torch.no_grad()``, and returns the same trees: at recurrentgemma-2b's full
size m and v alone are 26.6 GB, and a second copy of them would not fit
beside the activations on one card.

The ZeRO-1 specs (``zero1_pspec``, ``opt_pspec_tree``, ``:110-139``) shard
m and v over "data" even where the parameter is replicated; the sharded
train step (``train/step.py``) updates each rank's slice with
``update_leaf``, the arithmetic ``apply_updates`` runs on whole leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.spec import ParamSpec, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in fp32.  ``step`` is an
    int or a tensor (on the device the result should live on)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def init_state(params) -> dict:
    """Zero fp32 moments shaped like ``params`` and an int32 step, on the
    params' device."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(g.float())) for g in tree_leaves(tree)])))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place.  Returns (params, state, metrics) with the
    same trees it was given; metrics holds ``grad_norm`` and ``lr`` as fp32
    tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale, lr, b1c, b2c = step_scalars(cfg, step, gnorm)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"])):
        update_leaf(cfg, p, g, m, v, scale, lr, b1c, b2c)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor):
    """(clip scale, lr, b1c, b2c) of step ``step`` (counted from 1) at
    gradient norm ``gnorm``."""
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    return scale, lr, b1c, b2c


@torch.no_grad()
def update_leaf(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c) -> None:
    """One AdamW update of one leaf (or one slice of it) in place: ``p``,
    ``m`` and ``v`` are written, ``g`` is read."""
    g32 = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
    # delta = mhat / (sqrt(vhat) + eps) + wd * p, built in g32's room
    denom = torch.div(v, b2c, out=g32).sqrt_().add_(cfg.eps)
    delta = torch.div(m, b1c).div_(denom)
    p32 = p.float()  # p itself when p is fp32
    delta.add_(cfg.weight_decay * p32)
    if p32 is p:
        p.sub_(lr * delta)
    else:
        p.copy_(p32.sub_(lr * delta))


def opt_state_specs(param_specs) -> dict:
    """Spec tree for (m, v): the params' shapes and logical axes in fp32,
    and an int32 scalar step."""
    f32 = lambda s: ParamSpec(s.shape, s.axes, "float32", "zeros")
    return {
        "m": tree_map(f32, param_specs),
        "v": tree_map(f32, param_specs),
        "step": ParamSpec((), (), "int32", "zeros"),
    }


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding specs
# ---------------------------------------------------------------------------


def zero1_pspec(param_pspec, shape, data_size: int) -> tuple:
    """Extend a param's spec with 'data' on its largest unsharded, divisible
    dim (the first of equals).  This shards m/v over the data axis even when
    the param itself is only tensor-parallel - ZeRO-1.  Falls back to the
    param's own spec when no dim divides (tiny tensors: norm scales,
    gates)."""
    spec = list(param_pspec) + [None] * (len(shape) - len(param_pspec))
    used = {a for s in spec if s for a in ((s,) if isinstance(s, str) else s)}
    if "data" in used or not shape:
        return tuple(spec)
    candidates = [i for i, s in enumerate(spec) if s is None and shape[i] % data_size == 0]
    if not candidates:
        return tuple(spec)
    i = max(candidates, key=lambda i: shape[i])
    spec[i] = "data"
    return tuple(spec)


def opt_pspec_tree(param_specs, param_pspecs, zero1: bool, data_size: int = 1) -> dict:
    """Specs for the optimizer state tree: m and v per ``zero1_pspec`` (or
    the params' own without ZeRO-1), the step replicated."""
    pspecs = iter(tree_leaves(param_pspecs))

    def one(spec: ParamSpec):
        pspec = tuple(next(pspecs))
        return zero1_pspec(pspec, spec.shape, data_size) if zero1 else pspec

    m = tree_map(one, param_specs)
    return {"m": m, "v": tree_map(lambda x: x, m), "step": ()}
