"""Train and serve step builders: model + optimizer -> step functions.

Counterpart of ``repro/train/step.py`` (``:91-210``), on one device.  The
reference's builders also take a sharding ``Strategy`` and a ``Mesh`` and
wrap each step in its activation rules; sharding is not ported (ROADMAP.md,
"Modules to port", item 6), so the port's take the model and, for training,
the optimizer config only.  ``make_compressed_train_step`` (int8 gradient
reduction over data-parallel ranks) waits for the same item.

PyTorch runs eagerly: a step function is a plain closure, built once and
called per batch, where the reference's is jitted.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import adamw


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradients of ``model.loss`` by autograd (on the card, through the
    kernels' backward kernels), then one AdamW step, which updates the
    params and the optimizer state in place (``optim/adamw.py``).  metrics
    holds the loss's (``ce``, ``tokens``, ``loss``) and the optimizer's
    (``grad_norm``, ``lr``) as detached fp32 tensors."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = _unflatten_like(params, grads)
        params, opt_state, opt_metrics = adamw.apply_updates(opt_cfg, params, grads, opt_state)
        return params, opt_state, {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}

    return train_step


def _unflatten_like(tree, leaves: list):
    """``tree``'s nesting with its leaves, in ``tree_leaves`` order, replaced."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def metrics_struct(model: Model) -> dict:
    """The keys of the loss's metrics, each 0.0 (``step.py:184-188``)."""
    keys = ["ce", "tokens", "loss"]
    if model.cfg.family == "moe":
        keys += ["aux_loss", "z_loss"]
    return {k: 0.0 for k in keys}


def make_prefill_step(model: Model, cache_len: int):
    """(params, batch) -> (last-token logits, cache), without gradients."""

    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(model: Model):
    """(params, cache, batch) -> (logits, cache) for batch["tokens"] (B, 1)
    at batch["pos"] (B,), without gradients."""

    def decode_step(params, cache, batch):
        with torch.no_grad():
            return model.decode_step(params, cache, batch["tokens"], batch["pos"])

    return decode_step


def init_train_state(model: Model, generator: torch.Generator, device="cuda"):
    """Parameters drawn from ``generator`` (which lives on ``device``) and a
    zero AdamW state: (params, opt_state)."""
    params = model.init(generator, device)
    return params, adamw.init_state(params)
