"""Unified model facade: one API over the ported architecture families.

Counterpart of ``repro/models/model.py``::

    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    loss, metrics = model.loss(params, batch)
    logits = model.logits(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)

The dense, ssm and hybrid families are ported, for training and serving;
their forward and prefill run on the hand-written kernels where the tensors
lie on a CUDA device, and so does the backward of attention and of the
RG-LRU (``kernels/ops.py``).  On the card the ssm family trains only once
the ``selective_scan`` backward is ported: until then its train step raises
``ops.BackwardNotPorted`` there, and trains on the CPU.  The other families
raise ``NotImplementedError`` naming what is left.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru, ssm, transformer
from repro_torch.models.layers import remat
from repro_torch.models.spec import init_params, tree_size

_FAMILY = {
    "dense": transformer,
    "ssm": ssm,
    "hybrid": rglru,
}

_NOT_PORTED = {  # family -> its ROADMAP.md item ("Modules to port")
    "moe": "item 4b: the moe family, with moe_gmm on its expert matmuls",
    "audio": "item 4c: encdec, the audio family",
    "vlm": "item 4d: vision, the vlm family",
}

def _extras(batch: dict) -> Optional[dict]:
    ex = {k: v for k, v in batch.items() if k in ("enc_frames", "img_embeds")}
    return ex or None


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.family in _NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                f"(ROADMAP.md, 'Modules to port', {_NOT_PORTED[cfg.family]})"
            )
        self.cfg = cfg
        self.mod = _FAMILY[cfg.family]

    # -- parameters ----------------------------------------------------
    def specs(self):
        return self.mod.specs(self.cfg)

    def init(self, generator: torch.Generator, device="cuda"):
        """Initialised parameters on ``device``, drawn from ``generator``
        (which lives on that device)."""
        return init_params(self.specs(), generator, device)

    def param_count(self) -> int:
        return tree_size(self.specs())

    # -- forward -------------------------------------------------------
    def logits(self, params, batch: dict) -> torch.Tensor:
        return self.mod.forward(self.cfg, params, batch["tokens"], _extras(batch))

    def loss(self, params, batch: dict):
        """Next-token cross entropy.  Returns (loss, metrics) with the
        reference's keys: ``ce``, ``tokens``, ``loss`` (fp32 tensors)."""
        if self.cfg.logit_chunk:
            return self._loss_chunked_head(params, batch)
        logits = self.mod.forward(self.cfg, params, batch["tokens"], _extras(batch))
        ce, metrics = cross_entropy(logits, batch["labels"])
        metrics["loss"] = ce
        return ce, metrics

    def _loss_chunked_head(self, params, batch: dict):
        """The LM head and cross entropy a sequence chunk at a time, each
        chunk under a checkpoint that recomputes it in the backward, so the
        (B, L, V) fp32 logits never exist whole (``model.py:84-121``)."""
        from repro_torch.models.transformer import _head

        cfg = self.cfg
        hidden = self.mod.backbone(cfg, params, batch["tokens"], _extras(batch))
        B, L, D = hidden.shape
        ck = min(cfg.logit_chunk, L)
        while L % ck:
            ck -= 1
        labels = batch["labels"]

        def chunk_nll(h_chunk, l_chunk):
            ce, _ = cross_entropy(_head(cfg, params, h_chunk), l_chunk)
            return ce * l_chunk.numel()  # a sum, renormalised below

        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(L // ck):
            sl = slice(i * ck, (i + 1) * ck)
            total = total + remat(chunk_nll, hidden[:, sl], labels[:, sl], policy="full")
        loss = total / labels.numel()
        tokens = torch.tensor(float(labels.numel()), device=hidden.device)
        return loss, {"ce": loss, "tokens": tokens, "loss": loss}

    # -- serving -------------------------------------------------------
    def prefill(self, params, batch: dict, cache_len: Optional[int] = None):
        return self.mod.prefill(self.cfg, params, batch["tokens"], _extras(batch), cache_len=cache_len)

    def decode_step(self, params, cache, tokens, pos, extras=None):
        return self.mod.decode_step(self.cfg, params, cache, tokens, pos, extras)

    def cache_specs(self, batch: int, cache_len: int):
        return self.mod.cache_specs(self.cfg, batch, cache_len)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean next-token negative log-likelihood in fp32: logsumexp of each
    row minus the label's logit (the reference picks the label's logit with
    an iota mask, ``model.py:130-139``; a gather picks the same element).
    Returns (loss, {"ce": loss, "tokens": the label count})."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - picked)
    return loss, {"ce": loss, "tokens": torch.tensor(float(labels.numel()), device=logits.device)}
