"""Unified model facade: one API over the ported architecture families.

Counterpart of ``repro/models/model.py``::

    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    loss, metrics = model.loss(params, batch)
    logits = model.logits(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)  # writes into ``cache``

All six families are ported, for training and serving: dense, moe, ssm,
hybrid, audio (the encoder-decoder, ``models/encdec.py``) and vlm (the
gated cross-attention decoder, ``models/vision.py``).  Their forward and
prefill run on the hand-written kernels where the tensors lie on a CUDA
device, and so does the backward of attention (self and cross), of both
scans (the selective scan's and the RG-LRU's) and of the expert GEMMs
(``kernels/ops.py``): all six families train on the card.  Under tensor
parallelism (``train/step.py``'s train, prefill and decode steps on a
"model" axis above 1, or "serve_2dtp") ``params`` are a rank's shards,
which the models gather over the dp axes a layer at a time
(``parallel/tensor.py``, ``fsdp``), the loss takes the vocab-parallel cross
entropy where the head splits the vocab, the prefill's and decode's logits
come back whole, and the caches hold the rank's part.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, moe, rglru, ssm, transformer, vision
from repro_torch.models.layers import remat, vocab_cross_entropy
from repro_torch.models.transformer import _head, head_params, logits as head_logits
from repro_torch.models.spec import init_params, tree_size
from repro_torch.parallel import tensor as tp

_FAMILY = {
    "dense": transformer,
    "moe": moe,
    "ssm": ssm,
    "hybrid": rglru,
    "audio": encdec,
    "vlm": vision,
}

# the families whose loss may take the chunked head (``model.py:62``): not moe
_CHUNKED_HEAD = ("dense", "ssm", "hybrid", "vlm", "audio")


def _extras(batch: dict) -> Optional[dict]:
    ex = {k: v for k, v in batch.items() if k in ("enc_frames", "img_embeds")}
    return ex or None


class Model:
    def __init__(self, cfg: ArchConfig):
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
        out = self.mod.forward(self.cfg, params, batch["tokens"], _extras(batch))
        if isinstance(out, tuple):  # moe returns (logits, aux)
            return out[0]
        return out

    def loss(self, params, batch: dict):
        """Next-token cross entropy (+ the MoE aux losses).  Returns (loss,
        metrics) with the reference's keys: ``ce``, ``tokens``, ``loss``, and
        for moe ``aux_loss`` and ``z_loss`` (fp32 tensors)."""
        if self.cfg.logit_chunk and self.cfg.family in _CHUNKED_HEAD:
            return self._loss_chunked_head(params, batch)
        if self.cfg.family == "moe":
            (logits, split), moe_metrics = moe.forward(self.cfg, params, batch["tokens"], gather=False)
        else:
            hidden = self.mod.backbone(self.cfg, params, batch["tokens"], _extras(batch))
            logits, split = head_logits(self.cfg, params, hidden, batch["tokens"].shape[1], gather=False)
            moe_metrics = None
        ce, metrics = cross_entropy(logits, batch["labels"], split)
        loss = ce
        if moe_metrics is not None:
            loss = loss + moe.aux_loss(moe_metrics)
            metrics.update(moe_metrics)
        metrics["loss"] = loss
        return loss, metrics

    def _loss_chunked_head(self, params, batch: dict):
        """The LM head and cross entropy a sequence chunk at a time, each
        chunk under a checkpoint that recomputes it in the backward, so the
        (B, L, V) fp32 logits never exist whole (``model.py:84-121``).  The
        head's leaves are gathered once, before the chunks.  Under sequence
        parallelism the hidden states are the rank's slice of the sequence:
        a chunk is a slice of each rank's, its logits the ranks' together
        (the head reads them through ``seq_enter``)."""
        cfg = self.cfg
        labels = batch["labels"]
        hidden = self.mod.backbone(cfg, params, batch["tokens"], _extras(batch))
        seq = tp.seq_split(labels.shape[1])
        hp = tp.fsdp(head_params(params))
        B, L, D = hidden.shape
        ck = min(cfg.logit_chunk, L)
        while L % ck:
            ck -= 1
        by_rank = labels.unflatten(1, (-1, L))  # (B, ranks, L): the labels of each rank's slice

        def chunk_nll(h_chunk, l_chunk):
            logits, split = _head(cfg, hp, h_chunk, gather=False, seq=seq)
            ce, _ = cross_entropy(logits, l_chunk, split)
            return ce * l_chunk.numel()  # a sum, renormalised below

        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(L // ck):
            sl = slice(i * ck, (i + 1) * ck)
            total = total + remat(chunk_nll, hidden[:, sl], by_rank[:, :, sl].flatten(1, 2), policy="full")
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, split=None):
    """Mean next-token negative log-likelihood in fp32: logsumexp of each
    row minus the label's logit (the reference picks the label's logit with
    an iota mask, ``model.py:130-139``; a gather picks the same element).
    With ``split`` (logits split over "model" on the vocab, the head's
    ``weight_split``) the vocab-parallel form (``layers.vocab_cross_entropy``).
    Returns (loss, {"ce": loss, "tokens": the label count})."""
    tokens = torch.tensor(float(labels.numel()), device=logits.device)
    if split is not None:
        loss = vocab_cross_entropy(logits, labels, split)
        return loss, {"ce": loss, "tokens": tokens}
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - picked)
    return loss, {"ce": loss, "tokens": tokens}
