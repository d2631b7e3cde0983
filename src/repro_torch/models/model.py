"""Unified model facade: one API over the ported architecture families.

Counterpart of ``repro/models/model.py``, serving side::

    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    logits = model.logits(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)

The dense, ssm and hybrid families are ported; their prefill runs on the
hand-written kernels where the tensors lie on a CUDA device.  The other
families raise ``NotImplementedError`` naming what is left, and so does
training (``loss``), which comes with the train slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru, ssm, transformer
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

TRAIN_SLICE = (
    "training (optim/adamw, train/step, Model.loss) is not ported yet "
    "(ROADMAP.md, 'Modules to port', item 4a: the train slice)"
)


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
        raise NotImplementedError(TRAIN_SLICE)

    # -- serving -------------------------------------------------------
    def prefill(self, params, batch: dict, cache_len: Optional[int] = None):
        return self.mod.prefill(self.cfg, params, batch["tokens"], _extras(batch), cache_len=cache_len)

    def decode_step(self, params, cache, tokens, pos, extras=None):
        return self.mod.decode_step(self.cfg, params, cache, tokens, pos, extras)

    def cache_specs(self, batch: int, cache_len: int):
        return self.mod.cache_specs(self.cfg, batch, cache_len)
