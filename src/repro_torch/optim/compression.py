"""Gradient compression for the data-parallel reduction (1-bit-Adam family).

Counterpart of ``repro/optim/compression.py`` (``:29-102``): a two-phase
int8 mean all-reduce with error feedback, over a ``torch.distributed``
process group where the reference runs explicit collectives inside
``shard_map``:

  phase 1 (reduce-scatter): each rank block-quantizes (grad + worker error)
    to int8 with per-block fp32 scales and ``all_to_all_single``s the int8
    payload and the scales, so each rank owns 1/n of the blocks.
  phase 2 (all-gather): the owner sums its received contributions in fp32,
    re-quantizes the SUM to int8 (owner error feedback), and ``all_gather``s
    the int8 payload and its scales.

The payload stays int8 on the wire.  Both quantization errors are carried
into the next step.  ``_quant``/``_dequant`` keep the reference's arithmetic
as it runs, jitted (fp32 scale max|b| x fp32(1/127) floored at 1e-12, round
half to even, clip to ±127), so the same blocks give the same payload and
scales.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

BLOCK = 256


def _n_blocks(size: int, n_dev: int) -> int:
    nb = -(-size // BLOCK)
    return -(-nb // n_dev) * n_dev  # pad so every rank owns nb/n_dev blocks


def _to_blocks(x: torch.Tensor, n_dev: int) -> torch.Tensor:
    nb = _n_blocks(x.numel(), n_dev)
    flat = torch.zeros(nb * BLOCK, dtype=torch.float32, device=x.device)
    flat[: x.numel()] = x.float().reshape(-1)
    return flat.reshape(nb, BLOCK)


# the reference's ``/ 127.0`` as XLA compiles it: a product with the fp32
# reciprocal (a quotient differs in the last bit for some blocks)
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quant(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=-1, keepdim=True) * _INV_127, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def compression_state(param_shapes, n_dev: int, device=None):
    """(worker_err, owner_err) zero states, one dict a leaf of
    ``param_shapes`` (a tree whose leaves have a ``shape``: tensors or
    ``ParamSpec``s; a single leaf gives a single state), on ``device`` (by
    default a tensor leaf's own, else the CPU)."""
    from repro_torch.models.spec import tree_map

    def one(p):
        shape = tuple(p.shape)
        size = math.prod(shape) if shape else 1
        nb = _n_blocks(size, n_dev)
        dev = device if device is not None else getattr(p, "device", "cpu")
        return {
            "worker_err": torch.zeros(shape, dtype=torch.float32, device=dev),
            "owner_err": torch.zeros((nb // n_dev, BLOCK), dtype=torch.float32, device=dev),
        }

    return tree_map(one, param_shapes)


def compressed_mean(x: torch.Tensor, state: dict, group=None) -> tuple[torch.Tensor, dict]:
    """Error-feedback int8 mean over the ranks of ``group`` (a process
    group; None for a world of one, where the quantization runs and no
    collective does).

    x: this rank's local gradient (the param's full shape).  Returns (mean
    over ranks in x's dtype, new compression state)."""
    n = dist.get_world_size(group) if group is not None else 1
    blocks = _to_blocks(x, n)  # (nb, BLOCK)
    nb = blocks.shape[0]
    blocks = blocks + _to_blocks(state["worker_err"], n)  # worker error feedback

    q, scale = _quant(blocks)
    worker_err = blocks - _dequant(q, scale)  # residual kept locally

    # phase 1: rank i receives every rank's contribution to its owned blocks
    owned = nb // n
    if group is None:
        q_recv, s_recv = q, scale
    else:
        q_recv, s_recv = torch.empty_like(q), torch.empty_like(scale)
        dist.all_to_all_single(q_recv, q, group=group)
        dist.all_to_all_single(s_recv, scale, group=group)
    contrib = _dequant(q_recv.reshape(n, owned, BLOCK), s_recv.reshape(n, owned))
    total = torch.sum(contrib, dim=0) + state["owner_err"]  # (owned, BLOCK)

    q2, scale2 = _quant(total)
    owner_err = total - _dequant(q2, scale2)

    # phase 2: all_gather the int8 sums and their scales, rebuild the mean
    if group is None:
        q_all, s_all = q2, scale2
    else:
        q_parts = [torch.empty_like(q2) for _ in range(n)]
        s_parts = [torch.empty_like(scale2) for _ in range(n)]
        dist.all_gather(q_parts, q2, group=group)
        dist.all_gather(s_parts, scale2, group=group)
        q_all, s_all = torch.cat(q_parts), torch.cat(s_parts)
    mean = (_dequant(q_all, s_all) / n).reshape(-1)[: x.numel()].reshape(x.shape)

    new_state = {
        "worker_err": worker_err.reshape(-1)[: x.numel()].reshape(x.shape),
        "owner_err": owner_err,
    }
    return mean.to(x.dtype), new_state
