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
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

BLOCK = 256


@dataclass(frozen=True)
class ModelPart:
    """Where a rank's gradient is its part of the whole tensor over a
    mesh's "model" axis: the dim cut, in the ``(outer, m, rest)`` layout of
    ``parallel/tensor.py``."""

    mesh: Any
    dim: int
    outer: int = 1

    @property
    def n(self) -> int:
        return self.mesh.axis_size("model")

    def whole(self, t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        from repro_torch.parallel.tensor import all_gather

        return all_gather(t, self.mesh, "model", self.dim if dim is None else dim, self.outer if dim is None else 1)

    def mine(self, t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        from repro_torch.parallel.tensor import rank_slice

        d, outer = (self.dim, self.outer) if dim is None else (dim, 1)
        return rank_slice(t, self.n, self.mesh.coordinate("model"), d, outer)


def _owner_rows(owned: int, n_model: int) -> int:
    """A "model" rank's rows of the (owned, BLOCK) owner state: the rows cut
    in ``n_model`` even blocks, the last padded."""
    return -(-owned // n_model)


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
    # max |b| as max(max b, -min b), and the quotient rounded and clipped in
    # place: the same values with one fp32 temporary of the blocks' size
    peak = torch.maximum(torch.amax(blocks, dim=-1, keepdim=True), -torch.amin(blocks, dim=-1, keepdim=True))
    scale = torch.clamp(peak * _INV_127, min=1e-12)
    q = (blocks / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.mul(q, scale[..., None])  # int8 promoted to fp32 in the product: no fp32 copy of q


def compression_state(param_shapes, n_dev: int, device=None, *, parts: Optional[list] = None):
    """(worker_err, owner_err) zero states, one dict a leaf of
    ``param_shapes`` (a tree whose leaves have a ``shape``: tensors or
    ``ParamSpec``s, the whole parameters' shapes; a single leaf gives a
    single state), on ``device`` (by default a tensor leaf's own, else the
    CPU).  With ``parts`` (one ``ModelPart`` or None a leaf, in
    ``tree_leaves`` order) a leaf cut over "model" keeps the states of the
    rank's part: worker_err of its shard's shape, owner_err its block of
    the owned rows (``compressed_mean`` with ``part``)."""
    from repro_torch.models.spec import tree_leaves, tree_map

    parts_it = iter(parts if parts is not None else [None] * len(tree_leaves(param_shapes)))

    def one(p):
        shape = tuple(p.shape)
        part = next(parts_it)
        size = math.prod(shape) if shape else 1
        owned = _n_blocks(size, n_dev) // n_dev
        dev = device if device is not None else getattr(p, "device", "cpu")
        if part is not None:
            shape = tuple(n // part.n if d == part.dim else n for d, n in enumerate(shape))
            owned = _owner_rows(owned, part.n)
        return {
            "worker_err": torch.zeros(shape, dtype=torch.float32, device=dev),
            "owner_err": torch.zeros((owned, BLOCK), dtype=torch.float32, device=dev),
        }

    return tree_map(one, param_shapes)


def compressed_mean(x: torch.Tensor, state: dict, group=None, *, part: Optional[ModelPart] = None
                    ) -> tuple[torch.Tensor, dict]:
    """Error-feedback int8 mean over the ranks of ``group`` (a process
    group; None for a world of one, where the quantization runs and no
    collective does).

    x: this rank's local gradient (the param's full shape).  Returns (mean
    over ranks in x's dtype, new compression state).

    With ``part``, x and the state are the rank's part of the whole
    gradient over a "model" axis (``compression_state``'s with ``parts``),
    and ``group`` the "data" group of its "model" coordinate, as the
    reference quantizes each whole gradient in its ``shard_map`` body: the
    parts are gathered over "model" (the gradient and both error states),
    the mean of the whole tensor's blocks is taken as without a part, by
    every rank of the "model" group alike, and the rank keeps its part of
    the mean and of the new states.  The gathers move the gradient and its
    fp32 states once more over "model" (``parallel/tensor.COLLECTIVES``
    counts them); the int8 payload over "data" is the reference's."""
    n = dist.get_world_size(group) if group is not None else 1
    summed = x.float() + state["worker_err"]  # worker error feedback, as the padded blocks' sum
    if part is None:
        mean, worker_err, owner_err = _mean_of_sums(summed, state["owner_err"], group, n)
        return mean.reshape(x.shape).to(x.dtype), {"worker_err": worker_err.reshape(x.shape), "owner_err": owner_err}
    summed = part.whole(summed)
    owned = _n_blocks(summed.numel(), n) // n
    mean, worker_err, owner_err = _mean_of_sums(summed, part.whole(state["owner_err"], dim=0)[:owned], group, n)
    shape = list(summed.shape)  # the whole tensor's
    owner_err = torch.nn.functional.pad(owner_err, (0, 0, 0, state["owner_err"].shape[0] * part.n - owned))
    # copies of the rank's parts: the whole tensors go with this call
    return part.mine(mean.reshape(shape)).to(x.dtype, copy=True), {
        "worker_err": part.mine(worker_err.reshape(shape)).clone(), "owner_err": part.mine(owner_err, dim=0).clone()}


def _mean_of_sums(summed: torch.Tensor, owner_err: torch.Tensor, group, n: int) -> tuple:
    """``compressed_mean``'s two phases on ``summed``, a rank's fp32
    gradient plus its worker error (any shape; the caller's to consume):
    (the mean over the ranks, the new worker error, both flat fp32 of
    ``summed``'s size, and the new owner error).  Its buffers are updated
    in place where the values allow it (the same arithmetic): a whole
    leaf's fp32 copies are the compressed step's peak."""
    numel = summed.numel()
    nb = _n_blocks(numel, n)
    if nb * BLOCK == numel:
        blocks = summed.view(nb, BLOCK)
    else:
        blocks = torch.zeros(nb * BLOCK, dtype=torch.float32, device=summed.device)
        blocks[:numel] = summed.reshape(-1)
        blocks = blocks.view(nb, BLOCK)
    del summed

    q, scale = _quant(blocks)
    worker_err = blocks.sub_(_dequant(q, scale))  # residual kept locally
    del blocks

    # phase 1: rank i receives every rank's contribution to its owned blocks
    owned = nb // n
    if n == 1:  # a world of one, or a group of one rank: nothing to exchange
        q_recv, s_recv = q, scale
    else:
        q_recv, s_recv = torch.empty_like(q), torch.empty_like(scale)
        dist.all_to_all_single(q_recv, q, group=group)
        dist.all_to_all_single(s_recv, scale, group=group)
    del q
    contrib = _dequant(q_recv.reshape(n, owned, BLOCK), s_recv.reshape(n, owned))
    del q_recv
    total = (contrib[0] if n == 1 else torch.sum(contrib, dim=0)).add_(owner_err)  # (owned, BLOCK)
    del contrib

    q2, scale2 = _quant(total)
    owner_err = total.sub_(_dequant(q2, scale2))
    del total

    # phase 2: all_gather the int8 sums and their scales, rebuild the mean
    if n == 1:
        q_all, s_all = q2, scale2
    else:
        q_parts = [torch.empty_like(q2) for _ in range(n)]
        s_parts = [torch.empty_like(scale2) for _ in range(n)]
        dist.all_gather(q_parts, q2, group=group)
        dist.all_gather(s_parts, scale2, group=group)
        q_all, s_all = torch.cat(q_parts), torch.cat(s_parts)
        del q_parts
    del q2
    mean = _dequant(q_all, s_all).div_(n).reshape(-1)[:numel]
    return mean, worker_err.reshape(-1)[:numel], owner_err
