"""Tensor parallelism over the mesh's "model" axis: the moves of an
activation between its replicated and its split layout, and the count of
every collective the port runs.

The reference leaves these moves to GSPMD, which inserts the collectives its
sharding rules imply (``repro/parallel/sharding.py``).  The port runs eagerly,
one process a rank, so the model code places them itself, as Megatron-LM
does.  Each move is a ``torch.autograd.Function`` whose backward is its
conjugate, so the gradient of a replicated tensor comes out whole on every
rank and that of a split one as the rank's part, with no extra reduction:

  * ``reduce``: partial results summed (forward all_reduce, backward identity);
  * ``enter``: a replicated input handed to a split region (forward identity,
    backward all_reduce), once at each point where rank-specific work reads
    a replicated tensor;
  * ``gather``: a dim split over "model" made whole (forward all_gather,
    backward the rank's slice);
  * ``split``: the rank's slice of a replicated dim (forward slice, backward
    all_gather).

A split dim is laid out as ``(outer, m, rest)``: the rank's part is block
``[:, rank]``.  ``outer`` is the product of the mesh axes that precede
"model" in the dim's spec entry, which the train step gathers before the
layer runs (under "fsdp_tp" a spilled "embed" dim is ("data", "model")).

The moves act only inside a tensor-parallel step (``activation_rules(...,
tensor_parallel=True)``, installed by ``train/step.py``'s train and prefill
steps); elsewhere ``weight_split`` reads no split and the model runs on whole
weights.  On an abstract mesh (``launch/mesh.make_production_mesh``: no
process group) the moves do not communicate: they return tensors of the
right shape, dtype and device and record the same bytes, which is how the
dry run (``launch/dryrun.py``) counts a step's collectives.

Every collective of the port runs through ``all_reduce`` and ``all_gather``
here, which record (op, bytes a rank) in ``COLLECTIVES``; the bytes are the
result's, as ``repro/roofline/hlo.py`` counts them.  gloo on the CPU takes
each of these on CUDA tensors too.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Optional

import torch
import torch.distributed as dist


class CollectiveCounter:
    """Bytes a rank and calls, by op, since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes_by_op: dict[str, int] = defaultdict(int)
        self.count_by_op: dict[str, int] = defaultdict(int)

    def record(self, op: str, nbytes: int) -> None:
        self.bytes_by_op[op] += int(nbytes)
        self.count_by_op[op] += 1

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


COLLECTIVES = CollectiveCounter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ranks(mesh, axes) -> int:
    """The ranks over ``axes`` (a mesh axis or a tuple of them); 1 without a mesh."""
    if mesh is None:
        return 1
    return math.prod(mesh.axis_size(a) for a in ((axes,) if isinstance(axes, str) else axes))


def _abstract(mesh) -> bool:
    return mesh.device_mesh is None


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over ``axes`` (one mesh axis or a tuple) in
    place, and returned; on an abstract mesh ``t`` as it is.  Nothing runs or
    is recorded where the axes hold one rank; one call is recorded for
    several axes (one collective over their product, as XLA runs it)."""
    if _ranks(mesh, axes) == 1:
        return t
    COLLECTIVES.record("all-reduce", _nbytes(t))
    if not _abstract(mesh):
        for a in (axes,) if isinstance(axes, str) else axes:
            if mesh.axis_size(a) > 1:
                dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=mesh.group(a))
    return t


def all_gather(t: torch.Tensor, mesh, axes, dim: int, outer: int = 1) -> torch.Tensor:
    """The ranks' ``t`` over ``axes`` joined on ``dim`` in the ``(outer, n,
    rest)`` layout: each rank's block ``i`` of ``outer`` next to the others'.
    Several axes (a tuple, outermost first, ``outer`` 1) join as one dim
    split over their product."""
    n = _ranks(mesh, axes)
    if n == 1:
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    shape[dim] *= n
    COLLECTIVES.record("all-gather", _nbytes(t) * n)
    if _abstract(mesh):
        return t.new_empty(shape)
    for a in reversed((axes,) if isinstance(axes, str) else axes):  # the innermost first
        if mesh.axis_size(a) == 1:
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.axis_size(a))]
        dist.all_gather(parts, t.contiguous(), group=mesh.group(a))
        if outer == 1:
            t = torch.cat(parts, dim=dim)
        else:
            blocks = [p.unflatten(dim, (outer, -1)) for p in parts]
            t = torch.stack(blocks, dim=dim + 1).flatten(dim, dim + 2)
    return t


def rank_slice(t: torch.Tensor, n: int, r: int, dim: int, outer: int = 1) -> torch.Tensor:
    """Block ``r`` of ``n`` along ``dim`` in the ``(outer, n, rest)`` layout."""
    dim = dim % t.dim()
    if outer == 1:
        size = t.shape[dim] // n
        return t.narrow(dim, r * size, size)
    return t.unflatten(dim, (outer, n, -1)).select(dim + 1, r).flatten(dim, dim + 1)


# ---------------------------------------------------------------------------
# The tensor-parallel context (installed by parallel/sharding.activation_rules)
# ---------------------------------------------------------------------------


def _tp_mesh():
    """The mesh of a tensor-parallel step whose "model" axis is above 1, or None."""
    from repro_torch.parallel.sharding import current_mesh, tensor_parallel_enabled

    mesh = current_mesh()
    return mesh if tensor_parallel_enabled() and _ranks(mesh, "model") > 1 else None


def model_size() -> int:
    mesh = _tp_mesh()
    return mesh.axis_size("model") if mesh is not None else 1


def model_rank() -> int:
    mesh = _tp_mesh()
    return mesh.coordinate("model") if mesh is not None else 0


def weight_split(axes: tuple, shape: tuple) -> Optional[tuple[int, int]]:
    """Where a weight of global ``shape`` and logical ``axes`` is split over
    "model" in the running tensor-parallel step: (dim, outer), read from the
    strategy's parameter rules as ``param_pspec_tree`` resolves them, or
    None (whole on every rank, or no tensor-parallel step)."""
    mesh = _tp_mesh()
    if mesh is None:
        return None
    from repro_torch.parallel.sharding import current_param_rules, mesh_axis_sizes, resolve_axes, spec_axes

    spec = resolve_axes(tuple(axes), current_param_rules(), mesh.axis_names, tuple(shape), mesh_axis_sizes(mesh))
    for d, entry in enumerate(spec):
        names = spec_axes(entry)
        if "model" in names:
            return d, math.prod(mesh.axis_size(a) for a in names[: names.index("model")])
    return None


# ---------------------------------------------------------------------------
# The four moves
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, "model"), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, outer):
        ctx.mesh, ctx.dim, ctx.outer = mesh, dim, outer
        return all_gather(x, mesh, "model", dim, outer)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return rank_slice(g, m.axis_size("model"), m.coordinate("model"), ctx.dim, ctx.outer).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, outer):
        ctx.mesh, ctx.dim, ctx.outer = mesh, dim, outer
        return rank_slice(x, mesh.axis_size("model"), mesh.coordinate("model"), dim, outer).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, "model", ctx.dim, ctx.outer), None, None, None


def reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (``op="max"``: the largest, with
    no gradient, for a softmax's shift)."""
    mesh = _tp_mesh()
    if mesh is None:
        return x
    if op == "max":
        return all_reduce(x.detach().clone(), mesh, "model", "max")
    return _Reduce.apply(x, mesh)


def enter(x: torch.Tensor) -> torch.Tensor:
    """A replicated ``x`` read by rank-specific work: its gradient is summed
    over the ranks."""
    mesh = _tp_mesh()
    return x if mesh is None else _Enter.apply(x, mesh)


def gather(x: torch.Tensor, dim: int, outer: int = 1) -> torch.Tensor:
    """The whole of a ``dim`` split over "model"."""
    mesh = _tp_mesh()
    return x if mesh is None else _Gather.apply(x, mesh, dim, outer)


def split(x: torch.Tensor, dim: int, outer: int = 1) -> torch.Tensor:
    """The rank's part of a replicated ``dim``."""
    mesh = _tp_mesh()
    return x if mesh is None else _Split.apply(x, mesh, dim, outer)
