"""Tensor and sequence parallelism over the mesh's "model" axis, the
per-layer gather of a train or prefill step's dp shards, and the count of
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
    all_gather);
  * ``seq_enter`` and ``seq_leave``, Megatron-LM's sequence-parallel pair:
    the rank's slice of the sequence made whole at the entry of a
    column-parallel region (forward all_gather, backward reduce_scatter),
    and a row-parallel product's partial sums summed and cut to the rank's
    slice of the sequence (forward reduce_scatter, backward all_gather).
    Under a strategy whose activation rules map "seq" to "model"
    (``seq_split``) they take the place of ``enter`` and ``reduce`` at a
    block's boundaries, and the residual stream between blocks, its norms
    and its elementwise work run on the rank's slice of the sequence.

A split dim is laid out as ``(outer, m, rest)``: the rank's part is block
``[:, rank]``.  ``outer`` is the product of the mesh axes that precede
"model" in the dim's spec entry, which ``fsdp`` gathers before the layer
runs (under "fsdp_tp" a spilled "embed" dim is ("data", "model"), under
"fsdp" every split dim).

The train, prefill and decode steps keep each parameter as the rank's shard over
every mesh axis.  ``fsdp`` gathers a layer's shards over the dp axes where
the layer runs, inside the function that ``models/layers.remat``
checkpoints, so the remat replay gathers them again and no gathered weight
outlives its layer; its backward (``_FsdpGather``) reduce-scatters the
gradient straight to the rank's cut of the leaf's optimizer moments and
all-reduces it over the dp axes that cut no dim, and ``Shards`` collects it
(ROADMAP.md item 6c).

Under "serve_2dtp" (2D tensor parallelism, ``sharding.is_two_d``) the
"data" axis cuts weights too, on their d_model dims, and is no dp axis of
the step: ``data_split`` reads that cut, and ``reduce``, ``enter``,
``gather`` and ``split`` take ``axis="data"``.  A product whose
contraction "data" cuts reads the rank's "data" block of its input and
sums its partial results over "data"; one whose result "data" cuts reads
its input through ``enter`` over "data" and gathers the result; no
weight is gathered (``Shards`` with no dp axes).  Its batch is whole on
every rank while its caches hold the rank's rows: ``batch_part`` and
``batch_whole`` move the decode's token to and from them.

The moves act only inside a tensor-parallel step (``activation_rules(...,
tensor_parallel=True)``, installed by ``train/step.py``'s train, prefill
and decode steps); elsewhere ``weight_split`` reads no split, ``fsdp``
returns what it is given and the model runs on whole weights.  On an abstract mesh
(``launch/mesh.make_production_mesh``: no process group) the moves do not
communicate: they return tensors of the right shape, dtype and device and
record the same bytes, which is how the dry run (``launch/dryrun.py``)
counts a step's collectives.

Every collective of the port runs through ``all_reduce``, ``all_gather``
and ``reduce_scatter`` here, which record (op, bytes a rank) in
``COLLECTIVES``; the bytes are the result's, as ``repro/roofline/hlo.py``
counts them.  gloo on the CPU takes each of these on CUDA tensors too.
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
        self.param_bytes = 0  # of the all-gathers: those of parameter shards (``fsdp``)

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


# reduce_scatter_tensor, under the name torch gives it from release 2.13
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int, outer: int = 1) -> torch.Tensor:
    """The conjugate of ``all_gather``: ``t`` summed over the ranks of
    ``axes`` (one mesh axis or a tuple, outermost first) and cut to this
    rank's block of ``dim`` in the same ``(outer, n, rest)`` layout; a new
    tensor, or ``t`` itself where the axes hold one rank.  On an abstract
    mesh an empty tensor of the result's shape.  One call is recorded for
    several axes, with the result's bytes."""
    n = _ranks(mesh, axes)
    if n == 1:
        return t
    dim = dim % t.dim()
    if t.shape[dim] % (n * outer):
        raise ValueError(f"dim {t.shape[dim]} does not split over {n} ranks in {outer} blocks")
    shape = list(t.shape)
    shape[dim] //= n
    COLLECTIVES.record("reduce-scatter", _nbytes(t) // n)
    if _abstract(mesh):
        return t.new_empty(shape)
    for a in (axes,) if isinstance(axes, str) else axes:  # the outermost first
        if mesh.axis_size(a) > 1:
            blocks = t.unflatten(dim, (outer, mesh.axis_size(a), -1)).movedim(dim + 1, 0).contiguous()
            out = blocks.new_empty(blocks.shape[1:])  # (..., outer, rest, ...): the rank's block
            _REDUCE_SCATTER(out.view(-1), blocks.view(-1), group=mesh.group(a))
            t = out.flatten(dim, dim + 1)
    return t


def gather_axes(t: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """The tensor of which ``t`` is this rank's shard under ``spec``
    (an entry a dim): an all_gather along each dim split over more than one
    rank, over the dim's axes at once.  With ``axes`` only those mesh axes
    are gathered: a rank's "model" shard from its shard over (dp, "model")
    when ``axes`` are the dp axes, a dim split over ("data", "model") then
    holding the rank's "model" block of each "data" block (the ``(outer,
    m, rest)`` layout)."""
    from repro_torch.parallel.sharding import spec_axes

    for d, entry in enumerate(spec):
        names = spec_axes(entry)
        if axes is not None:
            names = tuple(a for a in names if a in axes)
        t = all_gather(t, mesh, names, d)
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


def _tp_mesh(axis: str = "model"):
    """The mesh of a tensor-parallel step whose ``axis`` is one of its
    tensor axes (``_tensor_axes``) and holds more than one rank, or None."""
    from repro_torch.parallel.sharding import current_mesh, tensor_parallel_enabled

    mesh = current_mesh()
    if not tensor_parallel_enabled() or axis not in _tensor_axes():
        return None
    return mesh if _ranks(mesh, axis) > 1 else None


def _tensor_axes() -> tuple:
    """The mesh axes that cut weights into the parts a rank computes on:
    "model", and "data" under "serve_2dtp" (elsewhere "data" is a dp axis,
    whose shards ``fsdp`` gathers)."""
    from repro_torch.parallel.sharding import two_d_enabled

    return ("data", "model") if two_d_enabled() else ("model",)


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
    tensor = _tensor_axes()
    for d, entry in enumerate(spec):
        names = spec_axes(entry)
        if "model" in names:
            return d, math.prod(mesh.axis_size(a) for a in names[: names.index("model")] if a not in tensor)
    return None


def data_split(axes: tuple, shape: tuple) -> Optional[tuple[int, int]]:
    """Under "serve_2dtp" (2D tensor parallelism), where a weight of global
    ``shape`` and logical ``axes`` is cut over "data": (dim, outer), "data"
    being the outermost axis of its dim (outer 1); None elsewhere.  A dim
    cut over ("data", "model") is read as the rank's "data" block, within
    which ``weight_split`` gives the "model" cut."""
    mesh = _tp_mesh("data")
    if mesh is None:
        return None
    from repro_torch.parallel.sharding import current_param_rules, mesh_axis_sizes, resolve_axes, spec_axes

    spec = resolve_axes(tuple(axes), current_param_rules(), mesh.axis_names, tuple(shape), mesh_axis_sizes(mesh))
    for d, entry in enumerate(spec):
        names = spec_axes(entry)
        if "data" in names:
            if names.index("data"):
                raise NotImplementedError(f"a weight dim cut over {names}: 'data' not outermost")
            return d, 1
    return None


# ---------------------------------------------------------------------------
# The four moves
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, outer, axis):
        ctx.mesh, ctx.dim, ctx.outer, ctx.axis = mesh, dim, outer, axis
        return all_gather(x, mesh, axis, dim, outer)

    @staticmethod
    def backward(ctx, g):
        m, a = ctx.mesh, ctx.axis
        return rank_slice(g, m.axis_size(a), m.coordinate(a), ctx.dim, ctx.outer).contiguous(), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, outer, axis):
        ctx.mesh, ctx.dim, ctx.outer, ctx.axis = mesh, dim, outer, axis
        return rank_slice(x, mesh.axis_size(axis), mesh.coordinate(axis), dim, outer).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim, ctx.outer), None, None, None, None


def reduce(x: torch.Tensor, op: str = "sum", axis="model") -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axis`` ("model", or under
    "serve_2dtp" "data" or both as one collective); ``op="max"``: the
    largest, with no gradient, for a softmax's shift."""
    axes = tuple(a for a in ((axis,) if isinstance(axis, str) else axis) if _tp_mesh(a) is not None)
    if not axes:
        return x
    mesh = _tp_mesh(axes[0])
    axes = axes[0] if len(axes) == 1 else axes
    if op == "max":
        return all_reduce(x.detach().clone(), mesh, axes, "max")
    return _Reduce.apply(x, mesh, axes)


def enter(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A replicated ``x`` read by rank-specific work: its gradient is summed
    over the ranks of ``axis``."""
    mesh = _tp_mesh(axis)
    return x if mesh is None else _Enter.apply(x, mesh, axis)


def gather(x: torch.Tensor, dim: int, outer: int = 1, axis: str = "model") -> torch.Tensor:
    """The whole of a ``dim`` split over ``axis``."""
    mesh = _tp_mesh(axis)
    return x if mesh is None else _Gather.apply(x, mesh, dim, outer, axis)


def split(x: torch.Tensor, dim: int, outer: int = 1, axis: str = "model") -> torch.Tensor:
    """The rank's part of a replicated ``dim`` over ``axis``."""
    mesh = _tp_mesh(axis)
    return x if mesh is None else _Split.apply(x, mesh, dim, outer, axis)


def batch_part(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The rank's rows of a batch that the step replicates over "data"
    while its caches hold the rank's rows ("serve_2dtp": tokens whole, the
    caches cut over "data" by ``cache_batch``); ``x`` elsewhere, where the
    step already cut the batch to the rank's rows."""
    return split(x, dim, axis="data")


def batch_whole(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The inverse of ``batch_part``: the ranks' rows joined over "data"."""
    return gather(x, dim, axis="data")


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------


class _SeqEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, "model", ctx.dim), None, None


class _SeqLeave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return reduce_scatter(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, "model", ctx.dim), None, None


def seq_split(length: int) -> bool:
    """Whether the residual stream of a sequence of ``length`` runs on the
    rank's slice of it: in a tensor-parallel step whose strategy maps "seq"
    to "model", where "model" divides the length (elsewhere a block keeps
    "tp"'s moves, with the same values)."""
    from repro_torch.parallel.sharding import sequence_parallel_enabled

    mesh = _tp_mesh()
    return mesh is not None and sequence_parallel_enabled() and length % mesh.axis_size("model") == 0


def seq_enter(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole sequence of the rank's slice ``x``, read by rank-specific
    work: its gradient summed over the ranks and cut to the rank's slice."""
    mesh = _tp_mesh()
    return x if mesh is None else _SeqEnter.apply(x, mesh, dim)


def seq_leave(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The sum of the ranks' partial ``x``, cut to the rank's slice of the
    sequence."""
    mesh = _tp_mesh()
    return x if mesh is None else _SeqLeave.apply(x, mesh, dim)


# ---------------------------------------------------------------------------
# The dp shards, gathered a layer at a time (ROADMAP.md item 6c)
# ---------------------------------------------------------------------------


class _Shard:
    """One parameter leaf of a step: the rank's shard, its spec as a
    parameter and as a gradient (the optimizer moments' cut), and the
    gradient collected so far (in the gradient's layout)."""

    def __init__(self, shard: torch.Tensor, spec: tuple, grad_spec: tuple, grad_shape: tuple):
        self.shard, self.spec, self.grad_spec, self.grad_shape = shard, spec, grad_spec, grad_shape
        self.grad: Optional[torch.Tensor] = None
        self.written: set = set()  # the layers whose gradient slot holds a value


class Shards:
    """A step's parameter shards, registered for ``fsdp``: the rank's shard
    of each leaf (``leaves``, in ``tree_leaves`` order) under ``specs``.

    With ``grad_specs`` (the moments' specs) the gathers take part in the
    backward: their gradients arrive summed over the dp ranks in the layout
    of ``grad_specs`` (``grads``).  With ``reduce`` False they arrive as this
    rank's own, whole over the dp axes (the layout ``fsdp`` computes in), as
    the compressed step reduces them itself.  Without ``grad_specs`` the
    gathers are forward-only (the prefill)."""

    def __init__(self, mesh, leaves: list, specs: list, grad_specs: Optional[list] = None, *, reduce: bool = True,
                 dp: Optional[tuple] = None):
        from repro_torch.parallel.sharding import dp_axes

        self.mesh, self.reduce = mesh, reduce
        self.dp = dp_axes(mesh.axis_names) if dp is None else tuple(dp)  # () under "serve_2dtp": nothing gathered
        self.leaves = []
        for i, (t, spec) in enumerate(zip(leaves, specs)):
            if t._base is not None:
                raise ValueError(f"a shard of shape {tuple(t.shape)} is a view: the steps take shards of their own")
            gspec = grad_specs[i] if grad_specs is not None else spec
            gshape = _local_over(self._whole_shape(t, spec), gspec, mesh, self.dp if reduce else ())
            self.leaves.append(_Shard(t, tuple(spec), tuple(gspec), gshape))
        self.by_id = {id(s.shard): s for s in self.leaves}
        self.token = torch.zeros((), device=leaves[0].device, requires_grad=True) if grad_specs is not None else None

    def _whole_shape(self, t: torch.Tensor, spec) -> tuple:
        """The shape of a shard gathered over the dp axes."""
        from repro_torch.parallel.sharding import spec_axes

        return tuple(n * math.prod(self.mesh.axis_size(a) for a in spec_axes(e) if a in self.dp)
                     for n, e in zip(t.shape, spec))

    def find(self, t: torch.Tensor) -> Optional[tuple]:
        """(the leaf, the layer) of a registered shard or of one layer of it
        (``models/spec.layer``'s view; the layer None for the leaf itself),
        or None."""
        s = self.by_id.get(id(t))
        if s is not None:
            return s, None
        base = t._base
        s = self.by_id.get(id(base)) if base is not None else None
        if s is None or base.dim() == 0 or tuple(t.shape) != tuple(base.shape[1:]):
            return None
        i, rem = divmod(t.storage_offset() - base.storage_offset(), base.stride(0))
        if rem or not 0 <= i < base.shape[0]:
            return None
        return s, i

    def gather(self, t: torch.Tensor, s: _Shard, layer: Optional[int]) -> torch.Tensor:
        """``t``, a registered leaf (or its layer ``layer``), gathered over
        the dp axes (a view of ``t`` where no dp axis cuts it)."""
        before = COLLECTIVES.bytes_by_op.get("all-gather", 0)
        out = gather_axes(t, s.spec if layer is None else s.spec[1:], self.mesh, self.dp)
        COLLECTIVES.param_bytes += COLLECTIVES.bytes_by_op.get("all-gather", 0) - before
        return t.view_as(t) if out is t else out

    def collect(self, s: _Shard, layer: Optional[int], g: torch.Tensor) -> None:
        """The gradient ``g`` of a gathered leaf (or layer), moved to the
        gradient's layout and added to what the leaf holds: a reduce-scatter
        over the dp axes that cut each dim, an all-reduce over those that
        cut none (a stacked leaf's layer dim among them, whose slot then
        lands only on the ranks that hold it)."""
        from repro_torch.parallel.sharding import spec_axes

        fresh = False
        if self.reduce:
            gspec = s.grad_spec if layer is None else s.grad_spec[1:]
            cut = set()
            for d, entry in enumerate(gspec):
                names = tuple(a for a in spec_axes(entry) if a in self.dp)
                if _ranks(self.mesh, names) > 1:
                    g, fresh, cut = reduce_scatter(g, self.mesh, names, d), True, cut | set(names)
            rest = tuple(a for a in self.dp if a not in cut and self.mesh.axis_size(a) > 1)
            if rest:
                g, fresh = all_reduce(g.clone() if not fresh else g, self.mesh, rest), True
        if layer is not None and self.reduce:
            layer_axes = tuple(a for a in spec_axes(s.grad_spec[0]) if a in self.dp)
            idx = 0
            for a in layer_axes:
                idx = idx * self.mesh.axis_size(a) + self.mesh.coordinate(a)
            per = s.grad_shape[0]
            if not idx * per <= layer < (idx + 1) * per:
                return  # another rank's slot
            layer -= idx * per
        if layer is None:
            if s.grad is None:
                s.grad = g if fresh or (g.is_contiguous() and g._base is None) else g.contiguous().clone()
            else:
                s.grad.add_(g)
            return
        if s.grad is None:
            s.grad = g.new_zeros(s.grad_shape)
        if layer in s.written:
            s.grad[layer].add_(g)
        else:
            s.grad[layer].copy_(g)
            s.written.add(layer)

    def grads(self) -> list:
        """The collected gradients, leaves in order (zeros where none arrived)."""
        return [s.grad if s.grad is not None else s.shard.new_zeros(s.grad_shape) for s in self.leaves]


def _local_over(shape: tuple, spec, mesh, axes) -> tuple:
    """``shape`` (whole over ``axes``) cut over the ``axes`` that ``spec``
    names on each dim."""
    from repro_torch.parallel.sharding import spec_axes

    return tuple(n // math.prod(mesh.axis_size(a) for a in spec_axes(e) if a in axes) for n, e in zip(shape, spec))


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, t, shards, leaf, layer):
        ctx.shards, ctx.leaf, ctx.layer = shards, leaf, layer
        return shards.gather(t, leaf, layer)

    @staticmethod
    def backward(ctx, g):
        ctx.shards.collect(ctx.leaf, ctx.layer, g)
        return None, None, None, None, None


def fsdp(tree):
    """Each leaf of a parameter tree that is a registered shard (or one
    layer of one) gathered over the dp axes: the rank's "model" shard of
    it, whose gradient the step collects (``Shards``).  Other leaves, and
    every leaf outside a step's ``Shards``, as they are."""
    from repro_torch.models.spec import tree_map
    from repro_torch.parallel.sharding import current_shards

    shards = current_shards()
    if shards is None:
        return tree

    def one(t):
        found = shards.find(t) if isinstance(t, torch.Tensor) else None
        if found is None:
            return t
        if shards.token is None or not torch.is_grad_enabled():
            return shards.gather(t, *found)
        return _FsdpGather.apply(shards.token, t, shards, *found)

    return tree_map(one, tree)
