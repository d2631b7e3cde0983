"""Train and serve step builders: model + sharding strategy + optimizer -> steps.

Counterpart of ``repro/train/step.py``.  PyTorch runs eagerly: a step
function is a plain closure, built once and called per batch, where the
reference's is jitted.

Without a mesh a step runs on one device.  With one (``launch/mesh.py``),
every rank of the ``torch.distributed`` world runs the same step on its
shard, as the reference's GSPMD program does:

  * a step takes the global batch; each rank computes on its shard of it
    over the dp axes (``batch_pspecs``), and what a step returns for the
    batch (metrics, logits) is global again;
  * state kept between steps lives in shards: the parameters as
    ``param_pspec_tree`` cuts them (the fsdp rules shard over "data", the
    tensor-parallel rules over "model"), AdamW's m and v as
    ``opt_pspec_tree`` cuts them (ZeRO-1), a serve step's cache as its
    rank's batch shard's; ``shard_tree`` and ``gather_tree`` move a tree
    between the global and the local layout;
  * a train step hands the model the rank's shards (``parallel/tensor.Shards``).
    The model gathers each layer's over the dp axes inside the layer's
    ``remat`` (``tp.fsdp``; the embedding and the head where they are
    used), so a rank holds one layer's gathered weights at a time, and the
    replay gathers them again in the backward.  Each gather's backward
    reduce-scatters its gradient over the dp axes straight to the rank's
    cut of the leaf's moments (ZeRO-1's, finer than the parameter's where
    the parameter is not cut over "data") and all-reduces it over the dp
    axes that cut none of its dims.  The step divides the gradients by the
    dp ranks, and each rank updates its slice of the moments and of the
    parameter, rebuilding the parameter's shard from the ranks' slices
    where ZeRO-1 cut finer.  The gradient norm sums each leaf's squares
    over every axis its gradient is cut on, once.  The prefill gathers a
    layer at a time too.  The compressed step keeps each rank's whole local
    gradients, as the reference's ``shard_map`` body does, since
    ``compressed_mean`` reduces them itself.

Tensor parallelism ("model" above 1) runs the train, prefill and decode
steps under every strategy: "tp", "fsdp_tp", "fsdp", "tp_sp",
"fsdp_tp_sp" and "serve_2dtp".  The two "_sp" strategies run the residual
stream on the rank's slice of the sequence (``models/layers.py``).
"serve_2dtp" is 2D tensor parallelism: its weights are cut over "data" on
their d_model dims as well as over "model", its activations replicated
over "data", so "data" is no dp axis there: no weight is gathered, a
product whose contraction "data" cuts sums its partial results over
"data", and a result "data" cuts is gathered (``parallel/tensor.py``); its
batch is whole on every rank and its gradients exact, with nothing to
average, while its caches hold the rank's rows ("cache_batch").  The
decode step takes the rank's shards of the weights, gathered a layer at a
time over the dp axes as the prefill gathers them, and the cache as the
tensor-parallel prefill returns it (``shard_cache`` cuts a whole cache so);
under a strategy with ``flash_decode`` the attention splits the cache's
sequence over "model" where the rank's cache holds every KV head
(``models/attention.py``).  The compressed step runs on a (d, m) mesh
too: the rank's gradients of its "model" shards, whole over the dp axes,
reduced by ``compressed_mean`` over its "data" group in the whole
tensors' int8 blocks.  On an abstract mesh
(``launch/mesh.make_production_mesh``) the steps run without a process
group: their collectives record their bytes and return tensors of the
right shapes (the dry run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.tensor import all_reduce
from repro_torch.parallel.tensor import gather_axes as gather  # the global tensor of a rank's shard
from repro_torch.parallel.sharding import (
    Strategy,
    activation_rules,
    default_strategy,
    dp_axes,
    is_two_d,
    local_shape,
    mesh_axis_sizes,
    param_pspec_tree,
    resolve_axes,
    spec_axes,
)


# ---------------------------------------------------------------------------
# Sharding bundles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepShardings:
    params: Any  # spec tree
    opt: Any
    batch: Any
    cache: Optional[Any] = None


def batch_pspecs(batch_specs: dict, mesh, strategy: Optional[Strategy] = None) -> dict:
    """tokens/labels (B, L) -> (dp, None); stub embeddings (B, T, D) likewise.
    Respects the strategy's "batch" activation rule (serve_2dtp replicates).
    The leaves need only a ``shape``."""
    rules = {"batch": strategy.act_rules.get("batch", "__dp__") if strategy else "__dp__"}
    sizes = mesh_axis_sizes(mesh)

    def one(leaf):
        axes = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return resolve_axes(axes, rules, mesh.axis_names, tuple(leaf.shape), sizes)

    return tree_map(one, batch_specs)


def act_pspec_tree(specs, strategy: Strategy, mesh):
    """Cache/state spec tree -> specs via the *activation* rules."""
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda s: resolve_axes(s.axes, strategy.act_rules, mesh.axis_names, s.shape, sizes), specs)


def make_shardings(model: Model, strategy: Strategy, mesh, batch_specs: dict, cache_specs=None) -> StepShardings:
    pspecs = param_pspec_tree(model.specs(), strategy, mesh)
    opt = adamw.opt_pspec_tree(model.specs(), pspecs, strategy.zero1, mesh_axis_sizes(mesh).get("data", 1))
    batch = batch_pspecs(batch_specs, mesh, strategy)
    cache = act_pspec_tree(cache_specs, strategy, mesh) if cache_specs is not None else None
    return StepShardings(pspecs, opt, batch, cache)


# ---------------------------------------------------------------------------
# Moving trees between the global and a rank's local layout
# ---------------------------------------------------------------------------


def local_slices(shape, spec, mesh) -> tuple:
    """This rank's slice of each dim of a global tensor of ``shape`` under
    ``spec``: block ``i`` of ``n``, with ``n`` the product of the dim's
    axes' sizes and ``i`` the rank's coordinates over them, the first axis
    outermost (a JAX mesh's order)."""
    lshape = local_shape(tuple(shape), spec, mesh)
    out = []
    for size, entry in zip(lshape, spec):
        idx = 0
        for a in spec_axes(entry):
            idx = idx * mesh.axis_size(a) + mesh.coordinate(a)
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the global tensor ``t``, a contiguous copy
    (never a view of ``t``: the steps update shards in place)."""
    return t[local_slices(t.shape, spec, mesh)].clone(memory_format=torch.contiguous_format)


def _dp_slices(shape, spec, mesh, cut=None) -> tuple:
    """This rank's slice of each dim of a tensor cut over "model" (and over
    the axes of the spec ``cut`` where given) that ``spec`` cuts over more
    axes: the rank's block over each dim's other axes, the first
    outermost.  The moments' slice of a gradient whole over the dp axes, or
    (``cut`` the parameter's spec) of a parameter shard ZeRO-1 cuts finer."""
    out = []
    for d, (size, entry) in enumerate(zip(shape, spec)):
        have = ("model",) + (spec_axes(cut[d]) if cut is not None else ())
        n, idx = 1, 0
        for a in spec_axes(entry):
            if a not in have:
                idx = idx * mesh.axis_size(a) + mesh.coordinate(a)
                n *= mesh.axis_size(a)
        out.append(slice(idx * (size // n), (idx + 1) * (size // n)))
    return tuple(out)


def shard_tree(tree, specs, mesh):
    """Each leaf of a global tree cut to this rank's shard (``specs``: a
    tree of the same nesting, one spec a leaf)."""
    flat = iter(tree_leaves(specs))
    return tree_map(lambda t: shard(t, next(flat), mesh), tree)


def gather_tree(tree, specs, mesh):
    """Each leaf of a local tree gathered to the global tensor (a
    collective: every rank calls it)."""
    flat = iter(tree_leaves(specs))
    return tree_map(lambda t: gather(t, next(flat), mesh), tree)


class _Layout:
    """One model's train state on a mesh: each leaf's spec as a parameter
    and as a moment (and so as a gradient), and the dp axes its gradients
    are summed over."""

    def __init__(self, model: Model, strategy: Strategy, mesh):
        if mesh.device_mesh is not None:
            for a in dp_axes(mesh.axis_names):
                if a != "data" and mesh.axis_size(a) > 1:
                    raise NotImplementedError(f"a dp axis {a!r} of {mesh.axis_size(a)} ranks: local meshes are ('data', 'model')")
        specs = model.specs()
        pspecs = param_pspec_tree(specs, strategy, mesh)
        self.mesh = mesh
        self.strategy = strategy
        self.shapes = [s.shape for s in tree_leaves(specs)]
        self.params = tree_leaves(pspecs)
        opt = adamw.opt_pspec_tree(specs, pspecs, strategy.zero1, mesh.axis_size("data"))
        self.moments = tree_leaves(opt["m"])
        # stacked leaves whose moments keep the layer dim whole: updated a layer at a time
        self.by_layer = [s.axes[:1] == ("layers",) and spec_axes(m[0]) == () for s, m in zip(tree_leaves(specs), self.moments)]
        self.param_tree = pspecs
        # the axes the batch is cut over and the gradients summed over: none
        # under "serve_2dtp", whose "data" axis cuts weights
        self.dp = () if is_two_d(strategy) else dp_axes(mesh.axis_names)
        self.n_dp = math.prod(mesh.axis_size(a) for a in self.dp)
        # the axes each gradient is cut on (its moment's), mesh order: a norm group
        self.cut = [tuple(a for a in mesh.axis_names if mesh.axis_size(a) > 1 and a in {x for e in spec for x in spec_axes(e)})
                    for spec in self.moments]

    def local_batch(self, batch: dict) -> dict:
        specs = batch_pspecs(batch, self.mesh, self.strategy)
        return {k: shard(v, specs[k], self.mesh) for k, v in batch.items()}

    def rules(self, shards: Optional[tp.Shards] = None):
        return activation_rules(self.strategy, self.mesh, tensor_parallel=True, shards=shards)

    def loss_and_grads(self, model: Model, params, batch: dict, *, reduce: bool = True):
        """(metrics of this rank's shard, gradients of its shard's loss,
        leaves in order) with respect to the rank's shards, which the model
        gathers a layer at a time.  The gradients come summed over the dp
        ranks in the moments' layout, or with ``reduce`` False as this
        rank's own, whole over the dp axes."""
        shards = tp.Shards(self.mesh, tree_leaves(params), self.params, self.moments, reduce=reduce, dp=self.dp)
        with self.rules(shards):  # the backward too: its moves and the remat replays read the rules
            loss, metrics = model.loss(params, self.local_batch(batch))
            torch.autograd.backward(loss, inputs=[shards.token])
        return {k: v.detach() for k, v in metrics.items()}, shards.grads()

    def grad_norm(self, grads: list) -> torch.Tensor:
        """The global gradient norm of gradients in the moments' layout:
        each leaf's squares summed over every axis the gradient is cut on,
        once (on one rank ``adamw.global_norm``'s sum)."""
        groups: dict = {}
        for g, cut in zip(grads, self.cut):
            groups.setdefault(cut, []).append(torch.sum(torch.square(g.float())))
        total = [all_reduce(torch.sum(torch.stack(sq)), self.mesh, cut) for cut, sq in sorted(groups.items())]
        return torch.sqrt(total[0] if len(total) == 1 else torch.sum(torch.stack(total)))

    @torch.no_grad()
    def update(self, opt_cfg: adamw.AdamWConfig, params, grads: list, opt_state):
        """AdamW on every rank's slices: the global norm from the averaged
        gradients (``grads``, in the moments' layout), each moment's slice
        updated with its gradient and the matching slice of the parameter's
        shard, and the shard rebuilt from the ranks' slices where ZeRO-1
        cut the moments finer.  A stacked leaf is updated a layer at a time
        (the update is elementwise: the same numbers), so its fp32
        temporaries are one layer's."""
        step = opt_state["step"] + 1
        gnorm = self.grad_norm(grads)
        scale, lr, b1c, b2c = adamw.step_scalars(opt_cfg, step, gnorm)
        leaves = zip(tree_leaves(params), grads, tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]),
                     self.params, self.moments, self.by_layer)
        for p, g, m, v, pspec, mspec, by_layer in leaves:
            parts = zip(p, g, m, v) if by_layer else [(p, g, m, v)]
            if by_layer:
                pspec, mspec = pspec[1:], mspec[1:]
            for p, g, m, v in parts:
                if pspec == mspec:
                    adamw.update_leaf(opt_cfg, p, g, m, v, scale, lr, b1c, b2c)
                    continue
                piece = p[_dp_slices(p.shape, mspec, self.mesh, cut=pspec)].clone()
                adamw.update_leaf(opt_cfg, piece, g, m, v, scale, lr, b1c, b2c)
                p.copy_(gather(piece, tuple(None if pe == me else me for pe, me in zip(pspec, mspec)), self.mesh))
        opt_state["step"] = step
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}

    def mean_metrics(self, metrics: dict, sum_keys=("tokens",)) -> dict:
        """The shards' metrics over the dp ranks: ``sum_keys`` summed, the
        rest averaged (equal shards: the mean of the shards' means is the
        global mean)."""
        out = {}
        for k, v in metrics.items():
            t = all_reduce(v.detach().float().clone(), self.mesh, self.dp)
            out[k] = t if k in sum_keys else t / self.n_dp
        return out


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _layout(model: Model, strategy: Optional[Strategy], mesh) -> _Layout:
    return _Layout(model, strategy or default_strategy(model.cfg), mesh)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *, strategy: Optional[Strategy] = None, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradients of ``model.loss`` by autograd (on the card, through the
    kernels' backward kernels), then one AdamW step, which updates the
    params and the optimizer state in place (``optim/adamw.py``).  metrics
    holds the loss's (``ce``, ``tokens``, ``loss``) and the optimizer's
    (``grad_norm``, ``lr``) as detached fp32 tensors.  With a ``mesh`` the
    state is this rank's shards and the gradients are averaged over the dp
    ranks (module docstring); ``strategy`` defaults to the config's."""
    if mesh is not None:
        return _sharded_train_step(model, opt_cfg, _layout(model, strategy, mesh))

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


def _sharded_train_step(model: Model, opt_cfg: adamw.AdamWConfig, layout: _Layout):
    def train_step(params, opt_state, batch):
        metrics, grads = layout.loss_and_grads(model, params, batch)
        for g in grads:  # summed over the dp ranks: their mean, in place
            g.div_(layout.n_dp)
        params, opt_state, opt_metrics = layout.update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**layout.mean_metrics(metrics), **opt_metrics}

    return train_step


def make_compressed_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *, strategy: Optional[Strategy] = None,
                               mesh=None):
    """Train step with int8 error-feedback gradient reduction over the dp
    ranks (``step.py:109-170``): each rank's local gradients, then
    ``compressed_mean`` a leaf in place of the all-reduce, then AdamW.

    (params, opt_state, comp_state, batch) -> (params, opt_state,
    comp_state, metrics); ``comp_state`` is ``init_compression_state``'s
    (``compression_state`` of the params' shapes over the dp ranks), and
    carries the error feedback between steps; it is updated in place, as
    AdamW's state is.  The metrics are averaged over the dp ranks, as the
    reference's ``pmean`` averages them.  Without a mesh, a world of one:
    the gradients are quantized and no collective runs.  Each rank keeps
    its whole local gradients over the dp axes (``loss_and_grads(reduce=False)``),
    as the reference's ``shard_map`` body does: ``compressed_mean`` takes
    them whole, and the step then updates the rank's slices of its mean.
    The reference's ``shard_map`` makes every mesh axis manual and reduces
    whole gradients; on a "model" axis above 1 a rank holds its "model"
    shard of each, which ``compressed_mean`` joins over "model" to
    quantize the whole tensor's blocks (``compression_parts``), so the
    numbers are the reference's on any mesh, and the error states the rank
    keeps are its shards.  The batch is cut over the dp axes whatever the
    strategy's "batch" rule, as the reference's ``shard_map`` cuts it (under
    "serve_2dtp" too, whose "data" axis is then a dp axis)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.compression import compressed_mean

    strategy = _dp_batch(strategy or default_strategy(model.cfg))
    layout = _layout(model, strategy, mesh if mesh is not None else Mesh(("data", "model"), (1, 1)))
    dp = layout.mesh.group("data")
    parts = compression_parts(model, strategy, layout.mesh)

    def train_step(params, opt_state, comp_state, batch):
        metrics, grads = layout.loss_and_grads(model, params, batch, reduce=False)
        for i, st in enumerate(_state_leaves(comp_state)):
            mean, new = compressed_mean(grads[i], st, dp, part=parts[i])
            grads[i] = mean[_dp_slices(mean.shape, layout.moments[i], layout.mesh)]
            for k, t in new.items():  # in place: two copies of the error states would not fit beside the model
                st[k].copy_(t)
        params, opt_state, opt_metrics = layout.update(opt_cfg, params, grads, opt_state)
        return params, opt_state, comp_state, {**layout.mean_metrics(metrics, sum_keys=()), **opt_metrics}

    return train_step


def _dp_batch(strategy: Strategy) -> Strategy:
    """``strategy`` with its batch cut over the dp axes (a 2D strategy's
    replicated batch cut as the compressed step's ``shard_map`` cuts it)."""
    if not is_two_d(strategy):
        return strategy
    return replace(strategy, act_rules={**strategy.act_rules, "batch": "__dp__"})


def compression_parts(model: Model, strategy: Strategy, mesh) -> list:
    """Each parameter leaf's "model" cut in the layout the compressed step
    reduces its gradient in (the rank's "model" shard, whole over the dp
    axes): a ``compression.ModelPart`` (mesh, dim, outer: the dp axes
    before "model" in the dim's entry, gathered), or None where "model"
    cuts no dim or holds one rank."""
    from repro_torch.optim.compression import ModelPart

    out = []
    for spec in tree_leaves(param_pspec_tree(model.specs(), _dp_batch(strategy), mesh)):
        part = None
        for d, entry in enumerate(spec):
            names = spec_axes(entry)
            if "model" in names and mesh.axis_size("model") > 1:
                part = ModelPart(mesh, d, math.prod(mesh.axis_size(a) for a in names[: names.index("model")]))
        out.append(part)
    return out


def init_compression_state(model: Model, *, strategy: Optional[Strategy] = None, mesh=None, device="cuda"):
    """The compressed step's zero error states (``compression_state``) for
    this rank: over the "data" ranks, of each leaf's "model" shard where
    "model" cuts it (``compression_parts``), on ``device``."""
    from repro_torch.optim.compression import compression_state

    if mesh is None:
        return compression_state(model.specs(), 1, device=device)
    parts = compression_parts(model, strategy or default_strategy(model.cfg), mesh)
    return compression_state(model.specs(), mesh.axis_size("data"), device=device, parts=parts)


def _state_leaves(comp_state) -> list:
    """The per-parameter ``{"worker_err", "owner_err"}`` dicts of a
    compression state tree, in the params' ``tree_leaves`` order."""
    if "worker_err" in comp_state:
        return [comp_state]
    return [leaf for k in sorted(comp_state) for leaf in _state_leaves(comp_state[k])]


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


def make_prefill_step(model: Model, cache_len: int, *, strategy: Optional[Strategy] = None, mesh=None):
    """(params, batch) -> (last-token logits, cache), without gradients.
    With a mesh: ``params`` are this rank's shards (``param_pspec_tree``),
    gathered over the dp axes into its "model" shards a layer at a time
    (``tp.fsdp``; nothing under "serve_2dtp"); the rank computes on its
    shard of the batch under tensor parallelism; the logits come back
    global, the cache as ``shard_cache`` cuts a whole one: this rank's rows
    (its batch shard; under "serve_2dtp", which computes the whole batch,
    its rows of the cache's "data" cut), and of the heads and channels that
    its weights split over "model", its own."""
    if mesh is None:
        def prefill_step(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, cache_len=cache_len)

        return prefill_step

    layout = _layout(model, strategy, mesh)

    def sharded_prefill_step(params, batch):
        specs = batch_pspecs(batch, mesh, layout.strategy)
        shards = tp.Shards(mesh, tree_leaves(params), layout.params, dp=layout.dp)
        with torch.no_grad(), layout.rules(shards):
            logits, cache = model.prefill(params, layout.local_batch(batch), cache_len=cache_len)
        if is_two_d(layout.strategy):
            cache = shard_cache(model, cache, batch["tokens"].shape[0], cache_len, strategy=layout.strategy, mesh=mesh,
                                rows_only=True)
        return gather(logits, specs["tokens"], mesh), cache

    return sharded_prefill_step


def make_decode_step(model: Model, *, strategy: Optional[Strategy] = None, mesh=None):
    """(params, cache, batch) -> (logits, cache) for batch["tokens"] (B, 1)
    at batch["pos"] (B,), without gradients.  With a mesh: ``params`` are
    this rank's shards, as the prefill step takes them, gathered over the
    dp axes a layer at a time (none under "serve_2dtp"); ``cache`` is the
    rank's, as the prefill step returns it (``shard_cache``), never
    gathered; the batch global and cut to the rank's shard (whole under
    "serve_2dtp"); under tensor parallelism the rank computes on its
    "model" shards, and under ``strategy.flash_decode`` the attention
    splits the cache's sequence over "model" where the rank's cache holds
    every KV head.  The logits come back global.  The step writes its
    token into ``cache`` in place and returns it (``attention.write_cache``),
    as the reference's jitted step donates its cache: decoding twice from
    one cache takes a copy."""
    if mesh is None:
        def decode_step(params, cache, batch):
            with torch.no_grad():
                return model.decode_step(params, cache, batch["tokens"], batch["pos"])

        return decode_step

    layout = _layout(model, strategy, mesh)

    def sharded_decode_step(params, cache, batch):
        specs = batch_pspecs(batch, mesh, layout.strategy)
        local = layout.local_batch(batch)
        shards = tp.Shards(mesh, tree_leaves(params), layout.params, dp=layout.dp)
        with torch.no_grad(), layout.rules(shards):
            logits, cache = model.decode_step(params, cache, local["tokens"], local["pos"])
        return gather(logits, specs["tokens"], mesh), cache

    return sharded_decode_step


def shard_cache(model: Model, cache, batch: int, cache_len: int, *, mesh, strategy: Optional[Strategy] = None,
                rows_only: bool = False):
    """This rank's cache from a whole one (every row, head and channel, as
    a one-rank prefill returns it), in the layout the tensor-parallel
    prefill leaves and the decode step takes: the rank's rows over the dp
    axes ("cache_batch" under the strategy's activation rules; over "data"
    under "serve_2dtp" too), the KV heads its query heads read (its own
    where "kv_heads" splits: ``attention.cache_kv_heads``), and its channels
    where the weights split "ssm_inner" or "rnn" over "model".  Unlike the
    reference's activation rules, a rank keeps every cache position: where
    the rules spill "model" onto "cache_seq" (KV heads that "model" does
    not divide) it keeps the KV heads its query heads read, whole over the
    sequence.  ``rows_only``: cut the rows alone (a cache the rank computed
    for the whole batch).  Contiguous copies; ``batch`` and ``cache_len``
    are the whole cache's."""
    from repro_torch.models import attention as attn

    strategy = strategy or default_strategy(model.cfg)
    cfg = model.cfg
    specs = model.cache_specs(batch, cache_len)
    act = act_pspec_tree(specs, strategy, mesh)
    dp = dp_axes(mesh.axis_names)
    cuts = {}  # a cache dim's logical axis -> (t, dim) -> the rank's part of that dim
    if not rows_only:
        with activation_rules(strategy, mesh, tensor_parallel=True):
            heads = attn.cache_kv_heads(cfg) if cfg.n_kv_heads else None
            if heads is not None:
                cuts["kv_heads_act"] = lambda t, d, idx=torch.tensor(heads): t.index_select(d, idx.to(t.device))
            for name, width in (("ssm_inner", cfg.d_inner if cfg.family == "ssm" else 0),
                                ("rnn", cfg.rnn_dim if cfg.family == "hybrid" else 0)):
                s = tp.weight_split(("embed", name), (cfg.d_model, width)) if width else None
                if s is not None and s[0] == 1:
                    m, r = tp.model_size(), tp.model_rank()
                    cuts[name + "_act"] = lambda t, d, m=m, r=r, outer=s[1]: tp.rank_slice(t, m, r, d, outer)
    flat = iter(zip(tree_leaves(specs), tree_leaves(act)))

    def one(t):
        spec, pspec = next(flat)
        for d, (name, entry) in enumerate(zip(spec.axes, pspec)):
            if name == "cache_batch":
                n, idx = 1, 0
                for a in (a for a in spec_axes(entry) if a in dp):
                    idx, n = idx * mesh.axis_size(a) + mesh.coordinate(a), n * mesh.axis_size(a)
                t = tp.rank_slice(t, n, idx, d)
            elif name in cuts:
                t = cuts[name](t, d)
        return t.clone(memory_format=torch.contiguous_format)

    return tree_map(one, cache)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_train_state(model: Model, generator: torch.Generator, device="cuda", *, strategy: Optional[Strategy] = None,
                     mesh=None):
    """Parameters drawn from ``generator`` (which lives on ``device``) and a
    zero AdamW state: (params, opt_state).  With a mesh, every rank draws
    the global parameters from the same seed and keeps its shard; the
    moments are zeros of its ZeRO-1 shard's shape."""
    params = model.init(generator, device)
    if mesh is None:
        return params, adamw.init_state(params)
    layout = _Layout(model, strategy or default_strategy(model.cfg), mesh)
    moments = [torch.zeros(local_shape(shape, spec, mesh), dtype=torch.float32, device=device)
               for shape, spec in zip(layout.shapes, layout.moments)]
    return shard_tree(params, layout.param_tree, mesh), {
        "m": _unflatten_like(params, moments),
        "v": _unflatten_like(params, [torch.zeros_like(t) for t in moments]),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
