"""Parameter specs: shapes + logical axes, used to size and initialise a model.

Counterpart of ``repro/models/spec.py``.  Every model family declares its
parameters as a nested dict of ``ParamSpec``.  From the same spec tree come
the parameter count (no allocation), the initialised tensors on a device
and the shapes of the serve path's caches.  The logical axis names are kept for
the sharding rules (ROADMAP.md, "Modules to port", item 6); one device uses
none of them.

Trees are nested dicts, walked in sorted key order as ``jax.tree`` walks a
dict, so a tree of the reference's numpy leaves maps onto the port's leaf
for leaf (``params_from_jax``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string as a torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(DTYPES)}")
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones | ssm_a_log | ssm_dt_bias | rglru_lambda
    scale: float = 0.02  # stddev for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict (dicts are the only nodes)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_size(specs) -> int:
    return sum(s.size for s in tree_leaves(specs))


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    f32 = torch.float32
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "normal":
        return (torch.randn(spec.shape, generator=generator, dtype=f32, device=device) * spec.scale).to(dt)
    if spec.init == "ssm_a_log":
        # mamba1: A initialised to -[1..N] broadcast over d_inner; stored as log
        n = spec.shape[-1]
        a = torch.arange(1, n + 1, dtype=f32, device=device).expand(spec.shape)
        return torch.log(a).to(dt)
    if spec.init == "ssm_dt_bias":
        # softplus^-1 of dt ~ U(1e-3, 1e-1)
        u = torch.rand(spec.shape, generator=generator, dtype=f32, device=device) * (1e-1 - 1e-3) + 1e-3
        return torch.log(torch.expm1(u)).to(dt)
    if spec.init == "rglru_lambda":
        # a = sigmoid(Lambda)^(c) with a in [0.9, 0.999]: Lambda = logit(a^(1/c))
        c = 8.0
        a = torch.rand(spec.shape, generator=generator, dtype=f32, device=device) * (0.999 - 0.9) + 0.9
        ac = a ** (1.0 / c)
        return torch.log(ac / (1 - ac)).to(dt)
    raise ValueError(spec.init)


def init_params(specs, generator: torch.Generator, device) -> dict:
    """Materialise a spec tree on ``device``, drawing every leaf in turn from
    ``generator``, which must live on that device.  torch's streams are not
    ``jax.random``'s, so the values differ from the reference's by design;
    ``params_from_jax`` carries the reference's own weights across."""
    device = torch.device(device)
    return tree_map(lambda s: _init_leaf(s, generator, device), specs)


def params_from_jax(tree, device) -> dict:
    """The reference's parameter (or cache) tree, as numpy leaves
    (``jax.tree.map(np.asarray, params)``), as torch tensors on ``device``,
    with the same nesting and the stacked leading layer axis.  bf16 leaves
    cross bit for bit through a ``uint16`` view: numpy has no bfloat16 of its
    own, and ``ml_dtypes``' arrays are 2-byte words."""
    device = torch.device(device)

    def one(arr) -> torch.Tensor:
        arr = np.array(arr)  # a writable copy: the reference's arrays are read-only
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device)

    return tree_map(one, tree)


def train_state_from_jax(params, opt_state, device) -> tuple[dict, dict]:
    """The reference's train state, ``(params, opt_state)`` as numpy trees
    (``jax.tree.map(np.asarray, ...)`` of ``train/step.init_train_state``'s
    or a train step's output), as the port's on ``device``: the params as
    ``params_from_jax`` carries them, the moments ``m`` and ``v`` in fp32
    and ``step`` an int32 scalar."""
    m, v = (params_from_jax(opt_state[k], device) for k in ("m", "v"))
    for leaf in tree_leaves(m) + tree_leaves(v):
        if leaf.dtype != torch.float32:
            raise ValueError(f"the reference's AdamW moments are fp32; got {leaf.dtype}")
    step = torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32, device=device)
    return params_from_jax(params, device), {"m": m, "v": v, "step": step}


# ---------------------------------------------------------------------------
# Spec construction helpers
# ---------------------------------------------------------------------------


def dense(shape, axes, dtype, scale=None, init="normal") -> ParamSpec:
    if scale is None:
        # lecun-ish: 1/sqrt(fan_in) with fan_in = prod of all but last axis
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


def stacked(n_layers: int, spec_tree):
    """Prefix every spec in the tree with a leading ('layers', n) axis."""

    def one(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n_layers,) + s.shape, ("layers",) + s.axes, s.dtype, s.init, s.scale)

    return tree_map(one, spec_tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (a view of each leaf)."""
    return tree_map(lambda t: t[i], tree)


def stack_layers(per_layer: list):
    """The inverse of ``layer``: per-layer trees stacked on a leading axis."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in per_layer]) for k in sorted(first)}
    return torch.stack(per_layer)
