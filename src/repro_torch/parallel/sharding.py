"""Logical-axis -> mesh-axis sharding rules (MaxText-style), per strategy.

Counterpart of ``repro/parallel/sharding.py`` (``:22-291``): the same rule
tables, strategies, divisibility drops and spill targets.  A *strategy* maps
logical parameter and activation axis names to mesh axes; the same model
code serves every strategy.

A spec is a plain tuple with one entry per dim: None (replicated), a mesh
axis name, or a tuple of them (the dim split over their product, the first
axis outermost), entry for entry what ``jax.sharding.PartitionSpec`` holds.
A mesh is anything with ``axis_names`` and ``shape`` (``launch/mesh.py``).

Mesh axes (production): single-pod ("data", "model") = (16, 16); multi-pod
("pod", "data", "model") = (2, 16, 16).  "pod" is an outer data-parallel
axis.  The train and serve steps (``train/step.py``) run these specs on
``torch.distributed``: data parallelism with FSDP parameter shards and
ZeRO-1 optimizer shards over "data", gathered a layer at a time over the dp
axes inside the layer loop and their gradients reduce-scattered back
(``parallel/tensor.py``, ``fsdp``), and, under every strategy, tensor
parallelism over "model" in the train, prefill and decode steps: each rank computes on its "model" shard of every
weight, with the moves of ``parallel/tensor.py`` where the reference's
GSPMD inserts collectives, under the two "_sp" strategies the residual
stream between blocks on the rank's slice of the sequence (Megatron-LM's
sequence parallelism), and under "serve_2dtp" (``is_two_d``) the "data"
axis cutting the weights' d_model dims as a second tensor axis.  The
distributed flash-decode splits the cache's sequence over "model"
(``models/attention.py``).  The compressed step runs on any mesh
(``optim/compression.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Union

AxisVal = Union[None, str, tuple[str, ...]]
Spec = tuple  # one AxisVal a dim

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Parameter logical axes.
_TP_PARAM: dict[str, AxisVal] = {
    "layers": None,
    "embed": None,
    "embed_table": None,  # input embedding table's d_model dim
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",  # EP: experts over model axis (arctic)
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "dt_rank": None,
    "conv": None,
    "rnn": "model",
    "norm": None,
    # when a param dim cannot shard (e.g. 56 heads or 8 KV heads on a 16-way
    # model axis), the dropped mesh axis spills onto the embed/mlp dim
    "__spill__": ("embed", "mlp"),
}

# FSDP(+TP): additionally shard the replicated matrix dim over "data".
_FSDP_TP_PARAM = dict(_TP_PARAM, embed="data", embed_table="data")

# Pure FSDP (no tensor parallelism): everything big over ("data","model")
# treated as one flat fsdp axis.
_FSDP_PARAM = dict(
    _TP_PARAM,
    mlp=("data", "model"),
    heads=("data", "model"),
    kv_heads=None,
    vocab=("data", "model"),
    experts=("data", "model"),
    ssm_inner=("data", "model"),
    rnn=("data", "model"),
    embed=None,
)

# Activation logical axes ("batch" resolves to the dp axes of the live mesh).
_ACT_BASE: dict[str, AxisVal] = {
    "batch": "__dp__",  # placeholder -> ("pod","data") or ("data",)
    "seq": None,
    "embed_act": None,
    "heads_act": "model",
    "kv_heads_act": "model",
    "mlp_act": "model",
    "vocab_act": "model",
    "experts_act": "model",
    "ssm_inner_act": "model",
    "rnn_act": "model",
    "group_act": "__dp__",
    "cache_batch": "__dp__",  # cache batch dim (decouples from token batch)
    "cache_seq": None,
    # a dropped mesh axis spills onto these dims: a KV cache whose KV heads
    # cannot shard becomes sequence-sharded (the flash-decode layout)
    "__spill__": ("cache_seq",),
}

# Sequence-parallel variant: shard seq over "model" in norm/elementwise regions.
_ACT_SP = dict(_ACT_BASE, seq="model")


@dataclass(frozen=True)
class Strategy:
    """A named sharding strategy = param rules + activation rules + options."""

    name: str
    param_rules: dict[str, AxisVal]
    act_rules: dict[str, AxisVal]
    zero1: bool = True  # shard optimizer state over "data" (ZeRO-1)
    fsdp_pod: bool = False  # extend FSDP sharding over the "pod" axis too
    flash_decode: bool = False  # distributed flash-decode over the "model" axis

    def with_overrides(self, **param_overrides: AxisVal) -> "Strategy":
        return replace(self, param_rules={**self.param_rules, **param_overrides})


STRATEGIES: dict[str, Strategy] = {
    "tp": Strategy("tp", _TP_PARAM, _ACT_BASE),
    "fsdp_tp": Strategy("fsdp_tp", _FSDP_TP_PARAM, _ACT_BASE),
    "fsdp": Strategy("fsdp", _FSDP_PARAM, _ACT_BASE),
    "tp_sp": Strategy("tp_sp", _TP_PARAM, _ACT_SP),
    "fsdp_tp_sp": Strategy("fsdp_tp_sp", _FSDP_TP_PARAM, _ACT_SP),
    # serving: params 2D-sharded like fsdp_tp, except the embed table (a 2D
    # table is gathered for every lookup), token activations replicated over
    # "data"; caches stay batch-sharded through cache_batch
    "serve_2dtp": Strategy(
        "serve_2dtp",
        dict(_FSDP_TP_PARAM, embed_table=None),
        dict(_ACT_BASE, batch=None),
        zero1=False,
    ),
}


def default_strategy(arch) -> Strategy:
    """Per-arch default strategy: fsdp_tp past 100 B parameters, else tp;
    a moe config with fewer than 16 experts shards inside its experts."""
    big = arch.param_count() > 100e9
    strat = STRATEGIES["fsdp_tp" if big else "tp"]
    if arch.family == "moe" and arch.n_experts and arch.n_experts < 16:
        strat = strat.with_overrides(experts=None, expert_mlp="model")
    return strat


# ---------------------------------------------------------------------------
# Resolution: logical axes -> spec
# ---------------------------------------------------------------------------


def dp_axes(mesh_axis_names) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_names)


def resolve_axes(
    logical_axes: tuple[Optional[str], ...],
    rules: dict[str, AxisVal],
    mesh_axis_names,
    shape: Optional[tuple[int, ...]] = None,
    axis_sizes: Optional[dict[str, int]] = None,
) -> Spec:
    """Map logical axis names to a spec for the mesh.

    When ``shape``/``axis_sizes`` are given, a mesh axis that does not divide
    its dim is dropped (dim replicated) and, if the rules declare
    ``__spill__`` targets, re-assigned to the first eligible spill dim.
    """
    used: set[str] = set()
    dropped: list[str] = []
    out: list[Optional[tuple[str, ...]]] = []

    def divides(dim: int, axes: tuple[str, ...]) -> bool:
        if axis_sizes is None:
            return True
        n = 1
        for a in axes:
            n *= axis_sizes.get(a, 1)
        return n > 0 and dim % n == 0

    for i, name in enumerate(logical_axes):
        val: AxisVal = None if name is None else rules.get(name, None)
        if val == "__dp__":
            val = dp_axes(mesh_axis_names)
        if isinstance(val, str):
            val = (val,)
        if val is not None:
            val = tuple(a for a in val if a in mesh_axis_names and a not in used)
            if shape is not None and val:
                keep: list[str] = []
                for a in val:
                    if divides(shape[i], tuple(keep) + (a,)):
                        keep.append(a)
                    else:
                        dropped.append(a)
                val = tuple(keep)
            used.update(val)
            val = val if val else None
        out.append(val)

    # spill dropped mesh axes onto eligible dims (e.g. cache seq dim)
    spill_names = rules.get("__spill__", ()) or ()
    for a in dropped:
        for i, name in enumerate(logical_axes):
            if name not in spill_names:
                continue
            cur = out[i] or ()
            if a in used:
                break
            if shape is not None and not divides(shape[i], cur + (a,)):
                continue
            out[i] = cur + (a,)
            used.add(a)
            break

    return tuple(v[0] if (v is not None and len(v) == 1) else v for v in out)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def param_pspec_tree(specs, strategy: Strategy, mesh):
    """Spec tree -> spec tree (one tuple a leaf) under the given strategy."""
    from repro_torch.models.spec import tree_map

    rules = _param_rules(strategy, mesh)
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda s: resolve_axes(s.axes, rules, mesh.axis_names, s.shape, sizes), specs)


def spec_axes(entry: AxisVal) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard: each dim over the product of its axes'
    sizes (the rules dropped every axis that does not divide its dim).
    ``spec`` has an entry a dim, as ``resolve_axes`` gives it."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in spec_axes(entry):
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} ({n} shards)")
        out.append(dim // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation sharding context (read by model code)
# ---------------------------------------------------------------------------


class _Ctx:
    mesh = None
    flash_decode: bool = False
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    two_d: bool = False
    param_rules: Optional[dict] = None
    shards = None


_CTX = _Ctx()


def _param_rules(strategy: Strategy, mesh) -> dict:
    """The strategy's parameter rules on ``mesh``, with the fsdp shards
    extended over "pod" where the strategy asks for it."""
    rules = dict(strategy.param_rules)
    if strategy.fsdp_pod and "pod" in mesh.axis_names:
        rules = {k: (("pod", "data") if v == "data" else v) for k, v in rules.items()}
    return rules


class activation_rules:
    """Context manager installing a strategy's mesh and flash-decode switch
    for the model code under it (``current_mesh``, ``flash_decode_enabled``),
    and, with ``tensor_parallel``, its parameter rules, from which the model
    code reads each weight's "model" split (``parallel/tensor.py``,
    ``weight_split``), whether its activation rules map "seq" to "model"
    (``sequence_parallel_enabled``), and the step's parameter shards
    (``shards``, a ``parallel/tensor.Shards``), which ``fsdp`` gathers a
    layer at a time.  The reference installs the activation rules for
    ``shard_x`` too; here ``shard_x`` reads none (its docstring)."""

    def __init__(self, strategy: Strategy, mesh, *, tensor_parallel: bool = False, shards=None):
        self.mesh = mesh
        self.flash_decode = strategy.flash_decode
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = strategy.act_rules.get("seq") == "model"
        self.two_d = is_two_d(strategy)
        self.param_rules = _param_rules(strategy, mesh)
        self.shards = shards

    def __enter__(self):
        _CTX.mesh, _CTX.flash_decode = self.mesh, self.flash_decode
        _CTX.tensor_parallel, _CTX.param_rules = self.tensor_parallel, self.param_rules
        _CTX.sequence_parallel, _CTX.shards, _CTX.two_d = self.sequence_parallel, self.shards, self.two_d
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.flash_decode, _CTX.tensor_parallel, _CTX.param_rules = None, False, False, None
        _CTX.sequence_parallel, _CTX.shards, _CTX.two_d = False, None, False
        return False


def is_two_d(strategy: Strategy) -> bool:
    """Whether a strategy runs 2D tensor parallelism ("serve_2dtp"): its
    activations replicated over "data" (``batch`` None) while its weights
    are cut over "data", so "data" cuts weights as "model" does and is no
    dp axis of the step: partial products summed over "data", results cut
    over "data" gathered, and no weight gathered (``parallel/tensor.py``)."""
    return strategy.act_rules.get("batch", "__dp__") is None


def current_mesh():
    """The mesh installed by ``activation_rules``, or None."""
    return _CTX.mesh


def tensor_parallel_enabled() -> bool:
    """True inside a tensor-parallel train, prefill or decode step."""
    return _CTX.tensor_parallel and _CTX.mesh is not None


def current_param_rules() -> Optional[dict]:
    return _CTX.param_rules


def two_d_enabled() -> bool:
    """True inside a tensor-parallel step of a 2D strategy ("serve_2dtp")."""
    return tensor_parallel_enabled() and _CTX.two_d


def sequence_parallel_enabled() -> bool:
    """True inside a tensor-parallel step whose strategy maps "seq" to "model"."""
    return tensor_parallel_enabled() and _CTX.sequence_parallel


def current_shards():
    """The running step's parameter shards (``parallel/tensor.Shards``), or None."""
    return _CTX.shards


def flash_decode_enabled() -> bool:
    return _CTX.flash_decode and _CTX.mesh is not None and "model" in _CTX.mesh.axis_names


def shard_x(x, *logical_axes: Optional[str]):
    """The activation ``x`` under the current rules: ``x`` itself, inside the
    context or out.  The reference constrains the layout for GSPMD; here
    every rank runs on its own shard, which the steps cut explicitly (the
    batch over the dp axes), and the model code moves activations over
    "model" itself (``parallel/tensor.py``)."""
    return x
