"""Tensor and sequence parallelism over "model", and the per-layer gather
over the dp axes, held against one rank and the reference, on the CPU.

The port's train and prefill steps under "tp", "fsdp_tp", "fsdp", "tp_sp"
and "fsdp_tp_sp" on gloo meshes of (1, 2), (2, 2) and (1, 4) ranks, and
under "tp" and "fsdp_tp" on (2, 1) and (4, 1) ranks, where the dp shards
alone are gathered a layer at a time and the gradients reduce-scattered
(``tests/_torch_dist.py``, ``tp_worker``), for reduced configs of all six
families, with widths that hit every split and spill the rules make
(``test_widths_hit_every_split_and_spill``):

  * a KV head count that "model" does not divide (row-parallel ``wk`` and
    ``wv``, whole K and V, each rank's query heads mapped to their KV heads);
  * a head count it does not divide (whole q, ``wo`` column-parallel on
    d_model);
  * a vocab it divides (vocab-parallel embedding, head and cross entropy,
    untied and tied) and one it does not (a replicated table, a
    row-parallel head);
  * the moe experts split over "model" (arctic under the plain "tp") and
    each expert's FFN split inside (grok-1's default override);
  * under "fsdp" the heads, experts, vocab and channels split over
    ("data", "model"), a rank's part in blocks on (2, 2);
  * and, on a (1, 3) mesh, the RG-LRU gate blocks straddled by a rank's
    channels (48 channels in 16 blocks of 3: 16 channels a rank), and a
    sequence of 16 that "model" does not divide, where the "_sp"
    strategies keep "tp"'s moves.

From the same initial state and batches as the port's one-rank step: the
gradients of the first batch's loss, every leaf within 1e-5 of its largest
element, or within twice what one ulp of noise in the weights moves the
one-rank gradients where that is more (``ulp_noise``: the hybrid's RG-LRU
gate leaves move up to 1.7e-5 of their largest element when each weight is
nudged by one ulp, and a row-parallel sum rounds differently from a whole
one); two train steps' metrics within 1e-5 relative; the gathered
parameters within 1e-2 of the peak learning rate wherever the AdamW update
is well conditioned (``test_torch_sharding._ill_conditioned``), the bound
``test_torch_train.compare_train_steps`` holds the port to against the
reference (AdamW's update is the gradient over its own magnitude, so an
element's gradient off by 1e-6 of its leaf's largest one moves it by 1e-3 lr
where it is 1e-3 of that largest), with at most 5e-2 of the elements ill
conditioned; the prefill's logits within 1e-4 of the largest, and its
cache within 1e-4 of ``shard_cache`` of one rank's; under "tp" and
"serve_2dtp" on every world (and "fsdp_tp" and "fsdp" on (2, 2)) three
greedy decode steps on each rank's own cache, the logits within 1e-4 and
the tokens equal ("serve_2dtp", 2D tensor parallelism, runs the dense and
moe families on (2, 2) and the dense on (2, 1)).  The decode step from the
reference's own prefill cache (``cache_from_jax``, cut by ``shard_cache``)
on the (2, 2) world gives the reference's host-mesh decode's logits within
1e-4, one case a family and "serve_2dtp".  The reference's train step on an XLA host mesh of the same
shape and strategy, from the same state, gives the same two steps' metrics
within 1e-4 relative (``test_torch_train.compare_train_steps``' bound),
checked against the one-rank port and the sharded one: each family under
each strategy on one of its meshes (``REF_CASES``), every shape among them,
in a subprocess that runs beside the gloo worlds.  Each world runs its cases
in one spawn under a timeout (``RANKS_TIMEOUT``).  The measured errors print
when this file runs as a script:

    PYTHONPATH=src python tests/test_torch_tensor_parallel.py
"""
from __future__ import annotations

import copy
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.mesh import Mesh
from repro_torch.models import rglru
from repro_torch.models.model import Model
from repro_torch.models.spec import cache_from_jax, tree_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import tensor as tp
from repro_torch.train import step as tstep

import test_torch_sharding as tsharding
from _torch_dist import greedy_decode, mesh22_worker, run_ranks, tp_driver_worker, tp_worker

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 2), (1, 4)]  # ("data", "model")
DP_MESHES = [(2, 1), (4, 1)]  # the dp shards alone, a layer at a time
STRADDLE_MESH = (1, 3)
STRATEGIES = ("tp", "fsdp_tp", "fsdp", "tp_sp", "fsdp_tp_sp")
DP_STRATEGIES = ("tp", "fsdp_tp")
SP_STRATEGIES = ("tp_sp", "fsdp_tp_sp")
# family -> (arch, reduced widths, strategy overrides)
FAMILIES = {
    "dense": ("llama3-8b", dict(n_heads=6, n_kv_heads=3, vocab_size=256), {}),
    "moe_experts": ("arctic-480b", dict(vocab_size=256), {}),
    "moe_inner": ("grok-1-314b", dict(n_heads=6, n_kv_heads=3, vocab_size=251), {"experts": None, "expert_mlp": "model"}),
    "ssm": ("falcon-mamba-7b", dict(vocab_size=250), {}),
    "hybrid": ("recurrentgemma-2b", dict(n_heads=4, n_kv_heads=1, vocab_size=251), {}),
    "audio": ("seamless-m4t-medium", dict(n_heads=6, n_kv_heads=3, vocab_size=256), {}),
    "vlm": ("llama-3.2-vision-11b", dict(n_heads=4, n_kv_heads=2, vocab_size=251), {}),
}
STRADDLE = ("recurrentgemma-2b", dict(rnn_width=48, n_heads=4, n_kv_heads=1, vocab_size=255), {})
REMAT_NONE = ("llama3-8b", dict(FAMILIES["dense"][1], remat="none"), {})
DATA = dict(seq_len=16, global_batch=4, steps=2)
OPT = dict(warmup_steps=1, peak_lr=1e-3)
TP_REL = 1e-5  # gradients and metrics against one rank (fp32)
PARAMS_OVER_LR = 1e-2  # well-conditioned params against one rank, in units of the peak lr
ILL_SHARE = 5e-2
PREFILL_REL = 1e-4  # prefill and decode logits, and the prefill's cache, against one rank
DECODE_STEPS = 3  # greedy decode steps on each rank's own cache after the prefill
REF_REL = 1e-4  # metrics against the reference's host-mesh step
RANKS_TIMEOUT = 300  # seconds, a world of ranks running every case


def _strategies(mesh: tuple) -> tuple:
    return DP_STRATEGIES if mesh in DP_MESHES else STRATEGIES


# "serve_2dtp" (2D tensor parallelism: "data" cuts weights too) for these
# families on these worlds
SERVE_2DTP = {(2, 2): ("dense", "moe_experts"), (2, 1): ("dense",)}


def _families(mesh: tuple) -> dict:
    """The families a world runs: on the (1, 3) mesh the straddled gate
    blocks and the dense family at a sequence "model" does not divide; on
    the dp meshes the dense family under remat "none" too."""
    if mesh == STRADDLE_MESH:
        return {"hybrid_straddle": STRADDLE, "dense_nondiv": FAMILIES["dense"]}
    return {**FAMILIES, "dense_remat_none": REMAT_NONE} if mesh in DP_MESHES else FAMILIES


def _family(family: str) -> tuple:
    if family in ("hybrid_straddle", "dense_remat_none"):
        return {"hybrid_straddle": STRADDLE, "dense_remat_none": REMAT_NONE}[family]
    return FAMILIES[family.removesuffix("_nondiv")]


def _case_id(mesh, family, strategy) -> str:
    return f"{'x'.join(map(str, mesh))}-{family}-{strategy}"


def _model(arch: str, cut: dict) -> Model:
    return Model(get_arch(arch).reduced().replace(**cut))


def _strategy(name: str, overrides: dict) -> sh.Strategy:
    return sh.STRATEGIES[name].with_overrides(**overrides)


_ONE_RANK: dict = {}


def one_rank(arch: str, cut: dict) -> dict:
    """The port's one-rank run of a config: its initial state (the vlm's
    gates opened, as every vlm check opens them), batches, the first batch's
    gradients, each step's metrics, v and final params, and the prefill's
    logits."""
    key = (arch, tuple(sorted(cut.items())))
    if key in _ONE_RANK:
        return _ONE_RANK[key]
    model = _model(arch, cut)
    cfg = model.cfg
    params, opt = tstep.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":
        params["superblocks"]["xattn"]["gate_attn"].fill_(0.5)
        params["superblocks"]["xattn"]["gate_mlp"].fill_(-0.3)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=DATA["seq_len"], global_batch=DATA["global_batch"], seed=0,
                    enc_len=cfg.enc_len_train, d_model=cfg.d_model, n_img_tokens=cfg.n_img_tokens, family=cfg.family)
    batches = [{k: torch.as_tensor(v) for k, v in batch_at(dc, i).items()} for i in range(DATA["steps"])]
    out = {"params0": copy.deepcopy(params), "opt0": copy.deepcopy(opt), "batches": batches}
    prefill = {k: v for k, v in batches[0].items() if k != "labels"}
    out["logits"], out["cache"] = tstep.make_prefill_step(model, DATA["seq_len"] + DECODE_STEPS)(params, prefill)
    out["decode"] = greedy_decode(tstep.make_decode_step(model), params, out["cache"], out["logits"], DATA["seq_len"],
                                  DECODE_STEPS)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batches[0])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out["grads"] = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    for p in leaves:
        p.requires_grad_(False)
    out["ulp_noise"] = ulp_noise(model, out["params0"], batches[0], out["grads"])
    fn = tstep.make_train_step(model, adamw.AdamWConfig(**OPT))
    out["steps"] = []
    for b in batches:
        params, opt, metrics = fn(params, opt, b)
        out["steps"].append({"metrics": {k: float(t) for k, t in metrics.items()}, "v": copy.deepcopy(opt["v"])})
    out["params"] = params
    _ONE_RANK[key] = out
    return out


def ulp_noise(model: Model, params, batch: dict, grads: list) -> float:
    """How far the one-rank gradients move, at most over the leaves and
    relative to each leaf's largest element, when every weight is nudged by
    one ulp up, down or not (a fixed draw): the fp32 floor below which no
    other order of the same sums can be held."""
    nudged = copy.deepcopy(params)
    gen = torch.Generator().manual_seed(1)
    leaves = tree_leaves(nudged)
    with torch.no_grad():
        for t in leaves:
            t.mul_(1 + torch.randint(-1, 2, t.shape, generator=gen).float() * 2.0 ** -23)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(nudged, batch)
    moved = torch.autograd.grad(loss, leaves, allow_unused=True)
    return max(_leaf_rel(m, g) for m, g in zip(moved, grads) if m is not None)


def _decodes(mesh: tuple, strategy: str) -> bool:
    """Whether a world's case also decodes: every family under "tp" and
    "serve_2dtp" on every world, and under "fsdp_tp" and "fsdp" (the dp
    gather a layer at a time; the rank's query heads in blocks) on (2, 2)."""
    return strategy in ("tp", "serve_2dtp") or (mesh == (2, 2) and strategy in ("fsdp_tp", "fsdp"))


def _cases(families: dict, strategies: tuple, mesh: tuple) -> dict:
    cases = {}
    for family, (arch, cut, overrides) in families.items():
        base = one_rank(arch, cut)
        for sname in strategies:
            cases[(family, sname)] = {"arch": arch, "cut": cut, "strategy": (sname, overrides), "params": base["params0"],
                                      "opt": base["opt0"], "batches": base["batches"], "cache1": base["cache"],
                                      "decode": _decodes(mesh, sname)}
    return cases


_RUNS: dict = {}


def tp_run(mesh: tuple, tmp_path_factory) -> dict:
    """Every family and strategy on one gloo world of ``mesh`` (one spawn)."""
    _start_reference(tmp_path_factory)
    if mesh not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"tp{'x'.join(map(str, mesh))}")
        payload = os.path.join(tmp, "payload.pt")
        cases = _cases(_families(mesh), _strategies(mesh), mesh)
        cases.update(_cases({f: FAMILIES[f] for f in SERVE_2DTP.get(mesh, ())}, ("serve_2dtp",), mesh))
        torch.save({"cases": cases, "opt_cfg": OPT, "decode_steps": DECODE_STEPS}, payload)
        world = mesh[0] * mesh[1]
        _RUNS[mesh] = run_ranks(tp_worker, world, tmp, RANKS_TIMEOUT, (mesh[1], payload))[0]
    return _RUNS[mesh]


def _leaf_rel(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max() / (want.detach().float().abs().max() + 1e-30))


def compare(mesh: tuple, family: str, strategy: str, tmp_path_factory) -> dict:
    """The sharded run's errors against the one-rank port's."""
    arch, cut, _ = _family(family)
    got, want = tp_run(mesh, tmp_path_factory)[(family, strategy)], one_rank(arch, cut)
    errs = {"wrong_shapes": got["wrong_shapes"]}
    errs["grads"] = max(_leaf_rel(g, w) for g, w in zip(got["grads"], want["grads"]))
    errs["metrics"] = max(abs(s["metrics"][k] - w["metrics"][k]) / max(abs(w["metrics"][k]), 1e-30)
                          for s, w in zip(got["steps"], want["steps"]) for k in w["metrics"])
    opt_cfg = adamw.AdamWConfig(**OPT)
    ill = [torch.zeros(t.shape, dtype=torch.bool) for t in tree_leaves(want["params"])]
    for i, (s, w) in enumerate(zip(got["steps"], want["steps"])):
        for mask, va, vb in zip(ill, tree_leaves(s["v"]), tree_leaves(w["v"])):
            mask |= tsharding._ill_conditioned(va, vb, i, opt_cfg)
    well = 0.0
    for g, w, mask in zip(tree_leaves(got["params"]), tree_leaves(want["params"]), ill):
        d = (g.float() - w.detach().float()).abs() / opt_cfg.peak_lr
        well = max(well, float(d[~mask].max()) if (~mask).any() else 0.0)
    errs["params_over_lr"] = well
    errs["grad_bound"] = max(TP_REL, 2 * want["ulp_noise"])
    errs["ill_share"] = sum(int(m.sum()) for m in ill) / sum(m.numel() for m in ill)
    errs["prefill"] = _leaf_rel(got["logits"], want["logits"])
    errs["cache"], errs["cache_shapes"] = got["cache_err"], got["cache_shapes"]
    if got["decode"] is not None:
        errs["decode"] = max(_leaf_rel(g, w) for (_, g), (_, w) in zip(got["decode"], want["decode"]))
        errs["decode_tokens_equal"] = all(torch.equal(g, w) for (g, _), (w, _) in zip(got["decode"], want["decode"]))
    errs["collectives"] = got["steps"][0]["collectives"]
    errs["params_gathered"] = {"train": got["steps"][0]["params_gathered"],
                               "decode": got["decode_bytes"]["params"] if got["decode"] is not None else 0}
    return errs


def _check(errs: dict, mesh: tuple = (1, 2), strategy: str = "tp") -> None:
    assert errs["wrong_shapes"] == [], errs["wrong_shapes"]
    assert errs["grads"] <= errs["grad_bound"] and errs["metrics"] <= TP_REL, errs
    assert errs["params_over_lr"] <= PARAMS_OVER_LR and errs["ill_share"] <= ILL_SHARE, errs
    assert errs["prefill"] <= PREFILL_REL, errs
    assert errs["cache"] <= PREFILL_REL and errs["cache_shapes"] == [], errs
    if _decodes(mesh, strategy):
        assert errs["decode"] <= PREFILL_REL and errs["decode_tokens_equal"], errs
    assert errs["collectives"].get("all-reduce", 0) > 0, errs  # the "model" moves ran
    # reduce-scatters: the gradients' over the dp axes, the sequence's over "model"
    # where a block's last product is row-parallel, and no other ("serve_2dtp"
    # has no dp axis: its "data" axis cuts weights, whose gradients are exact)
    scattered = errs["collectives"].get("reduce-scatter", 0) > 0
    seq_cut = strategy in SP_STRATEGIES and mesh[1] > 1 and DATA["seq_len"] % mesh[1] == 0
    dp_ranks = 1 if strategy == "serve_2dtp" else mesh[0]
    assert scattered if dp_ranks > 1 else (scattered <= seq_cut), errs["collectives"]
    if strategy == "serve_2dtp":  # no weight gathered, in the train step nor in decode
        assert errs["params_gathered"] == {"train": 0, "decode": 0}, errs["params_gathered"]


def test_sequence_parallelism_trades_all_reduces_for_reduce_scatters(tmp_path_factory):
    """The dense family on (1, 2): under "tp_sp" the block outputs leave
    through reduce-scatters and enter through all-gathers, and the
    all-reduce bytes of a step fall below "tp"'s."""
    tp_bytes = tp_run((1, 2), tmp_path_factory)[("dense", "tp")]["steps"][0]["collectives"]
    sp_bytes = tp_run((1, 2), tmp_path_factory)[("dense", "tp_sp")]["steps"][0]["collectives"]
    assert "reduce-scatter" not in tp_bytes and sp_bytes["reduce-scatter"] > 0, (tp_bytes, sp_bytes)
    assert sp_bytes["all-reduce"] < tp_bytes["all-reduce"], (tp_bytes, sp_bytes)


# ---------------------------------------------------------------------------
# The widths hit every split and spill
# ---------------------------------------------------------------------------


def _has_model(entry) -> bool:
    return "model" in sh.spec_axes(entry)


def splits_hit(mesh: tuple) -> set:
    """The split and spill cases the cases' widths hit under "tp" on ``mesh``."""
    m = Mesh(("data", "model"), mesh)
    hit = set()
    families = {"hybrid_straddle": STRADDLE} if mesh == STRADDLE_MESH else FAMILIES
    for family, (arch, cut, overrides) in families.items():
        model, st = _model(arch, cut), _strategy("tp", overrides)
        cfg = model.cfg
        specs = sh.param_pspec_tree(model.specs(), st, m)
        blocks = next(specs[k] for k in ("blocks", "superblocks", "dec_blocks") if k in specs)
        attn = blocks.get("attn") or blocks.get("self", {}).get("attn")
        if attn is not None and "wq" not in attn:  # the hybrid's attention block
            attn = attn["attn"]
        if attn is not None:  # the layer axes lead: index from the end
            wq, wk, wo = attn["wq"], attn["wk"], attn["wo"]
            if _has_model(wq[-2]) and _has_model(wk[-3]):
                hit.add("kv_heads_spilled")
            if not _has_model(wq[-2]) and _has_model(wo[-1]):
                hit.add("heads_spilled")
        head = specs.get("lm_head")
        if _has_model(specs["embed"][0]):
            hit.add("vocab_split_tied" if head is None else "vocab_split")
        elif head is not None and _has_model(head[0]):
            hit.add("vocab_spilled")
        if cfg.family == "moe":
            w = blocks["moe"]["w_gate"]
            hit.add("experts_split" if _has_model(w[-3]) else "expert_ffn_split" if _has_model(w[-1]) else "moe_whole")
        if cfg.family == "hybrid":
            nb = rglru._gate_blocks(cfg)
            if cfg.rnn_dim % mesh[1] == 0 and nb % mesh[1]:
                hit.add("rglru_gate_blocks_straddled")
        if cfg.family == "ssm" and _has_model(blocks["w_in_x"][-1]):
            hit.add("ssm_inner_split")
    return hit


def test_widths_hit_every_split_and_spill():
    want = {"kv_heads_spilled", "vocab_spilled", "experts_split", "expert_ffn_split", "ssm_inner_split"}
    assert want | {"vocab_split", "vocab_split_tied"} <= splits_hit((1, 2)), splits_hit((1, 2))
    assert want | {"heads_spilled", "vocab_split"} <= splits_hit((1, 4)), splits_hit((1, 4))
    assert {"rglru_gate_blocks_straddled", "vocab_split"} <= splits_hit(STRADDLE_MESH), splits_hit(STRADDLE_MESH)


# ---------------------------------------------------------------------------
# Sharded against one rank
# ---------------------------------------------------------------------------

TP_CASES = [(mesh, family, s) for mesh in MESHES + DP_MESHES for family in FAMILIES for s in _strategies(mesh)]
TP_CASES += [(mesh, family, "serve_2dtp") for mesh, families in SERVE_2DTP.items() for family in families]


@pytest.mark.parametrize("mesh,family,strategy", TP_CASES, ids=[_case_id(*c) for c in TP_CASES])
def test_tensor_parallel_steps_match_one_rank(mesh, family, strategy, tmp_path_factory):
    _check(compare(mesh, family, strategy, tmp_path_factory), mesh, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rglru_gate_blocks_straddled_by_a_rank_match_one_rank(strategy, tmp_path_factory):
    """rank 1 of 3 holds channels 16-31: blocks 5 (in part) to 10 (in part)."""
    cfg = _model(*STRADDLE[:2]).cfg
    nb = rglru._gate_blocks(cfg)
    per_rank, bd = cfg.rnn_dim // STRADDLE_MESH[1], cfg.rnn_dim // nb
    assert per_rank % bd and nb % STRADDLE_MESH[1], (per_rank, bd, nb)
    _check(compare(STRADDLE_MESH, "hybrid_straddle", strategy, tmp_path_factory), STRADDLE_MESH, strategy)


REMAT_NONE_CASES = [(mesh, s) for mesh in DP_MESHES for s in DP_STRATEGIES]


@pytest.mark.parametrize("mesh,strategy", REMAT_NONE_CASES, ids=[f"{'x'.join(map(str, m))}-{s}" for m, s in REMAT_NONE_CASES])
def test_remat_none_keeps_the_numbers(mesh, strategy, tmp_path_factory):
    """Under remat "none" autograd keeps each gathered weight for the
    backward (no replay gathers it again); the steps give one rank's
    values all the same."""
    _check(compare(mesh, "dense_remat_none", strategy, tmp_path_factory), mesh, strategy)


@pytest.mark.parametrize("strategy", SP_STRATEGIES)
def test_a_sequence_model_does_not_divide_keeps_tp_moves(strategy, tmp_path_factory):
    """A sequence of 16 on a "model" axis of 3: the residual stream stays
    whole, every block keeps "tp"'s moves (no reduce-scatter runs: the dp
    axis holds one rank), and the steps give one rank's values."""
    mesh = Mesh(("data", "model"), STRADDLE_MESH)
    with sh.activation_rules(sh.STRATEGIES[strategy], mesh, tensor_parallel=True):
        assert not tp.seq_split(DATA["seq_len"]) and tp.seq_split(DATA["seq_len"] + 2)
    _check(compare(STRADDLE_MESH, "dense_nondiv", strategy, tmp_path_factory), STRADDLE_MESH, strategy)


# ---------------------------------------------------------------------------
# Against the reference's train step on an XLA host mesh
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"  # one core: the suite runs beside it
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.parallel import sharding as sh
    from repro.train import step as step_lib

    # expm1's derivative as exp(x), as test_torch_train.reference_expm1_exact takes it
    jnp.expm1 = lambda x: jax.lax.expm1(x, accuracy=jax.lax.AccuracyMode.HIGHEST)
    cases = pickle.load(open(sys.argv[1], "rb"))
    decode_cases = {k: cases.pop(k) for k in [k for k in cases if k[0] == "decode"]}
    out = {}
    for key, c in cases.items():
        shape = tuple(c["mesh"])
        mesh = Mesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("data", "model"))
        model = Model(get_arch(c["arch"]).reduced().replace(**c["cut"]))
        strategy = sh.STRATEGIES[c["strategy"][0]].with_overrides(**c["strategy"][1])
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in c["batches"][0].items()}
        shs = step_lib.make_shardings(model, strategy, mesh, specs)
        named = lambda t: jax.tree.map(lambda ps: NamedSharding(mesh, ps), t)
        params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]), named(shs.params))
        opt = jax.device_put(adamw.init_state(params), named(shs.opt))
        fn = jax.jit(step_lib.make_train_step(model, strategy, mesh, adamw.AdamWConfig(**c["opt_cfg"])),
                     in_shardings=(named(shs.params), named(shs.opt), named(shs.batch)),
                     out_shardings=(named(shs.params), named(shs.opt), None))
        metrics = []
        for b in c["batches"]:
            params, opt, m = fn(params, opt, jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, named(shs.batch)))
            metrics.append({k: float(v) for k, v in m.items()})
        out[key] = metrics
    for key, c in decode_cases.items():
        # the reference's prefill step and then its decode step on the host
        # mesh, with the dry run's in-shardings (launch/dryrun.py:74-104)
        shape = tuple(c["mesh"])
        mesh = Mesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("data", "model"))
        model = Model(get_arch(c["arch"]).reduced().replace(**c["cut"]))
        strategy = sh.STRATEGIES[c["strategy"][0]].with_overrides(**c["strategy"][1])
        params = jax.tree.map(jnp.asarray, c["params"])
        prefill = {k: jnp.asarray(v) for k, v in c["prefill"].items()}
        B, L = prefill["tokens"].shape
        named = lambda t: jax.tree.map(lambda ps: NamedSharding(mesh, ps), t)
        shp = step_lib.make_shardings(model, strategy, mesh, prefill, model.cache_specs(B, L + 1))
        pf = jax.jit(step_lib.make_prefill_step(model, strategy, mesh, cache_len=L + 1),
                     in_shardings=(named(shp.params), named(shp.batch)))
        logits0, cache = pf(jax.device_put(params, named(shp.params)), jax.device_put(prefill, named(shp.batch)))
        cache = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), cache)
        batch = {"tokens": jnp.argmax(logits0[:, -1], -1)[:, None].astype(jnp.int32), "pos": jnp.full((B,), L, jnp.int32)}
        shs = step_lib.make_shardings(model, strategy, mesh, batch, model.cache_specs(B, L + 1))
        fn = jax.jit(step_lib.make_decode_step(model, strategy, mesh),
                     in_shardings=(named(shs.params), named(shs.cache), named(shs.batch)))
        logits, _ = fn(jax.device_put(params, named(shs.params)), jax.device_put(cache, named(shs.cache)),
                       jax.device_put(batch, named(shs.batch)))
        out[key] = {"cache": jax.tree.map(np.asarray, cache), "batch": jax.tree.map(np.asarray, batch),
                    "logits": np.asarray(logits), "cache_len": L + 1, "prefill_logits": np.asarray(logits0)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")

# each family under "tp" and under each strategy this file adds ("fsdp",
# "tp_sp", "fsdp_tp_sp"; and "tp" or "fsdp_tp" on a dp mesh) on one host
# mesh of its sharded runs' shapes, every shape used
REF_CASES = [((1, 2), "dense", "tp"), ((2, 2), "moe_experts", "tp"), ((1, 4), "moe_inner", "tp"), ((1, 2), "ssm", "tp"),
             ((2, 2), "hybrid", "tp"), ((1, 4), "audio", "tp"), ((2, 2), "vlm", "tp"),
             (STRADDLE_MESH, "hybrid_straddle", "tp")]
REF_CASES += [(MESHES[(i + j) % len(MESHES)], family, s) for j, s in enumerate(STRATEGIES[2:])
              for i, family in enumerate(FAMILIES)]
REF_CASES += [(DP_MESHES[i % 2], family, DP_STRATEGIES[i // 2 % 2]) for i, family in enumerate(FAMILIES)]
REF_CASES += [(mesh, family, "serve_2dtp") for mesh, families in SERVE_2DTP.items() for family in families]


# the decode step against the reference's on a host mesh of the same shape,
# from the reference's own prefill cache: one case a family, and "serve_2dtp"
REF_DECODE_CASES = [((2, 2), family, "tp") for family in FAMILIES] + [((2, 2), "dense", "serve_2dtp")]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


_REF: dict = {}


REF_PROCS = 2  # reference subprocesses, each on its share of REF_CASES


def _start_reference(tmp_path_factory) -> None:
    """Start the reference's two train steps under each ``REF_CASES``
    strategy on a host mesh of its shape, in REF_PROCS subprocesses that
    run beside the gloo worlds."""
    if "procs" in _REF:
        return
    cases = {}
    for mesh, family, strategy in REF_CASES:
        arch, cut, overrides = _family(family)
        base = one_rank(arch, cut)
        cases[(mesh, family, strategy)] = {"mesh": mesh, "arch": arch, "cut": cut, "strategy": (strategy, overrides),
                                           "params": _numpy(base["params0"]), "opt_cfg": OPT,
                                           "batches": [{k: v.numpy() for k, v in b.items()} for b in base["batches"]]}
    for mesh, family, strategy in REF_DECODE_CASES:
        arch, cut, overrides = _family(family)
        base = one_rank(arch, cut)
        cases[("decode", mesh, family, strategy)] = {
            "mesh": mesh, "arch": arch, "cut": cut, "strategy": (strategy, overrides), "params": _numpy(base["params0"]),
            "prefill": {k: v.numpy() for k, v in base["batches"][0].items() if k != "labels"}}
    tmp = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"), JAX_PLATFORMS="cpu")
    _REF.update(procs=[], dsts=[])
    for i in range(REF_PROCS):
        src, dst = os.path.join(tmp, f"cases{i}.pkl"), os.path.join(tmp, f"out{i}.pkl")
        with open(src, "wb") as f:
            pickle.dump({k: c for j, (k, c) in enumerate(cases.items()) if j % REF_PROCS == i}, f)
        _REF["procs"].append(subprocess.Popen([sys.executable, "-c", _REFERENCE, src, dst], env=env, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        _REF["dsts"].append(dst)


def reference_metrics(tmp_path_factory) -> dict:
    """The reference's metrics by (mesh, family, strategy), waiting for its subprocesses."""
    _start_reference(tmp_path_factory)
    if "out" not in _REF:
        _REF["out"] = {}
        for proc, dst in zip(_REF["procs"], _REF["dsts"]):
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, out
            with open(dst, "rb") as f:
                _REF["out"].update(pickle.load(f))
    return _REF["out"]


def _ref_id(mesh, family, strategy) -> str:
    """A reference case's name ("tp"'s without the strategy, as before the others came)."""
    return f"{'x'.join(map(str, mesh))}-{family}" if strategy == "tp" and mesh not in DP_MESHES else _case_id(mesh, family, strategy)


@pytest.mark.parametrize("mesh,family,strategy", REF_CASES, ids=[_ref_id(*c) for c in REF_CASES])
def test_one_rank_and_sharded_metrics_match_the_reference_on_a_host_mesh(mesh, family, strategy, tmp_path_factory):
    arch, cut, _ = _family(family)
    ref = reference_metrics(tmp_path_factory)[(mesh, family, strategy)]
    ours = one_rank(arch, cut)["steps"]
    sharded = tp_run(mesh, tmp_path_factory)[(family, strategy)]["steps"]
    for r, o, s in zip(ref, ours, sharded):
        assert sorted(r) == sorted(o["metrics"]), (sorted(r), sorted(o["metrics"]))
        for k in r:
            for got in (o["metrics"][k], s["metrics"][k]):
                assert abs(got - r[k]) <= REF_REL * max(abs(r[k]), 1e-30), (k, got, r[k])


_MESH22: dict = {}


def mesh22_run(tmp_path_factory) -> dict:
    """The (2, 2) world of ``mesh22_worker``: the moves against what they
    mean, and the decode step of each ``REF_DECODE_CASES`` case from the
    reference's prefill cache (one spawn, after the reference has run)."""
    if not _MESH22:
        ref = reference_metrics(tmp_path_factory)
        tmp = tmp_path_factory.mktemp("mesh22")
        payload = os.path.join(tmp, "decode.pt")
        cases = {}
        for mesh, family, strategy in REF_DECODE_CASES:
            arch, cut, overrides = _family(family)
            r = ref[("decode", mesh, family, strategy)]
            cases[(family, strategy)] = {"arch": arch, "cut": cut, "strategy": (strategy, overrides),
                                         "params": one_rank(arch, cut)["params0"], "cache_len": r["cache_len"],
                                         "cache": cache_from_jax(r["cache"], "cpu"),
                                         "batch": {k: torch.from_numpy(v) for k, v in r["batch"].items()}}
        torch.save(cases, payload)
        _MESH22["ranks"] = run_ranks(mesh22_worker, 4, tmp, RANKS_TIMEOUT, (payload,))
    return _MESH22


@pytest.mark.parametrize("mesh,family,strategy", REF_DECODE_CASES, ids=[_case_id(*c) for c in REF_DECODE_CASES])
def test_prefill_matches_the_reference_prefill_step_on_a_host_mesh(mesh, family, strategy, tmp_path_factory):
    """The port's prefill step on the gloo world of ``mesh`` (``tp_run``):
    its last-token logits within 1e-4 of the reference's prefill step's on
    a host mesh of the same shape, from the same weights and prompt."""
    want = reference_metrics(tmp_path_factory)[("decode", mesh, family, strategy)]["prefill_logits"]
    assert _leaf_rel(tp_run(mesh, tmp_path_factory)[(family, strategy)]["logits"], torch.from_numpy(want)) <= PREFILL_REL


@pytest.mark.parametrize("mesh,family,strategy", REF_DECODE_CASES, ids=[_case_id(*c) for c in REF_DECODE_CASES])
def test_decode_from_the_reference_cache_matches_the_reference_on_a_host_mesh(mesh, family, strategy, tmp_path_factory):
    """The reference's prefill cache (``cache_from_jax``) cut to each rank's
    (``shard_cache``) and one decode step on the (2, 2) gloo world: the
    logits within 1e-4 of the reference's decode step on a (2, 2) host
    mesh from the same cache, weights and token."""
    want = reference_metrics(tmp_path_factory)[("decode", mesh, family, strategy)]["logits"]
    got = mesh22_run(tmp_path_factory)["ranks"][0]["decode"][(family, strategy)]
    assert _leaf_rel(got, torch.from_numpy(want)) <= PREFILL_REL


def test_serve_2dtp_decode_moves_partial_sums_and_gathers_no_parameter(tmp_path_factory):
    """The dense family's decode steps on (2, 2) under "serve_2dtp": the
    bytes a rank all-reduces and all-gathers, from the shapes (B rows of
    one token, fp32), and no parameter gathered, where "fsdp_tp" on the
    same mesh gathers each layer's weights over "data".  A step
    all-reduces the embedding's rows over "model" (vocab-parallel), a
    layer's q over "data" (its d_model cut), its k and v over ("data",
    "model") (3 KV heads: "model" spilled onto d_model), ``wo``'s and
    ``w_down``'s partial (D / d) sums over "model", ``w_gate``'s and
    ``w_up``'s over "data", and the head's vocab part over "data"; it
    all-gathers the attention's rows over "data" (the cache holds the
    rank's), ``wo``'s and ``w_down``'s results over "data", and the
    logits' vocab over "model"."""
    run = tp_run((2, 2), tmp_path_factory)
    got, fsdp_tp = run[("dense", "serve_2dtp")]["decode_bytes"], run[("dense", "fsdp_tp")]["decode_bytes"]
    cfg = _model(*FAMILIES["dense"][:2]).cfg
    d, m = 2, 2
    D, hd, F, V, H, KV, n = cfg.d_model, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    assert H % m == 0 and KV % m and V % m == 0 and D % (d * m) == 0
    row = DATA["global_batch"] * 4  # B rows of fp32
    all_reduce = row * (D + n * (H // m * hd + 2 * KV * hd + 2 * D // d + 2 * F // m) + V // m)
    all_gather = row * (n * (H // m * hd + 2 * D) + V)
    assert got["by_op"] == {"all-reduce": DECODE_STEPS * all_reduce, "all-gather": DECODE_STEPS * all_gather}, got
    assert got["params"] == 0 and fsdp_tp["params"] > 0, (got, fsdp_tp)


# ---------------------------------------------------------------------------
# The moves, the counter and the refusals
# ---------------------------------------------------------------------------


def test_train_driver_takes_a_model_axis(tmp_path):
    """``launch/train.py`` with ``model_parallel=2`` (``--model-parallel 2``)
    in a 2-rank gloo world, under "tp" and under "serve_2dtp": both ranks
    read the one-rank driver's losses and grad norms within 1e-5."""
    from repro_torch.launch.train import train

    want = train("llama3-8b", steps=2, seq_len=16, global_batch=4, log_every=0, device="cpu")
    for r in run_ranks(tp_driver_worker, 2, tmp_path, RANKS_TIMEOUT, (2, ("tp", "serve_2dtp"))):
        for name, got in r.items():
            for key in ("losses", "grad_norms"):
                assert max(abs(a - b) / abs(b) for a, b in zip(got[key], want[key])) <= TP_REL, (name, key, got[key], want[key])


def test_moves_on_an_abstract_mesh_record_bytes_without_a_group():
    """On a mesh with no process group (the dry run's) the moves return the
    right shapes and record their bytes: gather and split conjugate, reduce
    and enter conjugate."""
    mesh = Mesh(("data", "model"), (2, 4))
    tp.COLLECTIVES.reset()
    x = torch.randn(3, 8, requires_grad=True)
    with sh.activation_rules(sh.STRATEGIES["tp"], mesh, tensor_parallel=True):
        assert tp.model_size() == 4 and tp.model_rank() == 0
        y = tp.gather(tp.split(x, -1), -1)
        z = tp.reduce(tp.enter(y))
        assert y.shape == z.shape == x.shape
        z.sum().backward()
        assert tp.weight_split(("embed", "heads", None), (64, 6, 16)) == (0, 1)  # 6 heads spill onto embed
        assert tp.weight_split(("embed", "heads", None), (64, 8, 16)) == (1, 1)
    assert x.grad.shape == x.shape
    # split's backward gathers, gather's forward gathers: 2 x 3 x 8 x 4 bytes; reduce and enter's backward
    assert dict(tp.COLLECTIVES.count_by_op) == {"all-gather": 2, "all-reduce": 2}
    assert tp.COLLECTIVES.bytes_by_op["all-gather"] == 2 * 3 * 8 * 4
    with sh.activation_rules(sh.STRATEGIES["tp"], mesh):  # not a tensor-parallel step: nothing moves
        assert tp.model_size() == 1 and tp.weight_split(("embed", "heads", None), (64, 8, 16)) is None


def test_reduce_scatter_fsdp_and_sequence_moves_record_bytes_on_an_abstract_mesh():
    """On a mesh with no process group: ``reduce_scatter`` returns its
    result's shape (over one axis, two, and an outer layout) and records
    its bytes, ``all_gather`` its conjugate; ``seq_enter`` and
    ``seq_leave`` conjugate forward and backward; ``fsdp`` gathers a leaf
    over "data" and its backward reduce-scatters the gradient to the
    moments' cut."""
    mesh = Mesh(("data", "model"), (2, 4))
    tp.COLLECTIVES.reset()
    x = torch.randn(3, 16, 8)
    assert tp.reduce_scatter(x, mesh, "model", 1).shape == (3, 4, 8)
    assert tp.all_gather(tp.reduce_scatter(x, mesh, "model", 1), mesh, "model", 1).shape == x.shape
    assert tp.reduce_scatter(x, mesh, ("data", "model"), 2).shape == (3, 16, 1)
    assert tp.reduce_scatter(x, mesh, "model", 1, outer=2).shape == (3, 4, 8)
    assert dict(tp.COLLECTIVES.count_by_op) == {"reduce-scatter": 4, "all-gather": 1}
    assert tp.COLLECTIVES.bytes_by_op["reduce-scatter"] == 3 * (3 * 4 * 8 * 4) + 3 * 16 * 1 * 4  # the results' bytes
    tp.COLLECTIVES.reset()
    with sh.activation_rules(sh.STRATEGIES["tp_sp"], mesh, tensor_parallel=True):
        assert tp.seq_split(16) and not tp.seq_split(6)
        h = torch.randn(2, 4, 8, requires_grad=True)  # a rank's 4 of 16 tokens
        whole = tp.seq_enter(h)
        back = tp.seq_leave(whole)
        assert whole.shape == (2, 16, 8) and back.shape == h.shape
        back.sum().backward()
    assert h.grad.shape == h.shape
    nb = 2 * 16 * 8 * 4
    assert dict(tp.COLLECTIVES.bytes_by_op) == {"all-gather": 2 * nb, "reduce-scatter": 2 * nb // 4}
    tp.COLLECTIVES.reset()
    shard = torch.randn(4, 6)  # a (16, 6) leaf's shard over ("data", "model")
    spec, moments = (("data", "model"), None), (("data", "model"), None)
    shards = tp.Shards(mesh, [shard], [spec], [moments])
    with sh.activation_rules(sh.STRATEGIES["fsdp"], mesh, tensor_parallel=True, shards=shards):
        assert tp.weight_split(("mlp", None), (16, 6)) == (0, 2)
        w = tp.fsdp(shard)
        assert w.shape == (8, 6)
        (w * 2).sum().backward(inputs=[shards.token])
    assert [g.shape for g in shards.grads()] == [shard.shape]
    assert dict(tp.COLLECTIVES.bytes_by_op) == {"all-gather": 8 * 6 * 4, "reduce-scatter": 4 * 6 * 4}


def test_moves_on_gloo_match_what_they_mean(tmp_path_factory):
    """``reduce_scatter``, ``seq_enter``/``seq_leave`` and ``fsdp``'s
    gather and collect on a (2, 2) gloo world, in fp64, against the sums
    and slices they stand for (``moves_worker``)."""
    errs = [r["moves"] for r in mesh22_run(tmp_path_factory)["ranks"]]
    for r, e in enumerate(errs):
        assert max(e.values()) <= 1e-12, (r, e)


def test_rank_slices_and_outer_layouts_invert():
    t = torch.arange(24.0).reshape(2, 12)
    parts = [tp.rank_slice(t, 3, r, -1, outer=2) for r in range(3)]
    assert torch.equal(parts[1], torch.tensor([[2.0, 3.0, 8.0, 9.0], [14.0, 15.0, 20.0, 21.0]]))
    blocks = [p.unflatten(-1, (2, -1)) for p in parts]
    assert torch.equal(torch.stack(blocks, dim=2).flatten(1, 3), t)


if __name__ == "__main__":
    import tempfile
    from pathlib import Path

    class _Factory:
        def mktemp(self, name):
            return Path(tempfile.mkdtemp(prefix=name))

    fac = _Factory()
    for mesh in MESHES + [STRADDLE_MESH]:
        print(mesh, sorted(splits_hit(mesh)))
    for mesh, family, s in TP_CASES + [(STRADDLE_MESH, f, s) for f in _families(STRADDLE_MESH) for s in STRATEGIES]:
        e = compare(mesh, family, s, fac)
        print(_case_id(mesh, family, s), {k: v for k, v in e.items() if k not in ("wrong_shapes",)})
    ref = reference_metrics(fac)
    for case in REF_CASES:
        print("reference", case, ref[case])
