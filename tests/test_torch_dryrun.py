"""The port's roofline and dry-run tools held against the reference, on the CPU.

  * ``configs.token_batch_spec``: the same keys, shapes and dtypes as the
    reference's for every arch x shape (meta tensors against
    ``jax.ShapeDtypeStruct``s);
  * ``roofline.model``: ``model_flops`` equal for every arch x shape, and
    the ``Roofline`` with the reference's properties and ``row()`` keys at
    the H100's data-sheet figures;
  * a mini dry run on an abstract (2, 4) mesh with ``test_dryrun_mini.py``'s
    reduced widths (llama3-8b, falcon-mamba-7b, grok-1-314b under "tp"):
    ``argument_size_in_bytes`` and ``output_size_in_bytes`` equal to the
    reference's ``memory_analysis()`` of its compiled train step on 8 host
    devices (a subprocess), flops and collective bytes above 0, every
    kernel of the family counted forward and backward; and a decode cell
    (llama3-8b, 4 KV heads) whose arguments, the rank's shards of the
    weights and its cache, are the reference's decode step's;
  * depth units 1 and 2 extrapolating to the count of the full-depth run
    within 1e-6 relative, for every family, on an abstract (1, 4) mesh:
    with a "data" axis ZeRO-1 shards a stacked leaf's moments over its
    layer dim where that dim is the largest one that "data" divides, so
    which leaves gather their update depends on the depth, and the dp
    collectives are not linear in it (in the reference too);
  * a layer at a time: on an abstract (4, 1) mesh each depth unit adds to
    the peak temp only its gradient's ZeRO-1 cut and its saved input, under
    "tp" and "fsdp_tp";
  * ``main`` on one cell writing a record with the reference's keys.

No process group starts and nothing runs on a device: the cells run on meta
tensors.  The measured numbers print when this file runs as a script:

    PYTHONPATH=src python tests/test_torch_dryrun.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import token_batch_spec as jtoken_batch_spec
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import SHAPES as JSHAPES
from repro.roofline import model as jroofline
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_arch, token_batch_spec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline import model as troofline

MINI_ARCHS = ("llama3-8b", "falcon-mamba-7b", "grok-1-314b")
MINI_WIDTHS = dict(d_model=128, d_ff=256, n_heads=8, head_dim=16, vocab_size=512)  # test_dryrun_mini.py's
MINI_SHAPE = ShapeConfig("mini", 32, 8, "train")
MINI_MESH = Mesh(("data", "model"), (2, 4))
# a decode cell whose KV heads "model" divides: the rank's cache is then the
# reference's cut of it (where "model" does not divide them, the reference
# cuts the cache's sequence and the port keeps the KV heads its query heads
# read, whole over the sequence: ROADMAP.md section 3)
MINI_DECODE = ("llama3-8b", {"n_kv_heads": 4})
MINI_DECODE_SHAPE = ShapeConfig("mini_decode", 32, 8, "decode")
EXTRAPOLATION_REL = 1e-6
EXTRAPOLATION_MESH = Mesh(("data", "model"), (1, 4))
KERNELS_BY_FAMILY = {"dense": ("flash_attention",), "ssm": ("selective_scan",), "moe": ("flash_attention", "moe_gmm"),
                     "hybrid": ("flash_attention", "rglru_scan"), "audio": ("flash_attention",), "vlm": ("flash_attention",)}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_token_batch_spec_matches_the_reference(name):
    for shape_name in sorted(SHAPES):
        got = token_batch_spec(ARCHS[name], SHAPES[shape_name])
        want = jtoken_batch_spec(JARCHS[name], JSHAPES[shape_name])
        assert sorted(got) == sorted(want), (name, shape_name)
        for k, t in got.items():
            assert t.device.type == "meta", (name, shape_name, k)
            assert tuple(t.shape) == tuple(want[k].shape), (name, shape_name, k)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), (name, shape_name, k, t.dtype, want[k].dtype)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_match_the_reference(name):
    for shape_name in sorted(SHAPES):
        assert troofline.model_flops(ARCHS[name], SHAPES[shape_name]) == jroofline.model_flops(JARCHS[name], JSHAPES[shape_name])


def test_roofline_rows_have_the_reference_keys_at_the_h100_figures():
    kw = dict(arch="a", shape="s", mesh="16x16", n_chips=256, flops_per_chip=1e15, bytes_per_chip=1e12,
              collective_bytes_per_chip=1e11, model_flops_total=2e17, hbm_bytes_est_per_chip=5e11)
    got, want = troofline.Roofline(**kw).row(), jroofline.Roofline(**kw).row()
    assert list(got) == list(want)
    assert (troofline.PEAK_FLOPS, troofline.HBM_BW, troofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert got["t_compute_s"] == round(1e15 / 989e12, 6) and got["t_collective_s"] == round(1e11 / 50e9, 6)
    assert got["bottleneck"] == "collective" and got["bottleneck_est"] == "collective"


# ---------------------------------------------------------------------------
# The mini dry run against the reference's memory analysis
# ---------------------------------------------------------------------------

_REFERENCE_MINI = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"  # one core: the suite runs beside it
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import compat_make_mesh
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.parallel.sharding import STRATEGIES
    from repro.train import step as step_lib

    mesh = compat_make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch_name in %(archs)r:
        arch = get_arch(arch_name).reduced().replace(**%(widths)r)
        model = Model(arch)
        strategy = STRATEGIES["tp"]
        if arch.family == "moe":
            strategy = strategy.with_overrides(experts=None)
        named = lambda t: jax.tree.map(lambda ps: NamedSharding(mesh, ps), t)
        batch_specs = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
                       "labels": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
        sh = step_lib.make_shardings(model, strategy, mesh, batch_specs)
        fn = step_lib.make_train_step(model, strategy, mesh, adamw.AdamWConfig())
        params, opt = step_lib.abstract_train_state(model)
        metrics_sh = jax.tree.map(lambda _: NamedSharding(mesh, P()), step_lib.metrics_struct(model))
        metrics_sh["grad_norm"] = NamedSharding(mesh, P())
        metrics_sh["lr"] = NamedSharding(mesh, P())
        jfn = jax.jit(fn, in_shardings=(named(sh.params), named(sh.opt), named(sh.batch)),
                      out_shardings=(named(sh.params), named(sh.opt), metrics_sh), donate_argnums=(0, 1))
        mem = jfn.lower(params, opt, batch_specs).compile().memory_analysis()
        out[arch_name] = {f: int(getattr(mem, f)) for f in
                          ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes", "temp_size_in_bytes")}
    # the decode cell: the dry run's in-shardings (launch/dryrun.py:89-104)
    from repro.configs import ShapeConfig, token_batch_spec
    from repro.parallel.sharding import mesh_axis_sizes, resolve_axes
    arch = get_arch(%(decode_arch)r).reduced().replace(**%(widths)r, **%(decode_cut)r)
    model, strategy, (B, L) = Model(arch), STRATEGIES["tp"], %(decode_shape)r
    batch_specs = token_batch_spec(arch, ShapeConfig("mini_decode", L, B, "decode"))
    sh = step_lib.make_shardings(model, strategy, mesh, batch_specs, model.cache_specs(B, L))
    logits_ps = resolve_axes(("batch", None, "vocab_act"), strategy.act_rules, mesh.axis_names, (B, 1, arch.vocab_size),
                             mesh_axis_sizes(mesh))
    jfn = jax.jit(step_lib.make_decode_step(model, strategy, mesh),
                  in_shardings=(named(sh.params), named(sh.cache), named(sh.batch)),
                  out_shardings=(NamedSharding(mesh, logits_ps), named(sh.cache)), donate_argnums=(1,))
    mem = jfn.lower(model.abstract_params(), model.abstract_cache(B, L), batch_specs).compile().memory_analysis()
    out["decode"] = {f: int(getattr(mem, f)) for f in ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes")}
    # the logits leave the reference's step as the rank's shard
    shard = NamedSharding(mesh, logits_ps).shard_shape((B, 1, arch.vocab_size))
    out["decode"]["logits_shard_bytes"] = int(4 * shard[0] * shard[1] * shard[2])
    print("MINI_MEMORY " + json.dumps(out))
""") % {"archs": MINI_ARCHS, "widths": MINI_WIDTHS, "decode_arch": MINI_DECODE[0], "decode_cut": MINI_DECODE[1],
       "decode_shape": (MINI_DECODE_SHAPE.global_batch, MINI_DECODE_SHAPE.seq_len)}


def _mini_arch(name: str):
    return get_arch(name).reduced().replace(**MINI_WIDTHS)


def mini_port(name: str) -> dict:
    fn, args, meta = dryrun.build_cell(_mini_arch(name), MINI_SHAPE, MINI_MESH, "tp")
    counts, io = dryrun.run_counted(fn, args, meta)
    return {"memory_analysis": dryrun._mem_fields(counts, io), "flops": counts.flops, "bytes": counts.bytes,
            "collectives": counts.collectives.row(), "kernels": counts.kernels}


_MINI_REF: dict = {}


def mini_reference() -> dict:
    if not _MINI_REF:
        env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"), JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", _REFERENCE_MINI], env=env, capture_output=True, text=True, timeout=600)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("MINI_MEMORY ")]
        assert run.returncode == 0 and line, run.stdout + run.stderr
        _MINI_REF.update(json.loads(line[0].removeprefix("MINI_MEMORY ")))
    return _MINI_REF


@pytest.mark.parametrize("name", MINI_ARCHS)
def test_mini_dry_run_memory_matches_the_reference(name):
    got, want = mini_port(name), mini_reference()[name]
    for field in ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes"):
        assert got["memory_analysis"][field] == want[field], (field, got["memory_analysis"], want)
    assert got["memory_analysis"]["temp_size_in_bytes"] > 0
    assert got["flops"] > 0 and got["collectives"]["collective_bytes"] > 0, got
    family = _mini_arch(name).family
    for k in KERNELS_BY_FAMILY[family]:
        assert got["kernels"][k]["calls"] > 0 and got["kernels"][k + "_bwd"]["calls"] > 0, (k, got["kernels"])


def test_mini_dry_run_decode_cell_arguments_match_the_reference():
    """The decode cell on the (2, 4) mesh under "tp": the rank's shards of
    the weights, its cache and the batch are the bytes of the reference's
    compiled decode step's arguments; the step all-reduces (row-parallel
    products), gathers no parameter, and the logits come out global."""
    from repro_torch.parallel import tensor as tp

    arch = _mini_arch(MINI_DECODE[0]).replace(**MINI_DECODE[1])
    fn, args, meta = dryrun.build_cell(arch, MINI_DECODE_SHAPE, MINI_MESH, "tp")
    counts, io = dryrun.run_counted(fn, args, meta)
    assert io["argument"] == mini_reference()["decode"]["argument_size_in_bytes"], (io, mini_reference()["decode"])
    assert counts.collectives.bytes_by_op["all-reduce"] > 0 and tp.COLLECTIVES.param_bytes == 0, counts.collectives.row()


def test_mini_dry_run_decode_cell_writes_its_cache_in_place_as_the_reference_donates_it():
    """The reference's decode step donates its cache (``donate_argnums=(1,)``)
    and XLA writes the new cache over it; the port's step writes the token
    into the cache it is given and returns that cache.  The output bytes
    (logits and cache) and the aliased bytes (the cache) are the
    reference's, as the train cells' are, but for the logits: the port's
    step returns them global (a difference by design, ROADMAP §3), the
    reference's as the rank's shard."""
    arch = _mini_arch(MINI_DECODE[0]).replace(**MINI_DECODE[1])
    fn, args, meta = dryrun.build_cell(arch, MINI_DECODE_SHAPE, MINI_MESH, "tp")
    counts, io = dryrun.run_counted(fn, args, meta)
    got, want = dryrun._mem_fields(counts, io), mini_reference()["decode"]
    logits_bytes = 4 * MINI_DECODE_SHAPE.global_batch * arch.vocab_size
    assert got["output_size_in_bytes"] - logits_bytes == want["output_size_in_bytes"] - want["logits_shard_bytes"], (got, want)
    assert got["alias_size_in_bytes"] == want["alias_size_in_bytes"] == dryrun._nbytes(args[1]) > 0, (got, want)


# ---------------------------------------------------------------------------
# Depth extrapolation
# ---------------------------------------------------------------------------

EXTRAPOLATION_CASES = {  # one arch a family, at the mini widths, a few depth units deep
    "llama3-8b": 4, "falcon-mamba-7b": 3, "grok-1-314b": 3, "recurrentgemma-2b": 3, "seamless-m4t-medium": 3,
    "llama-3.2-vision-11b": 3,
}


def extrapolation_errors(name: str, units: int) -> dict:
    arch = _mini_arch(name)
    arch = dryrun.depth_variant(arch, units)
    ext = dryrun.extrapolate_costs(arch, MINI_SHAPE, EXTRAPOLATION_MESH, "tp")
    full = dryrun.measure_costs(arch, MINI_SHAPE, EXTRAPOLATION_MESH, "tp", units)
    return {k: abs(ext[k] - full[k]) / max(full[k], 1e-30) for k in ("flops", "bytes", "hbm", "coll")}


@pytest.mark.parametrize("name", sorted(EXTRAPOLATION_CASES))
def test_depth_units_one_and_two_extrapolate_to_the_full_depth_count(name):
    errs = extrapolation_errors(name, EXTRAPOLATION_CASES[name])
    assert max(errs.values()) <= EXTRAPOLATION_REL, errs


# ---------------------------------------------------------------------------
# A layer at a time: the temp a depth unit adds (ROADMAP.md item 6c)
# ---------------------------------------------------------------------------

LAYERWISE_MESH = Mesh(("data", "model"), (4, 1))
LAYERWISE_REL = 1e-2


def temp_growth(strategy: str, units: tuple = (2, 3, 4)) -> tuple[list, dict]:
    """The mini dense cell's peak temp at each depth in ``units`` (remat
    "full": a layer keeps its input alone) on the abstract (4, 1) mesh, and
    what a unit must add when a rank holds one layer's gathered weights at
    a time and each gradient only as its ZeRO-1 cut: the unit's gradient
    bytes over the four dp ranks plus its saved input (the rank's (B / 4,
    L, D) activations)."""
    import math

    from repro_torch.models.model import Model
    from repro_torch.models.spec import torch_dtype, tree_leaves

    temps = []
    for n in units:
        arch = _mini_arch("llama3-8b").replace(remat="full", n_layers=n)
        fn, args, meta = dryrun.build_cell(arch, MINI_SHAPE, LAYERWISE_MESH, strategy)
        temps.append(dryrun.run_counted(fn, args, meta)[0].peak_temp_bytes)
    cfg = _mini_arch("llama3-8b").replace(n_layers=1)
    unit = sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize for s in tree_leaves(Model(cfg).specs()["blocks"]))
    act = MINI_SHAPE.global_batch // 4 * MINI_SHAPE.seq_len * cfg.d_model * torch_dtype(cfg.compute_dtype).itemsize
    return temps, {"unit_param_bytes": unit, "want": unit / 4 + act}


@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
def test_a_depth_unit_adds_its_gradient_cut_and_saved_input_alone(strategy):
    """Each depth unit past the second adds to a rank's peak temp its
    gradient's ZeRO-1 cut (a quarter on four dp ranks) and its saved input,
    within 1% of the unit's parameter bytes: no gathered weight and no
    whole gradient is held past its layer.  Gathered for the whole step,
    as before the per-layer gather, a unit added its parameters and its
    whole gradient under "fsdp_tp" ((1 - 1/4) of them more than here,
    and its parameters again) and its whole gradient under "tp"."""
    temps, want = temp_growth(strategy)
    for a, b in zip(temps, temps[1:]):
        assert abs((b - a) - want["want"]) <= LAYERWISE_REL * want["unit_param_bytes"], (temps, want)


def test_main_writes_a_record_with_the_reference_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "seamless-m4t-medium", "--shape", "decode_32k"])
    assert dryrun.main() == 0
    record = json.loads((tmp_path / "seamless-m4t-medium__decode_32k__16x16__default.json").read_text())
    keys = {"arch", "shape", "strategy", "kind", "n_chips", "mesh", "lower_s", "compile_s", "memory_analysis",
            "raw_cost_flops_per_chip", "raw_cost_bytes_per_chip", "raw_collectives", "extrapolated", "flops_per_chip",
            "bytes_per_chip", "collective_bytes_per_chip", "roofline"}
    assert keys <= set(record), sorted(keys - set(record))
    assert list(record["roofline"]) == list(jroofline.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0, 1.0).row())
    assert record["n_chips"] == 256 and record["memory_analysis"]["argument_size_in_bytes"] > 0
    assert (tmp_path / "kernels__predicted.json").exists()
    assert "all 1 cells counted OK" in capsys.readouterr().out


if __name__ == "__main__":
    for n in MINI_ARCHS:
        print("mini", n, mini_port(n), "reference", mini_reference()[n])
    for n, u in sorted(EXTRAPOLATION_CASES.items()):
        print("extrapolation", n, extrapolation_errors(n, u))
    for s in ("tp", "fsdp_tp"):
        print("temp by depth", s, temp_growth(s))
