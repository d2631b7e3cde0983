"""Multi-pod dry run: build and count every (arch x shape x mesh) cell.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's jitted step on the production meshes and reads XLA's
memory and cost analyses.  The port runs eagerly, so a cell is the port's
own train, prefill or decode step (``train/step.py``) built on the abstract
production mesh (``launch/mesh.make_production_mesh``: (16, 16) ("data",
"model"), or (2, 16, 16) with "pod"), run once on rank 0's shards of the
parameters, AdamW state and batch as ``device="meta"`` tensors, which hold a
shape and a dtype and no memory.  No process group starts and no device is
touched: the collectives record their bytes (``parallel/tensor.py``), the
kernels add their own counts (``kernels/ops.py``'s meta route), and
``roofline/count.py`` counts the rest.  Decode cells run the decode step on
the rank's shards of the weights and its cache as the tensor-parallel
prefill leaves it (``train/step.shard_cache``: its rows, the KV heads its
query heads read, its channels).

Outputs per cell:

  * ``memory_analysis`` with the reference's field names:
    ``argument_size_in_bytes`` and ``output_size_in_bytes`` are the exact
    bytes of a rank's shards in and out (the outputs with the 8-byte tuple
    entry a leaf that XLA counts there), ``alias_size_in_bytes`` those of
    the outputs written in place over the inputs (the params and AdamW
    state; the cache a decode step writes its token into and returns), and ``temp_size_in_bytes`` the peak of the bytes the step
    allocated and still held;
  * flops, bytes and collective bytes a rank, counted at depth units 1 and 2
    and extrapolated to the full depth as the reference extrapolates, and at
    full depth;
  * the roofline at the H100's data-sheet figures (``roofline/model.py``);
  * a JSON record under ``artifacts/dryrun_torch/`` with the reference's
    keys (``lower_s`` is the seconds to build the cell, ``compile_s`` those
    of its counted run).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
      PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_arch, get_shape, token_batch_spec
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.models.spec import tree_leaves, tree_map, torch_dtype
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import STRATEGIES, default_strategy, local_shape
from repro_torch.roofline.count import count_step
from repro_torch.roofline.model import Roofline, model_flops
from repro_torch.train import step as step_lib

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# XLA's memory analysis counts the output tuple's table of 8-byte buffer
# pointers, one a leaf, in output_size_in_bytes; the port adds the same so
# that the field means what the reference's means
TUPLE_ENTRY_BYTES = 8


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _out_bytes(leaves: list) -> int:
    return sum(t.numel() * t.element_size() + TUPLE_ENTRY_BYTES for t in leaves)


def _local(specs, pspecs, mesh, dtype: Optional[torch.dtype] = None):
    """A rank's shard of each leaf of a ParamSpec tree under ``pspecs``, as meta tensors."""
    flat = iter(tree_leaves(pspecs))
    return tree_map(lambda s: _meta(local_shape(s.shape, next(flat), mesh), dtype or torch_dtype(s.dtype)), specs)


def _shape(shape) -> ShapeConfig:
    """A shape by name, or a ``ShapeConfig`` as it is (a cell off the
    assigned shapes, as the tests build)."""
    return shape if isinstance(shape, ShapeConfig) else get_shape(shape)


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def build_cell(arch, shape_name: str, mesh, strategy_name: Optional[str] = None):
    """Returns (step, args, meta): the port's step for the cell on ``mesh``
    and its arguments, a rank's shards as meta tensors (the batch global, as
    the steps take it).  ``meta`` holds the cell's names and the bytes of its
    arguments and outputs.  ``arch`` is an ArchConfig (possibly a
    reduced-depth cost variant)."""
    shape = _shape(shape_name)
    if not arch.supports(shape):
        raise ValueError(f"{arch.name} skips {shape.name} (sub-quadratic only)")
    model = Model(arch)
    strategy = STRATEGIES[strategy_name] if strategy_name else default_strategy(arch)
    if arch.family == "moe" and arch.n_experts < 16:
        strategy = strategy.with_overrides(experts=None)
    batch = token_batch_spec(arch, shape)
    batch_sh = step_lib.batch_pspecs(batch, mesh, strategy)
    local_batch = sum(math.prod(local_shape(tuple(t.shape), batch_sh[k], mesh)) * t.element_size() for k, t in batch.items())
    scalar = 4  # an fp32 metric, an int32 step
    if shape.kind == "train":
        sh = step_lib.make_shardings(model, strategy, mesh, batch)
        params = _local(model.specs(), sh.params, mesh)
        opt_specs = adamw.opt_state_specs(model.specs())
        opt = {"m": _local(opt_specs["m"], sh.opt["m"], mesh), "v": _local(opt_specs["v"], sh.opt["v"], mesh),
               "step": _meta((), torch.int32)}
        fn = step_lib.make_train_step(model, adamw.AdamWConfig(), strategy=strategy, mesh=mesh)
        args = (params, opt, batch)
        state = _nbytes(params) + _nbytes(opt)
        n_metrics = len(step_lib.metrics_struct(model)) + 2  # + grad_norm, lr
        n_out = len(tree_leaves(params)) + len(tree_leaves(opt)) + n_metrics
        io = {"argument": state + local_batch, "output": state + scalar * n_metrics + TUPLE_ENTRY_BYTES * n_out,
              "alias": state}
    elif shape.kind == "prefill":
        sh = step_lib.make_shardings(model, strategy, mesh, batch)
        params = _local(model.specs(), sh.params, mesh)
        fn = step_lib.make_prefill_step(model, shape.seq_len, strategy=strategy, mesh=mesh)
        args = (params, batch)
        io = {"argument": _nbytes(params) + local_batch, "output": None, "alias": 0}  # the outputs, counted when run
    elif shape.kind == "decode":
        # the rank's shards of the weights, as the prefill takes them, and its
        # cache as the tensor-parallel prefill leaves it (train/step.shard_cache)
        sh = step_lib.make_shardings(model, strategy, mesh, batch)
        params = _local(model.specs(), sh.params, mesh)
        whole = tree_map(lambda s: _meta(s.shape, torch_dtype(s.dtype)), model.cache_specs(shape.global_batch, shape.seq_len))
        cache = step_lib.shard_cache(model, whole, shape.global_batch, shape.seq_len, strategy=strategy, mesh=mesh)
        fn = step_lib.make_decode_step(model, strategy=strategy, mesh=mesh)
        args = (params, cache, batch)
        io = {"argument": _nbytes(params) + _nbytes(cache) + local_batch, "output": None, "alias": 0}
    else:
        raise ValueError(shape.kind)
    meta = {
        "arch": arch.name,
        "shape": shape.name,
        "strategy": strategy.name,
        "kind": shape.kind,
        "n_chips": math.prod(mesh.shape),
        "mesh": _mesh_name(mesh),
        "io_bytes": io,
    }
    return fn, args, meta


def run_counted(fn, args, meta: dict):
    """One run of a built cell under the counters: (StepCounts, io bytes)."""
    with torch.no_grad() if meta["kind"] != "train" else torch.enable_grad(), count_step() as c:
        out = fn(*args)
    io = dict(meta["io_bytes"])
    if io["output"] is None:  # prefill and decode: logits and cache as returned
        leaves = _flat(out)
        io["output"] = _out_bytes(leaves)
        if meta["kind"] == "decode":  # the cache leaves the step wrote in place and returned
            given = {id(t) for t in tree_leaves(args[1])}
            io["alias"] = sum(t.numel() * t.element_size() for t in leaves if id(t) in given)
    return c.counts, io


def _flat(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def depth_unit(arch) -> tuple[int, float]:
    """(layers per depth-unit, number of depth-units in the full model)."""
    if arch.family == "hybrid":
        p = len(arch.block_pattern or ("rec", "rec", "attn"))
        return p, arch.n_layers / p
    if arch.family == "vlm":
        p = arch.cross_attn_period
        return p, arch.n_layers / p
    return 1, float(arch.n_layers)


def depth_variant(arch, units: int):
    p, _ = depth_unit(arch)
    kw = {"n_layers": units * p}
    if arch.family == "audio":
        kw["n_enc_layers"] = units  # enc and dec depths extrapolate together
    return arch.replace(**kw)


def _costs(counts) -> dict:
    return {"flops": counts.flops, "bytes": counts.bytes, "hbm": counts.bytes,
            "coll": float(counts.collectives.total_bytes)}


def measure_costs(arch, shape_name: str, mesh, strategy_name, units: int) -> dict:
    """The counts of a variant ``units`` depth-units deep.  An eager run
    counts every layer it runs, so these are exact at any depth."""
    fn, args, meta = build_cell(depth_variant(arch, units), shape_name, mesh, strategy_name)
    return _costs(run_counted(fn, args, meta)[0])


def extrapolate_costs(arch, shape_name: str, mesh, strategy_name) -> dict:
    """Per-step cost = alpha + units_full * beta, solved from the counts at
    depth units 1 and 2, as the reference solves it."""
    m1 = measure_costs(arch, shape_name, mesh, strategy_name, 1)
    m2 = measure_costs(arch, shape_name, mesh, strategy_name, 2)
    _, units_full = depth_unit(arch)
    out = {}
    for k in ("flops", "bytes", "hbm", "coll"):
        beta = m2[k] - m1[k]
        alpha = max(m1[k] - beta, 0.0)
        out[k] = alpha + units_full * beta
        out[f"{k}_per_layer_unit"] = beta
        out[f"{k}_outside_layers"] = alpha
    return out


def _mem_fields(counts, io: dict) -> dict:
    return {
        "temp_size_in_bytes": int(counts.peak_temp_bytes),
        "argument_size_in_bytes": int(io["argument"]),
        "output_size_in_bytes": int(io["output"]),
        "alias_size_in_bytes": int(io["alias"]),
    }


def run_cell(
    arch_name: str,
    shape_name: str,
    multi_pod: bool = False,
    strategy_name: Optional[str] = None,
    save: bool = True,
    verbose: bool = True,
    extrapolate: bool = True,
    arch_overrides: Optional[dict] = None,
    label: Optional[str] = None,
    mesh=None,
) -> dict:
    """One cell: the full-depth step counted once (memory and raw counts),
    and with ``extrapolate`` the counts from depth units 1 and 2.  ``mesh``
    defaults to the production mesh."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    arch = get_arch(arch_name)
    if arch_overrides:
        arch = arch.replace(**arch_overrides)
    t0 = time.perf_counter()
    fn, args, meta = build_cell(arch, shape_name, mesh, strategy_name)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts, io = run_counted(fn, args, meta)
    t_run = time.perf_counter() - t0
    raw = _costs(counts)

    shape = _shape(shape_name)
    ext = extrapolate_costs(arch, shape_name, mesh, strategy_name) if extrapolate else None
    flops, byts, collb, hbm = (ext or raw)["flops"], (ext or raw)["bytes"], (ext or raw)["coll"], (ext or raw)["hbm"]
    rl = Roofline(
        arch=arch_name,
        shape=shape.name,
        mesh=meta["mesh"],
        n_chips=meta["n_chips"],
        flops_per_chip=flops,
        bytes_per_chip=byts,
        collective_bytes_per_chip=collb,
        model_flops_total=model_flops(arch, shape),
        hbm_bytes_est_per_chip=hbm,
    )
    meta = {k: v for k, v in meta.items() if k != "io_bytes"}
    record = {
        **meta,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "memory_analysis": _mem_fields(counts, io),
        "raw_cost_flops_per_chip": raw["flops"],
        "raw_cost_bytes_per_chip": raw["bytes"],
        "raw_collectives": counts.collectives.row(),
        "extrapolated": ext,
        "flops_per_chip": flops,
        "bytes_per_chip": byts,
        "collective_bytes_per_chip": collb,
        "roofline": rl.row(),
        "kernels": counts.kernels,
    }
    if verbose:
        print(f"== {arch_name} x {shape.name} on {meta['mesh']} ({meta['strategy']}) ==")
        print(f"  build {t_build:.1f}s counted run {t_run:.1f}s")
        print(f"  memory_analysis: {record['memory_analysis']}")
        print(f"  cost (extrapolated over depth units): flops={flops:.3e} bytes={byts:.3e} coll={collb:.3e}")
        print(f"  raw collectives (full depth): {counts.collectives.row()}")
        print(f"  roofline: {rl.row()}", flush=True)
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        sname = label or strategy_name or "default"
        path = os.path.join(ARTIFACT_DIR, f"{arch_name}__{shape.name}__{meta['mesh']}__{sname}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=2)
    return record


def kernel_report(save: bool = True, verbose: bool = True) -> list[dict]:
    """The tuner's roofline-predicted configs (``kernels/autotune.py``
    ``predict_best``): for every registered kernel at its smoke and full
    bench shapes, the config the pruned model sweep picks, its predicted
    arithmetic intensity, and the sweep accounting, at the H100's figures.
    No execution."""
    from repro_torch.kernels import registry as kreg
    from repro_torch.kernels.autotune import predict_best

    rows = []
    for name, kdef in kreg.KERNELS.items():
        for tier in ("smoke", "full"):
            shape = dict(getattr(kdef, f"{tier}_shape"))
            rows.append({"tier": tier, **predict_best(name, shape)})
            if verbose:
                r = rows[-1]
                print(f"  {name:18s} {tier:5s} config={r['config']:28s} "
                      f"intensity={r['intensity_flops_per_byte']:9.3f} swept {r['swept']}/{r['exhaustive']}")
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        with open(os.path.join(ARTIFACT_DIR, "kernels__predicted.json"), "w") as f:
            json.dump({"kind": "kernel_predictions", "rows": rows}, f, indent=2)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--all", action="store_true", help="every supported (arch x shape) cell")
    args = ap.parse_args()

    cells = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            if get_arch(a).supports(get_shape(s)):
                cells.append((a, s))
            else:
                print(f"SKIP {a} x {s} (sub-quadratic only)")

    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    failures = []
    for a, s in cells:
        for mp in pods:
            try:
                run_cell(a, s, multi_pod=mp, strategy_name=args.strategy, extrapolate=not mp)
            except Exception as e:
                failures.append((a, s, mp, repr(e)))
                traceback.print_exc()
    print("\n== kernel predicted configs (roofline model, no execution) ==")
    kernel_report()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"\nall {len(cells) * len(pods)} cells counted OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
