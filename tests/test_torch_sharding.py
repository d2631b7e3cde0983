"""The port's sharding held against the JAX reference, on the CPU.

  * the rules: every parameter leaf's spec and every optimizer moment's
    ZeRO-1 spec of every config in the registry (full and reduced) under
    every strategy, on the production meshes (16, 16) and (2, 16, 16), the
    latter also with ``fsdp_pod``, and on (2, 4), (4, 1) and (1, 1), entry
    for entry against the reference's ``PartitionSpec``s (its
    ``param_pspec_tree`` reads only a mesh's axis names and device shape,
    so a stand-in with no devices serves it);
  * the sharded train step on gloo worlds of 2 and 4 ranks (a (world, 1)
    mesh) for llama3-8b and grok-1-314b reduced: every local shard has its
    spec's shape, and three steps match the port's one-rank step (losses,
    metrics, and the gathered parameters, moments relative 1e-5 of each
    leaf's max-abs wherever the AdamW update is well conditioned, as
    ``test_torch_train.compare_train_steps`` defines it) and the
    reference's three steps within that test's tolerances;
  * ``compressed_mean`` on 4 gloo ranks against the reference's on 4 host
    devices (a subprocess, as ``tests/test_compression.py`` runs it): each
    round's mean from the reference's error state within 1e-6 of its
    largest element, the new states within 1e-6 of the largest value they
    are residuals of, and the reference test's
    own bounds (one shot < 0.05 of the largest mean; error feedback cuts
    the running mean's error 5x over 20 rounds);
  * ``make_compressed_train_step`` on 2 gloo ranks against the reference's
    on 2 host devices (its loss's activation constraints off: this JAX
    refuses them inside its ``shard_map``), llama3-8b reduced, 3 steps,
    with the model's loss and with a linear loss whose gradients are equal
    bit for bit: metrics within 1e-4; params, moments and every rank's
    error states within ``compare_train_steps``' tolerances on all but the
    few elements an int8 rounding sent a step apart, whose share is bounded;
  * the distributed flash-decode on a (2, 2) gloo mesh: llama3-8b and
    recurrentgemma-2b reduced with one KV head and a cache of 17 (odd, so
    the padded slice runs), logits within 1e-4 of the one-rank decode and
    of the reference's flash-decode on a (2, 2) mesh of host devices.

Every multi-process test runs its ranks under a timeout of its own
(``tests/_torch_dist.py``).  The measured errors print when this file runs
as a script:

    PYTHONPATH=src python tests/test_torch_sharding.py
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCHS as JARCHS
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsh
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import batch_at
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import Model
from repro_torch.models import spec as tspec
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import adamw
from repro_torch.optim import compression as C
from repro_torch.parallel import sharding as sh
from repro_torch.train import step as tstep

import test_torch_train as ttrain
from _torch_dist import compressed_train_worker, compression_worker, decode_worker, driver_worker, run_ranks, train_worker

torch.set_num_threads(1)

MESHES = [  # (axis names, shape, fsdp_pod)
    (("data", "model"), (16, 16), False),
    (("pod", "data", "model"), (2, 16, 16), False),
    (("pod", "data", "model"), (2, 16, 16), True),
    (("data", "model"), (2, 4), False),
    (("data", "model"), (4, 1), False),
    (("data", "model"), (1, 1), False),
]
CONFIGS = [(name, reduced) for name in sorted(JARCHS) for reduced in (False, True)]
RANKS_TIMEOUT = 120  # seconds, a world of ranks (a few seconds each when well)
SHARD_REL = 1e-5  # sharded against one-rank: losses, metrics, gathered state


def _ref_mesh(names, shape):
    """What the reference's rules read of a mesh: its names and device shape."""
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _ref_specs(tree) -> list:
    return [tuple(ps) for ps in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def compare_specs(name: str, reduced: bool) -> dict:
    """Per strategy and mesh, the number of parameter leaves and of moment
    specs whose port spec differs from the reference's (all 0 when they
    agree)."""
    jcfg, tcfg = JARCHS[name], get_arch(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspecs, tspecs = JModel(jcfg).specs(), Model(tcfg).specs()
    out = {}
    for sname in sorted(jsh.STRATEGIES):
        for names, shape, fsdp_pod in MESHES:
            jst = dataclasses.replace(jsh.STRATEGIES[sname], fsdp_pod=fsdp_pod)
            tst = dataclasses.replace(sh.STRATEGIES[sname], fsdp_pod=fsdp_pod)
            jmesh, tm = _ref_mesh(names, shape), tmesh.Mesh(names, shape)
            jps = jsh.param_pspec_tree(jspecs, jst, jmesh)
            tps = sh.param_pspec_tree(tspecs, tst, tm)
            want, got = _ref_specs(jps), tree_leaves(tps)
            data = dict(zip(names, shape)).get("data", 1)
            jopt = jadamw.opt_pspec_tree(jspecs, jps, jst.zero1, data)
            topt = adamw.opt_pspec_tree(tspecs, tps, tst.zero1, data)
            assert len(want) == len(got) == len(tree_leaves(tspecs)), (name, sname, shape)
            key = f"{sname}/{'x'.join(map(str, shape))}{'/fsdp_pod' if fsdp_pod else ''}"
            out[key] = {
                "params": sum(w != g for w, g in zip(want, got)),
                "m": sum(w != g for w, g in zip(_ref_specs(jopt["m"]), tree_leaves(topt["m"]))),
                "v": sum(w != g for w, g in zip(_ref_specs(jopt["v"]), tree_leaves(topt["v"]))),
                "step": int(tuple(jopt["step"]) != topt["step"]),
            }
    return out


@pytest.mark.parametrize("name,reduced", CONFIGS, ids=[f"{n}{'-reduced' if r else ''}" for n, r in CONFIGS])
def test_param_and_zero1_specs_match_the_reference(name, reduced):
    diff = compare_specs(name, reduced)
    bad = {k: v for k, v in diff.items() if any(v.values())}
    assert not bad, bad


def test_rules_resolve_as_the_reference_tests_them():
    sizes, axes = {"data": 16, "model": 16}, ("data", "model")
    tp = sh.STRATEGIES["tp"].param_rules
    assert sh.resolve_axes(("embed", "mlp"), tp, axes) == (None, "model")
    assert sh.resolve_axes(("experts", "embed", "mlp"), tp, axes) == ("model", None, None)
    assert sh.resolve_axes(("embed", "heads", None), tp, axes, (7168, 56, 128), sizes) == ("model", None, None)
    cache = ("layers", "batch", "cache_seq", "kv_heads_act", None)
    assert sh.resolve_axes(cache, sh.STRATEGIES["tp"].act_rules, axes, (32, 128, 32768, 8, 128), sizes) == (
        None, "data", "model", None, None)
    assert sh.resolve_axes(("embed", "mlp"), sh.STRATEGIES["fsdp_tp"].param_rules, axes, (16384, 53248), sizes) == (
        "data", "model")
    for name in ("llama3-8b", "llama3-405b", "grok-1-314b", "arctic-480b"):
        got, want = sh.default_strategy(get_arch(name)), jsh.default_strategy(JARCHS[name])
        assert (got.name, got.param_rules, got.act_rules, got.zero1) == (want.name, want.param_rules, want.act_rules, want.zero1)


def test_activation_and_batch_specs_match_the_reference():
    """The cache specs under the activation rules and the batch specs, for
    the cache of every family, on (16, 16) and (2, 4)."""
    for name in ("llama3-8b", "recurrentgemma-2b", "falcon-mamba-7b", "seamless-m4t-medium", "llama-3.2-vision-11b"):
        for names, shape, _ in MESHES[:1] + MESHES[3:4]:
            for sname in ("tp", "tp_sp", "serve_2dtp"):
                jmesh, tm = _ref_mesh(names, shape), tmesh.Mesh(names, shape)
                jm, m = JModel(JARCHS[name]), Model(get_arch(name))
                from repro.train import step as jstep

                want = jstep.act_pspec_tree(jm.cache_specs(128, 32768), jsh.STRATEGIES[sname], jmesh)
                got = tstep.act_pspec_tree(m.cache_specs(128, 32768), sh.STRATEGIES[sname], tm)
                assert _ref_specs(want) == tree_leaves(got), (name, sname, shape)
                batch = {"tokens": SimpleNamespace(shape=(128, 1)), "pos": SimpleNamespace(shape=(128,))}
                jb = jstep.batch_pspecs(batch, jmesh, jsh.STRATEGIES[sname])
                tb = tstep.batch_pspecs(batch, tm, sh.STRATEGIES[sname])
                assert {k: tuple(v) for k, v in jb.items()} == tb


def test_meshes_and_the_context():
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert (prod.axis_names, prod.shape, prod.device_mesh) == (("pod", "data", "model"), (2, 16, 16), None)
    assert tmesh.make_production_mesh().shape == (16, 16)
    local = tmesh.make_local_mesh(1)
    assert (local.axis_names, local.shape, local.group("data"), local.coordinate("model")) == (("data", "model"), (1, 1), None, 0)
    with pytest.raises(ValueError, match="world of 4"):
        tmesh.make_local_mesh(4)
    x = torch.ones(4, 4)
    assert sh.shard_x(x, "batch", None) is x and not sh.flash_decode_enabled()
    fd = dataclasses.replace(sh.STRATEGIES["tp"], flash_decode=True)
    with sh.activation_rules(fd, local):
        assert sh.flash_decode_enabled() and sh.current_mesh() is local and sh.shard_x(x, "batch", None) is x
    assert not sh.flash_decode_enabled() and sh.current_mesh() is None


def test_model_parallel_steps_build_and_run_on_a_1x2_mesh():
    """On a "model" axis of 2 every step builds and runs
    (tests/test_torch_tensor_parallel.py holds their numbers on gloo):
    "serve_2dtp"'s train, prefill and decode steps, the decode step on
    "model"-sharded weights under "tp", and the compressed step, each on an
    abstract (1, 2) mesh (no process group: the collectives record their
    bytes and return tensors of the right shapes) on rank 0's shards as
    meta tensors.  The logits come out global, the decode step's cache in
    the prefill's layout (``shard_cache``), the compressed step's error
    states at the rank's "model" shards, and a parameter is gathered by no
    step of "serve_2dtp"."""
    from repro_torch.configs import ShapeConfig, token_batch_spec
    from repro_torch.launch import dryrun
    from repro_torch.parallel import tensor as tp

    mesh = tmesh.Mesh(("data", "model"), (1, 2))
    arch = get_arch("llama3-8b").reduced()
    model = Model(arch)
    B, V = 2, arch.vocab_size
    for strategy in ("serve_2dtp", "tp"):
        for kind in ("train", "prefill", "decode"):
            fn, args, _ = dryrun.build_cell(arch, ShapeConfig("mini", 8, B, kind), mesh, strategy)
            tp.COLLECTIVES.reset()
            with torch.no_grad() if kind != "train" else torch.enable_grad():
                out = fn(*args)
            assert tp.COLLECTIVES.bytes_by_op["all-reduce"] > 0, (strategy, kind)
            if strategy == "serve_2dtp":
                assert tp.COLLECTIVES.param_bytes == 0, (kind, tp.COLLECTIVES.param_bytes)
            if kind == "train":
                assert sorted(out[2]) == sorted(list(tstep.metrics_struct(model)) + ["grad_norm", "lr"])
                continue
            logits, cache = out
            assert tuple(logits.shape) == (B, 1, V), (strategy, kind, logits.shape)
            if kind == "decode":
                assert [t.shape for t in tree_leaves(cache)] == [t.shape for t in tree_leaves(args[1])]
    strategy = sh.STRATEGIES["fsdp_tp"]
    batch = token_batch_spec(arch, ShapeConfig("mini", 8, B, "train"))
    shs = tstep.make_shardings(model, strategy, mesh, batch)
    params = dryrun._local(model.specs(), shs.params, mesh)
    opt_specs = adamw.opt_state_specs(model.specs())
    opt = {"m": dryrun._local(opt_specs["m"], shs.opt["m"], mesh), "v": dryrun._local(opt_specs["v"], shs.opt["v"], mesh),
           "step": torch.zeros((), dtype=torch.int32, device="meta")}
    comp = tstep.init_compression_state(model, strategy=strategy, mesh=mesh, device="meta")
    fn = tstep.make_compressed_train_step(model, adamw.AdamWConfig(), strategy=strategy, mesh=mesh)
    _, _, comp, metrics = fn(params, opt, comp, batch)
    assert sorted(metrics) == sorted(list(tstep.metrics_struct(model)) + ["grad_norm", "lr"])
    for st, p in zip(tstep._state_leaves(comp), tree_leaves(params)):
        assert st["worker_err"].shape == p.shape, (st["worker_err"].shape, p.shape)  # "fsdp_tp" on (1, 2): the "model" shards


# ---------------------------------------------------------------------------
# The sharded train step on gloo
# ---------------------------------------------------------------------------

TRAIN_CASES = [  # (arch, world, strategy: None for launch/train.py's default)
    ("llama3-8b", 2, None),
    ("llama3-8b", 4, "fsdp_tp"),
    ("grok-1-314b", 2, "fsdp"),
    ("grok-1-314b", 4, None),
]
TRAIN_DATA = {"seq_len": 16, "global_batch": 4}  # a moe group of 16 tokens a rank at 4 ranks


def _ill_conditioned(v_a, v_b, step: int, cfg: adamw.AdamWConfig):
    """Where sqrt(v-hat) is within 100 eps of 0 in one run and not 0 in both
    (``compare_train_steps``' mask)."""
    floor = (100 * cfg.eps) ** 2 * (1 - cfg.b2 ** (step + 1))
    lo, hi = torch.minimum(v_a, v_b), torch.maximum(v_a, v_b)
    return (lo < floor) & (hi > 0)


def compare_sharded_train(name: str, world: int, strategy, tmp_path) -> dict:
    """Three sharded steps against the reference (``compare_train_steps``'s
    errors) and against the port's one-rank step (``one_rank_*``)."""
    out = {}

    def sharded(model, opt_cfg):
        def run(params, opt, batches):
            batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
            payload = os.path.join(tmp_path, "payload.pt")
            torch.save({"params": params, "opt": opt, "batches": batches, "opt_cfg": dataclasses.asdict(opt_cfg)}, payload)
            ranks = run_ranks(train_worker, world, tmp_path, RANKS_TIMEOUT, (payload, name, strategy))
            out["wrong_shapes"] = [r["wrong_shapes"] for r in ranks]
            out["local_numel"] = [r["local_numel"] for r in ranks]
            r0 = ranks[0]
            # the one-rank port from the same state and batches
            p1, o1 = copy.deepcopy(params), copy.deepcopy(opt)
            fn = tstep.make_train_step(model, opt_cfg)
            ill = [torch.zeros(t.shape, dtype=torch.bool) for t in tree_leaves(params)]
            metric_err = 0.0
            for i, (batch, st) in enumerate(zip(batches, r0["steps"])):
                p1, o1, m1 = fn(p1, o1, batch)
                metric_err = max(metric_err, max(ttrain._rel(st["metrics"][k], m1[k]) for k in m1))
                for mask, va, vb in zip(ill, tree_leaves(st["v"]), tree_leaves(o1["v"])):
                    mask |= _ill_conditioned(va, vb, i, opt_cfg)
            well = 0.0
            for got, want, mask in zip(tree_leaves(r0["params"]), tree_leaves(p1), ill):
                d = (got.float() - want.detach().float()).abs() / (want.detach().float().abs().max() + 1e-30)
                well = max(well, float(d[~mask].max()) if (~mask).any() else 0.0)
            out["one_rank_metrics"] = metric_err
            out["one_rank_params"] = well
            out["one_rank_m"] = max(ttrain._rel(a, b) for a, b in zip(tree_leaves(r0["m"]), tree_leaves(o1["m"])))
            out["one_rank_ill_share"] = sum(int(m.sum()) for m in ill) / sum(m.numel() for m in ill)
            step = torch.tensor(r0["step"], dtype=torch.int32)
            for st in r0["steps"]:
                yield r0["params"], {"m": r0["m"], "v": st["v"], "step": step}, st["metrics"]

        return run

    out.update(ttrain.compare_train_steps(name, port_run=sharded, **TRAIN_DATA))
    return out


@pytest.mark.parametrize("name,world,strategy", TRAIN_CASES, ids=[f"{n}-{w}ranks-{s or 'default'}" for n, w, s in TRAIN_CASES])
def test_sharded_train_step_matches_one_rank_and_the_reference(name, world, strategy, tmp_path):
    errs = compare_sharded_train(name, world, strategy, tmp_path)
    assert errs["wrong_shapes"] == [[]] * world, errs["wrong_shapes"]
    total = Model(get_arch(name).reduced()).param_count()
    if strategy in ("fsdp", "fsdp_tp"):  # the fsdp rules shard the big leaves over "data"
        assert max(errs["local_numel"]) < total, (errs["local_numel"], total)
    assert errs["one_rank_metrics"] <= SHARD_REL and errs["one_rank_params"] <= SHARD_REL, errs
    share = ttrain.ILL_SHARE.get(get_arch(name).family, 2e-2)
    assert errs["one_rank_m"] <= SHARD_REL and errs["one_rank_ill_share"] <= share, errs
    assert errs["params_over_lr"] <= 1e-2 and errs["ill_conditioned_share"] <= share, errs
    assert errs["m"] <= 1e-4 and errs["v"] <= 1e-4 and errs["step"] == 0, errs
    assert max(v for k, v in errs.items() if k.endswith("_metrics") and k.startswith("step")) <= 1e-4, errs


def test_train_driver_shards_over_a_two_rank_world_and_restarts(tmp_path):
    """``launch/train.py`` in a 2-rank gloo world: checkpoints of the global
    state written by rank 0, a restart that resumes at step 2 on both ranks,
    and the losses of the same two runs of the one-rank driver (relative
    1e-5)."""
    want = driver_worker(0, 1, str(tmp_path / "one_rank"))  # no process group: the one-rank driver
    ranks = run_ranks(driver_worker, 2, tmp_path, RANKS_TIMEOUT, (str(tmp_path / "ckpt"),))
    assert sorted(os.listdir(tmp_path / "ckpt")) == sorted(os.listdir(tmp_path / "one_rank"))
    for r in ranks:
        assert r["resumed_steps"] == want["resumed_steps"] == 1, r
        got, ref = r["losses"] + r["resumed_losses"], want["losses"] + want["resumed_losses"]
        assert max(abs(a - b) / abs(b) for a, b in zip(got, ref)) <= SHARD_REL, (got, ref)


# ---------------------------------------------------------------------------
# compressed_mean on gloo against the reference on host devices
# ---------------------------------------------------------------------------

COMP_WORLD, COMP_ROUNDS, COMP_SHAPE = 4, 21, (37, 53)

_REFERENCE_COMPRESSION = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import compat_make_mesh, compat_shard_map
    from repro.optim import compression as C

    xs = np.load(sys.argv[1])
    n = xs.shape[0]
    mesh = compat_make_mesh((n,), ("data",))
    one = C.compression_state(jax.ShapeDtypeStruct(xs.shape[1:], jnp.float32), n)
    state = jax.tree.map(lambda a: jnp.stack([a] * n), one)  # each shard its own state

    def f(x_local, st):
        mean, st = C.compressed_mean(x_local[0], jax.tree.map(lambda a: a[0], st), "data")
        return mean[None], jax.tree.map(lambda a: a[None], st)

    fm = jax.jit(compat_shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data"))))
    out = {{"means": [], "worker_err": [], "owner_err": [], "worker_err_in": [], "owner_err_in": []}}
    for i in range({rounds}):
        for k in ("worker_err", "owner_err"):
            out[k + "_in"].append(np.asarray(state[k]))
        mean, state = fm(jnp.asarray(xs), state)
        out["means"].append(np.asarray(mean))
        for k in ("worker_err", "owner_err"):
            out[k].append(np.asarray(state[k]))
    np.savez(sys.argv[2], **{{k: np.stack(v) for k, v in out.items()}})
""")


def run_reference(script: str, *args) -> None:
    """``script`` in a Python of its own (its XLA host devices set before JAX
    loads), the reference on the path; fails with its output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    ref = subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env, capture_output=True, text=True,
                         timeout=RANKS_TIMEOUT)
    assert ref.returncode == 0, ref.stdout + ref.stderr


def compare_compression(tmp_path) -> dict:
    """The reference's ``compressed_mean`` on 4 host devices, 21 rounds with
    each shard's error state carried, and the port's on 4 gloo ranks: each
    round from the reference's state going into it (means and states, max
    abs), and the port's own 21 rounds (the reference test's bounds)."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(COMP_WORLD,) + COMP_SHAPE).astype(np.float32)
    np.save(os.path.join(tmp_path, "xs.npy"), xs)
    run_reference(_REFERENCE_COMPRESSION.format(world=COMP_WORLD, rounds=COMP_ROUNDS), os.path.join(tmp_path, "xs.npy"),
                  os.path.join(tmp_path, "ref.npz"))
    want = np.load(os.path.join(tmp_path, "ref.npz"))
    payload = os.path.join(tmp_path, "xs.pt")
    torch.save({"xs": torch.from_numpy(xs), "worker_err": torch.from_numpy(want["worker_err_in"]),
                "owner_err": torch.from_numpy(want["owner_err_in"])}, payload)
    ranks = run_ranks(compression_worker, COMP_WORLD, tmp_path, RANKS_TIMEOUT, (payload,))
    # the means relative to their largest element; a state, a rounding
    # residual, relative to the largest value it is the residual of (the
    # owner's: a sum of the world's contributions)
    mean_scale, state_scale = np.abs(want["means"]).max(), COMP_WORLD * np.abs(xs).max()
    errs = {"means": 0.0, "states": 0.0}
    for r, got in enumerate(ranks):
        for i, (mean, state) in enumerate(got["stepped"]):
            errs["means"] = max(errs["means"], float(np.abs(mean.numpy() - want["means"][i, r]).max() / mean_scale))
            for k, v in state.items():
                errs["states"] = max(errs["states"], float(np.abs(v.numpy() - want[k][i, r]).max() / state_scale))
    true_mean = xs.mean(0)
    means = ranks[0]["means"].numpy()
    errs["one_shot"] = float(np.abs(means[0] - true_mean).max() / np.abs(true_mean).max())
    running = np.cumsum(means[1:], axis=0) / np.arange(1, COMP_ROUNDS)[:, None, None]
    drift = np.abs(running - true_mean).max(axis=(1, 2))
    errs["ef_first"], errs["ef_last"] = float(drift[0]), float(drift[-1])
    errs["payload_dtype"] = str(C._quant(C._to_blocks(torch.from_numpy(xs[0]), COMP_WORLD))[0].dtype)
    return errs


def test_compressed_mean_on_gloo_matches_the_reference(tmp_path):
    errs = compare_compression(tmp_path)
    assert errs["means"] <= 1e-6 and errs["states"] <= 1e-6, errs
    assert errs["one_shot"] < 0.05 and errs["ef_last"] < errs["ef_first"] / 5, errs
    assert errs["payload_dtype"] == "torch.int8", errs


def test_compression_state_and_quantization_match_the_reference():
    import jax.numpy as jnp

    from repro.optim import compression as JC

    st = C.compression_state(torch.zeros(37, 53), 8)
    jst = JC.compression_state(jax.ShapeDtypeStruct((37, 53), jnp.float32), 8)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: tuple(v.shape) for k, v in jst.items()}
    x = np.random.default_rng(1).normal(size=(33, 17)).astype(np.float32) * 3
    q, s = C._quant(C._to_blocks(torch.from_numpy(x), 3))
    jq, js = jax.jit(JC._quant)(JC._to_blocks(jnp.asarray(x), 3))  # as the reference runs it
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    # a world of one: the quantization runs, no collective
    mean, st = C.compressed_mean(torch.from_numpy(x), C.compression_state(torch.from_numpy(x), 1))
    assert float((mean - torch.from_numpy(x)).abs().max()) <= float(s.max()) and st["worker_err"].shape == x.shape


def test_compressed_train_step_in_a_world_of_one():
    """Without a mesh the compressed step quantizes each gradient: its first
    loss is the plain step's, its first moments are the plain step's within
    the int8 rounding, and the error states carry the residual."""
    model = Model(get_arch("llama3-8b").reduced())
    cfg = adamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    params, opt = tstep.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    comp = C.compression_state(params, 1)
    p1, o1 = copy.deepcopy(params), copy.deepcopy(opt)
    batch = {k: torch.from_numpy(v) for k, v in ttrain._batch(model.cfg).items()}
    params, opt, comp, metrics = tstep.make_compressed_train_step(model, cfg)(params, opt, comp, batch)
    p1, o1, m1 = tstep.make_train_step(model, cfg)(p1, o1, batch)
    assert torch.equal(metrics["loss"], m1["loss"]) and abs(float(metrics["grad_norm"] / m1["grad_norm"]) - 1) < 1e-2
    assert all(float(e["worker_err"].abs().max()) > 0 for e in tstep._state_leaves(comp) if e["worker_err"].numel() > 1)
    assert max(ttrain._rel(a, b) for a, b in zip(tree_leaves(opt["m"]), tree_leaves(o1["m"]))) < 1e-2


# the compressed step on a (2, 2) gloo world against the reference's on a
# (2, 2) mesh of host devices: llama3-8b reduced, 3 steps, under "fsdp_tp"
# (the port's parameters and moments both in shards over "data", its
# parameters and error states cut over "model" too; the reference's
# shard_map quantizes whole gradients, and so does the port's
# compressed_mean, joining a rank's "model" parts first), with two losses:
#   * "model", the model's own: its gradients differ from the reference's in
#     the last bits, and the int8 rounding turns a few such differences into
#     a whole step of the quantizer, which the error feedback carries on;
#   * "linear", sum(p * G) with a drawn G a rank and step: its gradient is G
#     in both frameworks bit for bit, so what follows the gradients
#     (compressed_mean, the ZeRO-1 update, the metrics' mean) is held tight
COMP_STEP = {"arch": "llama3-8b", "data": 2, "model": 2, "strategy": "fsdp_tp", "steps": 3}
COMP_STEP_LOSSES = ("model", "linear")
# an error state's tolerance on the scale of the values it rounds: the
# gradient leaves' (LEAF_TOL of test_torch_train) where the gradients are the
# model's, 1e-6 where they are equal
COMP_STATE_TOL = {"model": 1e-4, "linear": 1e-6}

_REFERENCE_COMPRESSED_STEP = textwrap.dedent("""
    import contextlib, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import compat_make_mesh
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro.optim import adamw, compression as C
    from repro.parallel.sharding import STRATEGIES
    from repro.train import step as step_lib

    # under this JAX the loss's activation constraints name the shard_map's
    # manual axes and are refused; they place values and change none
    step_lib.activation_rules = lambda *a: contextlib.nullcontext()


    class Linear(Model):
        def loss(self, params, batch):
            gs = [batch[k] for k in sorted(batch)]
            loss = sum(jnp.sum(p * g[0]) for p, g in zip(jax.tree.leaves(params), gs))
            return loss, {{"ce": loss, "tokens": jnp.float32(gs[0].shape[0]), "loss": loss}}


    batches = pickle.load(open(sys.argv[1], "rb"))
    mesh = compat_make_mesh(({data}, {model}), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    host = lambda t: jax.tree.map(np.asarray, t)
    # the out spec says replicated, but each device keeps its own error state
    per_device = lambda t: jax.tree.map(
        lambda a: np.stack([np.asarray(s.data) for s in sorted(a.addressable_shards, key=lambda s: s.device.id)]), t)
    out = {{}}
    for loss, cls in (("model", Model), ("linear", Linear)):
        model = cls(get_arch("{arch}").reduced())
        fn = jax.jit(step_lib.make_compressed_train_step(model, STRATEGIES["{strategy}"], mesh, opt_cfg))
        params, opt = step_lib.init_train_state(model, jax.random.key(0))
        comp = C.compression_state(params, {data})
        run = out[loss] = {{"params0": host(params), "opt0": host(opt), "steps": []}}
        for b in batches[loss]:
            params, opt, comp, metrics = fn(params, opt, comp, {{k: jnp.asarray(v) for k, v in b.items()}})
            run["steps"].append({{"metrics": host(metrics), "v": host(opt["v"]), "comp": per_device(comp)}})
        run["params"], run["opt"] = host(params), host(opt)
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _compressed_batches(cfg) -> dict:
    """Per loss, the steps' global batches: the model's from the data
    pipeline; the linear loss's one G a rank (a row) per parameter leaf,
    keyed in the leaves' order, elements normal at a scale drawn per leaf."""
    arch = get_arch(cfg["arch"]).reduced()
    dc = ttrain._data(arch, **TRAIN_DATA)
    rng = np.random.default_rng(1)
    shapes = [s.shape for s in tree_leaves(Model(arch).specs())]
    linear = [
        {f"g{i:03d}": (rng.normal(size=(cfg["data"],) + shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
         for i, shape in enumerate(shapes)}
        for _ in range(cfg["steps"])
    ]
    return {"model": [batch_at(dc, i) for i in range(cfg["steps"])], "linear": linear}


def compare_compressed_train(tmp_path) -> dict:
    """The reference's ``make_compressed_train_step`` on a (2, 2) mesh of
    host devices and the port's on a (2, 2) gloo world, from the reference's
    initial state, three
    steps on the same batches, per loss: each step's metrics, the gathered
    params, m and v after the last (``compare_train_steps``' measures), and
    every rank's error states after every step against its device's
    (max-abs over the largest |G| of the run; the ``model`` loss reports
    how many elements of the states, m and the params are off instead)."""
    cfg = COMP_STEP
    batches = _compressed_batches(cfg)
    with open(os.path.join(tmp_path, "batches.pkl"), "wb") as f:
        pickle.dump(batches, f)
    run_reference(_REFERENCE_COMPRESSED_STEP.format(world=cfg["data"] * cfg["model"], **cfg), os.path.join(tmp_path, "batches.pkl"), os.path.join(tmp_path, "ref.pkl"))
    with open(os.path.join(tmp_path, "ref.pkl"), "rb") as f:
        refs = pickle.load(f)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, peak_lr=1e-3)
    out = {}
    for loss in COMP_STEP_LOSSES:
        ref = refs[loss]
        params, opt = tspec.train_state_from_jax(ref["params0"], ref["opt0"], "cpu")
        payload = os.path.join(tmp_path, f"compressed_{loss}.pt")
        torch.save({"params": params, "opt": opt, "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches[loss]],
                    "opt_cfg": dataclasses.asdict(opt_cfg)}, payload)
        ranks = run_ranks(compressed_train_worker, cfg["data"] * cfg["model"], tmp_path, RANKS_TIMEOUT,
                          (payload, cfg["arch"], cfg["strategy"], loss, cfg["model"]))
        r0, errs = ranks[0], out.setdefault(loss, {})
        ill = [torch.zeros(t.shape, dtype=torch.bool) for t in tree_leaves(params)]
        for i, (st, jst) in enumerate(zip(r0["steps"], ref["steps"])):
            assert sorted(st["metrics"]) == sorted(jst["metrics"])
            errs[f"step{i}_metrics"] = max(ttrain._rel(st["metrics"][k], jst["metrics"][k]) for k in jst["metrics"])
            for mask, tv, jv in zip(ill, tree_leaves(st["v"]), tree_leaves(jst["v"])):
                mask |= _ill_conditioned(tv, torch.from_numpy(np.asarray(jv)), i, opt_cfg)
        errs["ill_conditioned_share"] = sum(int(m.sum()) for m in ill) / sum(m.numel() for m in ill)
        errs["step"] = abs(r0["step"] - int(ref["opt"]["step"]))
        # each quantity: its worst element, and the share of its elements off
        # by more than compare_train_steps' tolerance (relative 1e-4 of the
        # reference leaf's max-abs; the params 1e-2 x peak_lr where every
        # update was well conditioned)
        # an error state is the residual of rounding values to int8 steps of
        # max|block| / 127, so at most 1/254 of the values it came from: held
        # on their scale, 254 x the largest the leaf's state reached in the
        # reference's run (an earlier step's larger values leave their last
        # bits in a later, smaller state), at the gradients' tolerance
        n_state = len(tree_leaves(ref["steps"][0]["comp"]))
        state_scale = [254 * max(float(np.abs(tree_leaves(jst["comp"])[j]).max()) for jst in ref["steps"]) for j in range(n_state)]
        pairs = {
            "m": [(a, b, float(np.abs(b).max())) for a, b in zip(tree_leaves(r0["m"]), tree_leaves(ref["opt"]["m"]))],
            "v": [(a, b, float(np.abs(b).max())) for a, b in zip(tree_leaves(r0["steps"][-1]["v"]), tree_leaves(ref["opt"]["v"]))],
            "states": [(t, jt[r], state_scale[j]) for r, got in enumerate(ranks) for st, jst in zip(got["steps"], ref["steps"])
                       for j, (t, jt) in enumerate(zip(tree_leaves(st["comp"]), tree_leaves(jst["comp"])))],
        }
        for name, leaves in pairs.items():
            tol = COMP_STATE_TOL[loss] if name == "states" else 1e-4
            rel = [(a.float() - torch.from_numpy(np.asarray(b, np.float32))).abs() / (scale + 1e-30) for a, b, scale in leaves]
            errs[name] = max(float(d.max()) for d in rel)
            errs[f"{name}_off_share"] = sum(int((d > tol).sum()) for d in rel) / sum(d.numel() for d in rel)
        diffs = [((t.float() - torch.from_numpy(np.asarray(jp, np.float32))).abs() / opt_cfg.peak_lr)[~m]
                 for t, jp, m in zip(tree_leaves(r0["params"]), tree_leaves(ref["params"]), ill)]
        errs["params_over_lr"] = max(float(d.max()) if d.numel() else 0.0 for d in diffs)
        errs["params_off_share"] = sum(int((d > 1e-2).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    return out


@pytest.fixture(scope="module")
def compressed_runs(tmp_path_factory):
    return compare_compressed_train(tmp_path_factory.mktemp("compressed"))


def test_compressed_train_step_on_gloo_matches_the_reference_from_equal_gradients(compressed_runs):
    """The linear loss: every step's metrics, v and the params within
    ``compare_train_steps``' tolerances; m within them and the error states
    within 1e-6 (``COMP_STATE_TOL``) on all but a share of 1e-4 of their
    elements (measured 9.4e-6 and 2.9e-5: an ulp of XLA's fused
    ``blocks - q * scale`` against the port's two roundings, rounded to the
    other int8 step a step later)."""
    errs = compressed_runs["linear"]
    assert max(v for k, v in errs.items() if k.endswith("_metrics")) <= 1e-4, errs
    assert errs["params_over_lr"] <= 1e-2 and errs["ill_conditioned_share"] <= 2e-2, errs
    assert errs["v"] <= 1e-4 and errs["step"] == 0, errs
    assert errs["m_off_share"] <= 1e-4 and errs["states_off_share"] <= 1e-4, errs


def test_compressed_train_step_on_gloo_matches_the_reference_with_the_model_loss(compressed_runs):
    """The model's loss: every step's metrics within 1e-4 of the
    reference's (the third step's loss is taken after two compressed
    updates); the error states, m, v and the params within
    ``compare_train_steps``' tolerances on all but a share of 2e-3 of their
    elements (measured 1.3e-4 to 4.0e-4: the elements whose rounding the
    gradients' last bits sent to the other int8 step)."""
    errs = compressed_runs["model"]
    assert max(v for k, v in errs.items() if k.endswith("_metrics")) <= 1e-4, errs
    assert errs["step"] == 0 and errs["ill_conditioned_share"] <= 2e-2, errs
    assert max(errs[f"{k}_off_share"] for k in ("states", "m", "v", "params")) <= 2e-3, errs


# ---------------------------------------------------------------------------
# The distributed flash-decode on a (2, 2) gloo mesh
# ---------------------------------------------------------------------------

DECODE_ARCHS = ("llama3-8b", "recurrentgemma-2b")
DECODE_B, DECODE_L = 4, 16

# the reference's flash-decode under tp on a (2, 2) mesh of 4 host devices,
# as tests/test_flash_decode.py runs it on (2, 4): its weights, tokens and
# logits a config
_REFERENCE_DECODE = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.compat import compat_make_mesh
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro.parallel import sharding as sh
    from repro.train import step as step_lib

    mesh = compat_make_mesh((2, 2), ("data", "model"))
    strat = dataclasses.replace(sh.STRATEGIES["tp"], name="tp_fd", flash_decode=True)
    named = lambda t: jax.tree.map(lambda ps: NamedSharding(mesh, ps), t)
    B, L, out = {b}, {l}, {{}}
    for arch in {archs!r}:
        model = Model(get_arch(arch).reduced().replace(n_kv_heads=1))
        params = model.init(jax.random.key(0))
        toks = jnp.asarray(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, L + 1)), jnp.int32)
        _, cache = model.prefill(params, {{"tokens": toks[:, :L]}}, cache_len=L + 1)
        batch = {{"tokens": toks[:, L:], "pos": jnp.full((B,), L, jnp.int32)}}
        shs = step_lib.make_shardings(model, strat, mesh, batch, model.cache_specs(B, L + 1))
        fn = jax.jit(step_lib.make_decode_step(model, strat, mesh), in_shardings=(named(shs.params), named(shs.cache), named(shs.batch)))
        logits, _ = fn(params, jax.tree.map(jax.device_put, cache, named(shs.cache)), batch)
        out[arch] = {{"params": jax.tree.map(np.asarray, params), "tokens": np.asarray(toks), "logits": np.asarray(logits)}}
    pickle.dump(out, open(sys.argv[1], "wb"))
""")


def compare_flash_decode(tmp_path) -> dict:
    """One decode step on a (2, 2) gloo mesh from the reference's weights
    and tokens, each rank's logits against the port's one-rank decode
    (``<arch>_rank<r>``) and against the reference's flash-decode on a
    (2, 2) mesh of host devices (``<arch>_rank<r>_reference``)."""
    run_reference(_REFERENCE_DECODE.format(b=DECODE_B, l=DECODE_L, archs=DECODE_ARCHS), os.path.join(tmp_path, "ref.pkl"))
    with open(os.path.join(tmp_path, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    cases, want = [], {}
    for name in DECODE_ARCHS:
        cut = {"n_kv_heads": 1}
        model = Model(get_arch(name).reduced().replace(**cut))
        params = tspec.params_from_jax(ref[name]["params"], "cpu")
        toks = torch.from_numpy(np.asarray(ref[name]["tokens"]))
        _, cache = tstep.make_prefill_step(model, DECODE_L + 1)(params, {"tokens": toks[:, :DECODE_L]})
        batch = {"tokens": toks[:, DECODE_L:], "pos": torch.full((DECODE_B,), DECODE_L, dtype=torch.int32)}
        # a decode step writes its cache in place: the ranks decode from the prefill's
        want[name] = tstep.make_decode_step(model)(params, tspec.tree_map(torch.clone, cache), batch)[0]
        cases.append({"arch": name, "cut": cut, "params": params, "cache": cache, "cache_len": DECODE_L + 1, **batch})
    payload = os.path.join(tmp_path, "decode.pt")
    torch.save(cases, payload)
    ranks = run_ranks(decode_worker, 4, tmp_path, RANKS_TIMEOUT, (payload, 2))
    errs = {}
    for r, got in enumerate(ranks):
        for name in DECODE_ARCHS:
            errs[f"{name}_rank{r}"] = ttrain._rel(got[name], want[name])
            errs[f"{name}_rank{r}_reference"] = ttrain._rel(got[name], ref[name]["logits"])
    return errs


def test_flash_decode_on_a_2x2_mesh_matches_one_rank(tmp_path):
    errs = compare_flash_decode(tmp_path)
    assert len(errs) == 2 * 4 * len(DECODE_ARCHS) and max(errs.values()) <= 1e-4, errs


def test_flash_decode_pads_and_combines_on_one_rank():
    """In a world of one the distributed path pads nothing, splits nothing
    and combines by no collective: the plain decode attention's output."""
    from repro_torch.models import attention as tattn

    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k, v = torch.randn(2, 17, 2, 16, generator=g), torch.randn(2, 17, 2, 16, generator=g)
    pos = torch.tensor([9, 16], dtype=torch.int32)
    want = tattn.decode_attention(q, k, v, pos, window=8)
    fd = dataclasses.replace(sh.STRATEGIES["tp"], flash_decode=True)
    with sh.activation_rules(fd, tmesh.make_local_mesh(1)):
        got = tattn.decode_attention(q, k, v, pos, window=8)
    assert ttrain._rel(got, want) <= 1e-6


if __name__ == "__main__":
    import tempfile

    for name, reduced in CONFIGS[:4]:
        print(name, reduced, "spec differences", sum(sum(v.values()) for v in compare_specs(name, reduced).values()))
    for case in TRAIN_CASES:
        with tempfile.TemporaryDirectory() as d:
            print("sharded train", case, compare_sharded_train(*case, d))
    with tempfile.TemporaryDirectory() as d:
        print("compressed_mean", compare_compression(d))
    with tempfile.TemporaryDirectory() as d:
        print("compressed train step", compare_compressed_train(d))
    with tempfile.TemporaryDirectory() as d:
        print("flash-decode", compare_flash_decode(d))
