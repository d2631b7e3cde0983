"""Running a function on several ranks of a gloo world, on the CPU, for the
port's sharding tests (``tests/test_torch_sharding.py``).

``run_ranks`` spawns one process a rank.  The ranks meet through a
``FileStore`` in the test's temporary directory (no port to collide under
pytest-xdist), each writes what its function returns to a file, and a rank
that raises or a world that outlives its timeout fails the call, with every
rank's traceback in the message.  The workers here import torch and the
port only, never JAX.
"""
from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist


def run_ranks(target, world: int, tmp_path, timeout: float, args=()) -> list:
    """``target(rank, world, *args)`` on every rank of a ``world``-rank gloo
    group; returns their results in rank order."""
    tmp = Path(tempfile.mkdtemp(prefix="ranks", dir=tmp_path))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, str(tmp), args), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: its peers may wait on it forever
            time.sleep(0.05)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = [(tmp / f"rank{r}.err") for r in range(world)]
    errors = "\n".join(f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errors) if e.exists())
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"ranks still running after {timeout} s: {hung}; exit codes {codes}\n{errors}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(target, rank: int, world: int, tmp: str, args) -> None:
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        out = target(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        Path(tmp, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Workers (each ``target(rank, world, ...)``; payloads cross as torch.save files)
# ---------------------------------------------------------------------------


def train_worker(rank: int, world: int, payload: str, name: str, strategy_name) -> dict:
    """The sharded train step over a (world, 1) mesh from the payload's
    global state, one step a batch.  Returns the shards' shapes against
    their specs' and, on rank 0, each step's metrics and gathered v and the
    final gathered params and m."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import strategy_for
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import local_shape
    from repro_torch.train import step as step_lib

    data = torch.load(payload, weights_only=False)
    model = Model(get_arch(name).reduced())
    mesh = make_local_mesh(world)
    strategy = strategy_for(model.cfg, strategy_name)
    sh = step_lib.make_shardings(model, strategy, mesh, data["batches"][0])
    params, opt = step_lib.shard_tree(data["params"], sh.params, mesh), step_lib.shard_tree(data["opt"], sh.opt, mesh)
    fn = step_lib.make_train_step(model, adamw.AdamWConfig(**data["opt_cfg"]), strategy=strategy, mesh=mesh)
    steps = []
    for batch in data["batches"]:
        params, opt, metrics = fn(params, opt, batch)
        v = step_lib.gather_tree(opt["v"], sh.opt["v"], mesh)
        steps.append({"metrics": {k: t.clone() for k, t in metrics.items()}, "v": v})
    specs = tree_leaves(model.specs())
    wrong = [
        (kind, s.shape, tuple(t.shape), spec)
        for kind, tree, spec_tree in (("params", params, sh.params), ("m", opt["m"], sh.opt["m"]), ("v", opt["v"], sh.opt["v"]))
        for s, t, spec in zip(specs, tree_leaves(tree), tree_leaves(spec_tree))
        if tuple(t.shape) != local_shape(s.shape, spec, mesh)
    ]
    out = {"wrong_shapes": wrong, "local_numel": sum(t.numel() for t in tree_leaves(params))}
    full = {"params": step_lib.gather_tree(params, sh.params, mesh), "m": step_lib.gather_tree(opt["m"], sh.opt["m"], mesh)}
    if rank == 0:
        out.update(steps=steps, step=int(opt["step"]), **full)
    return out


def compression_worker(rank: int, world: int, payload: str) -> dict:
    """``compressed_mean`` of the payload's ``xs[rank]`` over the world: one
    call a round from the payload's state for this rank (``stepped``: each
    round's mean and state), and ``rounds`` calls carrying its own state
    (``means``)."""
    from repro_torch.optim import compression as C

    data = torch.load(payload, weights_only=False)
    x = data["xs"][rank]
    stepped = []
    for worker_err, owner_err in zip(data["worker_err"], data["owner_err"]):
        state = {"worker_err": worker_err[rank].clone(), "owner_err": owner_err[rank].clone()}
        stepped.append(C.compressed_mean(x, state, dist.group.WORLD))
    state, means = C.compression_state(x, world), []
    for _ in range(len(stepped)):
        mean, state = C.compressed_mean(x, state, dist.group.WORLD)
        means.append(mean)
    return {"stepped": stepped, "means": torch.stack(means)}


def decode_worker(rank: int, world: int, payload: str, model_parallel: int) -> dict:
    """One decode step of each payload case on a (world / model_parallel,
    model_parallel) mesh, under tp with flash_decode: whole weights, the
    cache cut to this rank's batch shard.  Returns the global logits."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_map
    from repro_torch.parallel.sharding import STRATEGIES, mesh_axis_sizes, resolve_axes
    from repro_torch.train import step as step_lib

    mesh = make_local_mesh(world, model_parallel)
    strategy = dataclasses.replace(STRATEGIES["tp"], name="tp_fd", flash_decode=True)
    sizes = mesh_axis_sizes(mesh)
    rules = {"cache_batch": strategy.act_rules.get("cache_batch")}  # the batch dim over dp, the rest whole
    out = {}
    for case in torch.load(payload, weights_only=False):
        model = Model(get_arch(case["arch"]).reduced().replace(**case["cut"]))
        B, Lc = case["tokens"].shape[0], case["cache_len"]
        cache_specs = tree_map(lambda s: resolve_axes(s.axes, rules, mesh.axis_names, s.shape, sizes), model.cache_specs(B, Lc))
        cache = step_lib.shard_tree(case["cache"], cache_specs, mesh)
        fn = step_lib.make_decode_step(model, strategy=strategy, mesh=mesh)
        logits, _ = fn(case["params"], cache, {"tokens": case["tokens"], "pos": case["pos"]})
        out[case["arch"]] = logits
    return out


def linear_loss(params, batch: dict):
    """sum(p * G) over the leaves, G the batch's ``g*`` leaves in the
    leaves' order, one row a rank: the gradient is the rank's G exactly."""
    from repro_torch.models.spec import tree_leaves

    gs = [batch[k] for k in sorted(batch)]
    loss = sum((p * g[0]).sum() for p, g in zip(tree_leaves(params), gs))
    return loss, {"ce": loss, "tokens": torch.tensor(float(gs[0].shape[0])), "loss": loss}


def compressed_train_worker(rank: int, world: int, payload: str, name: str, strategy_name: str, loss: str) -> dict:
    """``make_compressed_train_step`` over a (world, 1) mesh from the
    payload's global state and zero error states, one step a batch, with the
    model's loss or (``loss="linear"``) ``linear_loss``.  Returns each
    step's metrics, gathered v and this rank's error states, and the final
    gathered params and m."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import compression_state
    from repro_torch.parallel.sharding import STRATEGIES
    from repro_torch.train import step as step_lib

    data = torch.load(payload, weights_only=False)
    model = Model(get_arch(name).reduced())
    if loss == "linear":
        model.loss = linear_loss
    mesh = make_local_mesh(world)
    strategy = STRATEGIES[strategy_name]
    sh = step_lib.make_shardings(model, strategy, mesh, data["batches"][0])
    params, opt = step_lib.shard_tree(data["params"], sh.params, mesh), step_lib.shard_tree(data["opt"], sh.opt, mesh)
    comp = compression_state(data["params"], world)
    fn = step_lib.make_compressed_train_step(model, adamw.AdamWConfig(**data["opt_cfg"]), strategy=strategy, mesh=mesh)
    steps = []
    for batch in data["batches"]:
        params, opt, comp, metrics = fn(params, opt, comp, batch)
        steps.append({"metrics": {k: t.clone() for k, t in metrics.items()}, "v": step_lib.gather_tree(opt["v"], sh.opt["v"], mesh),
                      "comp": copy.deepcopy(comp)})
    return {"steps": steps, "step": int(opt["step"]), "params": step_lib.gather_tree(params, sh.params, mesh),
            "m": step_lib.gather_tree(opt["m"], sh.opt["m"], mesh)}


def driver_worker(rank: int, world: int, ckpt_dir: str) -> dict:
    """``launch/train.py``'s ``train`` in the world (the default strategy
    over the driver's (world, 1) mesh): two steps with a checkpoint after
    each, then a restart that resumes from the second and takes a third."""
    from repro_torch.launch.train import train

    kw = dict(seq_len=16, global_batch=4, log_every=0, device="cpu", ckpt_dir=ckpt_dir, ckpt_every=1)
    first = train("llama3-8b", steps=2, **kw)
    if dist.is_initialized():
        dist.barrier()
    resumed = train("llama3-8b", steps=3, **kw)
    return {"losses": first["losses"], "resumed_losses": resumed["losses"], "resumed_steps": resumed["steps"]}


def gather_model(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of a rank's "model" shard, whole over the dp axes
    (the layout ``train/step.py`` computes on): each dim split over "model"
    gathered in its ``(outer, m, rest)`` layout."""
    import math

    from repro_torch.parallel import tensor as tp
    from repro_torch.parallel.sharding import spec_axes

    for d, entry in enumerate(spec):
        names = spec_axes(entry)
        if "model" in names and mesh.axis_size("model") > 1:
            outer = math.prod(mesh.axis_size(a) for a in names[: names.index("model")])
            t = tp.all_gather(t, mesh, "model", d, outer)
    return t


def tp_worker(rank: int, world: int, model_parallel: int, payload: str) -> dict:
    """Each payload case on a (world / model_parallel, model_parallel) mesh
    under its strategy: the gradients of the first batch's loss (averaged
    over the dp ranks and gathered whole), the metrics of a train step a
    batch, the gathered params and v after them, and the prefill's logits
    from the initial state.  Rank 0 returns them by case, with the shards
    whose shape is not their spec's and the collective bytes of a step."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import tensor as tp
    from repro_torch.parallel.sharding import STRATEGIES, local_shape
    from repro_torch.train import step as step_lib

    data = torch.load(payload, weights_only=False)
    mesh = make_local_mesh(world, model_parallel)
    out = {}
    for key, case in data["cases"].items():
        model = Model(get_arch(case["arch"]).reduced().replace(**case["cut"]))
        name, overrides = case["strategy"]
        strategy = STRATEGIES[name].with_overrides(**overrides)
        batches = case["batches"]
        sh = step_lib.make_shardings(model, strategy, mesh, batches[0])
        # copies: a shard of a leaf no axis splits is the leaf itself, which the
        # steps update in place, and the cases share the payload's state
        params = step_lib.shard_tree(copy.deepcopy(case["params"]), sh.params, mesh)
        opt = step_lib.shard_tree(copy.deepcopy(case["opt"]), sh.opt, mesh)
        wrong = [(s.shape, tuple(t.shape), spec) for s, t, spec in zip(tree_leaves(model.specs()), tree_leaves(params),
                                                                         tree_leaves(sh.params))
                 if tuple(t.shape) != local_shape(s.shape, spec, mesh)]
        prefill = {k: v for k, v in batches[0].items() if k != "labels"}
        logits, _ = step_lib.make_prefill_step(model, prefill["tokens"].shape[1], strategy=strategy, mesh=mesh)(params, prefill)
        layout = step_lib._layout(model, strategy, mesh, "a train step")
        _, _, grads = layout.loss_and_grads(model, params, batches[0])
        grads = [gather_model(tp.all_reduce(g, mesh, "data") / mesh.axis_size("data"), spec, mesh)
                 for g, spec in zip(grads, layout.params)]
        fn = step_lib.make_train_step(model, adamw.AdamWConfig(**data["opt_cfg"]), strategy=strategy, mesh=mesh)
        steps = []
        for batch in batches:
            tp.COLLECTIVES.reset()
            params, opt, metrics = fn(params, opt, batch)
            steps.append({"metrics": {k: float(t) for k, t in metrics.items()},
                          "v": step_lib.gather_tree(opt["v"], sh.opt["v"], mesh),
                          "collectives": dict(tp.COLLECTIVES.bytes_by_op)})
        full = step_lib.gather_tree(params, sh.params, mesh)
        out[key] = {"wrong_shapes": wrong, "logits": logits, "grads": grads, "steps": steps, "params": full}
    return out if rank == 0 else {}


def tp_driver_worker(rank: int, world: int, model_parallel: int) -> dict:
    """``launch/train.py``'s ``train`` in the world under "tp" with a
    "model" axis of ``model_parallel`` (``--model-parallel``): two steps."""
    from repro_torch.launch.train import train

    out = train("llama3-8b", steps=2, seq_len=16, global_batch=4, log_every=0, device="cpu", strategy_name="tp",
                model_parallel=model_parallel)
    return {"losses": out["losses"], "grad_norms": out["grad_norms"]}
