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
    model_parallel) mesh, under tp with flash_decode: the rank's shards of
    the weights, the whole cache cut to the rank's (``shard_cache``: its
    rows, and with one KV head every head, whole over the sequence, whose
    slice the rank attends to).  Returns the global logits."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import STRATEGIES
    from repro_torch.train import step as step_lib

    mesh = make_local_mesh(world, model_parallel)
    strategy = dataclasses.replace(STRATEGIES["tp"], name="tp_fd", flash_decode=True)
    out = {}
    for case in torch.load(payload, weights_only=False):
        model = Model(get_arch(case["arch"]).reduced().replace(**case["cut"]))
        batch = {"tokens": case["tokens"], "pos": case["pos"]}
        params = step_lib.shard_tree(case["params"], step_lib.make_shardings(model, strategy, mesh, batch).params, mesh)
        cache = step_lib.shard_cache(model, case["cache"], batch["tokens"].shape[0], case["cache_len"], strategy=strategy,
                                     mesh=mesh)
        fn = step_lib.make_decode_step(model, strategy=strategy, mesh=mesh)
        logits, _ = fn(params, cache, batch)
        out[case["arch"]] = logits
    return out


def linear_loss(params, batch: dict, cut=None):
    """sum(p * G) over the leaves, G the batch's ``g*`` leaves in the
    leaves' order, one row a rank: the gradient is the rank's G exactly.
    The leaves are gathered where they are used (``tp.fsdp``), as the
    models gather theirs.  ``cut``: which leaves a "model" axis cuts (the
    batch's G then holds the rank's part of theirs), whose partial sums
    are summed over "model"."""
    from repro_torch.models.spec import tree_leaves
    from repro_torch.parallel import tensor as tp

    params = tp.fsdp(params)
    gs = [batch[k] for k in sorted(batch)]
    cut = cut or [False] * len(gs)
    terms = [(p * g[0]).sum() for p, g in zip(tree_leaves(params), gs)]
    loss = sum(t for t, c in zip(terms, cut) if not c) + tp.reduce(sum((t for t, c in zip(terms, cut) if c), torch.zeros(())))
    return loss, {"ce": loss, "tokens": torch.tensor(float(gs[0].shape[0])), "loss": loss}


def compressed_train_worker(rank: int, world: int, payload: str, name: str, strategy_name: str, loss: str,
                            model_parallel: int = 1) -> dict:
    """``make_compressed_train_step`` over a (world / model_parallel,
    model_parallel) mesh from the payload's global state and zero error
    states (``init_compression_state``), one step a batch, with the model's
    loss or (``loss="linear"``) ``linear_loss``.  Returns each step's
    metrics, gathered v and this rank's error states made whole over
    "model" (the whole gradient's, as the reference's device keeps them),
    and the final gathered params and m."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import _n_blocks
    from repro_torch.parallel import tensor as tp
    from repro_torch.parallel.sharding import STRATEGIES
    from repro_torch.train import step as step_lib

    data = torch.load(payload, weights_only=False)
    model = Model(get_arch(name).reduced())
    mesh = make_local_mesh(world, model_parallel)
    strategy = STRATEGIES[strategy_name]
    sh = step_lib.make_shardings(model, strategy, mesh, data["batches"][0])
    params, opt = step_lib.shard_tree(data["params"], sh.params, mesh), step_lib.shard_tree(data["opt"], sh.opt, mesh)
    comp = step_lib.init_compression_state(model, strategy=strategy, mesh=mesh, device="cpu")
    parts = step_lib.compression_parts(model, strategy, mesh)
    n_dp = mesh.axis_size("data")
    batches = data["batches"]
    if loss == "linear":  # each rank's G of a leaf "model" cuts: its part, as the leaf's
        model.loss = lambda params, batch: linear_loss(params, batch, [p is not None for p in parts])
        batches = [{k: g if part is None else tp.rank_slice(g, part.n, mesh.coordinate("model"), part.dim + 1, part.outer).clone()
                    for (k, g), part in zip(sorted(b.items()), parts)} for b in batches]

    def whole(comp):
        comp = copy.deepcopy(comp)
        for st, part in zip(step_lib._state_leaves(comp), parts):
            if part is not None:
                st["worker_err"] = part.whole(st["worker_err"])
                owned = _n_blocks(st["worker_err"].numel(), n_dp) // n_dp  # the whole tensor's blocks a "data" rank owns
                st["owner_err"] = part.whole(st["owner_err"], dim=0)[:owned]
        return comp

    fn = step_lib.make_compressed_train_step(model, adamw.AdamWConfig(**data["opt_cfg"]), strategy=strategy, mesh=mesh)
    steps = []
    for batch in batches:
        params, opt, comp, metrics = fn(params, opt, comp, batch)
        steps.append({"metrics": {k: t.clone() for k, t in metrics.items()}, "v": step_lib.gather_tree(opt["v"], sh.opt["v"], mesh),
                      "comp": whole(comp)})
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


def greedy_decode(decode, params, cache, logits: torch.Tensor, pos: int, steps: int) -> list:
    """``steps`` decode steps from a prefill's last logits, each feeding its
    greedy token back: one (tokens (B, 1), logits) a step."""
    out = []
    for i in range(steps):
        tokens = logits[:, -1].argmax(-1)[:, None].int()
        logits, cache = decode(params, cache, {"tokens": tokens, "pos": torch.full((tokens.shape[0],), pos + i, dtype=torch.int32)})
        out.append((tokens, logits))
    return out


def tp_worker(rank: int, world: int, model_parallel: int, payload: str) -> dict:
    """Each payload case on a (world / model_parallel, model_parallel) mesh
    under its strategy: the gradients of the first batch's loss (as the
    first train step collects them, averaged over the dp ranks and gathered
    whole), the metrics of a train step a
    batch, the gathered params and v after them, the prefill's logits from
    the initial state, its cache's largest error against ``shard_cache`` of
    the one-rank prefill's (``cache1``), and where the case asks
    (``decode``) ``decode_steps`` greedy decode steps on the rank's own
    cache with their collective bytes and the bytes of the parameters they
    gathered.  Rank 0 returns them by case,
    with the shards whose shape is not their spec's and the collective
    bytes of a step."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import tensor as tp
    from repro_torch.parallel.sharding import STRATEGIES, is_two_d, local_shape
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
        B, L = prefill["tokens"].shape
        cache_len = L + data["decode_steps"]
        logits, cache = step_lib.make_prefill_step(model, cache_len, strategy=strategy, mesh=mesh)(params, prefill)
        want = step_lib.shard_cache(model, case["cache1"], B, cache_len, strategy=strategy, mesh=mesh)
        cache_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-30)) for a, b in zip(tree_leaves(cache), tree_leaves(want)))
        cache_shapes = [(tuple(a.shape), tuple(b.shape)) for a, b in zip(tree_leaves(cache), tree_leaves(want)) if a.shape != b.shape]
        decode = decode_bytes = None
        if case["decode"]:
            tp.COLLECTIVES.reset()
            decode = greedy_decode(step_lib.make_decode_step(model, strategy=strategy, mesh=mesh), params, cache, logits, L,
                                   data["decode_steps"])
            decode_bytes = {"by_op": dict(tp.COLLECTIVES.bytes_by_op), "params": tp.COLLECTIVES.param_bytes}
        fn = step_lib.make_train_step(model, adamw.AdamWConfig(**data["opt_cfg"]), strategy=strategy, mesh=mesh)
        steps, first = [], []
        collect = tp.Shards.grads

        def grads_kept(shards):  # the first step's gradients, as the step collects them
            out = collect(shards)
            if not first:
                first.extend(g.clone() for g in out)
            return out

        tp.Shards.grads = grads_kept
        try:
            for batch in batches:
                tp.COLLECTIVES.reset()
                params, opt, metrics = fn(params, opt, batch)
                steps.append({"metrics": {k: float(t) for k, t in metrics.items()},
                              "v": step_lib.gather_tree(opt["v"], sh.opt["v"], mesh),
                              "collectives": dict(tp.COLLECTIVES.bytes_by_op), "params_gathered": tp.COLLECTIVES.param_bytes})
        finally:
            tp.Shards.grads = collect
        n_dp = 1 if is_two_d(strategy) else mesh.axis_size("data")  # "serve_2dtp": whole batch, exact gradients
        grads = [step_lib.gather(g / n_dp, spec, mesh) for g, spec in zip(first, tree_leaves(sh.opt["m"]))]
        full = step_lib.gather_tree(params, sh.params, mesh)
        out[key] = {"wrong_shapes": wrong, "logits": logits, "grads": grads, "steps": steps, "params": full,
                    "cache_err": cache_err, "cache_shapes": cache_shapes, "decode": decode, "decode_bytes": decode_bytes}
    return out if rank == 0 else {}


def tp_driver_worker(rank: int, world: int, model_parallel: int, strategies=("tp",)) -> dict:
    """``launch/train.py``'s ``train`` in the world under each of
    ``strategies`` with a "model" axis of ``model_parallel``
    (``--strategy``, ``--model-parallel``): two steps each, by strategy."""
    from repro_torch.launch.train import train

    out = {}
    for name in strategies:
        run = train("llama3-8b", steps=2, seq_len=16, global_batch=4, log_every=0, device="cpu", strategy_name=name,
                    model_parallel=model_parallel)
        out[name] = {"losses": run["losses"], "grad_norms": run["grad_norms"]}
    return out


def moves_worker(rank: int, world: int, model_parallel: int) -> dict:
    """The moves of ``parallel/tensor.py`` on a (world / model_parallel,
    model_parallel) mesh against what they mean, from tensors every rank
    draws for every rank: ``reduce_scatter`` over "model", over ("data",
    "model") and in an (outer, n, rest) layout against the ranks' sum's
    block; ``seq_enter`` and ``seq_leave``, forward and backward; and a
    leaf split over ("data", "model") gathered by ``fsdp`` with its
    gradient collected in the moments' layout (cut over "data" on another
    dim).  Returns the largest error of each."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tensor as tp

    mesh = make_local_mesh(world, model_parallel)
    d, m = mesh.axis_size("data"), mesh.axis_size("model")
    dc, mc = mesh.coordinate("data"), mesh.coordinate("model")
    draw = lambda r, shape: torch.randn(shape, generator=torch.Generator().manual_seed(r), dtype=torch.float64)
    xs = [draw(r, (3, 8 * world, 5)) for r in range(world)]
    total = sum(xs)
    mine = xs[rank]
    errs = {}
    model_ranks = [dc * m + j for j in range(m)]  # this rank's "model" group, in coordinate order
    model_sum = sum(xs[r] for r in model_ranks)
    errs["reduce_scatter_model"] = float((tp.reduce_scatter(mine, mesh, "model", 1) - tp.rank_slice(model_sum, m, mc, 1)).abs().max())
    got = tp.reduce_scatter(mine, mesh, "model", 1, outer=2)
    errs["reduce_scatter_outer"] = float((got - tp.rank_slice(model_sum, m, mc, 1, outer=2)).abs().max())
    got = tp.reduce_scatter(mine, mesh, ("data", "model"), 1)
    errs["reduce_scatter_both"] = float((got - tp.rank_slice(total, world, dc * m + mc, 1)).abs().max())
    errs["all_gather_inverts"] = float((tp.all_gather(tp.rank_slice(mine, m, mc, 1), mesh, "model", 1)
                                        - torch.cat([tp.rank_slice(xs[r], m, j, 1) for j, r in enumerate(model_ranks)], 1)
                                        ).abs().max())
    # sequence moves in a tensor-parallel step of "tp_sp": enter gathers, leave sums and cuts
    with sh.activation_rules(sh.STRATEGIES["tp_sp"], mesh, tensor_parallel=True):
        x = tp.rank_slice(mine, m, mc, 1).clone().requires_grad_(True)
        y = tp.seq_enter(x)
        want_y = torch.cat([tp.rank_slice(xs[r], m, j, 1) for j, r in enumerate(model_ranks)], 1)
        errs["seq_enter"] = float((y - want_y).abs().max())
        z = tp.seq_leave(y * (mc + 1))
        want_z = tp.rank_slice(sum(want_y * (j + 1) for j in range(m)), m, mc, 1)
        errs["seq_leave"] = float((z - want_z).abs().max())
        g = draw(100 + rank, z.shape)
        z.backward(g)
        gs = [draw(100 + r, z.shape) for r in model_ranks]
        # d/dx: the leave's gradient gathered, times each rank's factor, summed over the ranks and cut
        want_gx = tp.rank_slice(sum(torch.cat(gs, 1) * (j + 1) for j in range(m)), m, mc, 1)
        errs["seq_backward"] = float((x.grad - want_gx).abs().max())
    # fsdp: a (8 world, 6) leaf over ("data", "model") on dim 0, its moments cut the same
    W = draw(7, (8 * world, 6))
    spec = (("data", "model"), None)
    shard = W[tuple(slice(*s) for s in [((dc * m + mc) * 8, (dc * m + mc + 1) * 8), (0, 6)])].clone()
    shards = tp.Shards(mesh, [shard], [spec], [spec])
    with sh.activation_rules(sh.STRATEGIES["fsdp"], mesh, tensor_parallel=True, shards=shards):
        w = tp.fsdp({"w": shard})["w"]
        want_w = torch.cat([W[(j * m + mc) * 8:(j * m + mc + 1) * 8] for j in range(d)])
        errs["fsdp_gather"] = float((w - want_w).abs().max())
        G = [draw(200 + r, w.shape) for r in range(world)]
        (w * G[rank]).sum().backward(inputs=[shards.token])
    [grad] = shards.grads()
    data_sum = sum(G[j * m + mc] for j in range(d))  # the gradient of this rank's "model" part, over "data"
    errs["fsdp_grad"] = float((grad - data_sum[dc * 8:(dc + 1) * 8]).abs().max())
    return errs


def reference_decode_worker(rank: int, world: int, model_parallel: int, payload: str) -> dict:
    """One decode step of each payload case on a (world / model_parallel,
    model_parallel) mesh under its strategy, from the whole weights cut to
    the rank's shards and the reference's whole prefill cache cut to the
    rank's (``shard_cache``): the global logits by case, on rank 0."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import STRATEGIES
    from repro_torch.train import step as step_lib

    mesh = make_local_mesh(world, model_parallel)
    out = {}
    for key, case in torch.load(payload, weights_only=False).items():
        model = Model(get_arch(case["arch"]).reduced().replace(**case["cut"]))
        name, overrides = case["strategy"]
        strategy = STRATEGIES[name].with_overrides(**overrides)
        batch = case["batch"]
        sh = step_lib.make_shardings(model, strategy, mesh, batch)
        params = step_lib.shard_tree(case["params"], sh.params, mesh)
        B = batch["tokens"].shape[0]
        cache = step_lib.shard_cache(model, case["cache"], B, case["cache_len"], strategy=strategy, mesh=mesh)
        out[key], _ = step_lib.make_decode_step(model, strategy=strategy, mesh=mesh)(params, cache, batch)
    return out if rank == 0 else {}


def mesh22_worker(rank: int, world: int, payload: str) -> dict:
    """``moves_worker`` and ``reference_decode_worker`` in one (2, 2) world."""
    return {"moves": moves_worker(rank, world, 2), "decode": reference_decode_worker(rank, world, 2, payload)}
