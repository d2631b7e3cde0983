"""Training driver: data pipeline + train step + checkpoint/restart.

Counterpart of ``repro/launch/train.py``.  Runs on a CUDA device unless the
caller asks for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --steps 200 --ckpt-dir /tmp/ckpt --ckpt-every 50 --device cpu

  * restart-safe: resumes from the latest checkpoint; the data stream is
    indexed by step, so the token stream realigns exactly and a run
    restarted from step k takes the same steps as one that never stopped;
  * the async checkpointer snapshots the state to host memory at the save
    and writes it in the background, overlapping the next steps;
  * the prefetcher keeps batches ready on the device.

With ``--strategy`` (or in a ``torch.distributed`` world of more than one
rank, started by the caller: NCCL on the card, gloo on the CPU) the step runs
sharded over ``make_local_mesh(world size, --model-parallel)``, a ("data",
"model") mesh whose "model" axis is 1 unless ``--model-parallel N`` asks for
N (tensor parallelism, under every strategy; under "serve_2dtp" the "data"
axis cuts the weights too and every rank takes the whole batch), under the named strategy or
the config's default, as the reference's driver builds them
(``src/repro/launch/train.py:50-55``): each rank takes its shard of every
global batch (the whole batch under "serve_2dtp"), keeps its shards of the parameters and of AdamW's moments
(``train/step.py``), and checkpoints hold the global state, gathered and
written by rank 0.  The reference's driver
takes no gradient compression, and neither does this one
(``train/step.make_compressed_train_step`` is its own step).  Its
``--reduced`` is a ``store_true`` that defaults to True and cannot be turned
off except by ``--full``; here ``--reduced/--no-reduced`` (and ``--full``)
do both.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.distributed

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import STRATEGIES, default_strategy
from repro_torch.train import step as step_lib


def strategy_for(arch, strategy_name: Optional[str] = None):
    """The named strategy or the config's default; a moe config with fewer
    than 16 experts does not split them (``src/repro/launch/train.py:51-53``)."""
    strategy = STRATEGIES[strategy_name] if strategy_name else default_strategy(arch)
    if arch.family == "moe" and arch.n_experts < 16:
        strategy = strategy.with_overrides(experts=None)
    return strategy


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda') needs a CUDA device and none is visible; pass device='cpu'")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(
    arch_name: str,
    *,
    reduced: bool = True,
    steps: int = 100,
    seq_len: int = 64,
    global_batch: int = 8,
    peak_lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    strategy_name: Optional[str] = None,
    model_parallel: int = 1,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Train ``arch_name`` for ``steps`` steps (from the latest checkpoint
    under ``ckpt_dir`` when there is one).  Returns the reference's dict
    (first and final loss, params, opt) plus, per step taken here, its loss,
    grad norm, wall seconds (synchronized) and kernel launches forward and
    backward (``ops`` counts process-wide: run nothing else on the kernels
    meanwhile), and on a CUDA device the peak memory.  Sharded (a strategy
    named, or a world of several ranks), ``params`` and ``opt`` are this
    rank's shards; ``model_parallel`` ranks of the world form the "model"
    axis."""
    dev = _device(device)
    arch = get_arch(arch_name)
    if reduced:
        arch = arch.reduced()
    model = Model(arch)
    strategy = mesh = None
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if strategy_name is not None or world > 1:
        mesh = make_local_mesh(world, model_parallel)
        strategy = strategy_for(arch, strategy_name)
    opt_cfg = adamw.AdamWConfig(peak_lr=peak_lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    train_step = step_lib.make_train_step(model, opt_cfg, strategy=strategy, mesh=mesh)

    dc = DataConfig(
        vocab_size=arch.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, enc_len=arch.enc_len_train, d_model=arch.d_model,
        n_img_tokens=arch.n_img_tokens, family=arch.family,
    )

    start_step = 0
    params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(seed), dev)
    checkpointer = None
    if ckpt_dir:
        checkpointer = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            start_step, restored = ckpt_lib.restore(ckpt_dir, {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            print(f"resumed from step {start_step}")
    if mesh is not None:  # every rank drew (or restored) the global state; keep its shards
        shardings = step_lib.make_shardings(model, strategy, mesh, {})
        params, opt = step_lib.shard_tree(params, shardings.params, mesh), step_lib.shard_tree(opt, shardings.opt, mesh)

    def global_state():
        if mesh is None:
            return {"params": params, "opt": opt}
        return {"params": step_lib.gather_tree(params, shardings.params, mesh),
                "opt": step_lib.gather_tree(opt, shardings.opt, mesh)}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prefetch = Prefetcher(dc, start_step=start_step, depth=2, device=dev)
    losses, grad_norms, step_s, launches, backward_launches = [], [], [], [], []
    t0 = time.perf_counter()
    try:
        for _ in range(start_step, steps):
            step_idx, batch = next(prefetch)
            fwd, bwd = ops.launch_counts(), ops.backward_launch_counts()
            _sync(dev)
            ts = time.perf_counter()
            params, opt, metrics = train_step(params, opt, batch)
            loss = float(metrics["loss"])  # waits for the step
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
            launches.append({k: n - fwd[k] for k, n in ops.launch_counts().items()})
            backward_launches.append({k: n - bwd[k] for k, n in ops.backward_launch_counts().items()})
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if log_every and (step_idx + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / max(len(losses), 1)
                print(f"step {step_idx + 1:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} ({dt*1e3:.0f} ms/step)")
            if checkpointer and (step_idx + 1) % ckpt_every == 0:
                state = global_state()  # a collective when sharded: every rank gathers
                if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
                    checkpointer.save(step_idx + 1, state)
    finally:
        prefetch.close()
        if checkpointer:
            checkpointer.wait()
    return {
        "arch": arch_name,
        "steps": len(losses),
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "grad_norms": grad_norms,
        "step_s": step_s,
        "launches": launches,
        "backward_launches": backward_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "device": str(dev),
        "params": params,
        "opt": opt,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--model-parallel", type=int, default=1, help="ranks of the 'model' axis (every strategy)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(
        args.arch, reduced=args.reduced, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, peak_lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, strategy_name=args.strategy, model_parallel=args.model_parallel,
        device=args.device,
    )
    print(f"done: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
