"""Traffic builders: the paper's heterogeneous mix as Workflow DAGs.

Counterpart of ``repro/scenarios/traffic.py``, copied with its imports
rewritten.

Three shapes share one brokered fleet, mirroring the repo's real drivers
while staying cheap enough to run thousands of instances under VirtualClock:

  facts_ensemble   the FACTS sea-rise DAG (pre -> fit -> project -> post)
                   with the REAL data footprints from facts/workflow.py —
                   the 2 GB pinned forcing input and the per-stage output
                   sizes — but modeled (sleep) runtimes, so a ≥1k-member
                   ensemble executes in virtual seconds.
  train_traffic    launch/train.py's restart-safe loop: checkpoint-delimited
                   step blocks, each block consuming the previous block's
                   checkpoint dataset (ckpt/checkpoint.py semantics) and a
                   shared pinned corpus.
  serve_traffic    launch/serve.py's shape: waves of short independent
                   requests, each reading one pinned model snapshot.

Every dataset name is parameterized by the scenario name, so twin runs
(chaos vs no-chaos) inside one process never collide in a shared registry —
each run builds its own broker/registry anyway; the prefix keeps traces
legible."""
from __future__ import annotations

from repro_torch.core.managers.workflow import Workflow
from repro_torch.core.task import Resources, Task
from repro_torch.facts.workflow import FORCING_DATASET, STAGE_MB, register_forcing

TRAIN_CORPUS_MB = 4096.0
TRAIN_CKPT_MB = 512.0
SERVE_SNAPSHOT_MB = 1024.0


def facts_ensemble(
    registry,
    n_members: int,
    durations: tuple = (2.0, 1.0, 3.0, 0.5),
    prefix: str = "searise",
) -> list[Workflow]:
    """``n_members`` FACTS instances with real footprints, modeled runtimes."""
    register_forcing(registry)
    pre_s, fit_s, proj_s, post_s = durations
    res = Resources(cpus=1, memory_mb=2048)
    # multi-tenant front door: the ensemble is throughput work — a "facts"
    # batch lane the serve tenant's interactive lane preempts in the queue
    lane = dict(tenant="facts", slo_class="batch")
    wfs = []
    for i in range(n_members):
        wf = Workflow(f"{prefix}.facts.{i:05d}")
        base = f"{prefix}/facts/{i:05d}"
        pre = wf.add(
            Task(
                "sleep",
                duration=pre_s,
                resources=res,
                inputs=[FORCING_DATASET],
                outputs={f"{base}/pre": STAGE_MB["pre"]},
                **lane,
            )
        )
        fit = wf.add(
            Task(
                "sleep",
                duration=fit_s,
                resources=res,
                inputs=[f"{base}/pre"],
                outputs={f"{base}/fit": STAGE_MB["fit"]},
                **lane,
            ),
            deps=[pre],
        )
        proj = wf.add(
            Task(
                "sleep",
                duration=proj_s,
                resources=res,
                inputs=[f"{base}/pre", f"{base}/fit"],
                outputs={f"{base}/proj": STAGE_MB["proj"]},
                **lane,
            ),
            deps=[fit],
        )
        wf.add(
            Task(
                "sleep",
                duration=post_s,
                resources=res,
                inputs=[f"{base}/proj"],
                outputs={f"{base}/result": STAGE_MB["result"]},
                **lane,
            ),
            deps=[proj],
        )
        wfs.append(wf)
    return wfs


def train_traffic(
    registry,
    n_jobs: int,
    n_blocks: int = 3,
    block_s: float = 6.0,
    prefix: str = "searise",
) -> list[Workflow]:
    """Checkpoint-delimited training jobs: block k reads ckpt k-1."""
    corpus = f"{prefix}/train/corpus"
    registry.add(corpus, TRAIN_CORPUS_MB, sites=["shared"], pinned=True)
    res = Resources(cpus=4, memory_mb=8192)
    lane = dict(tenant="train", slo_class="batch")
    wfs = []
    for j in range(n_jobs):
        wf = Workflow(f"{prefix}.train.{j:03d}")
        prev_task, prev_ckpt = None, None
        for k in range(n_blocks):
            inputs = [corpus] if prev_ckpt is None else [corpus, prev_ckpt]
            ckpt = f"{prefix}/train/{j:03d}/ckpt-{k + 1}"
            t = wf.add(
                Task(
                    "sleep",
                    duration=block_s,
                    resources=res,
                    inputs=inputs,
                    outputs={ckpt: TRAIN_CKPT_MB},
                    **lane,
                ),
                deps=[prev_task] if prev_task is not None else None,
            )
            prev_task, prev_ckpt = t, ckpt
        wfs.append(wf)
    return wfs


def serve_traffic(
    registry,
    n_waves: int,
    tasks_per_wave: int = 8,
    task_s: float = 0.5,
    prefix: str = "searise",
    kernels: tuple = (),
    kernel_reps: int = 1,
) -> list[Workflow]:
    """Waves of short independent requests against one pinned snapshot.

    With ``kernels`` non-empty the wave tasks carry REAL compute: each is a
    ``kind="kernel"`` payload (managers/compute.py KernelRuntime) cycling
    through the named kernels at their registry tiny shapes — the paper's
    heterogeneous-workload claim exercised with actual kernel calls instead
    of modeled sleeps.  The snapshot input still gates placement, so kernel
    requests obey data gravity exactly like the sleep-shaped ones."""
    snapshot = f"{prefix}/serve/model-snapshot"
    registry.add(snapshot, SERVE_SNAPSHOT_MB, sites=["shared"], pinned=True)
    # the latency-sensitive tenant: interactive requests preempt queued
    # batch backfill in the dispatcher's lanes
    lane = dict(tenant="serve", slo_class="interactive")
    res = Resources(cpus=1, memory_mb=1024)
    wfs = []
    i = 0
    for w in range(n_waves):
        wf = Workflow(f"{prefix}.serve.{w:03d}")
        for _ in range(tasks_per_wave):
            if kernels:
                wf.add(
                    Task(
                        "kernel",
                        payload={
                            "kernel": kernels[i % len(kernels)],
                            "reps": kernel_reps,
                            "seed": i,
                        },
                        resources=res,
                        inputs=[snapshot],
                        **lane,
                    )
                )
                i += 1
            else:
                wf.add(
                    Task(
                        "sleep",
                        duration=task_s,
                        resources=res,
                        inputs=[snapshot],
                        **lane,
                    )
                )
        wfs.append(wf)
    return wfs


def build_traffic(registry, traffic, prefix: str = "searise") -> list[Workflow]:
    """One TrafficSpec -> the full workflow list (FACTS + train + serve)."""
    wfs: list[Workflow] = []
    if traffic.facts_members:
        wfs += facts_ensemble(
            registry,
            traffic.facts_members,
            durations=tuple(traffic.facts_durations),
            prefix=prefix,
        )
    if traffic.train_jobs:
        wfs += train_traffic(
            registry,
            traffic.train_jobs,
            n_blocks=traffic.train_blocks,
            block_s=traffic.train_block_s,
            prefix=prefix,
        )
    if traffic.serve_waves:
        wfs += serve_traffic(
            registry,
            traffic.serve_waves,
            tasks_per_wave=traffic.serve_tasks_per_wave,
            task_s=traffic.serve_task_s,
            kernels=tuple(traffic.serve_kernels),
            kernel_reps=traffic.serve_kernel_reps,
            prefix=prefix,
        )
    return wfs
