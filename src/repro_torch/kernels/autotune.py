"""Roofline-driven kernel autotuner, with Hopper's cost model.

Counterpart of ``repro/kernels/autotune.py``.  Sweeps the block configs of
every registered kernel per (device, problem shape), prunes the sweep with a
roofline cost model before any candidate runs, times the survivors (warm-up
+ min-of-N), and caches each winner as a *replicated dataset* in the
broker's staging registry -- so tuned configs flow through data-gravity
placement and survive site death exactly like any other artifact.

Pruning (the "provably dominated" rule)
---------------------------------------
Every admissible config computes the same result, so under the model
``t = max(flops/peak(dtype), hbm_bytes/bw) + grid_cells * cell_overhead`` a
config A cannot beat a config B whose FLOPs, HBM traffic AND grid-cell count
(``registry.TileCost``) are all <= A's, with one strictly smaller.  The
sweep keeps only:

  1. configs whose tiles fit one block's shared memory: the H100 grants a
     block at most 227 KB (232448 bytes) when it opts in, and
  2. the Pareto frontier of (flops, hbm_bytes, grid_cells) among those.

The peaks are the H100 SXM data sheet's (dense, no sparsity): 989e12
operations/s in bf16 on the tensor cores, 67e12 in fp32, and 3.35e12 bytes/s
of HBM3.  ``chip_smoke.py`` reads its roofline bound from the same constants.

Cache keys and determinism
--------------------------
Winners key as ``tune:<kernel>:<device type>:<shape-sig>``, the device type
being the broker's (``cuda`` or ``cpu``), so a cache never serves another
device kind, and the port's keys never meet the reference's (``tpu`` /
``cpu`` from JAX's backend).  The cached payload is canonical JSON of the
*choice* -- never the timings -- so identically seeded runs give
byte-identical payloads.  A cache hit returns the stored result without
re-timing and without emitting ``kernel.tune``.

Timers: ``timer="wall"`` (default) runs the candidates on the tuner's device:
CUDA events on a CUDA device, ``perf_counter`` around the call on the CPU
(where the wrappers run the plain versions).  The hand kernels keep only the
reference's block divisibility rule and pick their own tiles, so configs that
share a ``KernelDef.launch_key`` are one launch: the sweep times one
candidate per key and gives its time to every config sharing it, and ties
keep the canonical-order first.  ``timer="model"`` scores by the expression
above, fully deterministic.

``ops.py`` and the kernel-task runtime consult the process-global tuner
(:func:`tuned_config`) only when ``HYDRA_AUTOTUNE=1``; with the gate off they
use the kernels' committed defaults.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.kernels import registry as kreg

# H100 SXM data sheet, dense: HBM3 bytes/s and peak operations/s by dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# the most shared memory one block may opt in to on sm_90 (227 KB)
SMEM_BUDGET_BYTES = 232448

# modeled price of one grid cell (one block) for timer="model".  Not a
# measurement: the value only shifts modeled times; what matters is that
# cells are priced at all, so the model prefers fewer blocks when FLOPs and
# traffic tie.
MODEL_CELL_OVERHEAD_S = 1e-6

PAYLOAD_VERSION = 1


def autotune_enabled() -> bool:
    """The ``HYDRA_AUTOTUNE=1`` gate consulted by kernels/ops.py."""
    return os.environ.get("HYDRA_AUTOTUNE", "") not in ("", "0")


def device_kind(device="cuda") -> str:
    """The device type a tune key names: ``cuda`` or ``cpu``."""
    return torch.device(device).type


@dataclass
class TuneResult:
    kernel: str
    device: str
    sig: str
    key: str
    config: dict
    exhaustive: int  # full sweep-space size
    swept: int  # survivors scored
    pruned: int  # exhaustive - swept
    best_s: float  # winner's min-of-N (or modeled) seconds
    timings: dict = field(default_factory=dict)  # config sig -> seconds
    cached: bool = False  # True on cache hits (no re-timing happened)

    @property
    def sweep_cut(self) -> float:
        return self.exhaustive / self.swept if self.swept else float("inf")


class Autotuner:
    """Sweep, prune, time, cache.  One per broker (``Hydra.
    enable_kernel_autotune``) or process-global for bare ops calls."""

    def __init__(
        self,
        *,
        registry=None,  # staging DatasetRegistry (winners become datasets)
        events=None,  # EventBus (kernel.tune on cache misses)
        seed: int = 0,
        reps: int = 3,
        warmup: int = 1,
        timer: str = "wall",
        smem_budget: int = SMEM_BUDGET_BYTES,
        device="cuda",
    ):
        assert timer in ("wall", "model"), timer
        self.registry = registry
        self.events = events
        self.seed = seed
        self.reps = reps
        self.warmup = warmup
        self.timer = timer
        self.smem_budget = smem_budget
        self.device = torch.device(device)
        self._results: dict = {}  # cache key -> TuneResult
        self._payloads: dict = {}  # cache key -> bytes
        self._lock = threading.RLock()
        # legacy accumulators (HYDRA_EVENTS_CHECK ground truth, mirrored by
        # broker._events_recompute when this tuner is broker-attached)
        self.tunes = 0
        self.swept_configs = 0

    # -- keys ----------------------------------------------------------
    def cache_key(self, kernel: str, shape: dict, dtype: str, device: Optional[str] = None) -> str:
        device = device or device_kind(self.device)
        return f"tune:{kernel}:{device}:{kreg.shape_sig(shape, dtype)}"

    # -- pruning -------------------------------------------------------
    def prune(self, kernel: str, shape: dict, dtype: str = "float32"):
        """Returns ``(survivors, exhaustive_n)`` where survivors is the
        shared-memory-admissible Pareto frontier of (flops, hbm_bytes,
        grid_cells), in sweep-space order."""
        kdef = kreg.get_kernel(kernel)
        space = kdef.space(shape)
        exhaustive = len(space)
        costed = [(cfg, kdef.tile_cost(shape, cfg, dtype)) for cfg in space]
        fits = [(cfg, c) for cfg, c in costed if c.smem_bytes <= self.smem_budget]
        if not fits:
            # every candidate over budget: the kernel defaults, not an empty sweep
            return [kdef.defaults(shape)], exhaustive

        def dominated(ci: kreg.TileCost) -> bool:
            for _, cj in fits:
                if cj is ci:
                    continue
                if (
                    cj.flops <= ci.flops
                    and cj.hbm_bytes <= ci.hbm_bytes
                    and cj.grid_cells <= ci.grid_cells
                    and (
                        cj.flops < ci.flops
                        or cj.hbm_bytes < ci.hbm_bytes
                        or cj.grid_cells < ci.grid_cells
                    )
                ):
                    return True
            return False

        survivors = [cfg for cfg, c in fits if not dominated(c)]
        return survivors, exhaustive

    # -- timing --------------------------------------------------------
    def _time_wall(self, thunk: Callable[[], object]) -> float:
        """Min of ``reps`` single-call seconds after ``warmup`` calls."""
        on_card = self.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(self.device)

        for _ in range(self.warmup):
            thunk()
        sync()
        best = float("inf")
        for _ in range(self.reps):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                thunk()
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                thunk()
                sync()
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    @staticmethod
    def model_time_s(cost: kreg.TileCost, dtype: str = "float32") -> float:
        """Roofline-modeled seconds: max(compute, memory) + cell tax."""
        return (
            max(cost.flops / PEAK_OPS_PER_S[dtype], cost.hbm_bytes / HBM_BYTES_PER_S)
            + cost.grid_cells * MODEL_CELL_OVERHEAD_S
        )

    # -- the sweep -----------------------------------------------------
    def tune(self, kernel: str, shape: dict, dtype: str = "float32") -> TuneResult:
        """Sweep (or cache-hit) the winning config for one problem.

        Coarse-grained lock: tuning is rare and cache lookups from task
        threads are cheap; holding the lock across the sweep also keeps
        the cache-miss event count exact (one ``kernel.tune`` per key)."""
        with self._lock:
            key = self.cache_key(kernel, shape, dtype)
            hit = self._results.get(key)
            if hit is not None:
                return TuneResult(**{**vars(hit), "cached": True})
            kdef = kreg.get_kernel(kernel)
            survivors, exhaustive = self.prune(kernel, shape, dtype)
            args = None
            if self.timer == "wall":
                args = kdef.make_args(shape, dtype, self.seed, self.device)
            best_cfg, best_s, timings = None, float("inf"), {}
            by_launch: dict = {}  # launch key -> seconds
            for cfg in survivors:
                if self.timer == "wall":
                    lk = kdef.launch_key(shape, cfg, dtype)
                    if lk not in by_launch:
                        by_launch[lk] = self._time_wall(lambda: kdef.call(shape, args, cfg))
                    t = by_launch[lk]
                else:
                    t = self.model_time_s(kdef.tile_cost(shape, cfg, dtype), dtype)
                timings[kreg.config_sig(cfg)] = t
                # strict < : ties keep the earlier (canonical-order) config
                if t < best_s:
                    best_cfg, best_s = cfg, t
            result = TuneResult(
                kernel=kernel,
                device=key.split(":")[2],
                sig=kreg.shape_sig(shape, dtype),
                key=key,
                config=dict(best_cfg),
                exhaustive=exhaustive,
                swept=len(survivors),
                pruned=exhaustive - len(survivors),
                best_s=best_s,
                timings=timings,
            )
            payload = self._payload_bytes(result, shape, dtype)
            self._results[key] = result
            self._payloads[key] = payload
            self._register_dataset(key, payload)
            self.tunes += 1
            self.swept_configs += result.swept
            if self.events is not None:
                self.events.emit(
                    "kernel.tune",
                    kernel=kernel,
                    sig=result.sig,
                    config=kreg.config_sig(result.config),
                    swept=result.swept,
                    exhaustive=exhaustive,
                )
            return result

    def _payload_bytes(self, result: TuneResult, shape: dict, dtype: str) -> bytes:
        # choice only, never timings: byte-identical across same-seed runs
        doc = {
            "version": PAYLOAD_VERSION,
            "kernel": result.kernel,
            "device": result.device,
            "dtype": dtype,
            "shape": {k: shape[k] for k in sorted(shape)},
            "sig": result.sig,
            "config": result.config,
            "exhaustive": result.exhaustive,
            "swept": result.swept,
            "pruned": result.pruned,
            "seed": self.seed,
            "reps": self.reps,
            "timer": self.timer,
        }
        return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()

    def _register_dataset(self, key: str, payload: bytes) -> None:
        if self.registry is None:
            return
        from repro_torch.core.staging import SHARED_SITE

        # pinned shared-store replica: a tuned config is authoritative
        # metadata, never LRU-evicted, and survives any one site's death
        self.registry.add(
            key, size_mb=max(len(payload) / 1e6, 1e-6),
            sites=(SHARED_SITE,), pinned=True,
        )

    # -- consultation (the ops.py fast path) ---------------------------
    def lookup(
        self, kernel: str, shape: dict, dtype: str = "float32", device: Optional[str] = None
    ) -> Optional[dict]:
        """Cached winner for this problem on ``device`` (a device type;
        default the tuner's), or None (caller uses defaults).  Never
        triggers a sweep: the dispatch fast path must stay cheap."""
        with self._lock:
            hit = self._results.get(self.cache_key(kernel, shape, dtype, device))
            return dict(hit.config) if hit is not None else None

    def payload(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._payloads.get(key)

    def results(self) -> dict:
        with self._lock:
            return dict(self._results)

    def stats(self) -> dict:
        with self._lock:
            return {"tunes": self.tunes, "swept_configs": self.swept_configs}


# ---------------------------------------------------------------------------
# process-global tuner (bare ops.py calls outside any broker)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Autotuner] = None
_GLOBAL_LOCK = threading.Lock()


def get_autotuner() -> Autotuner:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Autotuner()
        return _GLOBAL


def set_autotuner(tuner: Optional[Autotuner]) -> None:
    """Install (or clear, with None) the process-global tuner consulted by
    kernels/ops.py under HYDRA_AUTOTUNE=1."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = tuner


def unset_autotuner(tuner: Autotuner) -> None:
    """Clear the global slot only if ``tuner`` still owns it (broker
    shutdown must not clobber a successor broker's tuner)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is tuner:
            _GLOBAL = None


def tuned_config(
    kernel: str, shape: dict, dtype: str = "float32", device: Optional[str] = None
) -> Optional[dict]:
    """Env-gated cache consultation for the ops.py entry points: None when
    the gate is off or the problem was never tuned for ``device`` (a device
    type; default the tuner's)."""
    if not autotune_enabled():
        return None
    return get_autotuner().lookup(kernel, shape, dtype, device)


def predict_best(kernel: str, shape: dict, dtype: str = "float32") -> dict:
    """Pure-model prediction (no execution): the config the roofline picks
    plus its predicted intensity."""
    tuner = Autotuner(timer="model")
    kdef = kreg.get_kernel(kernel)
    survivors, exhaustive = tuner.prune(kernel, shape, dtype)
    best_cfg, best_t = None, float("inf")
    for cfg in survivors:
        t = tuner.model_time_s(kdef.tile_cost(shape, cfg, dtype), dtype)
        if t < best_t:
            best_cfg, best_t = cfg, t
    cost = kdef.tile_cost(shape, best_cfg, dtype)
    return {
        "kernel": kernel,
        "sig": kreg.shape_sig(shape, dtype),
        "config": kreg.config_sig(best_cfg),
        "swept": len(survivors),
        "exhaustive": exhaustive,
        "intensity_flops_per_byte": round(cost.intensity, 3),
        "t_model_s": best_t,
    }


__all__ = [
    "HBM_BYTES_PER_S",
    "PEAK_OPS_PER_S",
    "SMEM_BUDGET_BYTES",
    "TuneResult",
    "Autotuner",
    "autotune_enabled",
    "device_kind",
    "get_autotuner",
    "set_autotuner",
    "unset_autotuner",
    "tuned_config",
    "predict_best",
]
