"""Three-term roofline of a dry-run cell, at the H100's data-sheet figures.

Counterpart of ``repro/roofline/model.py``: the same ``Roofline`` (every
property and ``row()`` key) and ``model_flops``, with the TPU v5e's
constants replaced by an NVIDIA H100 SXM's, as its data sheet states them
(not measured, and with no power limit attached):

    peak bf16 compute : 989 TFLOP/s per GPU (dense tensor cores)
    HBM3 bandwidth    : 3.35 TB/s per GPU
    link bandwidth    : 50 GB/s per GPU: one ConnectX-7 port at 400 Gb/s
                        (InfiniBand NDR), one a GPU in a DGX H100

NVLink 4 gives each GPU 450 GB/s a direction to the seven others of its
8-GPU node, but the production meshes' 16-wide "model" axis spans two such
nodes, so each of its collectives crosses the InfiniBand links too, and the
slower link bounds the step: the collective term prices every byte at
``LINK_BW``, as the reference prices every byte at one ICI link.

Terms (seconds, per step):
    compute    = flops_per_chip / peak
    memory     = bytes_per_chip / hbm_bw
    collective = collective_bytes_per_chip / link_bw

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per train step
(2x forward-only for serve steps); the ratio MODEL_FLOPS / counted flops
exposes remat and redundant work.  The per-chip counts come from the port's
eager step (``roofline/count.py``, ``launch/dryrun.py``), not from HLO.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_total: float
    hbm_bytes_est_per_chip: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def t_memory_est(self) -> float:
        """The HBM-traffic estimate (``roofline/count.py``): for an eager
        step every op's operands and result cross HBM, so it equals the
        counted bytes (t_memory) unless the caller gives another."""
        return self.hbm_bytes_est_per_chip / HBM_BW

    @property
    def bottleneck_est(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory_est,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_est(self) -> float:
        return max(self.t_compute, self.t_memory_est, self.t_collective)

    @property
    def mfu_est(self) -> float:
        """MODEL_FLOPS / (chips * peak * step_est): the roofline fraction with
        the fusion-aware memory term."""
        denom = self.n_chips * PEAK_FLOPS * self.step_time_est
        return self.model_flops_total / denom if denom else 0.0

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap model: step >= max(terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted flops across all chips)."""
        total = self.flops_per_chip * self.n_chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """MODEL_FLOPS / (chips * peak * step_lower_bound): the roofline
        fraction achievable if the step ran exactly at its dominant term."""
        denom = self.n_chips * PEAK_FLOPS * self.step_time_lower_bound
        return self.model_flops_total / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.n_chips,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "t_memory_est_s": round(self.t_memory_est, 6),
            "bottleneck": self.bottleneck,
            "bottleneck_est": self.bottleneck_est,
            "model_flops": f"{self.model_flops_total:.3e}",
            "hlo_flops_per_chip": f"{self.flops_per_chip:.3e}",  # the reference's key: here the counted flops
            "useful_flops_frac": round(self.useful_flops_fraction, 4),
            "mfu_upper_bound": round(self.mfu_upper_bound, 4),
            "mfu_est": round(self.mfu_est, 4),
        }


def model_flops(arch, shape) -> float:
    """6*N*D train / 2*N*D forward-only, with N = active params (MoE-aware)."""
    n_active = arch.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
