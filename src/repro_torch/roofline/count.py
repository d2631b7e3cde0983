"""A step's work for the roofline, counted from one eager run: flops, bytes
moved, collective bytes and live memory.

Counterpart of ``repro/roofline/hlo.py``.  The reference compiles its step
and reads the counts from XLA: ``cost_analysis`` for flops and bytes, the
HLO text for the collectives and for a fusion-aware HBM estimate.  The port
runs eagerly and has no HLO, so it counts what runs:

  * collectives: every move over "model" and every dp collective records
    (op, bytes a rank) in ``parallel/tensor.COLLECTIVES``;
    ``collective_stats`` reads it as the reference's ``CollectiveStats``;
  * flops: ``torch.utils.flop_counter.FlopCounterMode`` over the step's aten
    ops, plus each hand-written kernel's own count, which its meta route
    adds (``kernels/ops.py``; on meta tensors a kernel runs no aten op, so
    nothing is counted twice);
  * bytes: the operands' and results' bytes of every op that is neither a
    view nor an allocation, plus each kernel's own bytes.  An eager step
    writes every op's result to memory and reads its operands back, so the
    sum is also its HBM traffic estimate;
  * memory: the bytes of the storages the step allocates, live from their
    creation until their release; the peak is the step's temporaries.

The kernels' counts have one home here (``chip_smoke.py``'s bounds read
them): the multiply-adds over live (query, key) pairs, the scans' bytes and
operations, the GEMM's products.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.parallel import tensor as tp

# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=lambda: defaultdict(int))
    count_by_op: dict = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def row(self) -> dict:
        return {
            "collective_bytes": self.total_bytes,
            **{f"{k}_bytes": v for k, v in sorted(self.bytes_by_op.items())},
            **{f"{k}_count": v for k, v in sorted(self.count_by_op.items())},
        }


def collective_stats() -> CollectiveStats:
    """The collectives recorded since ``tp.COLLECTIVES.reset()``."""
    return CollectiveStats(dict(tp.COLLECTIVES.bytes_by_op), dict(tp.COLLECTIVES.count_by_op))


# ---------------------------------------------------------------------------
# The hand-written kernels' own counts: (flops, bytes) a call
# ---------------------------------------------------------------------------


def attention_live_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps: the work a call's shapes need."""
    qp = np.arange(Lq)
    hi = np.minimum(Lk, qp + 1) if causal else np.full(Lq, Lk)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(Lq, dtype=np.int64)
    return int(np.maximum(0, hi - lo).sum())


def attention_fwd(B, H, KV, Lq, Lk, hd, causal, window, item: int) -> tuple[float, float]:
    """The forward's two products (S and P V) over the live pairs; q, k, v
    read and o written once."""
    flops = 4 * B * H * attention_live_pairs(Lq, Lk, causal, window) * hd
    return float(flops), float(item * (2 * B * H * Lq * hd + 2 * B * KV * Lk * hd))


def attention_bwd(B, H, KV, Lq, Lk, hd, causal, window, item: int) -> tuple[float, float]:
    """2.5x the forward's multiply-adds over the live pairs (dV, dP, dQ, dK
    and the S recompute are five products against the forward's two); q, k,
    v, o, dO read and dq, dk, dv written once (the forward's LSE, 4 bytes a
    row against 4 hd a row of the rest, is left out)."""
    flops = 2.5 * 4 * B * H * attention_live_pairs(Lq, Lk, causal, window) * hd
    return float(flops), float(item * (4 * B * H * Lq * hd + 4 * B * KV * Lk * hd))


def selective_scan_fwd(B, ck, di, N, x_item: int) -> tuple[float, float]:
    """Per (step, channel, state) the discretisation, the state update and
    y's sum, ~6 fp32 operations; x (its dtype) and dt read, B, C, A and h0
    read, y and h_last written (fp32)."""
    elems = B * ck * di
    nbytes = x_item * elems + 4 * elems + 4 * (2 * B * ck * N + di * N + B * di * N) + 4 * (elems + B * di * N)
    return 6.0 * elems * N, float(nbytes)


def selective_scan_bwd(B, ck, di, N, x_item: int) -> tuple[float, float]:
    """x, dt and dy read and dx and ddt written, B and C read and dB and dC
    written, A read and dA written, h0 and dh_last read and dh0 written;
    ~20 fp32 operations a (step, channel, state) (the states again, the
    reverse step, the sums)."""
    elems = B * ck * di
    nbytes = 2 * x_item * elems + 4 * 3 * elems + 4 * 4 * B * ck * N + 4 * 2 * di * N + 4 * 3 * B * di * N
    return 20.0 * elems * N, float(nbytes)


def rglru_fwd(B, L, dr) -> tuple[float, float]:
    """An exp and a multiply-add a (step, channel); log_a, gx read and y
    written, h0 read and h_last written (fp32)."""
    return 3.0 * B * L * dr, 4.0 * (3 * B * L * dr + 2 * B * dr)


def rglru_bwd(B, L, dr) -> tuple[float, float]:
    """log_a, y, dy read and dlog_a, dgx written, h0 and dh_last read and
    dh0 written (fp32); ~6 operations an element."""
    return 6.0 * B * L * dr, 4.0 * (5 * B * L * dr + 3 * B * dr)


def gmm_fwd(E, C, D, F, item: int) -> tuple[float, float]:
    """2 E C D F; x and w read and y written once."""
    return 2.0 * E * C * D * F, float(item * E * (C * D + D * F + C * F))


def gmm_bwd(E, C, D, F, item: int, need_dx: bool = True, need_dw: bool = True) -> tuple[float, float]:
    """The gradients asked for, each the forward's products (2 E C D F):
    dx reads dy and w and writes dx; dw reads x and dy and writes dw; both
    together read dy once."""
    x, w, dy = E * C * D, E * D * F, E * C * F
    elems = dy + need_dx * (w + x) + need_dw * (x + w)
    return 2.0 * E * C * D * F * (need_dx + need_dw), float(item * elems)


KERNELS: dict[str, list] = defaultdict(lambda: [0.0, 0.0, 0])  # name -> [flops, bytes, calls]


def add_kernel(name: str, counts: tuple[float, float]) -> None:
    """A kernel call's (flops, bytes), added by its meta route."""
    entry = KERNELS[name]
    entry[0] += counts[0]
    entry[1] += counts[1]
    entry[2] += 1


# ---------------------------------------------------------------------------
# The step's aten ops: bytes and live storage
# ---------------------------------------------------------------------------

_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like",
                "new_zeros", "ones", "ones_like", "full", "full_like", "new_full", "scalar_tensor", "arange"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _OpCounter(TorchDispatchMode):
    """Bytes of every op that is not a view or an allocation, and the live
    and peak bytes of the storages allocated under it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _free(self, key, nbytes) -> None:
        self.live -= nbytes
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _ALLOCATIONS:
            self.bytes += _bytes(ins) + _bytes(outs)
        # a view or an in-place result shares an input's storage: allocated
        # before (by the step, or the step's arguments), not here
        shared = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in shared:
                continue
            self._seen.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, st.nbytes())
        return out


@dataclass
class StepCounts:
    flops: float  # aten ops' and kernels'
    bytes: float
    peak_temp_bytes: int  # the peak of the live storages the step allocated
    collectives: CollectiveStats
    kernels: dict  # name -> {"flops", "bytes", "calls"}


class count_step:
    """Context manager counting what runs under it (``StepCounts`` in
    ``.counts`` after it exits): aten flops, op bytes and live storage,
    the kernels' meta routes, and the collectives."""

    def __enter__(self):
        tp.COLLECTIVES.reset()
        KERNELS.clear()
        self._flops = FlopCounterMode(display=False)
        self._ops = _OpCounter()
        self._flops.__enter__()
        self._ops.__enter__()
        return self

    def __exit__(self, *exc):
        self._ops.__exit__(*exc)
        self._flops.__exit__(*exc)
        kernels = {k: {"flops": v[0], "bytes": v[1], "calls": v[2]} for k, v in sorted(KERNELS.items())}
        self.counts = StepCounts(
            flops=float(self._flops.get_total_flops()) + sum(v["flops"] for v in kernels.values()),
            bytes=float(self._ops.bytes) + sum(v["bytes"] for v in kernels.values()),
            peak_temp_bytes=int(self._ops.peak),
            collectives=collective_stats(),
            kernels=kernels,
        )
        return False
