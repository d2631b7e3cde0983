#!/usr/bin/env python3
"""Device time of the port's selective-scan backward
(``csrc/selective_scan_bwd.cu``) at falcon-mamba-7b's chunk, on one NVIDIA
GPU.

    python3 scripts/selective_bwd_timing.py [--src DIR] [--variants a,b,...]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two commits can be timed on one card: unpack the
other with ``git archive`` under ``build/`` and give its ``src``, and run
the two in turns (parent, this, this, parent).  Each case prints one
``timing`` line of JSON: chip_smoke.py's SS_BWD_WIDTH (B 1, chunk 256, di
8192, N 16) with fp32 and with bf16 x, the error against the plain version
relative to each gradient's largest element, the median device time
(``ms``, chip_smoke.py's spin-kernel timing), the bound
(``selective_bwd_bound``) and, where the tree has it, the launch's parts and
occupancy (``selective_scan.bwd_launch_config``).

``--variants`` times diagnostic builds of this checkout's kernel as well,
each compiled with its own flags into a library of its own (never the one
the port loads); the names are those of ``VARIANTS``: ``pass_a`` (the
forward pass over each part and the fold alone) and ``pass_b`` (the
recompute and the reverse walk alone, on whatever the scratch holds).
Both skip the sums' launch and give no gradients, so their lines carry no
error.  Set-up prints the card line.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = {
    "pass_a": ("-DSSB_PHASES=1",),
    "pass_b": ("-DSSB_PHASES=2",),
}


def build_variants(_build, names: list) -> dict:
    """Compile each variant of csrc/selective_scan_bwd.cu with its flags,
    one nvcc each, all started together.  Returns name -> flags."""
    base = tuple(_build.NVCC_FLAGS)
    procs = []
    for name in names:
        flags = base + VARIANTS[name]
        _build.NVCC_FLAGS = flags
        out = _build.library_path("selective_scan_bwd")
        _build.NVCC_FLAGS = base
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc(), *flags, "-o", str(out), str(_build.CSRC / "selective_scan_bwd.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        for usage in _build.ptxas_usage(log):
            print(f"ptxas variant={name} " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)
    return {name: base + VARIANTS[name] for name in names}


def use_flags(_build, flags) -> None:
    """Make the next call of the backward load the library built with ``flags``."""
    _build.NVCC_FLAGS = tuple(flags)
    _build._LIBS.pop("selective_scan_bwd", None)
    for key in [k for k in _build._FUNCS if k[0] == "selective_scan_bwd"]:
        del _build._FUNCS[key]


def time_width(torch, cs, ops, dev, label: str, errors: bool) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    _, *width = cs.SS_BWD_WIDTH
    for dtype in ("float32", "bfloat16"):
        operands = cs.selective_bwd_operands(torch, dev, *width, dtype, seed=15)
        run = lambda: ops.selective_scan_chunk_bwd(*operands)
        got = run()
        torch.cuda.synchronize()
        row = {"kernel": "selective_scan_bwd", "tree": label, "case": cs.SS_BWD_WIDTH[0], "dtype": dtype}
        if errors:
            want = ref.selective_scan_chunk_bwd_ref(*operands)
            row["rel_err"] = [float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, want)]
            del want
        if hasattr(ss, "bwd_launch_config"):
            row.update(ss.bwd_launch_config(*width, getattr(torch, dtype), dev))
        row["ms"] = cs.median_ms(torch, run)
        row.update(cs.selective_bwd_bound(*width, 2 if dtype == "bfloat16" else 4))
        print("timing " + json.dumps(row), flush=True)
        del operands, got
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--variants", default="", help="comma-separated names of VARIANTS to time as well")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("selective_bwd_timing: no CUDA device is visible", file=sys.stderr)
        return 2
    names = [v for v in args.variants.split(",") if v]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"selective_bwd_timing: no variant {unknown}; known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    print(f"card {cs.card_line()} src={os.path.relpath(args.src, ROOT)}", flush=True)
    dev = torch.device("cuda", 0)
    base = tuple(_build.NVCC_FLAGS)
    time_width(torch, cs, ops, dev, "tree", errors=True)
    for usage in _build.ptxas_usage(_build.BUILD_LOGS.get("selective_scan_bwd", "")):
        print("ptxas tree " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)
    for name, flags in build_variants(_build, names).items():
        use_flags(_build, flags)
        time_width(torch, cs, ops, dev, name, errors=False)
    use_flags(_build, base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
