#!/usr/bin/env python3
"""Device time of variants of the persistent bf16 GEMM backward
(``csrc/gmm.cuh``, ``gmm_wgmma_persistent``) against this tree's kernels
and, where given, another commit's, on one NVIDIA GPU.

    python3 scripts/gemm_bwd_variants.py [--parent DIR] [--variants a,b,...] [--once]

Each variant is this tree's ``src`` copied under ``build/gemm_bwd_variants/``
with an edit of ``csrc/gmm.cuh`` or ``csrc/moe_gmm_bwd.cu`` (``VARIANTS``:
text replaced, each match counted).  Each tree is timed by ``scripts/gemm_timing.py --backward-only
--dtype bfloat16 --src <tree>`` in its own process (dx and dw, whole and
each alone, at grok-1's and arctic-480b's expert shapes), in the order
parent, this tree, the variants, the variants again in reverse, this tree,
parent, so that drift on the card shows as a difference between the two
runs of one tree (``--once``: each variant once, between the runs of this
tree and the parent's).  ``--parent`` is the ``src`` of another commit (``git
archive`` unpacked under ``build/``).  Each output line is the tree's name
and ``gemm_timing.py``'s ``timing`` JSON.  ``no_store`` and ``no_mma``
and ``no_load`` compute wrong gradients: they time the kernel without its
stores, its products or its loads, to show which of them bounds it.
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("repro_torch/kernels/csrc")
GMM, BWD = CSRC / "gmm.cuh", CSRC / "moe_gmm_bwd.cu"

_MMA = """        mma_slice<A_MN, B_MN, D>(acc, a_base + s * SA, b_base + s * SB);
        hopper::wgmma_wait<1>();  // the group of slice it - 1 has finished"""
_TILE = "const int m0 = (tile % n_m) * BM, n0 = ((tile / n_m) % n_n) * BN, e = tile / (n_m * n_n);"
_STORE = "hopper::tma_store_3d_hint(omap, stg + wg * STG_WG + c * OUT_BOX, col + 64 * c, row, e, once);"
_LOAD = "load_slice<A_MN, B_MN, D, true>(amap, bmap, As + s * SA, Bs + s * SB, &full[s], kb, m0, n0, e, keep);"
_DX, _DW = "DX_STAGES = 3, DX_STG_COLS = 256", "DW_STAGES = 3, DW_STG_COLS = 256"

# name -> [(file, text, replacement, matches expected)]
VARIANTS = {
    # four stages beside half the staging (the epilogue in two passes of 128
    # columns), for dx or dw; two stages beside the whole staging, for both
    "dx_stages4": [(BWD, _DX, "DX_STAGES = 4, DX_STG_COLS = 128", 1)],
    "dw_stages4": [(BWD, _DW, "DW_STAGES = 4, DW_STG_COLS = 128", 1)],
    "stages2": [(BWD, _DX, "DX_STAGES = 2, DX_STG_COLS = 256", 1), (BWD, _DW, "DW_STAGES = 2, DW_STG_COLS = 256", 1)],
    # dw in two 64-deep slices where C is 65 to 96 too
    "no_short_k": [(BWD, "C > tc::BK && C <= DW_SHORT_K ?", "false ?", 1)],
    # N tiles fastest: the blocks in flight write whole rows of out
    "n_fastest": [(GMM, _TILE, "const int n0 = (tile % n_n) * BN, m0 = ((tile / n_n) % n_m) * BM, e = tile / (n_m * n_n);", 2)],
    # the last, short slice runs only the k16 steps that hold depths below K
    "trim_k": [(GMM, _MMA, """        if (K - kb * D >= D) {
          mma_slice<A_MN, B_MN, D>(acc, a_base + s * SA, b_base + s * SB);
        } else {
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            if (kk * 16 >= K - kb * D) break;
            const uint32_t a = a_base + s * SA, b = b_base + s * SB;
            const uint64_t da = A_MN ? hopper::make_desc<128>(a + kk * 16 * 128, D * 128, 1024)
                                     : hopper::make_desc<128>(a + kk * 32, 16, 1024);
            const uint64_t db = B_MN ? hopper::make_desc<128>(b + kk * 16 * 128, D * 128, 1024)
                                     : hopper::make_desc<128>(b + kk * 32, 16, 1024);
            hopper::WgmmaSS<BN, B_MN, A_MN>::run(acc, da, db, 1);
          }
          hopper::wgmma_commit();
        }
        hopper::wgmma_wait<1>();  // the group of slice it - 1 has finished""", 1)],
    # without the L2 policies (loads evict_last, stores evict_first)
    "no_l2_hints": [(GMM, _LOAD, _LOAD.replace("D, true>", "D, false>"), 1),
                    (GMM, _STORE, "hopper::tma_store_3d(omap, stg + wg * STG_WG + c * OUT_BOX, col + 64 * c, row, e);", 1)],
    # half of an MN-major B slice (dw's dy) loaded: the loads' share of the time
    "half_b": [(GMM, "hopper::mbar_arrive_expect_tx(bar, (BM + BN) * D * 2);",
                "hopper::mbar_arrive_expect_tx(bar, (BM + (B_MN ? BN / 2 : BN)) * D * 2);", 1),
               (GMM, "for (int c = 0; c < BN / 64; ++c) load_box<HINT>(bd + c * CHUNK",
                "for (int c = 0; c < BN / 128; ++c) load_box<HINT>(bd + c * CHUNK", 1)],
    # diagnostics (wrong gradients): without the stores, the products, the loads
    "no_store": [(GMM, _STORE, "if (tiles < 0) " + _STORE, 1)],
    "no_mma": [(GMM, _MMA, _MMA.replace("mma_slice<A_MN, B_MN, D>(acc, a_base + s * SA, b_base + s * SB);",
                                        "hopper::wgmma_commit();"), 1)],
    "no_load": [(GMM, _LOAD, "hopper::mbar_arrive(&full[s]);", 1)],
}


def make_tree(name: str, edits) -> Path:
    dst = ROOT / "build" / "gemm_bwd_variants" / name / "src"
    if dst.parent.exists():
        shutil.rmtree(dst.parent)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    for path, old, new, n in edits:
        text = (dst / path).read_text()
        if text.count(old) != n:
            raise SystemExit(f"variant {name}: {text.count(old)} matches of an edit of {path}, want {n}: {old[:60]!r}")
        (dst / path).write_text(text.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the src directory of another commit, timed first and last")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names of VARIANTS")
    ap.add_argument("--once", action="store_true", help="time each variant once, not twice")
    args = ap.parse_args()
    names = [v for v in args.variants.split(",") if v]
    trees = {"this": ROOT / "src", **{v: make_tree(v, VARIANTS[v]) for v in names}}
    order = ["this", *names, *([] if args.once else reversed(names)), "this"]
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
        order = ["parent", *order, "parent"]
    failed = 0
    for name in order:
        cmd = [sys.executable, str(ROOT / "scripts" / "gemm_timing.py"), "--backward-only", "--dtype", "bfloat16",
               "--src", str(trees[name])]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        for line in out.stdout.splitlines():
            print(f"{name} {line}", flush=True)
        if out.returncode:  # the others still run
            print(f"{name} failed (exit {out.returncode}): {out.stderr[-2000:]}", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
