#!/usr/bin/env python3
"""Device time of variants of the fp32 attention at head width 256 (the
``tf32x3_cluster`` route) at recurrentgemma-2b's shape, on one NVIDIA GPU.

    python3 scripts/attention_cluster_variants.py [--runs NAME ...]

Each variant is built from a copy of ``src/repro_torch/kernels/csrc`` under
``build/attention_variants/<name>`` with the edits named below, then the
forward and the backward (fed by the forward kernel's LSE, as the train
step calls it) are timed at B1 H10 KV1 L4096 hd256, causal, window 2048,
with chip_smoke.py's device timing (``median_ms``), and held against the
plain versions (relative error of the largest element).  Some variants
drop work the result needs, so their errors are large: they time what that
work costs.

  as_is          the tree's kernels
  no_exchange    no pair exchange: each block keeps its own half's partial
                 S and dP (times the exchange)
  no_split       the backward skips its split pass: the products read
                 stale tiles (times the split)
  one_in_flight  one product stage in flight (``product_s`` without PIPE)
  dq_first       the backward's dQ blocks first in the grid
  parts2, parts5 the backward's query heads of a KV head split in 2 or 5
                 parts (``kv_parts`` forced)

One ``variant`` line of JSON a run; set-up prints the card line and each
build's ``ptxas`` registers and spills.
"""
import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BWD, FWD = "flash_attention_bwd_tf32x3.cu", "flash_attention.cu"
EDITS = {
    "as_is": {},
    "no_exchange": {
        BWD: [("    if constexpr (SPLIT > 1) pair.expect(j, t);\n", ""),
              ("    if constexpr (SPLIT > 1) pair.send(s, j, 0, t);\n", ""),
              ("      if constexpr (SPLIT > 1) pair.send(dp, j, XB, t);\n", ""),
              ("      pair.wait(j);\n      pair.add(s, j, 0, t);\n", "      pair.add(s, j, 0, t);\n")],
        FWD: [("      pair.expect(j, t);\n      pair.send(s, j, 0, t);\n      pair.wait(j);\n", "")],
    },
    "no_split": {
        BWD: [("    if (DS) {\n      split_raw", "    if (false) {\n      split_raw"),
              ("    } else {\n      split_raw<T, W, BN, true, false, X3>(st, t0_hi",
               "    } else if (false) {\n      split_raw<T, W, BN, true, false, X3>(st, t0_hi")],
    },
    "one_in_flight": {
        BWD: [("constexpr bool PIPE = SPLIT > 1;", "constexpr bool PIPE = false;")],
        FWD: [("product_s<W, BN, X3, (SPLIT > 1)>(s,", "product_s<W, BN, X3, false>(s,")],
    },
    "dq_first": {
        BWD: [("""  if (idx < n_kv)
    bwd_block<T, HD, SPLIT, kDK>(base, a, idx);
  else if (idx < 2 * n_kv)
    bwd_block<T, HD, SPLIT, kDV>(base, a, idx - n_kv);
  else
    bwd_block<T, HD, SPLIT, kDQ>(base, a, idx - 2 * n_kv);""", """  if (idx < n_dq)
    bwd_block<T, HD, SPLIT, kDQ>(base, a, idx);
  else if (idx < n_dq + n_kv)
    bwd_block<T, HD, SPLIT, kDK>(base, a, idx - n_dq);
  else
    bwd_block<T, HD, SPLIT, kDV>(base, a, idx - n_dq - n_kv);""")],
    },
}
PARTS = {"parts2": 2, "parts5": 5}
SHAPE = (1, 10, 1, 4096, 256, 2048)  # B, H, KV, L, hd, window (causal)


def build(_build, name):
    """Point the build at an edited copy of csrc and build the attention sources."""
    d = ROOT / "build" / "attention_variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "kernels" / "csrc", d / "csrc")
    for f, subs in EDITS[name].items():
        s = (d / "csrc" / f).read_text()
        for old, new in subs:
            if old not in s:
                raise SystemExit(f"variant {name}: {f} no longer holds the text it edits: {old[:60]!r}")
            s = s.replace(old, new)
        (d / "csrc" / f).write_text(s)
    _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "lib"
    _build._LIBS.clear()
    _build._FUNCS.clear()
    _build.BUILD_LOGS.clear()
    _build.load(FWD[:-3], BWD[:-3])
    for src in (FWD[:-3], BWD[:-3]):
        usage = [(u["kernel"], u.get("registers"), u.get("spill_stores")) for u in _build.ptxas_usage(_build.BUILD_LOGS.get(src, ""))]
        print(f"ptxas variant={name} source={src} {json.dumps(usage)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=["as_is", "no_exchange", "no_split", "one_in_flight", "dq_first",
                                                  "parts2", "parts5", "as_is"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_cluster_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"card {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    B, H, KV, L, hd, w = SHAPE
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn(B, H, L, hd, generator=g, device=dev)
    k, v = (torch.randn(B, KV, L, hd, generator=g, device=dev) for _ in range(2))
    do = torch.randn(B, H, L, hd, generator=g, device=dev)
    o_ref = ref.attention_ref(q, k, v, causal=True, window=w)
    want = ref.attention_bwd_ref(q, k, v, o_ref, do, causal=True, window=w)
    kv_parts = fa.kv_parts
    for name in args.runs:
        build(_build, name if name in EDITS else "as_is")
        fa.kv_parts = (lambda *a, n=PARTS[name]: n) if name in PARTS else kv_parts
        lse = torch.empty(B, H, L, device=dev)
        o = fa.flash_attention(q, k, v, causal=True, window=w, lse=lse)
        run = lambda: fa.flash_attention_bwd(q, k, v, o, do, causal=True, window=w, lse=lse)
        got = run()
        torch.cuda.synchronize()
        row = {
            "variant": name,
            "bwd_ms": cs.median_ms(torch, run),
            "bwd_rel_err": max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want)),
            "fwd_ms": cs.median_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True, window=w)),
            "fwd_rel_err": float((o - o_ref).abs().max()) / float(o_ref.abs().max()),
        }
        fa.kv_parts = kv_parts
        print("variant " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
