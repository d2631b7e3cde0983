#!/usr/bin/env python3
"""Device time of the port's grouped GEMM (``moe_gmm``) and of its backward
at the shapes chip_smoke.py holds them at, on one NVIDIA GPU.

    python3 scripts/gemm_timing.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two commits can be timed on one card in one run:
unpack the other with ``git archive`` under ``build/`` and give its ``src``.
The forward's cases are the registry's three fp32 tiers and chip_smoke.py's
GEMM ``MODEL_WIDTHS`` (grok-1's expert shape in both dtypes, arctic-480b's
in both, grok-1's decode shape in bf16); the backward's are its
``BWD_GMM_CASES`` in both dtypes (``--backward-only``: those alone).  Each
case prints one ``timing`` line of JSON: the route the call took (by the
kernel module's launch counters; ``refused`` where the tree has no such
kernel), the error against the plain version relative to its largest
element (the backward's on its first expert), and the kernel's median
device time (``ms``, chip_smoke.py's spin-kernel timing).  A backward case
is timed whole and, as ``dx_*`` and ``dw_*`` keys, each gradient alone,
each with its own bound and ``torch.bmm`` (chip_smoke.py's
``gmm_bwd_parts``).  With ``--digests`` it then prints, for each of
chip_smoke.py's small backward cases (``GMM_CASES``, ``BWD_GMM_EDGE_CASES``)
in both dtypes, one ``digest`` line: the route and a SHA-256 prefix of the
bytes of dx and of dw from operands made from a fixed seed, so that runs of
two trees show whether they give bit-equal gradients.  With ``--small``
it times, instead of the model widths, the small shapes in both dtypes:
the reduced grok-1 step's expert products (``SMALL_CASES``: E4, 32 rows of
two groups of 16 tokens, D64 F128 up and D128 F64 down) and chip_smoke.py's
``GMM_CASES`` (F 50 and 100, and D95 F49, on the ``mma`` route), forward and
backward, and ``BWD_GMM_EDGE_CASES``, backward only, each beside its bound
and ``torch.bmm``, with the parts each product's launch took (``parts``,
``dx_parts``, ``dw_parts``; where the tree has a plan,
``moe_gmm.launch_config``).  Set-up prints the card line.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the reduced grok-1 config's expert products in a train step of 2 x 16
# tokens (models/moe.py: groups of 16, capacity 16 an expert a group at
# top-2 and factor 2): x (E, G*C, D) @ w (E, D, F), up and gate, then down
SMALL_CASES = [
    ({"E": 4, "C": 32, "D": 64, "F": 128}, "grok_1_reduced_up"),
    ({"E": 4, "C": 32, "D": 128, "F": 64}, "grok_1_reduced_down"),
]


def parts(gmm, product, x, w, dy=None):
    """The parts the tree's launch of ``product`` takes on these operands
    (None where the route has no plan or the tree none at all)."""
    if not hasattr(gmm, "launch_config"):
        return None
    E, C, D = x.shape
    cfg = gmm.launch_config(product, E, C, D, w.shape[-1], x.dtype, x.device, x=x, w=w, dy=dy)
    return cfg and cfg["parts"]


def time_forward(torch, cs, gmm, ops, ref, x, w, label, dtype, route, rel) -> None:
    """One ``timing`` line of the forward on x (E, C, D) and w (E, D, F)."""
    E, C, D = x.shape
    F = w.shape[-1]
    before = {r: c.value for r, c in gmm.ROUTE_LAUNCHES.items()}
    y = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    took = [r for r, c in gmm.ROUTE_LAUNCHES.items() if c.value > before[r]]
    item = 2 if dtype == "bfloat16" else 4
    row = {"kernel": "moe_gmm", "case": label, "dtype": dtype, "route": took, "rel_err": rel(y, ref.moe_gmm_ref(x, w)),
           "ms": cs.median_ms(torch, lambda: ops.moe_gmm(x, w)),
           **cs.route_bounds(2 * E * C * D * F, item * (E * C * D + E * D * F + E * C * F), dtype, route),
           "library_ms": cs.median_ms(torch, lambda: torch.bmm(x, w)), "parts": parts(gmm, "forward", x, w)}
    print("timing " + json.dumps(row), flush=True)


def time_small(torch, cs, gmm, ops, ref, flush, dev) -> None:
    """The forward (at SMALL_CASES and GMM_CASES; the forward's blocks
    must divide the edge cases' shapes, which its callers never make) and
    the backward (at those and BWD_GMM_EDGE_CASES) in both dtypes: the
    route, the error relative to the largest element, the device time
    beside the bound and torch.bmm (TF32 off); for the backward, dx and dw
    each alone too (``gmm_bwd_parts``)."""
    forward_too = SMALL_CASES + cs.GMM_CASES
    for shape, label in forward_too + cs.BWD_GMM_EDGE_CASES:
        for dtype in ("float32", "bfloat16"):
            E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
            g = torch.Generator(dev).manual_seed(14)
            dt = getattr(torch, dtype)
            x = torch.randn(E, C, D, generator=g, device=dev).to(dt)
            w = (torch.randn(E, D, F, generator=g, device=dev) * D ** -0.5).to(dt)
            dy = torch.randn(E, C, F, generator=g, device=dev).to(dt)
            route = cs.expected_route("moe_gmm", shape, dtype)
            rel = lambda got, want: float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
            if (shape, label) in forward_too:
                time_forward(torch, cs, gmm, ops, ref, x, w, label, dtype, route, rel)
            before = {r: c.value for r, c in gmm.BWD_ROUTE_LAUNCHES.items()}
            got = ops.moe_gmm_bwd(x, w, dy)
            torch.cuda.synchronize()
            took = [r for r, c in gmm.BWD_ROUTE_LAUNCHES.items() if c.value > before[r]]
            want = ref.moe_gmm_bwd_ref(x, w, dy)
            row = {"kernel": "moe_gmm_bwd", "case": label, "dtype": dtype, "route": took,
                   "rel_err": [rel(a, b) for a, b in zip(got, want)],
                   "ms": cs.median_ms(torch, lambda: ops.moe_gmm_bwd(x, w, dy)),
                   **cs.gmm_bwd_bound(E, C, D, F, dtype, route)}
            row.update(cs.gmm_bwd_parts(torch, ops, flush, x, w, dy, got))
            row["library_ms"] = row["dx_library_ms"] + row["dw_library_ms"]  # the two products, one bmm each
            row.update(dx_parts=parts(gmm, "dx", x, w, dy), dw_parts=parts(gmm, "dw", x, w, dy))
            print("timing " + json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--backward-only", action="store_true", help="time the backward's cases only")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), help="time the backward in this dtype only")
    ap.add_argument("--digests", action="store_true",
                    help="then print a digest of the backward's dx and dw at the small cases, to hold two trees bit-equal")
    ap.add_argument("--small", action="store_true",
                    help="time the forward and backward at the small shapes (SMALL_CASES, the ragged and mma cases) instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemm_timing: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import registry as kreg

    print(f"card {cs.card_line()} src={args.src}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    kdef = kreg.get_kernel("moe_gmm")
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    if args.small:
        time_small(torch, cs, gmm, ops, ref, flush, dev)
        return 0
    fwd = [(tier, dict(getattr(kdef, f"{tier}_shape")), "float32") for tier in ("tiny", "smoke", "full")]
    fwd += [(model, shape, dtype) for name, model, shape, dtype in cs.MODEL_WIDTHS if name == "moe_gmm"]
    if args.backward_only:
        fwd = []
    for label, shape, dtype in fwd:
        x, w = kdef.make_args(shape, dtype, 0, dev)
        before = {r: c.value for r, c in gmm.ROUTE_LAUNCHES.items()}
        got = ops.moe_gmm(x, w)
        torch.cuda.synchronize()
        route = [r for r, c in gmm.ROUTE_LAUNCHES.items() if c.value > before[r]]
        want = ref.moe_gmm_ref(x, w)
        err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
        row = {"kernel": "moe_gmm", "case": label, "dtype": dtype, "route": route, "rel_err": err,
               "ms": cs.median_ms(torch, lambda: ops.moe_gmm(x, w))}
        print("timing " + json.dumps(row), flush=True)
        del x, w, got, want
        torch.cuda.empty_cache()
    for label, shape in cs.BWD_GMM_CASES:
        for dtype in [args.dtype] if args.dtype else ("bfloat16", "float32"):
            row = {"kernel": "moe_gmm_bwd", "case": label, "dtype": dtype}
            if not hasattr(ops, "moe_gmm_bwd"):
                print("timing " + json.dumps({**row, "route": "refused"}), flush=True)
                continue
            E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
            g = torch.Generator(dev).manual_seed(14)
            dt = getattr(torch, dtype)
            x = torch.randn(E, C, D, generator=g, device=dev).to(dt)
            w = (torch.randn(E, D, F, generator=g, device=dev) * D ** -0.5).to(dt)
            dy = torch.randn(E, C, F, generator=g, device=dev).to(dt)
            before = {r: c.value for r, c in gmm.BWD_ROUTE_LAUNCHES.items()}
            got = ops.moe_gmm_bwd(x, w, dy)
            torch.cuda.synchronize()
            row["route"] = [r for r, c in gmm.BWD_ROUTE_LAUNCHES.items() if c.value > before[r]]
            # each gradient beside its plain version, relative to its largest element (in
            # slices along the experts: arctic's fp32 dw is 17.8 GB)
            want = ref.moe_gmm_bwd_ref(x[:1], w[:1], dy[:1])
            row["rel_err_expert0"] = [float((a[:1].float() - b.float()).abs().max()) / float(b.float().abs().max())
                                      for a, b in zip(got, want)]
            del want
            path = row["route"][0] if len(row["route"]) == 1 else None
            row["ms"] = cs.median_ms(torch, lambda: ops.moe_gmm_bwd(x, w, dy))
            row.update(cs.gmm_bwd_bound(E, C, D, F, dtype, path))
            row.update(cs.gmm_bwd_parts(torch, ops, flush, x, w, dy, got))
            row.update(dx_parts=parts(gmm, "dx", x, w, dy), dw_parts=parts(gmm, "dw", x, w, dy))
            print("timing " + json.dumps(row), flush=True)
            del x, w, dy, got
            torch.cuda.empty_cache()
    if args.digests:
        for shape, label in cs.GMM_CASES + cs.BWD_GMM_EDGE_CASES:
            for dtype in ("float32", "bfloat16"):
                E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
                g = torch.Generator(dev).manual_seed(14)
                dt = getattr(torch, dtype)
                x = torch.randn(E, C, D, generator=g, device=dev).to(dt)
                w = (torch.randn(E, D, F, generator=g, device=dev) * D ** -0.5).to(dt)
                dy = torch.randn(E, C, F, generator=g, device=dev).to(dt)
                before = {r: c.value for r, c in gmm.BWD_ROUTE_LAUNCHES.items()}
                dx, dw = ops.moe_gmm_bwd(x, w, dy)
                torch.cuda.synchronize()
                route = [r for r, c in gmm.BWD_ROUTE_LAUNCHES.items() if c.value > before[r]]
                digest = {k: hashlib.sha256(v.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
                          for k, v in (("dx", dx), ("dw", dw))}
                print("digest " + json.dumps({"kernel": "moe_gmm_bwd", "case": label, "dtype": dtype, "route": route, **digest}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
