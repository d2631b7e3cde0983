#!/usr/bin/env python3
"""The spread of the scenario phase's makespans over repeated runs.

    python3 scripts/scenario_spread.py --pairs 4 [--device cpu] [--seed 0]

Runs the scenario of ``chip_smoke.py`` (``searise_at_scale`` with the
serve-lane kernels, the model-timer autotuner and task checkpoints) as a
chaos run and its no-chaos twin, ``--pairs`` times, and prints one line per
run and per pair: the modeled makespan, the wall seconds, and the pair's
inflation against the spec's bound with ``check_invariants``' verdict.  The
makespan is virtual time, so it moves with the order in which the broker's
threads happen to bind and stage, not with the host's speed; one pair is a
single draw from its spread.  The last line is a JSON summary.  The default
device is the card, as for every entry point of the port; ``--device cpu``
runs the kernel payloads' plain versions.  Exits 1 if any pair violates an
invariant.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import scenario_spec
    from repro_torch.scenarios import check_invariants, run_scenario

    os.environ["HYDRA_EVENTS_CHECK"] = "1"
    os.environ["HYDRA_LEDGER_CHECK"] = "1"
    spec = scenario_spec()
    spec.seed = args.seed
    makespans = {"chaos": [], "baseline": []}
    inflations, bad = [], 0
    for i in range(args.pairs):
        reports = {}
        for chaos in (True, False):
            tag = "chaos" if chaos else "baseline"
            t0 = time.perf_counter()
            reports[tag] = run_scenario(spec, chaos=chaos, device=args.device)
            wall = time.perf_counter() - t0
            makespans[tag].append(reports[tag].makespan_s)
            print(f"run pair={i} twin={tag} makespan_s={reports[tag].makespan_s} wall_s={wall} "
                  f"failed={reports[tag].failed_tasks}", flush=True)
        violations = check_invariants(reports["chaos"], reports["baseline"], spec)
        bad += bool(violations)
        inflations.append(reports["chaos"].makespan_s / reports["baseline"].makespan_s)
        print(f"pair={i} inflation={inflations[-1]} bound={spec.max_makespan_inflation} invariants={violations}", flush=True)
    summary = {"pairs": args.pairs, "device": args.device, "bound": spec.max_makespan_inflation,
               "violating_pairs": bad, "inflation": [min(inflations), max(inflations)]}
    summary.update({f"makespan_{tag}_s": [min(v), max(v)] for tag, v in makespans.items()})
    print(json.dumps(summary), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
