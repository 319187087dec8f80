"""The readings that a cell's limits are set from, on the chip, in one
process (the kernels are built once):

    python -m benchmark.controls --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 5 --out chiprun_out/<file>.jsonl

For each seed the cell runs as the benchmark runs it, for a short window
at its own load, and its compared numbers are the lower readings. On the
control seeds the control is read as well: the plain reference computed
in TF32 (the precision below the configuration's float32 with TF32 off)
put in the program's place and compared as the program is; for a training
cell also the faults planted in the reference put in the program's place
(half of the batch left out, the mean over the rest; the first D leaf
given twice its gradient). A step that returns its state unchanged reads
1 on ``change_gap`` by its definition and needs no run. Each seed's line
is appended to ``--out``; a summary ends standard output. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

from benchmark.run import ROOT, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    mix = next(w["traffic"] for w in bench["workloads"] if w["name"] == args.workload)
    driver = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json").read_text())["driver"]
    # a driver that plants faults (the training drivers) names them in FAULTS
    faults = getattr(importlib.import_module(f"benchmark.drivers.{driver}"), "FAULTS", None)
    plan = [(int(s), ()) for s in args.seeds.split(",") if s]
    plan += [(int(s), ("rerun", "tf32", *faults) if faults else ("tf32",))
             for s in args.control_seeds.split(",") if s]
    rows = []
    for seed, controls in plan:
        res = run_cell(bench, args.workload, seed, args.seconds, False, t0=time.monotonic(),
                       controls=controls)
        # a training driver also gives the numbers its limits do not name
        numbers = res.get("readings", {k: c["value"] for k, c in res["checks"].items()})
        row = {"seed": seed, "correct": res["correct"], "checks": numbers,
               "controls": res["controls"], "metrics": res["metrics"]}
        rows.append(row)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    names = sorted(rows[0]["checks"]) if rows else []
    for k in names:
        lower = max(r["checks"].get(k, float("nan")) for r in rows)
        uppers = {c: min(r["controls"][c].get(k, float("nan"))
                         for r in rows if c in r["controls"])
                  for c in {c for r in rows for c in r["controls"]}}
        print(f"{k}: lower {lower!r} over {len(rows)} seeds; control and faults {uppers}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
