"""The control on the card, at each cell's own size, with a short window:
the program passes its check, and the plain reference computed in TF32
put in the program's place (the control) fails one of the cell's numbers,
as does each fault a training cell can have, planted in the reference put
in the program's place. Run on the card:

    python -m pytest -m cuda benchmark/test_bench_card.py
"""

from __future__ import annotations

import json
import math
import time

import pytest

from benchmark.conftest import ROOT

pytestmark = pytest.mark.cuda

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_device, cell):
    from benchmark.harness import load_limits
    from benchmark.run import run_cell

    controls = ("tf32", "half_batch", "altered") if ".train" in cell else ("tf32",)
    out = run_cell(BENCH, cell, 2 ** 31 + 4321, 2.0, False, t0=time.monotonic(),
                   controls=controls)
    assert out["correct"], out["checks"]
    limits = load_limits(cell)
    for name, numbers in out["controls"].items():
        failed = [k for k, lim in limits.items()
                  if not (math.isfinite(numbers[k]) and numbers[k] <= lim)]
        assert failed, (name, numbers)
