"""CPU tests of the benchmark: each cell against the plain reference at a
tiny size, the check failing under each fault a cell can have, the
imports (no JAX, no JAX package; the reference loads nothing of the
program), a configuration, mix and metric added as files alone, and the
refusals. The control on the card is ``test_bench_card.py``."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.conftest import HERE, ROOT, kept_cells, make_tiny_tree, run_in, tiny_name

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEPT = kept_cells(BENCH)
TRAINING = [c for c in CELLS if ".train" in c]
SERVING = [c for c in CELLS if ".train" not in c]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_reference(run_tiny, cell):
    out = run_tiny(tiny_name(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["forbidden"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics(run_tiny, cell):
    out = run_tiny(tiny_name(cell), trace=True)
    assert out["correct"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the CPU has no device trace: the readers that need kernels return None
    wanted = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= wanted and any(k.startswith("mfu") for k in out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


FAULTS = [(c, f) for c in TRAINING for f in ("frozen", "half_batch", "altered")]
FAULTS += [(c, "altered") for c in SERVING]
FAULTS += [(c, "half_batch") for c in SERVING if c.endswith(".sample")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_check_fails_under_fault(run_tiny, cell, fault):
    out = run_tiny(tiny_name(cell), fault=fault)
    assert not out["correct"], out["checks"]


RUNNER = """
import json, sys, time
from benchmark.run import run_cell
bench = json.load(open("BENCHMARK.json"))
out = run_cell(bench, sys.argv[1], int(sys.argv[2]), 0.5, False, device="cpu", t0=time.monotonic(),
               controls=tuple(sys.argv[3].split(",")))
print(json.dumps({k: out[k] for k in ("correct", "checks", "controls")}))
"""


@pytest.mark.parametrize("cell", TRAINING)
def test_reference_faults_fail_the_check(tiny_tree, cell):
    # the faults planted in the reference put in the program's place (as
    # controls.py reads them on the card) fail the check; the reference
    # run again passes it
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUNNER, tiny_name(cell), str(2 ** 31 + 5),
                           "rerun,half_batch,altered"], cwd=tiny_tree, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    for name, numbers in out["controls"].items():
        failed = [k for k, lim in limits.items()
                  if not (math.isfinite(numbers[k]) and numbers[k] <= lim)]
        assert bool(failed) == (name != "rerun"), (name, numbers)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in KEPT
                                        for f in ("", "frozen", "half_batch", "altered")])
def test_kept_mix_runs_as_a_cell(kept_tree, cell, fault):
    # a kept mix comes back as a cell by its entry in BENCHMARK.json alone
    out = run_in(kept_tree, tiny_name(cell), fault=fault)
    assert out["correct"] == (fault == ""), out["checks"]


def test_reference_and_work_load_nothing_of_the_program():
    code = ("import sys, benchmark.reference.models, benchmark.reference.steps, "
            "benchmark.reference.histogram, benchmark.work.flops, benchmark.work.histogram; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'histogan_tpu', 'histogan_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(run_tiny):
    # the harness's own name check compares top-level names whole
    from benchmark.run import FORBIDDEN

    assert "histogan_tpu" in FORBIDDEN and "histogan_tpu_torch" not in FORBIDDEN
    for cell in CELLS:
        out = run_tiny(tiny_name(cell), trace=True)
        assert out["forbidden"] == []
        assert out["program_modules"]  # the program did run


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    tree = make_tiny_tree(tmp_path)
    b = tree / "benchmark"
    cfg = json.loads((b / "configs" / "histogan-tiny.json").read_text())
    cfg.update(network_capacity=3)
    (b / "configs" / "dummy-net.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "train-b16-tiny.json").read_text())
    traffic.update(batch_size=2)
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps(traffic))
    (b / "metrics" / "dummy_share.py").write_text(
        "def read(view, ctx):\n    return 100.0 * len(view.units) / (1 + len(view.units))\n")
    shutil.copy(b / "limits" / "histogan-tiny.train-b16-tiny.json",
                b / "limits" / "dummy-net.dummy-mix.json")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-net", "source": "https://example.org",
                             "file": "benchmark/configs/dummy-net.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-net.dummy-mix", "config": "dummy-net",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append("dummy-net.dummy-mix")
    bench["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "trainer and step",
                               "moves": "train_imgs_per_s", "workloads": ["dummy-net.dummy-mix"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_in(tree, "dummy-net.dummy-mix")
    assert out["correct"] and set(out["metrics"]) == {"setup_s", "train_imgs_per_s"}
    out = run_in(tree, "dummy-net.dummy-mix", trace=True)
    assert out["metrics"]["dummy_share"]["value"] > 0


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
