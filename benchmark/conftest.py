"""Fixtures of the benchmark's own tests (``python -m pytest benchmark``).

``tiny_tree`` is a copy of the benchmark in a temporary directory, with a
tiny configuration and traffic beside each cell's (32 px, capacity 2,
latent 16, histograms of 24 px), cells of those names with ``-tiny`` appended, and the cells'
limits: it runs on the CPU in seconds. ``kept_tree`` also holds, as
cells, the mixes the benchmark keeps with their limits but without an
entry in BENCHMARK.json (``kept_cells``). ``run_tiny`` runs one of its cells
in a subprocess on the CPU, past the harness's look for a chip, and
returns the result. ``cuda_device`` skips a test that needs the card
unless one is there."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# hist_insz below 32 px, so that the histogram's resize runs as at full size
TINY = {"image_size": 32, "network_capacity": 2, "latent_dim": 16, "style_depth": 2,
        "hist_insz": 24}
TINY_TRAFFIC = {
    "train-b16": {"batch_size": 4, "dataset_images": 8},
    "train-2x8": {"batch_size": 2, "gradient_accumulate_every": 2, "dataset_images": 8},
    "recolor": {"photos": 4, "targets": 4, "checked_requests": 3, "profile_requests": 2},
    "sample": {"targets": 2, "num_image_tiles": 4, "batch_size": 4, "checked_requests": 2,
               "profile_requests": 1},
}


def tiny_name(name: str) -> str:
    return name.replace("256-c16", "tiny") + "-tiny"


def kept_cells(bench: dict) -> list:
    """Cells whose mix and limits (``limits/<config>.<mix>.json``) the
    benchmark keeps without an entry in ``workloads``: that entry alone
    brings such a cell back (PERF.md says why each is out)."""
    names = {w["name"] for w in bench["workloads"]}
    return sorted(p.stem for p in (HERE / "limits").glob("*.json") if p.stem not in names)


def make_tiny_tree(dest: Path, kept: bool = False) -> Path:
    shutil.copytree(HERE, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if kept:
        for name in kept_cells(bench):
            config, mix = name.split(".", 1)
            bench["workloads"].append({"name": name, "config": config, "traffic": mix,
                                       "chips": 1, "why": "a kept mix"})
    b = dest / "benchmark"
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY)
        c["name"] = c["name"].replace("256-c16", "tiny")
        c["file"] = c["file"].replace("256-c16", "tiny")
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        limits = b / "limits" / f"{w['name']}.json"
        w["name"], w["config"] = tiny_name(w["name"]), w["config"].replace("256-c16", "tiny")
        traffic = json.loads((b / "traffic" / f"{w['traffic']}.json").read_text())
        traffic.update(TINY_TRAFFIC.get(w["traffic"], {}))
        w["traffic"] += "-tiny"
        (b / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(traffic))
        shutil.copy(limits, b / "limits" / f"{w['name']}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_name(x) for x in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


RUNNER = """
import json, sys, time
from benchmark.run import forbidden_modules, run_cell
bench = json.load(open("BENCHMARK.json"))
out = run_cell(bench, sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), bool(int(sys.argv[4])),
               device="cpu", t0=time.monotonic(), fault=sys.argv[5] or None)
out["forbidden"] = forbidden_modules()
out["program_modules"] = sorted(m for m in sys.modules if m.split(".")[0] == "histogan_tpu_torch")
print(json.dumps(out))
"""


def run_in(tree: Path, cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
           trace: bool = False, fault: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUNNER, cell, str(seed), str(seconds),
                           str(int(trace)), fault], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory) -> Path:
    return make_tiny_tree(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def kept_tree(tmp_path_factory) -> Path:
    return make_tiny_tree(tmp_path_factory.mktemp("kept"), kept=True)


@pytest.fixture(scope="session")
def run_tiny(tiny_tree):
    def run(cell, **kwargs):
        return run_in(tiny_tree, cell, **kwargs)
    return run


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
