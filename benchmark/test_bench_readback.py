"""The reader of ``readback_chunks_per_img`` (``metrics/readback_chunks_per_img.py``)
on the CPU: the program's counter ``readback_chunks`` over the profiled
images, 0 where the program records spans but reads its samples back whole
(the CPU's path), and nothing where it records no spans."""

from __future__ import annotations

import json
from types import SimpleNamespace

from benchmark.conftest import ROOT, tiny_name
from benchmark.run import load_metric

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "readback_chunks_per_img.sample"


def test_the_sample_cell_has_the_metric():
    cells = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
             if m["name"].startswith("readback_chunks_per_img.")}
    assert cells == {NAME: ["histogan-256-c16.sample"]}


def test_reader_counts_chunks_per_image():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from histogan_tpu_torch.utils.logging import count, readback, reset_spans, span

    read = load_metric(NAME)
    view = SimpleNamespace(units=[0, 1], images=64)
    reset_spans()
    assert read(view, {}) is None  # no spans
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sample.generate"):
            readback("images", torch.zeros((2, 3)))  # read back whole
    assert read(view, {}) == 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):  # as the chunked copy counts its chunks
            count("readback_chunks")
    assert read(view, {}) == 0.0625
    reset_spans()
    assert read(view, {}) is None


def test_tiny_traced_sample_cell_reads_zero_on_the_cpu(run_tiny):
    out = run_tiny(tiny_name("histogan-256-c16.sample"), trace=True)
    assert out["correct"]
    assert out["metrics"][NAME]["value"] == 0.0
