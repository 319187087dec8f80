"""The reader of ``upsample2x_per_img`` (``metrics/upsample2x_per_img.py``)
on the CPU: the program's counter ``upsample2x`` over the profiled images,
0 where the program records spans but launches no U1 (the CPU, or aten's
upsample), and nothing where it records no spans."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark.conftest import ROOT
from benchmark.run import load_metric

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["per_layer"] if m["name"].startswith("upsample2x_per_img.")]


def test_both_cells_have_the_metric():
    cells = {m["name"]: m["workloads"] for m in BENCH["per_layer"] if m["name"] in NAMES}
    assert cells == {"upsample2x_per_img.train": ["histogan-256-c16.train-b16"],
                     "upsample2x_per_img.sample": ["histogan-256-c16.sample"]}


@pytest.mark.parametrize("name", NAMES)
def test_reader_counts_launches_per_image(name):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from histogan_tpu_torch.ops import resize
    from histogan_tpu_torch.utils.logging import count, reset_spans, span

    read = load_metric(name)
    view = SimpleNamespace(units=[0, 1], images=8)
    reset_spans()
    assert read(view, {}) is None  # no spans
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sample.generate"):
            resize.upsample2x(torch.zeros((1, 2, 4, 4)))  # the CPU: F.interpolate, no U1
    assert read(view, {}) == 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(12):  # as U1 counts its launches
            count("upsample2x")
    assert read(view, {}) == 1.5
    reset_spans()
    assert read(view, {}) is None
