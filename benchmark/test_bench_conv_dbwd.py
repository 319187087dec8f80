"""The reader of ``conv_dbwd_per_img`` (``metrics/conv_dbwd_per_img.py``)
on the CPU: the program's counter ``conv_dbwd`` over the profiled images,
D's convolutions once each per GP call, 0 where the program records
spans but takes no such double backward, and nothing where it records no
spans."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark.conftest import ROOT
from benchmark.run import load_metric

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["per_layer"] if m["name"].startswith("conv_dbwd_per_img.")]


def test_both_training_cells_have_the_metric():
    cells = {m["name"]: m["workloads"] for m in BENCH["per_layer"] if m["name"] in NAMES}
    assert cells == {"conv_dbwd_per_img.train": ["histogan-256-c16.train-b16",
                                                 "histogan-256-c16-dopts.train-b16"]}


@pytest.mark.parametrize("name", NAMES)
def test_reader_counts_double_backwards_per_image(name):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from histogan_tpu_torch.models.discriminator import Discriminator
    from histogan_tpu_torch.ops import losses
    from histogan_tpu_torch.utils.logging import reset_spans, span

    read = load_metric(name)
    view = SimpleNamespace(units=[0, 1], images=8)
    d = Discriminator(16, 2)  # 4 blocks x 3 + 3 downsamples
    real = torch.rand(2, 3, 16, 16)
    reset_spans()
    assert read(view, {}) is None  # no spans
    with profile(activities=[ProfilerActivity.CPU]):
        with span("step.d_phase"):  # no GP: no double backward
            torch.autograd.grad(d(real)[0].sum(), list(d.parameters()))
    assert read(view, {}) == 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with span("step.d_phase"):
            logits, gp = losses.shared_forward_gradient_penalty(lambda x: d(x)[0], real)
            torch.autograd.grad(logits.mean() + gp, list(d.parameters()))
    assert read(view, {}) == 15 / 8
    reset_spans()
    assert read(view, {}) is None
