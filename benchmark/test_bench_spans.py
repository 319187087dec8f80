"""The per-layer metrics read from the program's own spans and counters
(``histogan_tpu_torch/utils/logging.py``): on the CPU each tiny traced
cell reads its host-time and count metrics finite, ``syncs_per_photo``
exactly 1, and no stream-time metric (the CPU has no CUDA events); on the
card every one of them reads a finite value at the cell's own size. The
readback readers read 0 where the program records spans but no readback,
and nothing where it records no spans. Run the card's case on the card:

    python -m pytest -m cuda benchmark/test_bench_spans.py
"""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.conftest import ROOT, tiny_name
from benchmark.run import load_metric

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# read from host clocks or a counter, and from CUDA events
HOST = ("data_ms.train", "enqueue_ms.recolor", "sync_ms.recolor", "syncs_per_photo.recolor")
STREAM = ("d_phase_ms.train", "gp_ms.train", "g_phase_ms.train", "update_ms.train",
          "readback_ms.sample")
STREAMED = {"step.d_phase", "step.g_phase", "step.update", "step.ema", "sync.images", "d.attn",
            "d.vq"}


def span_metrics(cell: str) -> set:
    return {m["name"] for m in BENCH["per_layer"]
            if m["name"] in HOST + STREAM and cell in m["workloads"]}


def test_every_cell_has_span_metrics():
    assert set().union(*map(span_metrics, CELLS)) == set(HOST + STREAM)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_cell_reads_its_span_metrics(run_tiny, cell):
    out = run_tiny(tiny_name(cell), trace=True)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in span_metrics(cell):
        if name in STREAM:
            assert name not in got, name
        else:
            assert math.isfinite(got[name]) and got[name] >= 0, (name, got.get(name))
    if cell.endswith(".recolor"):
        assert got["syncs_per_photo.recolor"] == 1.0


@pytest.mark.parametrize("synced", [True, False])
def test_readback_readers_count_a_photo_without_readback_as_zero(monkeypatch, synced):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from histogan_tpu_torch.cli import histogan
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
    from histogan_tpu_torch.utils.logging import reset_spans

    if not synced:  # the target histogram kept on the host's side of no readback
        monkeypatch.setattr(histogan, "readback", lambda name, t, stream=False: t.cpu())
    view = SimpleNamespace(units=[0, 1], images=2)
    names = ("syncs_per_photo.recolor", "sync_ms.recolor", "enqueue_ms.recolor")
    reset_spans()
    assert [load_metric(n)(view, {}) for n in names] == [None] * 3  # no spans
    img = np.random.default_rng(0).random((24, 24, 3)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in view.units:
            histogan.image_hist(img, RGBuvHistBlock(insz=16), torch.device("cpu"))
    per_photo, sync_ms, enqueue_ms = (load_metric(n)(view, {}) for n in names)
    reset_spans()
    assert per_photo == (1.0 if synced else 0.0)
    assert sync_ms > 0 if synced else sync_ms == 0.0
    assert enqueue_ms > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_reads_every_span_metric(cuda_device, cell):
    from benchmark.run import run_cell
    from histogan_tpu_torch.utils.logging import reset_spans, span_table

    reset_spans()  # the table holds one traced window: this cell's
    out = run_cell(BENCH, cell, 2 ** 31 + 4322, 2.0, True, t0=time.monotonic())
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in span_metrics(cell):
        assert math.isfinite(got[name]), (name, got.get(name))
    if cell.endswith(".recolor"):
        assert got["syncs_per_photo.recolor"] == 1.0
    if ".train" in cell:
        assert got["gp_ms.train"] > 0 and got["update_ms.train"] > 0
    # CUDA events on the spans whose stream time is read, and on no other
    for s in span_table():
        assert (s.stream_ms is not None) == (s.name in STREAMED), s
