"""CPU tests of the frozen work counters: the model FLOP function against
a dispatch-mode count of the port's own training step at a tiny size,
and the histogram operation's work against the program's own counts."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.conftest import ROOT, TINY
from benchmark.work import flops, histogram
from benchmark.work.flops import _Count


def _cfg(name):
    """The tiny configuration, with histograms of the image's own 32 px:
    the port's CPU histogram pads its pixels to 512-pixel tiles, and 32^2
    is whole tiles, so that both sides count the same products."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg.update(TINY, hist_insz=TINY["image_size"])
    return cfg


def _batch(gen, a, b, s, h, images=False):
    def hists():
        x = torch.rand((a, b, 3, h, h), generator=gen)
        return x / x.sum(dim=(2, 3, 4), keepdim=True)

    batch = {"d_images": torch.randint(0, 256, (a, b, s, s, 3), generator=gen,
                                       dtype=torch.uint8),
             "d_hists": hists(), "g_hists": hists()}
    if images:
        batch["g_images"] = torch.randint(0, 256, (a, b, s, s, 3), generator=gen,
                                          dtype=torch.uint8)
    return batch


@pytest.mark.parametrize("kind", ["", "gp", "pl", "gppl"])
def test_histogan_step_flop_matches_the_port(tmp_path, kind):
    from histogan_tpu_torch.train.steps import draw_step, train_step
    from histogan_tpu_torch.train.trainer import Trainer

    cfg = _cfg("histogan-256-c16")
    traffic = {"driver": "train", "batch_size": 4, "gradient_accumulate_every": 2}
    t = Trainer(name="w", results_dir=str(tmp_path), models_dir=str(tmp_path),
                image_size=cfg["image_size"], network_capacity=cfg["network_capacity"],
                latent_dim=cfg["latent_dim"], style_depth=cfg["style_depth"],
                hist_insz=cfg["hist_insz"], hist_resizing=cfg["hist_resizing"], batch_size=4,
                gradient_accumulate_every=2, device="cpu")
    t.init_GAN()
    gen = torch.Generator().manual_seed(0)
    batch = _batch(gen, 2, 4, cfg["image_size"], cfg["hist_bin"])
    draws = draw_step(gen, t.cfg, "cpu", "pl" in kind)
    with _Count() as c:
        train_step(t.state, batch, draws, t.cfg, "gp" in kind, "pl" in kind, True)
    assert flops.unit_flop(cfg, traffic, kind) == pytest.approx(c.total, rel=1e-3)


@pytest.mark.parametrize("kind", ["", "gp"])
def test_rehistogan_step_flop_matches_the_port(tmp_path, kind):
    from histogan_tpu_torch.train.rehisto_steps import draw_step, train_step
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    cfg = _cfg("rehistogan-256-c16")
    traffic = {"driver": "train", "batch_size": 2, "gradient_accumulate_every": 2}
    t = RecoloringTrainer(name="w", results_dir=str(tmp_path), models_dir=str(tmp_path),
                          image_size=cfg["image_size"],
                          network_capacity=cfg["network_capacity"],
                          latent_dim=cfg["latent_dim"], style_depth=cfg["style_depth"],
                          hist_insz=cfg["hist_insz"], hist_resizing=cfg["hist_resizing"],
                          skip_conn_to_GAN=cfg["skip_conn_to_GAN"], batch_size=2,
                          gradient_accumulate_every=2, device="cpu")
    t.init_GAN()
    gen = torch.Generator().manual_seed(0)
    batch = _batch(gen, 2, 2, cfg["image_size"], cfg["hist_bin"], images=True)
    draws = draw_step(gen, t.cfg, "cpu")
    with _Count() as c:
        train_step(t.state, batch, draws, t.cfg, kind == "gp", cfg["alpha"], cfg["beta"],
                   cfg["gamma"])
    assert flops.unit_flop(cfg, traffic, kind) == pytest.approx(c.total, rel=1e-3)


def test_flagship_counts():
    """The counts PERF.md states, GFLOP an image at 256 px, capacity 16."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "histogan-256-c16.json").read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "train-b16.json").read_text())
    per_img = {k: flops.unit_flop(cfg, traffic, k) / 16e9 for k in ("", "gp")}
    assert per_img[""] == pytest.approx(127.34, abs=0.05)
    assert per_img["gp"] == pytest.approx(140.29, abs=0.05)


@pytest.mark.parametrize("direction,name", [("fwd", "histogram_fwd"), ("bwd", "histogram_bwd")])
@pytest.mark.parametrize("b,n", [(16, 4096), (1, 4096), (2, 4096), (1, 22500), (8, 62500)])
def test_histogram_work_matches_the_programs_count(direction, name, b, n):
    from histogan_tpu_torch.ops.histogram_cuda import kernel_work

    assert histogram.hist_work(direction, b, n) == kernel_work(name, b, n)


def test_histogram_bound_is_the_tensor_core_products():
    w = histogram.hist_work("fwd", 16, 4096)
    assert histogram.bound_s(w) == pytest.approx(w["flop"] / 495e12)
