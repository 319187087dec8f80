"""CPU tests of the cell with D's options (``histogan-256-c16-dopts.train-b16``,
``drivers/train_dopts.py``, ``reference/d_options.py``,
``work/flops_dopts.py``) at the tiny size: the traced cell reads
``correct`` and its exact attention count; the reference takes the program's code for a row
only within the distance's rounding; its G phase runs against the D put
in place between the phases; the FLOP count equals a hand count
of the attention and the port's own dispatch-mode count. The program's
faults (``frozen``, ``half_batch``, ``altered``) and those planted in the
reference put in the program's place are ``test_bench_harness.py``'s
cases for every training cell, this one included."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.conftest import ROOT, TINY, tiny_name
from benchmark.reference import d_options
from benchmark.reference import steps as ref_steps
from benchmark.work import flops_dopts
from benchmark.work.flops import _Count

CELL = "histogan-256-c16-dopts.train-b16"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "histogan-256-c16-dopts.json").read_text())

def test_tiny_cell_reads_correct_and_counts_attention(run_tiny):
    out = run_tiny(tiny_name(CELL), trace=True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss1_gap", "dgrad1_gap", "dchange1_gap", "code1_gap",
                                  "feed_gap"}
    # 3 D calls a step (fakes, reals, G's fakes) x 2 layers x 2 blocks, over 16 images
    assert out["metrics"]["attn_per_img.dopts"]["value"] == 0.75
    assert out["metrics"]["mfu.dopts"]["value"] > 0


def test_reference_takes_the_programs_code_only_within_the_rounding():
    vq = d_options.VectorQuantize(2, 3)
    with torch.no_grad():
        vq.embed.copy_(torch.tensor([[1.0, -1.0, 10.0], [0.0, 0.0, 10.0]]))
    vq.eval()
    # row 0 sits on the tie between codes 0 and 1 (a hair toward 0), row 1
    # near code 0 and far from code 2
    rows = torch.tensor([[[1e-7, 0.0], [0.9, 0.1]]])
    vq.pins = [torch.tensor([1, 2])]
    _, codes, _ = vq(rows)
    assert codes.tolist() == [[1, 0]] and (vq.pinned, vq.flipped) == (1, 1)
    vq.pins = [torch.tensor([1, 0, 0])]  # another shape (half a batch): no pin
    _, codes, _ = vq(rows)
    assert codes.tolist() == [[0, 0]] and (vq.pinned, vq.flipped) == (1, 1)


def _tiny_cfg(**kw):
    return dict(CONFIG, **dict(TINY, hist_insz=TINY["image_size"]), **kw)


def test_flop_count_holds_the_attention_hand_count():
    """A plain step's attention FLOP at the tiny size: each D forward's four
    1x1 convs (Fc) and two contractions (Fx), 2 a multiply-add; the D
    phase's two calls take each forward, weight and input gradient (3 Fc +
    3 Fx), G's call the forward and the input gradient of the convs (2 Fc)
    and both operands' gradients of the contractions (3 Fx): 8 Fc + 9 Fx."""
    traffic = {"driver": "train_dopts", "batch_size": 4, "gradient_accumulate_every": 1}
    cfg = _tiny_cfg()
    b, fc, fx = 4, 0, 0
    for layer in cfg["attn_layers"]:
        chan, side = cfg["network_capacity"] * 2 ** (layer - 1), cfg["image_size"] >> layer
        n = side * side
        fc += 2 * (2 * b * n * (chan * 3 * 512 + 512 * chan))  # two blocks a layer
        fx += 2 * (2 * (2 * b * 8 * 64 * 64 * n))
    without = flops_dopts.unit_flop(dict(cfg, attn_layers=[]), traffic, "")
    assert flops_dopts.unit_flop(cfg, traffic, "") - without == 8 * fc + 9 * fx


@pytest.mark.parametrize("kind", ["", "gp", "gppl"])
def test_flop_count_matches_the_port(tmp_path, kind):
    from histogan_tpu_torch.train.steps import draw_step, train_step
    from histogan_tpu_torch.train.trainer import Trainer

    cfg = _tiny_cfg()
    traffic = {"driver": "train_dopts", "batch_size": 4, "gradient_accumulate_every": 1}
    t = Trainer(name="w", results_dir=str(tmp_path), models_dir=str(tmp_path),
                image_size=cfg["image_size"], network_capacity=cfg["network_capacity"],
                latent_dim=cfg["latent_dim"], style_depth=cfg["style_depth"],
                hist_insz=cfg["hist_insz"], hist_resizing=cfg["hist_resizing"], batch_size=4,
                attn_layers=cfg["attn_layers"], fq_layers=cfg["fq_layers"],
                fq_dict_size=cfg["fq_dict_size"], aug_prob=cfg["aug_prob"],
                aug_types=cfg["aug_types"], device="cpu")
    t.init_GAN()
    gen = torch.Generator().manual_seed(0)
    s, h = cfg["image_size"], cfg["hist_bin"]
    hists = torch.rand((2, 1, 4, 3, h, h), generator=gen)
    hists = hists / hists.sum(dim=(3, 4, 5), keepdim=True)
    batch = {"d_images": torch.randint(0, 256, (1, 4, s, s, 3), generator=gen, dtype=torch.uint8),
             "d_hists": hists[0], "g_hists": hists[1]}
    draws = draw_step(gen, t.cfg, "cpu", "pl" in kind)
    with _Count() as c:
        train_step(t.state, batch, draws, t.cfg, "gp" in kind, "pl" in kind, True)
    assert flops_dopts.unit_flop(cfg, traffic, kind) == pytest.approx(c.total, rel=1e-3)


def test_reference_g_phase_runs_against_the_d_put_in_place(tmp_path):
    """The teacher forcing of ``drivers/train_dopts.py``: what ``between``
    puts in D's place after its update is what the G phase's D call sees.
    With D's last layer zeroed there, G's adversarial loss is its bias."""
    import dataclasses

    from histogan_tpu_torch.train import steps
    from histogan_tpu_torch.train.trainer import Trainer

    cfg = _tiny_cfg()
    t = Trainer(name="w", results_dir=str(tmp_path), models_dir=str(tmp_path),
                image_size=cfg["image_size"], network_capacity=cfg["network_capacity"],
                latent_dim=cfg["latent_dim"], style_depth=cfg["style_depth"],
                hist_insz=cfg["hist_insz"], hist_resizing=cfg["hist_resizing"], batch_size=2,
                attn_layers=cfg["attn_layers"], fq_layers=cfg["fq_layers"],
                fq_dict_size=cfg["fq_dict_size"], aug_prob=cfg["aug_prob"],
                aug_types=cfg["aug_types"], device="cpu")
    t.init_GAN()
    gen = torch.Generator().manual_seed(3)
    s, h = cfg["image_size"], cfg["hist_bin"]
    hists = torch.rand((2, 1, 2, 3, h, h), generator=gen)
    hists = hists / hists.sum(dim=(3, 4, 5), keepdim=True)
    batch = {"d_images": torch.randint(0, 256, (1, 2, s, s, 3), generator=gen, dtype=torch.uint8),
             "d_hists": hists[0], "g_hists": hists[1]}
    draws = dataclasses.asdict(steps.draw_step(gen, t.cfg, "cpu", False))
    losses = {}
    for forced in (False, True):
        flat = {k: v.clone() for k, v in t.reference_state_dict().items()}
        m = d_options.load_flat(d_options.build_modules(cfg, "meta"), flat)
        opt_d = ref_steps.DiffGrad(list(m["D"].parameters()), cfg["learning_rate"])
        opt_g = ref_steps.DiffGrad([p for k in "SHG" for p in m[k].parameters()],
                                   cfg["learning_rate"])

        def zero_last(mods):
            with torch.no_grad():
                mods["D"].to_logit.weight.zero_()
                mods["D"].to_logit.bias.fill_(0.25)

        metrics, _ = d_options.histogan_step(m, opt_d, opt_g, batch, draws, cfg, False, False,
                                             False, torch.zeros(()), None,
                                             zero_last if forced else None)
        losses[forced] = float(metrics["g_loss"])
    assert losses[True] == 0.25 and losses[False] != 0.25
