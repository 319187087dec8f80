"""CPU tests of the training driver (``drivers/train.py``) beyond the
tiny cells' runs: the window's rule, on a scripted clock and a trainer
whose PL steps cost more, and the teacher forcing of the reference's
first G phase with the program's D."""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.conftest import ROOT, TINY, TINY_TRAFFIC
from benchmark.drivers import train

STEP_S, PL_S = 0.165, 0.055  # a plain step's cost on the scripted clock, and a PL step's more
START = 30404  # the window's first step in the training mixes: a GP step


class ScriptedTrainer:
    """Steps from ``START``; each step moves the clock by its cost and
    records its (gp, pl, ema) kind."""

    def __init__(self, cfg):
        self.cfg, self.steps, self.now, self.kinds = cfg, START, 1000.0, []

    def monotonic(self):
        return self.now

    def train(self, **kw):
        kind = train.schedule(self.cfg, self.steps)
        self.kinds.append(kind)
        self.now += STEP_S + (PL_S if kind[1] else 0.0)
        self.steps += 1


class FakeProfile:
    def start(self):
        pass

    def stop(self, path):
        return path


def cycle_s(model: str) -> float:
    """The scripted seconds of the first period from ``START``."""
    cfg = {"model": model}
    return sum(STEP_S + (PL_S if train.schedule(cfg, START + j)[1] else 0.0)
               for j in range(train.period(cfg)))


CASES = [(model, k * cycle_s(model) + eps) for model in ("histogan", "rehistogan")
         for k in (1, 2, 3) for eps in (-1e-6, 1e-6)] + [("histogan", 10.0)]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("model,seconds", CASES)
def test_window_holds_whole_periods(monkeypatch, model, seconds, trace):
    """Whether the clock crosses ``--seconds`` just before or just after a
    period's end, the window stops on the first whole period past it (or,
    traced, past its profiled cycles), and
    holds one PL step and eight GP steps in every 32 (HistoGAN), three EMA
    steps in each of its first three; traced, the profiled GP cycles hold
    no PL step."""
    cfg = {"model": model}
    trainer = ScriptedTrainer(cfg)
    views = []
    monkeypatch.setattr(train, "time", SimpleNamespace(monotonic=trainer.monotonic))
    monkeypatch.setattr(train, "Profile", FakeProfile)
    monkeypatch.setattr(train, "TraceView", lambda path, kinds, imgs: views.append(kinds))
    ctx = SimpleNamespace(cfg=cfg, traffic={"profile_cycles": 2, "batch_size": 16,
                                            "gradient_accumulate_every": 1},
                          device=torch.device("cpu"), seconds=seconds, trace=trace,
                          workdir=Path("unused"))
    n, elapsed, _ = train.window(ctx, trainer, {})
    per = train.period(cfg)
    assert n == len(trainer.kinds) and n % per == 0 and n > 0
    assert elapsed >= seconds
    if not trace:  # traced, the window also runs on past its profiled cycles
        assert sum(STEP_S + (PL_S if k[1] else 0.0) for k in trainer.kinds[:n - per]) < seconds
    assert sum(k[0] for k in trainer.kinds) == n // 4
    if model == "histogan":
        assert per == 32 and sum(k[1] for k in trainer.kinds) == n // 32
        if n <= 96:
            assert sum(k[2] for k in trainer.kinds) == 3 * n // 32
    else:
        assert per == 4 and not any(k[1] or k[2] for k in trainer.kinds)
    if trace:
        (kinds,) = views
        assert len(kinds) == 8 and kinds.count("gp") == 2 and kinds[0] == "gp"
        assert not any("pl" in k for k in kinds)


def _tiny_ctx(tmp_path, seed=2 ** 31 + 9):
    name = "histogan-256-c16.train-b16"
    cell = next(w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                if w["name"] == name)
    cfg = dict(json.loads((ROOT / "benchmark" / "configs" / "histogan-256-c16.json").read_text()),
               **TINY)
    traffic = dict(json.loads((ROOT / "benchmark" / "traffic" / "train-b16.json").read_text()),
                   **TINY_TRAFFIC["train-b16"])
    return harness.Ctx(cell=cell, cfg=cfg, traffic=traffic, seed=seed, seconds=0.5, trace=False,
                       device=torch.device("cpu"), t0=time.monotonic(), workdir=tmp_path,
                       limits=harness.load_limits(name))


def test_reference_first_g_phase_runs_against_the_programs_d(tmp_path):
    """The Recorder keeps D as the program's first G phase found it (moved
    by the D phase's update), and the reference's first G phase reads that
    D and no other: with its last layer zeroed there, the reference's first
    ``g_loss`` is that layer's bias. Its D change after the first step
    stays its own update's."""
    ctx = _tiny_ctx(tmp_path)
    trainer, kw, readings, rec, _, unplant = train.setup(ctx)
    unplant()
    trainer.close()
    start = harness.make_weights(ctx.cfg, ctx.seed, ctx.device)
    d_keys = [k for k in start if k.startswith("D.")]
    assert sorted(f"D.{k}" for k in rec.d_at_g) == sorted(d_keys)
    assert any(not torch.equal(rec.d_at_g[k[2:]], start[k]) for k in d_keys)
    ref = train.reference_readings(ctx, rec)
    assert train.compare(readings, ref)["loss1_gap"] <= ctx.limits["loss1_gap"]
    rec.d_at_g["to_logit.weight"].zero_()
    rec.d_at_g["to_logit.bias"].fill_(0.25)
    forced = train.reference_readings(ctx, rec)
    assert forced["losses"][0]["g_loss"] == 0.25 and ref["losses"][0]["g_loss"] != 0.25
    assert all(forced["change1"][k] == ref["change1"][k] for k in d_keys)
