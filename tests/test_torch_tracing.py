"""The port's spans and counters (``histogan_tpu_torch/utils/logging.py``)
on the CPU at a toy size: untraced nothing is recorded and no
``record_function`` is entered; under a ``torch.profiler`` each training
step is one ``train.step`` span holding its data, phase, update and
readback spans (the GP's only on a GP step), the readbacks and the GP's
double backwards through D's convolutions are counted,
the spans lie in the Chrome trace as user annotations around their ops,
``ProfilerHook`` leaves the table holding its steps, and tracing leaves the
step's numbers bit for bit as they are."""

import json

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from histogan_tpu_torch.cli.histogan import image_hist
from histogan_tpu_torch.models.layers import DConv
from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
from histogan_tpu_torch.train.trainer import Trainer
from histogan_tpu_torch.utils import logging as telemetry

torch.set_num_threads(1)

# 64 bins, so that the histogram goes through hist_core (its plain
# versions on the CPU)
TINY = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_insz=24,
            batch_size=2, gradient_accumulate_every=1, seed=0, device="cpu")
STEP_SPANS = ("data.take", "step.d_phase", "step.g_phase", "step.update", "sync.metrics")


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    root = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return root


def make_trainer(tmp_path, photos, **kw):
    t = Trainer("tr", str(tmp_path / "r"), str(tmp_path / "m"), **{**TINY, **kw})
    t.init_GAN()
    t.set_data_src(str(photos))
    t.steps = t.state.step = 4  # a GP step (no PL, save, evaluation or EMA reset)
    return t


def traced(fn):
    telemetry.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def below(table, root: int):
    """The spans under span ``root`` (any depth)."""
    def inside(i):
        p = table[i].parent
        return p is not None and (p == root or inside(p))
    return [s for i, s in enumerate(table) if inside(i)]


def test_untraced_records_nothing(tmp_path, photos, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    telemetry.reset_spans()
    t = make_trainer(tmp_path, photos)
    t.train()
    image_hist(np.full((16, 16, 3), 0.5, np.float32), RGBuvHistBlock(insz=24), "cpu")
    telemetry.count("syncs")
    assert telemetry.span("a") is telemetry.span("b", unit=3, stream=True)  # one shared no-op
    assert entered == [] and telemetry.span_table() == [] and telemetry.counters() == {}


@pytest.mark.parametrize("sync_every,syncs", [(1, 4), (4, 1)])
def test_four_steps_from_a_gp_step(tmp_path, photos, sync_every, syncs):
    t = make_trainer(tmp_path, photos, sync_every=sync_every)
    traced(lambda: [t.train() for _ in range(4)])
    table = telemetry.span_table()
    steps = [i for i, s in enumerate(table) if s.name == "train.step"]
    assert [table[i].unit for i in steps] == [4, 5, 6, 7]
    assert all(table[i].parent is None and table[i].host_ms > 0 for i in steps)
    assert all(s.stream_ms is None for s in table)  # no CUDA events on the CPU
    for k, i in enumerate(steps):
        assert {s.unit for s in below(table, i)} == {table[i].unit}
        names = [s.name for s in below(table, i)]
        for name in STEP_SPANS[:-1]:
            assert names.count(name) == (2 if name == "step.update" else 1), (name, names)
        assert names.count("sync.metrics") == (1 if k == 0 or sync_every == 1 else 0)
        assert names.count("step.gp") == (1 if k == 0 else 0)
        assert "step.pl" not in names and "step.ema" not in names
    # the optimizer's spans lie in the phases, the GP's in the D phase
    for s in table:
        if s.name in ("step.update", "step.gp"):
            assert table[s.parent].name in ("step.d_phase", "step.g_phase")
    # the GP step's double backward through each of D's 19 convolutions
    assert telemetry.counters() == {"syncs": syncs, "conv_dbwd": 19}


@pytest.mark.parametrize("call", ["image_hist", "evaluate"])
def test_a_served_call_counts_one_sync(tmp_path, photos, call):
    if call == "image_hist":
        img = np.random.default_rng(1).random((40, 40, 3)).astype(np.float32)
        out, _ = traced(lambda: image_hist(img, RGBuvHistBlock(insz=24), "cpu"))
        assert out.shape == (1, 3, 64, 64)
    else:
        t = make_trainer(tmp_path, photos)
        out, _ = traced(lambda: t.evaluate(None))
        assert out.shape == (16, 32, 32, 3)
    table = telemetry.span_table()
    assert telemetry.counters() == {"syncs": 1}
    if call == "image_hist":
        assert table[0].name == "hist.target" and table[0].unit < 0
        assert [s.name for s in below(table, 0)] == ["sync.hist"]
    else:  # the sampler's span, then the copy of its images
        assert [s.name for s in table if s.parent is None] == ["sample.generate",
                                                                "sync.images"]


def test_chrome_trace_holds_each_span_around_its_ops(tmp_path, photos):
    t = make_trainer(tmp_path, photos)
    _, prof = traced(t.train)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    ours = {s.name for s in telemetry.span_table()}
    assert {"train.step", "step.gp", *STEP_SPANS} <= ours
    assert ours <= {e["name"] for e in spans}  # torch's optimizer adds one of its own
    for e in spans:
        # a CPU tensor's .cpu() is the tensor itself: sync.* holds no op here
        if e["name"] not in ours or e["name"].startswith("sync."):
            continue
        held = [o["name"] for o in ops if o["tid"] == e["tid"]
                and e["ts"] <= o["ts"] and o["ts"] + o["dur"] <= e["ts"] + e["dur"]]
        assert held, e["name"]


def test_profiler_hook_leaves_its_steps_in_the_table(tmp_path, photos):
    t = make_trainer(tmp_path, photos)
    t.enable_profiling(5, 2)
    try:
        for _ in range(4):
            t.train()
    finally:
        t.close()
    assert t.profiler_hook.path.name == "steps_5-6.json"
    table = telemetry.span_table()
    assert sorted({s.unit for s in table}) == [5, 6]
    assert [s.unit for s in table if s.name == "train.step"] == [5, 6]
    assert telemetry.counters() == {"syncs": 2}


def test_tracing_leaves_the_steps_bit_identical(tmp_path, photos):
    def run(trace):
        t = make_trainer(tmp_path / str(trace), photos)
        steps = lambda: [t.train() for _ in range(2)]  # noqa: E731
        metrics = traced(steps)[0] if trace else steps()
        return metrics, {f"{k}.{n}": v.detach().clone() for k, m in t.models().items()
                         for n, v in m.state_dict().items()}

    (m_off, p_off), (m_on, p_on) = run(False), run(True)
    assert m_on == m_off
    assert p_on.keys() == p_off.keys()
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_off)


D_OPTIONS = dict(attn_layers=(1,), fq_layers=(2,), aug_prob=1.0)


@pytest.mark.parametrize("options", [D_OPTIONS, {}], ids=["d_options", "plain_d"])
def test_d_options_record_their_spans_and_counter(tmp_path, photos, options):
    # a GP step's three D calls (fakes, reals inside the GP, G's fakes), each
    # through the AugWrapper, two attention blocks and one VQ layer
    t = make_trainer(tmp_path, photos, **options)
    traced(t.train)
    table = telemetry.span_table()
    names = [s.name for s in table]
    calls = 3 if options else 0
    assert [names.count(n) for n in ("d.attn", "d.vq", "d.aug")] == [2 * calls, calls, calls]
    assert telemetry.counters().get("attn", 0) == 2 * calls
    step = next(i for i, s in enumerate(table) if s.name == "train.step")
    inside = below(table, step)
    for s in table:
        if s.name.startswith("d."):
            assert s in inside and s.unit == 4 and s.host_ms > 0 and s.stream_ms is None
    gp = next(i for i, s in enumerate(table) if s.name == "step.gp")
    assert [s.name for s in below(table, gp)].count("d.attn") == (2 if options else 0)


@pytest.mark.parametrize("gp", [True, False], ids=["gp_step", "plain_step"])
@pytest.mark.parametrize("options", [{}, dict(attn_layers=(1,))], ids=["plain_d", "attn_d"])
def test_conv_dbwd_counts_each_d_convolution_once_a_gp_call(tmp_path, photos, options, gp):
    # 5 blocks x 3 + 4 downsamples; the attention's two blocks add 4 1x1 each
    t = make_trainer(tmp_path, photos, **options)
    if not gp:
        t.steps = t.state.step = 5
    traced(t.train)
    n_convs = sum(isinstance(m, DConv) for m in t.state.D.modules())
    assert n_convs == 19 + 8 * bool(options)
    assert telemetry.counters().get("conv_dbwd", 0) == (n_convs if gp else 0)


def test_d_options_are_a_shared_no_op_untraced(tmp_path, photos, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    telemetry.reset_spans()
    t = make_trainer(tmp_path, photos, **D_OPTIONS)
    t.train()
    assert entered == [] and telemetry.span_table() == [] and telemetry.counters() == {}
