"""The port's debug and profiling hooks on the CPU: ``checkify_step``
(``utils/debug.py``) raises at the first NaN or Inf of any op, the
backward's included, as the JAX package's checkify wrapper does
(tests/test_debug.py's two cases, and a train step), and
``ProfilerHook`` / ``Trainer.enable_profiling`` write a Chrome trace of
the chosen steps."""

import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu_torch.train import steps
from histogan_tpu_torch.train.trainer import Trainer
from histogan_tpu_torch.utils.debug import FloatCheckError, checkify_step
from histogan_tpu_torch.utils.logging import ProfilerHook

torch.set_num_threads(1)

SMALL = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
             batch_size=2, gradient_accumulate_every=1, seed=0, device="cpu")


def test_checkify_catches_nan():
    wrapped = checkify_step(lambda x: torch.log(x) * 2.0)
    assert wrapped(torch.tensor(2.0)).item() == pytest.approx(2 * math.log(2.0), rel=1e-6)
    with pytest.raises(FloatCheckError, match="aten.log"):
        wrapped(torch.tensor(-1.0))


def test_checkify_clean_path_passes():
    assert checkify_step(lambda x: torch.sqrt(x) + 1.0)(torch.tensor(4.0)).item() == 3.0


class _PlantedNaN(torch.autograd.Function):
    """Identity forward; a backward whose multiply makes a NaN."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * float("nan")


def test_checkify_catches_a_nan_born_in_the_backward():
    def step(x):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(_PlantedNaN.apply(x).square().sum(), x)[0]

    def clean(x):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(x.square().sum(), x)[0]

    assert checkify_step(clean)(torch.ones(3)).sum().item() == 6.0
    with pytest.raises(FloatCheckError, match="aten.mul") as err:
        checkify_step(step)(torch.ones(3))
    assert err.value.op.startswith("aten.mul")

    def sqrt_grad(x):  # d sqrt(x) / dx at 0 is Inf, an op of the backward
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(torch.sqrt(x).sum(), x)[0]

    with pytest.raises(FloatCheckError, match="Inf"):
        checkify_step(sqrt_grad)(torch.tensor([0.0, 1.0]))


def _step_inputs(t):
    rng = np.random.default_rng(0)
    h = rng.random((2, 1, 2, 3, 16, 16), dtype=np.float32)
    batch = {"d_images": torch.from_numpy(rng.integers(0, 256, (1, 2, 32, 32, 3), np.uint8)),
             "d_hists": torch.from_numpy(h[0]), "g_hists": torch.from_numpy(h[1])}
    draws = steps.draw_step(torch.Generator().manual_seed(1), t.cfg, "cpu", apply_pl=True)
    return batch, draws


def test_checkify_a_train_step(tmp_path):
    """The GP+PL step passes clean and sees its backward's ops; with one of
    D's weights NaN it raises and names the op."""
    t = Trainer("d", str(tmp_path / "r"), str(tmp_path / "m"), **SMALL)
    t.init_GAN()
    batch, draws = _step_inputs(t)
    step = checkify_step(steps.train_step)
    m = step(t.state, batch, draws, t.cfg, True, True)
    assert all(math.isfinite(v.item()) for v in m.values())
    assert step.checks.ops["convolution_backward"] > 0  # the backward ran under the mode
    with torch.no_grad():
        t.state.D.blocks[0].conv_res.weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatCheckError, match=r"NaN in the output of aten\."):
        step(t.state, batch, draws, t.cfg, True, True)


def test_profiler_hook_writes_a_trace(tmp_path):
    hook = ProfilerHook(tmp_path / "tr", start=1, count=2)
    x = torch.ones(8)
    for s in range(4):
        torch.mm(x[None], x[:, None])  # step s
        hook.step(s)
    assert hook.path == tmp_path / "tr" / "steps_1-2.json"
    names = {e.get("name") for e in json.loads(hook.path.read_text())["traceEvents"]}
    assert "aten::mm" in names


def test_enable_profiling_traces_two_of_three_steps(tmp_path):
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    t = Trainer("p", str(tmp_path / "r"), str(tmp_path / "m"), **SMALL)
    t.init_GAN()
    t.set_data_src(str(root))
    t.enable_profiling(1, 2)
    try:
        for _ in range(3):
            t.train()
    finally:
        t.close()
    path = tmp_path / "r" / "p" / "traces" / "steps_1-2.json"
    assert t.profiler_hook.path == path
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::convolution_backward" in names
