"""The port's bf16 policy (``precision='bf16'``) against the JAX package's,
on the CPU.

One JAX step (``make_train_step`` with ``precision='bf16'``, 32 px,
capacity 4, latent 32, style depth 2, the step-0 flags GP and PL) and the
port's ``train_step`` start from the same weights, batch and draws (JAX
draws z in bf16; the port takes it as fp32, exactly, and casts it). The
port's fp32 step on the same draws is the yardstick for how far bf16 moves
a gradient. The rest: the compute dtypes inside the step, the GP gradient
on the CPU against float64, the degenerate path-length configuration, and
bf16 training through the Trainer and the CLI.

What the tolerances cover: bf16 rounds every intermediate to 8 bits, and
XLA-CPU and torch-CPU round in other places. XLA-CPU adds a bias's
gradient up in bf16 while torch adds in fp32, so on G's last block, whose
noise bias takes a sum over every pixel, the JAX step's bf16 gradient is
4.5 times its own norm away from the fp32 one; the port's is 0.24 away.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.optim import diffgrad as jax_diffgrad
from histogan_tpu.train import steps as jax_steps
from histogan_tpu.train.state import HistoGANState as JaxState
from histogan_tpu.utils.config import HistoGANConfig as JaxConfig
from histogan_tpu_torch.cli import histogan as cli
from histogan_tpu_torch.models.discriminator import Discriminator
from histogan_tpu_torch.ops import losses
from histogan_tpu_torch.train import convert, steps
from histogan_tpu_torch.train.trainer import Trainer
from histogan_tpu_torch.utils.inits import reset_parameters_
from test_torch_steps import (LR, SMALL, JaxDiscriminator, JaxGenerator, JaxHistVectorizer,
                              JaxStyleVectorizer, _batch, _jax_params, _named_grads,
                              jax_step_draws)

torch.set_num_threads(1)

# d_loss and g_loss are made of D's logits, here of magnitude 32-64, where
# bf16's spacing is 0.25: 4 spacings. Measured: 0.25 and 0.47 port vs JAX,
# 0.36 and 0.25 port bf16 vs fp32.
LOGIT_LOSS_ATOL = 1.0
# gp_loss, h_loss, pl_mean, relative. Measured: at most 1.2e-2 port vs JAX
# (pl_mean), 3.9e-3 port bf16 vs fp32.
LOSS_RTOL = 3e-2
# Cosine of the port's and the JAX step's bf16 gradients: all tensors as
# one vector (measured 0.99988), and each of S, H, G, D (worst H, 0.9969).
GRAD_COS_ALL = 0.999
GRAD_COS_MODULE = 0.99
# Per tensor, |port bf16 - port fp32| / |port fp32| (measured at most 0.24,
# D's first block's biases; the JAX step's reaches 4.5).
GRAD_REL_BF16 = 0.5
# Post-step parameters: DiffGrad's first update is lr * sigmoid(|g|) *
# sign(g), so they agree to fp32 rounding where both gradients have one
# sign and nearly one size. Measured: 97.97 % of the entries within
# PARAM_CLOSE (bf16 noise flips the sign of gradients near 0).
PARAM_CLOSE = 1e-6
PARAM_SAME_MIN = 0.95
LIVE = ("S", "H", "G", "D")


def _port_trainer(tmp_path, bundle, precision):
    t = Trainer("p", str(tmp_path / f"r{precision}"), str(tmp_path / f"m{precision}"),
                device="cpu", seed=0, gradient_accumulate_every=1, precision=precision, **SMALL)
    t.init_GAN()
    assert t.load_state_dict(convert.state_dict_from_jax(bundle)) == []
    return t


@pytest.fixture(scope="module")
def bf16_step(tmp_path_factory):
    """One JAX bf16 step (GP and PL), and the port's bf16 and fp32 steps on
    its weights, batch and draws; the only JAX step this file compiles."""
    cfg = JaxConfig(gradient_accumulate_every=1, precision="bf16", **SMALL)
    params_g, params_d = _jax_params(cfg, seed=20)
    bundle = {"params_g": params_g, "params_d": params_d, "ema": params_g}
    models = jax_steps.Models(
        JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity),
        JaxDiscriminator(cfg.image_size, cfg.network_capacity))
    tx = jax_diffgrad(LR, 0.5, 0.9)
    state = JaxState(step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
                     ema=params_g, opt_g=tx.init(params_g), opt_d=tx.init(params_d),
                     pl_mean=jnp.zeros(()))
    batch = _batch(1, seed=21)
    key = jax.random.PRNGKey(22)
    step = jax_steps.make_train_step(models, tx, tx, cfg)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                        apply_gp=True, apply_pl=True)
    new = jax.device_get(new)
    draws = jax_step_draws(key, cfg, apply_pl=True, z_dtype=jnp.bfloat16)
    tmp = tmp_path_factory.mktemp("bf16_step")
    port = {}
    for precision in ("bf16", "fp32"):
        t = _port_trainer(tmp, bundle, precision)
        m = steps.train_step(t.state, {k: torch.from_numpy(v) for k, v in batch.items()},
                             copy.deepcopy(draws), t.cfg, apply_gp=True, apply_pl=True)
        grads = {**_named_grads(t.state, t.state.opt_g, ("S", "H", "G")),
                 **_named_grads(t.state, t.state.opt_d, ("D",))}
        port[precision] = dict(trainer=t, metrics={k: v.item() for k, v in m.items()},
                               grads=grads)
    return dict(
        bundle=bundle, port=port,
        metrics={k: float(v) for k, v in metrics.items()},
        after=convert.state_dict_from_jax(
            {"params_g": new.params_g, "params_d": new.params_d, "ema": new.ema}),
        grads=convert.state_dict_from_jax({"params_g": new.opt_g.previous_grad,
                                           "params_d": new.opt_d.previous_grad,
                                           "ema": new.opt_g.previous_grad}))


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                 dim=0).item()


def _check_losses(got, want):
    assert set(got) == set(want)
    for k in ("d_loss", "g_loss"):
        assert abs(got[k] - want[k]) <= LOGIT_LOSS_ATOL, (k, got[k], want[k])
    for k in ("gp_loss", "h_loss", "pl_mean"):
        assert abs(got[k] - want[k]) <= LOSS_RTOL * abs(want[k]), (k, got[k], want[k])
    assert got["q_loss"] == want["q_loss"] == 0.0


def test_bf16_train_step_matches_jax(bf16_step):
    r = bf16_step
    bf16, fp32 = r["port"]["bf16"], r["port"]["fp32"]
    _check_losses(bf16["metrics"], r["metrics"])
    assert r["metrics"]["gp_loss"] > 0 and r["metrics"]["pl_mean"] > 0  # both terms ran

    got, want = bf16["grads"], r["grads"]
    assert set(got) == {k for k in want if k.split(".")[0] in LIVE}

    def cat(d, keys):
        return torch.cat([d[k].flatten() for k in keys])

    assert _cos(cat(got, got), cat(want, got)) >= GRAD_COS_ALL
    for prefix in LIVE:
        keys = [k for k in got if k.split(".")[0] == prefix]
        assert _cos(cat(got, keys), cat(want, keys)) >= GRAD_COS_MODULE, prefix
    moved = 0
    for k, g in got.items():
        ref = fp32["grads"][k]
        if ref.abs().max() == 0:  # D's last bias takes no gradient from the GP
            continue
        rel = ((g - ref).norm() / ref.norm()).item()
        assert rel <= GRAD_REL_BF16, (k, rel)
        moved += rel > 0
    assert moved > 0.9 * len(got)  # bf16 really ran

    params = bf16["trainer"].reference_state_dict()
    assert set(params) == set(r["after"])
    same = total = 0
    for k, v in params.items():
        same += int(((v - r["after"][k]).abs() <= PARAM_CLOSE).sum())
        total += v.numel()
    assert same >= PARAM_SAME_MIN * total
    before = convert.state_dict_from_jax(r["bundle"])
    assert all(torch.equal(params[k], before[k]) for k in params
               if k.split(".")[0] in ("SE", "HE", "GE"))  # no EMA at step 0


def test_bf16_losses_against_fp32(bf16_step):
    """The port's bf16 and fp32 steps on the same weights and draws."""
    _check_losses(bf16_step["port"]["bf16"]["metrics"], bf16_step["port"]["fp32"]["metrics"])


def test_bf16_keeps_fp32_masters_and_state(bf16_step):
    t = bf16_step["port"]["bf16"]["trainer"]
    for m in t.state.modules().values():
        assert all(p.dtype == torch.float32 for p in m.parameters())
    for opt in (t.state.opt_g, t.state.opt_d):
        for st in opt.state.values():
            assert all(st[k].dtype == torch.float32 for k in ("exp_avg", "previous_grad"))


def test_bf16_step_computes_where_jax_does(tmp_path):
    """bf16 images and logits inside, fp32 losses and an fp32 GP image
    gradient outside; fp32 gradients on the fp32 masters."""
    cfg = JaxConfig(**SMALL)
    params_g, params_d = _jax_params(cfg, seed=60)
    t = _port_trainer(tmp_path, {"params_g": params_g, "params_d": params_d, "ema": params_g},
                      "bf16")
    dt = steps.compute_dtype(t.cfg)
    assert dt == torch.bfloat16
    models = steps.cast_models(steps.Models(t.state.S, t.state.H, t.state.G, t.state.D), dt)
    draws = steps.draw_gen(torch.Generator().manual_seed(0), 2, t.cfg, "cpu")
    hists = torch.from_numpy(_batch(1, seed=61)["g_hists"][0])
    images, w_styles, h_rows = steps.generate(models, hists, draws, t.cfg.num_layers, dt)
    assert images.dtype == w_styles.dtype == h_rows.dtype == torch.bfloat16
    assert models.D(images)[0].dtype == torch.bfloat16
    real = torch.rand(2, 3, 32, 32)
    for gp in (False, True):
        loss, div, q, pen = steps.d_loss(models.D, images.detach(), real, gp, dt)
        assert loss.dtype == div.dtype == q.dtype == pen.dtype == torch.float32
    seen = []
    _, pen = losses.shared_forward_gradient_penalty(
        lambda x: seen.append(x) or models.D(x.to(dt))[0].float(), real)
    assert seen[0].dtype == torch.float32 and pen.dtype == torch.float32
    loss, adv, hist, avg_pl = steps.g_loss(models, hists, draws, torch.randn(2, 2, 32),
                                           torch.zeros(()), t.cfg, True)
    assert all(x.dtype == torch.float32 for x in (loss, adv, hist, avg_pl))
    grads = torch.autograd.grad(loss, t.state.g_params())
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_cpu_bf16_gradient_penalty_matches_float64():
    """The GP's gradient on D's 32x32 convolutions in bf16 on the CPU, as
    the D phase takes it (under ``cpu_bf16_double_backward_guard``),
    against float64."""
    D = reset_parameters_(Discriminator(32, 4), torch.Generator().manual_seed(0))
    real = torch.from_numpy(np.random.default_rng(70).random((2, 3, 32, 32), dtype=np.float32))
    names = ("blocks.0.net.0.weight", "blocks.0.net.2.weight")

    def gp_grads(module, dt):
        run = steps.cast_module(module, dt)
        _, gp = losses.shared_forward_gradient_penalty(
            lambda x: run(x.to(dt))[0].double(), real.to(torch.float64 if dt == torch.float64
                                                      else torch.float32))
        params = dict(module.named_parameters())
        return torch.autograd.grad(gp, [params[n] for n in names])

    want = gp_grads(copy.deepcopy(D).double(), torch.float64)
    with steps.cpu_bf16_double_backward_guard(torch.device("cpu"), torch.bfloat16):
        got = gp_grads(D, torch.bfloat16)
    for n, g, w in zip(names, got, want):
        assert _cos(g, w) >= 0.99, n


def test_bf16_degenerate_path_length_config_stays_finite(tmp_path):
    """Capacity 4, latent 512, style depth 8 at 64 px under bf16 with GP
    and PL (tests/test_precision.py's regression): w coordinates that are
    equal across the batch make the std 0, and the safe variance keeps the
    sqrt's gradient finite."""
    t = Trainer("deg", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", seed=42,
                image_size=64, network_capacity=4, latent_dim=512, style_depth=8,
                batch_size=2, gradient_accumulate_every=1, precision="bf16")
    t.init_GAN()
    rng = np.random.default_rng(0)
    h = rng.random((2, 1, 2, 3, 64, 64), dtype=np.float32)
    h /= h.sum(axis=(3, 4, 5), keepdims=True)
    batch = {"d_images": torch.from_numpy(rng.random((1, 2, 64, 64, 3), dtype=np.float32)),
             "d_hists": torch.from_numpy(h[0]), "g_hists": torch.from_numpy(h[1])}
    draws = steps.draw_step(torch.Generator().manual_seed(100), t.cfg, "cpu", apply_pl=True)
    m = steps.train_step(t.state, batch, draws, t.cfg, apply_gp=True, apply_pl=True)
    assert all(np.isfinite(v.item()) for v in m.values()), m
    for opt in (t.state.opt_g, t.state.opt_d):
        for st in opt.state.values():
            assert all(torch.isfinite(st[k]).all() for k in ("exp_avg", "exp_avg_sq"))
    for m in t.state.modules().values():
        assert all(torch.isfinite(p).all() for p in m.parameters())


@pytest.fixture
def images(tmp_path):
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return root


def test_bf16_trainer_two_steps(images, tmp_path):
    t = Trainer("bf16", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", seed=0,
                image_size=32, network_capacity=4, latent_dim=32, style_depth=2, batch_size=2,
                gradient_accumulate_every=1, hist_bin=16, precision="bf16",
                opt_state_dtype="bf16", ema_dtype="bf16")
    t.init_GAN()
    t.set_data_src(str(images))
    try:
        for _ in range(2):  # step 0 takes GP and PL
            m = t.train()
    finally:
        t.close()
    assert all(np.isfinite(v) for v in m.values()) and t.h_loss > 0
    assert all(p.dtype == torch.float32 for k in LIVE for p in getattr(t.state, k).parameters())
    assert all(p.dtype == torch.bfloat16 for k in ("SE", "HE", "GE")
               for p in getattr(t.state, k).parameters())
    st = t.state.opt_g.state[next(t.G.parameters())]
    assert st["step"] == 2 and st["exp_avg"].dtype == torch.bfloat16


def test_cli_trains_in_bf16(images, tmp_path):
    cli.main(["--data", str(images), "--name", "b", "--new", "True", "--device", "cpu",
              "--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
              "--image_size", "32", "--network_capacity", "2", "--batch_size", "2",
              "--gradient_accumulate_every", "1", "--num_train_steps", "2",
              "--precision", "bf16", "--opt_state_dtype", "bf16", "--ema_dtype", "bf16"])
    payload = torch.load(tmp_path / "mod" / "b" / "model_0.pt", weights_only=True)
    assert payload["GAN"]["GE.initial_block"].dtype == torch.bfloat16
    assert payload["GAN"]["G.initial_block"].dtype == torch.float32
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in payload["opt_g"]["state"].values())
    assert (tmp_path / "res" / "b" / "0-ema.jpg").is_file()
