"""Block-boundary remat in the port (``models/remat.py``), on the CPU.

``remat=True`` checkpoints G's synthesis blocks, D's conv blocks and the
reHistoGAN encoder-decoder's and head's blocks with non-reentrant
``torch.utils.checkpoint``: the same forward values, gradients (the
gradient penalty's double backward included) and parameter names as
without it. The train step with remat, fp32 and bf16, with the step-0
flags (GP and PL), is held against the JAX package's remat step
(``make_train_step`` on models built with ``remat=True``) on the same
weights, batch and draws, with the tolerances of
``tests/test_torch_steps.py`` and ``tests/test_torch_precision.py``; the
reHistoGAN step likewise (``tests/test_torch_rehisto_trainer.py``'s).
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
from histogan_tpu_torch.models import remat
from histogan_tpu_torch.models.discriminator import Discriminator
from histogan_tpu_torch.models.generator import Generator
from histogan_tpu_torch.models.rehisto import RecoloringEncoderDecoder, RecoloringGAN
from histogan_tpu_torch.ops import losses
from histogan_tpu_torch.train import convert, steps
from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
from histogan_tpu_torch.train.trainer import Trainer
from histogan_tpu_torch.utils.inits import reset_parameters_
from test_torch_precision import (GRAD_COS_ALL, GRAD_COS_MODULE, PARAM_SAME_MIN, _check_losses,
                                  _cos)
from test_torch_precision import PARAM_CLOSE as BF16_PARAM_CLOSE
from test_torch_rehisto_trainer import _rehisto_step_parity
from test_torch_steps import (LIVE, LR, SMALL, JaxDiscriminator, JaxGenerator, JaxHistVectorizer,
                              JaxStyleVectorizer, _batch, _compare_step, _jax_params,
                              _named_grads, _port_trainer, jax_step_draws)

torch.set_num_threads(1)

SIZE, CAP, LATENT = 32, 4, 32
FWD_TOL = 1e-6  # forward values, remat against plain (tests/test_remat.py)
GRAD_TOL = 1e-5  # gradients, global-norm relative error (tests/test_remat.py)


def _pair(make, seed=0):
    """The module without and with remat, the same weights."""
    plain = reset_parameters_(make(False), torch.Generator().manual_seed(seed))
    checked = make(True)
    assert list(plain.state_dict()) == list(checked.state_dict())  # .pt files interchange
    checked.load_state_dict(plain.state_dict(), strict=True)
    return plain, checked


def _grad_err(a, b) -> float:
    va = torch.cat([x.double().flatten() for x in a])
    vb = torch.cat([x.double().flatten() for x in b])
    return ((va - vb).norm() / (vb.norm() + 1e-12)).item()


def _rand(*shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _check(plain, checked, run):
    """``run(module)`` -> (output, loss) on both; forward to FWD_TOL, the
    loss's parameter gradients to GRAD_TOL."""
    out0, loss0 = run(plain)
    out1, loss1 = run(checked)
    assert (out0 - out1).abs().max().item() <= FWD_TOL * max(1.0, out0.abs().max().item())
    g0 = torch.autograd.grad(loss0, list(plain.parameters()))
    g1 = torch.autograd.grad(loss1, list(checked.parameters()))
    assert _grad_err(g1, g0) < GRAD_TOL
    assert any(x.abs().max() > 0 for x in g0)


def test_generator_remat_matches_plain():
    plain, checked = _pair(lambda r: Generator(SIZE, LATENT, CAP, remat=r))
    w = torch.randn(2, plain.num_layers - 2, LATENT, generator=torch.Generator().manual_seed(1))
    h = torch.randn(2, 2, LATENT, generator=torch.Generator().manual_seed(2))
    noise = _rand(2, SIZE, SIZE, 1, seed=3)

    def run(g):
        out = g(w, h, noise)
        return out, torch.mean(out ** 2)

    _check(plain, checked, run)


def test_generator_overrides_are_never_checkpointed(monkeypatch):
    """A block given the projection tools' overrides takes the plain call,
    the others are checkpointed (the JAX package's per-block choice)."""
    _, checked = _pair(lambda r: Generator(SIZE, LATENT, CAP, remat=r))
    calls, real = [], remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    n, first = len(checked.blocks), checked.blocks[0]
    noises = [(torch.zeros(1, first.conv1.weight.shape[0], 4, 4),
               torch.zeros(1, first.conv2.weight.shape[0], 4, 4))] + [None] * (n - 1)
    out = checked(torch.randn(1, checked.num_layers - 2, LATENT), torch.randn(1, 2, LATENT),
                  torch.rand(1, SIZE, SIZE, 1), block_noises=noises)
    assert torch.isfinite(out).all() and len(calls) == n - 1


def test_discriminator_remat_matches_plain_with_the_gradient_penalty():
    """Attention and VQ (never checkpointed) between checkpointed conv
    blocks; the loss is the hinge term plus the gradient penalty, a double
    backward through the checkpointed blocks."""
    plain, checked = _pair(lambda r: Discriminator(SIZE, CAP, fq_layers=(2,), fq_dict_size=16,
                                                   attn_layers=(1,), remat=r))
    real = _rand(2, 3, SIZE, SIZE, seed=4)

    def run(d):
        logits, q, gp = losses.shared_forward_gradient_penalty(lambda x: d(x), real,
                                                               has_aux=True)
        return logits, torch.mean(torch.relu(1.0 + logits)) + q + gp

    _check(plain, checked, run)


@pytest.mark.parametrize("skip,internal", [(True, False), (False, True)])
def test_encoder_decoder_and_head_remat_match_plain(skip, internal):
    hbin = 16
    plain, checked = _pair(lambda r: RecoloringEncoderDecoder(
        SIZE, CAP, hbin, LATENT, 2, skip_conn_to_GAN=skip, internal_hist=internal, remat=r))
    head0, head1 = _pair(lambda r: RecoloringGAN(SIZE, LATENT, CAP, remat=r), seed=5)
    x = _rand(2, 3, SIZE, SIZE, seed=6)
    hist = _rand(2, LATENT, seed=7) if internal else _rand(2, 3, hbin, hbin, seed=7)
    style, noise = _rand(2, LATENT, seed=8), _rand(2, SIZE, SIZE, 1, seed=9)
    heads = {id(plain): head0, id(checked): head1}

    def run(ed):
        out = ed(x, hist)
        rgb = heads[id(ed)](out[0], out[1], style, noise, *out[2:])
        return rgb, torch.mean(rgb ** 2) + torch.mean(out[1] ** 2)

    _check(plain, checked, run)
    g0 = torch.autograd.grad(run(plain)[1], list(head0.parameters()))
    g1 = torch.autograd.grad(run(checked)[1], list(head1.parameters()))
    assert _grad_err(g1, g0) < GRAD_TOL


def _jax_remat_step(precision):
    """One JAX step of models built with remat=True, step-0 flags."""
    cfg = JaxConfig(gradient_accumulate_every=1, precision=precision, remat=True, **SMALL)
    params_g, params_d = _jax_params(cfg, seed=20)
    models = jax_steps.Models(
        JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity, remat=True),
        JaxDiscriminator(cfg.image_size, cfg.network_capacity, remat=True))
    tx = jax_diffgrad(LR, 0.5, 0.9)
    state = JaxState(step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
                     ema=params_g, opt_g=tx.init(params_g), opt_d=tx.init(params_d),
                     pl_mean=jnp.zeros(()))
    batch = _batch(1, seed=21)
    key = jax.random.PRNGKey(22)
    new, metrics = jax_steps.make_train_step(models, tx, tx, cfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key, apply_gp=True,
        apply_pl=True)
    new = jax.device_get(new)
    z_dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32
    return dict(cfg=cfg, bundle={"params_g": params_g, "params_d": params_d, "ema": params_g},
                batch=batch, draws=jax_step_draws(key, cfg, apply_pl=True, z_dtype=z_dtype),
                metrics={k: float(v) for k, v in metrics.items()},
                after={"params_g": new.params_g, "params_d": new.params_d, "ema": new.ema},
                grads={"params_g": new.opt_g.previous_grad, "params_d": new.opt_d.previous_grad,
                       "ema": new.opt_g.previous_grad})


def _port_remat_step(tmp_path, r, precision):
    t = _port_trainer(tmp_path, r["bundle"], remat=True, precision=precision)
    assert t.G.remat and t.D.remat
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    metrics = steps.train_step(t.state, batch, copy.deepcopy(r["draws"]), t.cfg, apply_gp=True,
                               apply_pl=True)
    assert r["metrics"]["gp_loss"] > 0 and r["metrics"]["pl_mean"] > 0  # both terms ran
    return t, metrics


def test_remat_train_step_matches_jax_fp32(tmp_path):
    r = _jax_remat_step("fp32")
    t, metrics = _port_remat_step(tmp_path, r, "fp32")
    _compare_step(t, r, metrics, LIVE)


def test_remat_train_step_matches_jax_bf16(tmp_path):
    """The bf16 cast (``functional_call`` on bf16 copies) under remat: the
    recompute runs on the copies, not on the fp32 masters; held to the
    JAX bf16 remat step in tests/test_torch_precision.py's gates."""
    r = _jax_remat_step("bf16")
    t, metrics = _port_remat_step(tmp_path, r, "bf16")
    _check_losses({k: v.item() for k, v in metrics.items()}, r["metrics"])
    got = {**_named_grads(t.state, t.state.opt_g, ("S", "H", "G")),
           **_named_grads(t.state, t.state.opt_d, ("D",))}
    want = convert.state_dict_from_jax(r["grads"])

    def cat(d, keys):
        return torch.cat([d[k].flatten() for k in keys])

    assert _cos(cat(got, got), cat(want, got)) >= GRAD_COS_ALL
    for prefix in LIVE:
        keys = [k for k in got if k.split(".")[0] == prefix]
        assert _cos(cat(got, keys), cat(want, keys)) >= GRAD_COS_MODULE, prefix
    params, after = t.reference_state_dict(), convert.state_dict_from_jax(r["after"])
    same = sum(int(((v - after[k]).abs() <= BF16_PARAM_CLOSE).sum()) for k, v in params.items())
    assert same >= PARAM_SAME_MIN * sum(v.numel() for v in params.values())
    # and the same as the port's bf16 step without remat, bit for bit on the CPU
    plain = _port_trainer(tmp_path / "plain", r["bundle"], precision="bf16")
    steps.train_step(plain.state, {k: torch.from_numpy(v) for k, v in r["batch"].items()},
                     copy.deepcopy(r["draws"]), plain.cfg, apply_gp=True, apply_pl=True)
    ref = plain.reference_state_dict()
    assert all(torch.equal(params[k], ref[k]) for k in ref)


def test_rehisto_remat_train_step_matches_jax(tmp_path):
    t, _, _ = _rehisto_step_parity(tmp_path, True, 1, False, remat=True)
    assert t.ED.remat and t.G.remat and t.D.remat


@pytest.fixture
def images(tmp_path):
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return root


def test_trainers_take_a_gp_step_with_remat(tmp_path, images):
    """Trainer and RecoloringTrainer with remat=True take step 0 (the GP;
    HistoGAN's the PL too), save and load: the checkpoint has the plain
    models' keys."""
    small = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
                 batch_size=2, gradient_accumulate_every=1, seed=0, device="cpu")
    for cls, extra in ((Trainer, {}), (RecoloringTrainer, {"skip_conn_to_GAN": True})):
        t = cls("rm", str(tmp_path / cls.__name__ / "r"), str(tmp_path / cls.__name__ / "m"),
                remat=True, **small, **extra)
        t.init_GAN()
        t.set_data_src(str(images))
        try:
            m = t.train()
        finally:
            t.close()
        assert all(np.isfinite(v) for v in m.values()) and m["gp_loss"] > 0
        plain = cls("pl", str(tmp_path / cls.__name__ / "r"), str(tmp_path / cls.__name__ / "m"),
                    **small, **extra)
        plain.init_GAN()
        saved = torch.load(t.store.path(0), weights_only=True)["GAN"]
        assert set(saved) == set(plain.reference_state_dict())
        plain.load_state_dict(saved)
