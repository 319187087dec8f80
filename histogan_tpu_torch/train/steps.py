"""One HistoGAN training step in PyTorch, the counterpart of
``histogan_tpu/train/steps.py`` (reference histoGAN/histoGAN.py:853-1020).

A step is a D phase then a G phase, each summing its gradients over
``gradient_accumulate_every`` micro-batches and dividing by their count
before one DiffGrad update: hinge divergence, with the gradient penalty
on the flagged steps (every 4th); adversarial mean plus the Hellinger
histogram loss on ``histogram_feature(relu(G))``, with the path-length
penalty on the flagged steps (every 32nd); then ``pl_mean`` and the EMA.

Differences of form from the JAX step, none of value:
- The step updates the state's modules and optimizers in place.
- torch cannot reproduce JAX's keys, so the step takes its random draws
  as inputs (:class:`StepDraws`): ``draw_step`` makes them from a
  ``torch.Generator`` with the JAX step's distributions, and the parity
  tests rebuild the JAX step's own draws from its key.
- Images are NCHW. Real batches arrive NHWC (uint8 from the loader) and
  are turned NCHW on the device; the histogram loss reads G's output
  permuted to NHWC.
- Gradients are taken with ``torch.autograd.grad`` over the phase's own
  parameters, so the G phase leaves no gradient on D.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from histogan_tpu_torch.ops import losses
from histogan_tpu_torch.ops.histogram import histogram_feature
from histogan_tpu_torch.train.state import HistoGANState

EPS = 1e-8  # histoGAN/histoGAN.py:53


class Models(NamedTuple):
    S: nn.Module
    H: nn.Module
    G: nn.Module
    D: nn.Module


@dataclasses.dataclass
class GenDraws:
    """The random inputs of one generator forward
    (histoGAN/histoGAN.py:166-190).

    ``z1``, ``z2``: (B, latent) normal. ``cutoff``: 0-d integer tensor;
    style rows below it take w(z1), the rest w(z2) (``num_rows`` when the
    draw does not mix). ``noise``: (B, S, S, 1) U[0, 1), NHWC."""

    z1: torch.Tensor
    z2: torch.Tensor
    cutoff: torch.Tensor
    noise: torch.Tensor


@dataclasses.dataclass
class StepDraws:
    """One step's draws: a GenDraws per micro-batch of each phase, and on
    path-length steps the (B, num_layers - 2, latent) normal PL noise per
    G micro-batch."""

    d: List[GenDraws]
    g: List[GenDraws]
    pl: Optional[List[torch.Tensor]] = None


def draw_gen(gen: torch.Generator, batch: int, cfg, device) -> GenDraws:
    """sample_w_rows' and image_noise's draws (steps.py:59-78): mix two
    z's with probability ``mixed_prob`` at a cutoff uniform on
    [0, num_rows), else one z for every row."""
    num_rows = cfg.num_layers - 2
    z1 = torch.randn((batch, cfg.latent_dim), generator=gen, device=device)
    z2 = torch.randn((batch, cfg.latent_dim), generator=gen, device=device)
    use_mixed = torch.rand((), generator=gen, device=device) < cfg.mixed_prob
    tt = torch.randint(0, num_rows, (), generator=gen, device=device)
    cutoff = torch.where(use_mixed, tt, torch.full_like(tt, num_rows))
    noise = torch.rand((batch, cfg.image_size, cfg.image_size, 1), generator=gen, device=device)
    return GenDraws(z1, z2, cutoff, noise)


def draw_step(gen: torch.Generator, cfg, device, apply_pl: bool) -> StepDraws:
    accum, batch = cfg.gradient_accumulate_every, cfg.batch_size
    d = [draw_gen(gen, batch, cfg, device) for _ in range(accum)]
    g = [draw_gen(gen, batch, cfg, device) for _ in range(accum)]
    pl = ([torch.randn((batch, cfg.num_layers - 2, cfg.latent_dim), generator=gen, device=device)
           for _ in range(accum)] if apply_pl else None)
    return StepDraws(d, g, pl)


def sample_w_rows(S: nn.Module, draws: GenDraws, num_rows: int) -> torch.Tensor:
    """(B, num_rows, latent) per-block w: w(z1) below the cutoff, w(z2)
    from it on (mixed_list / noise_list, histoGAN/histoGAN.py:174-176)."""
    w1, w2 = S(draws.z1), S(draws.z2)
    rows = torch.arange(num_rows, device=w1.device)[None, :, None]
    return torch.where(rows < draws.cutoff, w1[:, None, :], w2[:, None, :])


def generate(models: Models, hist_batch: torch.Tensor, draws: GenDraws, num_layers: int):
    """G forward from the draws; returns (NCHW images, w_styles, h_rows)."""
    w_styles = sample_w_rows(models.S, draws, num_layers - 2)
    h_w = models.H(hist_batch)
    h_rows = torch.stack([h_w, h_w], dim=1)  # histoGAN/histoGAN.py:900-902
    return models.G(w_styles, h_rows, draws.noise), w_styles, h_rows


def dequantize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32(u8) / 255 on the device (steps.py:92-103);
    float images pass through."""
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def d_loss(D: nn.Module, fake: torch.Tensor, real: torch.Tensor, apply_gp: bool):
    """Hinge D loss on NCHW fakes and reals; returns (loss, divergence, gp).

    On non-GP steps the two halves go through D as one batch of 2B
    (steps.py:160-186: equal, since D works per sample). On GP steps one
    real forward gives both the hinge logits and the penalty."""
    if not apply_gp:
        b = fake.shape[0]
        logits = D(torch.cat([fake, real], dim=0))
        div = losses.hinge_divergence(logits[b:], logits[:b])
        return div, div, fake.new_zeros(())
    fake_logits = D(fake)
    real_logits, gp = losses.shared_forward_gradient_penalty(D, real)
    div = losses.hinge_divergence(real_logits, fake_logits)
    return div + gp, div, gp


def g_loss(models: Models, hist_batch: torch.Tensor, draws: GenDraws,
           pl_noise: Optional[torch.Tensor], pl_mean: torch.Tensor, cfg, apply_pl: bool):
    """G loss; returns (loss, adversarial, histogram, mean path length)."""
    images, w_styles, h_rows = generate(models, hist_batch, draws, cfg.num_layers)
    adv = torch.mean(models.D(images))
    gen_hists = histogram_feature(
        F.relu(images).permute(0, 2, 3, 1), h=cfg.hist_bin, insz=cfg.hist_insz,
        resizing=cfg.hist_resizing, method=cfg.hist_method, sigma=cfg.hist_sigma)
    hist = losses.hellinger_histogram_loss(hist_batch, gen_hists, cfg.alpha)
    loss = adv + hist
    avg_pl = images.new_zeros(())
    if apply_pl:
        # path-length regularisation (histoGAN/histoGAN.py:965-975) with the
        # JAX package's safe std: var + 1e-12 keeps the sqrt's gradient
        # finite when a w coordinate is equal across the batch
        sigma = torch.sqrt(torch.var(w_styles, dim=0, keepdim=True, correction=1) + 1e-12)
        std = 0.1 / (sigma + EPS)
        w2 = w_styles + pl_noise / (std + EPS)
        pl_images = models.G(w2, h_rows, draws.noise)
        pl_lengths = losses.path_length_lengths(pl_images, images)
        avg_pl = torch.mean(pl_lengths)
        loss = loss + losses.path_length_penalty(pl_lengths, pl_mean)
    return loss, adv, hist, avg_pl


def _accumulate(total, grads):
    if total is None:
        return list(grads)
    torch._foreach_add_(total, list(grads))
    return total


def _update(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor], grads, accum: int) -> None:
    """One optimizer step on the mean of the summed micro-batch gradients."""
    if accum > 1:
        torch._foreach_div_(grads, float(accum))
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def d_phase(state: HistoGANState, batch: Dict[str, torch.Tensor], draws: StepDraws, cfg,
            apply_gp: bool) -> Dict[str, torch.Tensor]:
    models = Models(state.S, state.H, state.G, state.D)
    params = list(state.D.parameters())
    accum = cfg.gradient_accumulate_every
    grads, divs, gp = None, [], None
    for a in range(accum):
        with torch.no_grad():
            fake, _, _ = generate(models, batch["d_hists"][a], draws.d[a], cfg.num_layers)
        real = to_nchw(dequantize_images(batch["d_images"][a]))
        loss, div, gp = d_loss(state.D, fake, real, apply_gp)
        grads = _accumulate(grads, torch.autograd.grad(loss, params))
        divs.append(div.detach())
    _update(state.opt_d, params, grads, accum)
    return {"d_loss": torch.stack(divs).mean(), "q_loss": torch.zeros_like(divs[0]),
            "gp_loss": gp.detach()}


def g_phase(state: HistoGANState, batch: Dict[str, torch.Tensor], draws: StepDraws, cfg,
            apply_pl: bool) -> Dict[str, torch.Tensor]:
    models = Models(state.S, state.H, state.G, state.D)
    params = state.g_params()
    accum = cfg.gradient_accumulate_every
    grads, advs, hists, avg_pl = None, [], [], None
    for a in range(accum):
        pl_noise = draws.pl[a] if apply_pl else None
        loss, adv, hist, avg_pl = g_loss(models, batch["g_hists"][a], draws.g[a], pl_noise,
                                         state.pl_mean, cfg, apply_pl)
        grads = _accumulate(grads, torch.autograd.grad(loss, params))
        advs.append(adv.detach())
        hists.append(hist.detach())
    _update(state.opt_g, params, grads, accum)
    if apply_pl:  # the last micro-batch's mean path length, as the JAX scan carries it
        avg_pl = avg_pl.detach()
        state.pl_mean = torch.where(torch.isnan(avg_pl), state.pl_mean,
                                    state.pl_mean * 0.99 + 0.01 * avg_pl)
    return {"g_loss": torch.stack(advs).mean(), "h_loss": torch.stack(hists).mean(),
            "pl_mean": state.pl_mean}


def train_step(state: HistoGANState, batch: Dict[str, torch.Tensor], draws: StepDraws, cfg,
               apply_gp: bool, apply_pl: bool, apply_ema: bool = False) -> Dict[str, torch.Tensor]:
    """One D phase, one G phase against the updated D, then the moving
    averages. ``batch``: {'d_images': (A, B, S, S, C) uint8 or float NHWC,
    'd_hists', 'g_hists': (A, B, 3, h, h)}, on the state's device.
    Returns the step's metrics as 0-d tensors (no host sync)."""
    metrics = d_phase(state, batch, draws, cfg, apply_gp)
    metrics.update(g_phase(state, batch, draws, cfg, apply_pl))
    if apply_ema:
        state.update_ema()
    state.step += 1
    return metrics
