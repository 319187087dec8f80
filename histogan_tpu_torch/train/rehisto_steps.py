"""One reHistoGAN (recoloring) training step in PyTorch, the counterpart
of ``histogan_tpu/train/rehisto_steps.py`` (reference
rehistoGAN.py:895-1052), in the eager style of ``train/steps.py``.

A step is a D phase then a G phase, each summing its gradients over
``gradient_accumulate_every`` micro-batches and dividing by their count
before one DiffGrad update:
- D: per micro-batch a no-grad recolor of ``d_images`` toward
  ``d_hists``, then the hinge loss of ``steps.d_loss`` against the real
  ``d_images``, with the gradient penalty on the flagged steps (every 4th);
- G, against the updated D: gamma * mean(D(fake)) + the Hellinger loss of
  ``hist(relu(fake))`` (alpha) + beta * the reconstruction loss against
  ``g_images`` + the variance loss. The variance loss keeps the
  reference's hist-of-hist: relu(target histogram) is read as an image
  and goes back through ``histogram_feature`` (rehistoGAN.py:1020).
  With ``fixed_gan_weights`` only ED learns: H and G get zero gradients,
  which still go through DiffGrad (rehistoGAN.py:671-676).

No EMA, path length or style mixing: the reference recoloringTrainer has
none. The discriminator's attention and VQ layers run as in HistoGAN's
step (``steps.d_loss``), without augmentation (the recoloringTrainer has
no AugWrapper); unlike HistoGAN's, the G phase leaves the codebook as it
is (``train_stats=False``, rehisto_steps.py:147-149). As in ``train/steps.py`` the draws are inputs (:class:`ReHistoDraws`,
one (B, S, S, 1) uniform noise per micro-batch of each phase), so the
tests can feed the JAX step's own.

Under ``precision='bf16'`` the step follows the JAX package's policy
(rehisto_steps.py:31-39, 121-175): each phase casts the fp32 masters of
ED, H, G and D once to bf16 copies (``steps.cast_models``), and the
recolor runs on them with the image, the histogram and the noise cast to
bf16; D's logits, the losses and the histograms are fp32, so K1 and K2
see fp32 input (``generated32``). On the CPU the D phase runs under
``steps.cpu_bf16_double_backward_guard``.

Over several ranks the step reduces as ``train/steps.py`` does: the
Hellinger and variance losses read the global batch's sums, each phase's
gradients and the metrics are averaged across the ranks; with the state
sharded each phase gathers the full parameters of ED, H, G and D once and
reduce-scatters its gradients onto the shards, as ``train/steps.py`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from histogan_tpu_torch import parallel
from histogan_tpu_torch.ops import filters, losses
from histogan_tpu_torch.ops.histogram import histogram_feature
from histogan_tpu_torch.parallel import fsdp
from histogan_tpu_torch.train.state import ReHistoGANState
from histogan_tpu_torch.train.steps import (
    _accumulate, _update, cast_models, cast_module, compute_dtype, cpu_bf16_double_backward_guard,
    d_loss, dequantize_images, to_nchw)
from histogan_tpu_torch.utils.logging import span

GAUSS_SIZE, GAUSS_SIGMA = 15, 5.0  # the variance loss's blur (rehisto_steps.py:85)


class RecolorModels(NamedTuple):
    ED: nn.Module
    H: nn.Module
    G: nn.Module
    D: nn.Module


@dataclasses.dataclass
class ReHistoDraws:
    """(B, S, S, 1) U[0, 1) noise for each micro-batch of each phase."""

    d: List[torch.Tensor]
    g: List[torch.Tensor]


def draw_step(gen: torch.Generator, cfg, device) -> ReHistoDraws:
    """The step's noise for the global batch ``cfg.batch_size``; over
    several ranks this rank's slice of it (``local_draws``)."""
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 1)
    accum = cfg.gradient_accumulate_every
    d = [torch.rand(shape, generator=gen, device=device) for _ in range(accum)]
    g = [torch.rand(shape, generator=gen, device=device) for _ in range(accum)]
    return local_draws(ReHistoDraws(d, g))


def local_draws(draws: ReHistoDraws) -> ReHistoDraws:
    """This rank's slice of the global batch's noise; the draws themselves
    at one rank."""
    if parallel.world_size() == 1:
        return draws
    return ReHistoDraws([parallel.local_slice(x) for x in draws.d],
                        [parallel.local_slice(x) for x in draws.g])


def recolor_forward(models: RecolorModels, image_batch: torch.Tensor,
                    hist_batch: torch.Tensor, noise: torch.Tensor, cfg) -> torch.Tensor:
    """The four-way ED/G dispatch (rehistoGAN.py:938-956): ED reads the
    histogram, or under ``internal_hist`` its projection H(hist); G gets
    ED's latent and rgb, H(hist) as the style of both blocks, the noise,
    and with ``skip_conn_to_GAN`` ED's two skip latents. NCHW images in
    and out; ``noise`` is (B, S, S, 1). Under bf16 the inputs are cast
    to bf16, the dtype ``models`` run in (``steps.cast_models``), so the
    output is bf16 too; under fp32 they run as given."""
    dtype = compute_dtype(cfg)
    if dtype != torch.float32:
        image_batch, hist_batch, noise = (x.to(dtype) for x in (image_batch, hist_batch, noise))
    h_w = models.H(hist_batch)
    out = models.ED(image_batch, h_w if cfg.internal_hist else hist_batch)
    return models.G(out[0], out[1], h_w, noise, *out[2:])


def widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 widened to fp32 for the loss math (``.astype(float32)`` in the
    JAX step); an fp32 or float64 tensor as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def rec_variant(rec_loss) -> str:
    """The CLI's ``--rec_loss`` as ``losses.reconstruction_loss``'s variant
    (rehisto_steps.py:62-69)."""
    if rec_loss is None:
        return "L1"
    if rec_loss == "sobel":
        return "1st gradient"
    if rec_loss == "laplacian":
        return "2nd gradient"
    raise ValueError(f"Unknown reconstruction loss {rec_loss!r}")


def _hist(x_nhwc: torch.Tensor, cfg) -> torch.Tensor:
    return histogram_feature(x_nhwc, h=cfg.hist_bin, insz=cfg.hist_insz,
                             resizing=cfg.hist_resizing, method=cfg.hist_method,
                             sigma=cfg.hist_sigma)


def g_loss(models: RecolorModels, image_batch: torch.Tensor, hist_batch: torch.Tensor,
           noise: torch.Tensor, cfg, alpha: float, beta: float, gamma: float,
           gauss: torch.Tensor):
    """G loss; returns (loss, adversarial, histogram, reconstruction,
    variance). ``image_batch`` NCHW. ``models`` run in
    ``compute_dtype(cfg)``; D's logits and the losses are fp32."""
    generated = recolor_forward(models, image_batch, hist_batch, noise, cfg)
    adv = gamma * torch.mean(widen(models.D(generated, train_stats=False)[0]))
    generated32 = widen(generated)  # the loss math in fp32 (rehisto_steps.py:152)
    gen_hists = _hist(F.relu(generated32).permute(0, 2, 3, 1), cfg)
    hist = losses.hellinger_histogram_loss(hist_batch, gen_hists, alpha)
    rec = beta * losses.reconstruction_loss(image_batch, generated32, rec_variant(cfg.rec_loss))
    loss = adv + hist + rec
    var = torch.zeros_like(loss)
    if cfg.variance_loss:
        # the reference's hist-of-hist (rehistoGAN.py:1020)
        hist_of_hist = _hist(F.relu(hist_batch).permute(0, 2, 3, 1), cfg)
        var = losses.variance_loss(hist_batch, hist_of_hist, image_batch, generated32, gauss, beta)
        loss = loss + var
    return loss, adv, hist, rec, var


def d_phase(state: ReHistoGANState, batch: Dict[str, torch.Tensor], draws: ReHistoDraws, cfg,
            apply_gp: bool) -> Dict[str, torch.Tensor]:
    dtype = compute_dtype(cfg)
    *full_g, full_d = fsdp.gather_parameters([state.ED, state.H, state.G, state.D])
    with torch.no_grad():
        models = cast_models(RecolorModels(state.ED, state.H, state.G, None), dtype,
                             [*full_g, None])
    D = cast_module(state.D, dtype, full_d)
    params = fsdp.phase_parameters([state.D], [full_d])
    accum = cfg.gradient_accumulate_every
    grads, divs, qs, gp = None, [], [], None
    for a in range(accum):
        real = to_nchw(dequantize_images(batch["d_images"][a]))
        with torch.no_grad():
            fake = recolor_forward(models, real, batch["d_hists"][a], draws.d[a], cfg)
        # D runs in bf16 under bf16, else on the images as they are (fp32,
        # or a float64 witness's)
        loss, div, q, gp = d_loss(D, fake, real, apply_gp,
                                  dtype if dtype == torch.bfloat16 else real.dtype,
                                  vq=state.D.has_vq)
        grads = _accumulate(grads, torch.autograd.grad(loss, params))
        divs.append(div.detach())
        qs.append(q.detach())
    del models, D, params, full_g, full_d  # the gathered parameters go before the update
    _update(state.opt_d, list(state.D.parameters()), grads, accum)
    return {"d_loss": torch.stack(divs).mean(), "q_loss": torch.stack(qs).mean(),
            "gp_loss": gp.detach()}


def g_phase(state: ReHistoGANState, batch: Dict[str, torch.Tensor], draws: ReHistoDraws, cfg,
            alpha: float, beta: float, gamma: float) -> Dict[str, torch.Tensor]:
    dtype = compute_dtype(cfg)
    gen = (state.ED, state.H, state.G)
    *full_g, full_d = fsdp.gather_parameters([*gen, state.D])
    models = cast_models(RecolorModels(*gen, None), dtype, [*full_g, None])
    with torch.no_grad():  # no gradient is taken on D here
        models = models._replace(D=cast_module(state.D, dtype, full_d))
    params = fsdp.phase_parameters(gen, full_g)
    # with fixed_gan_weights only ED's gradient is taken; H and G get zeros
    trainable = params[:len(list(state.ED.parameters()))] if cfg.fixed_gan_weights else params
    gauss = filters.gaussian_kernel(GAUSS_SIZE, GAUSS_SIGMA).to(params[0].device)
    accum = cfg.gradient_accumulate_every
    grads, terms = None, []
    for a in range(accum):
        image_batch = to_nchw(dequantize_images(batch["g_images"][a]))
        loss, *parts = g_loss(models, image_batch, batch["g_hists"][a], draws.g[a], cfg,
                              alpha, beta, gamma, gauss)
        # ED's rgb output reaches no loss (G discards it), so its conv_out_rgb
        # gets a zero gradient, as in the JAX step
        grads = _accumulate(grads, torch.autograd.grad(loss, trainable, allow_unused=True,
                                                       materialize_grads=True))
        terms.append(torch.stack([p.detach() for p in parts]))
    grads = grads + [torch.zeros_like(p) for p in params[len(trainable):]]
    del models, params, trainable, full_g, full_d
    _update(state.opt_g, state.g_params(), grads, accum)
    means = torch.stack(terms).mean(dim=0)
    return dict(zip(("g_loss", "h_loss", "r_loss", "var_loss"), means))


def train_step(state: ReHistoGANState, batch: Dict[str, torch.Tensor], draws: ReHistoDraws,
               cfg, apply_gp: bool, alpha: float, beta: float,
               gamma: float) -> Dict[str, torch.Tensor]:
    """One D phase, then one G phase against the updated D. ``batch``:
    {'d_images', 'g_images': (A, B, S, S, C) uint8 or float NHWC,
    'd_hists', 'g_hists': (A, B, 3, h, h)}, on the state's device.
    Over several ranks ``batch`` and ``draws`` are the rank's slices.
    Returns the step's metrics as 0-d tensors (no host sync), averaged
    across the ranks."""
    with (cpu_bf16_double_backward_guard(batch["d_hists"].device, compute_dtype(cfg)),
          span("step.d_phase", stream=True)):
        metrics = d_phase(state, batch, draws, cfg, apply_gp)
    with span("step.g_phase", stream=True):
        metrics.update(g_phase(state, batch, draws, cfg, alpha, beta, gamma))
    state.step += 1
    return parallel.mean_metrics_across_ranks(metrics)
