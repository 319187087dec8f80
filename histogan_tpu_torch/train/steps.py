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

The discriminator's options run as in the JAX step (steps.py:139-186,
230-314): with ``aug_prob`` > 0 every D call goes through ``aug_wrapper``
(per D micro-batch one AugDraws for the fakes and one for the reals, per
G micro-batch one for the fakes); with VQ layers the fakes and then the
reals go through D one after the other, each updating the codebook (on a
GP step once, inside the shared real forward), the G phase updates it
too, and ``q_loss`` is the mean of the fake and real quantize losses,
which D's loss includes. Without VQ the non-GP D forward stays merged.

Under ``precision='bf16'`` the step follows the JAX package's policy
(steps.py:88-186, 246-314): each phase casts the fp32 master parameters
to bf16 copies once (``cast_models``; the casts are differentiable, so
fp32 gradients reach the masters) and S, H, G and D run on them with bf16
inputs; D's logits, the losses, the histogram, the gradient penalty's
image gradient and the path length's statistics are fp32. The draws stay
fp32 and are cast where JAX draws or casts them. With fp32 the casts are
no-ops and the modules run themselves.

Over several ranks (``parallel/``) the step is the global batch's, as the
JAX step is under GSPMD: every rank draws the global batch's draws from
the same generators and keeps its slice (``local_draws``), its batch is
its slice, the losses that are not per-sample means read global sums
(the Hellinger norm, the path length's std), each phase's gradients are
averaged across the ranks before DiffGrad, the path length's mean before
``pl_mean`` moves, and the returned metrics too, so that every rank sees
the same NaN verdict. At one rank each of these is the identity.

With the state sharded (``param_sharding='fsdp'``, ``parallel/fsdp.py``)
each phase first gathers the full parameters of the modules it runs, once
(the D phase S, H, G and D; the G phase S, H, G and D), and runs the
unchanged phase code on them through ``functional_call``; the gradients
are taken with respect to the gathered tensors, and ``_update``
reduce-scatters them onto the shards, which DiffGrad steps. The sums are
those of data parallel, so at two ranks the step is data parallel's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from histogan_tpu_torch import parallel
from histogan_tpu_torch.ops import losses
from histogan_tpu_torch.ops.diffaugment import AugDraws, aug_wrapper, draw_aug
from histogan_tpu_torch.ops.histogram import histogram_feature
from histogan_tpu_torch.parallel import fsdp
from histogan_tpu_torch.train.state import HistoGANState
from histogan_tpu_torch.utils.logging import span

EPS = 1e-8  # histoGAN/histoGAN.py:53


class Models(NamedTuple):
    """The modules, or callables that run them on cast parameters."""

    S: Callable
    H: Callable
    G: Callable
    D: Callable


def compute_dtype(cfg) -> torch.dtype:
    """The compute dtype of ``cfg.precision`` (steps.py:88-89)."""
    return torch.bfloat16 if getattr(cfg, "precision", "fp32") == "bf16" else torch.float32


def cast_module(module: nn.Module, dtype: torch.dtype,
                params: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
    """``module`` run on its parameters cast to ``dtype`` (``cast_tree``,
    steps.py:106-111): the module itself at fp32, else a
    ``functional_call`` on copies cast once here. Under grad mode the
    casts carry fp32 gradients back to the parameters. ``params`` (the
    gathered full parameters of a sharded module) replace the module's
    own."""
    if params is None:
        if dtype == torch.float32:
            return module
        params = dict(module.named_parameters())
    params = {n: p.to(dtype) for n, p in params.items()}
    return lambda *args, **kwargs: torch.func.functional_call(module, params, args, kwargs)


@contextlib.contextmanager
def cpu_bf16_double_backward_guard(device: torch.device, dtype: torch.dtype):
    """oneDNN off for a bf16 phase on the CPU. torch's CPU double backward
    of a bf16 convolution through oneDNN returns a wrong weight gradient
    once the image is over 16x16 (cosine to float64 about 0, where the same
    op without oneDNN agrees to bf16 rounding); the gradient penalty takes
    that double backward. The card's convolutions do not go through
    oneDNN."""
    off = device.type == "cpu" and dtype == torch.bfloat16
    was = torch.backends.mkldnn.enabled
    if off:
        torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def cast_models(models, dtype: torch.dtype, params=None):
    """``cast_module`` of each module of ``models`` (a ``Models`` or
    another NamedTuple of modules), in a tuple of its type; a None stays
    None. ``params``: per module its gathered parameters or None
    (``fsdp.gather_parameters``)."""
    params = params or [None] * len(models)
    return type(models)(*(None if m is None else cast_module(m, dtype, p)
                          for m, p in zip(models, params)))


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
    """One step's draws: a GenDraws per micro-batch of each phase, on
    path-length steps the (B, num_layers - 2, latent) normal PL noise per
    G micro-batch, and with ``aug_prob`` > 0 the AugWrapper draws: (fakes,
    reals) per D micro-batch, the fakes' per G micro-batch."""

    d: List[GenDraws]
    g: List[GenDraws]
    pl: Optional[List[torch.Tensor]] = None
    d_aug: Optional[List[Tuple[AugDraws, AugDraws]]] = None
    g_aug: Optional[List[AugDraws]] = None


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


def draw_step(gen: torch.Generator, cfg, device, apply_pl: bool,
              coins: Optional[torch.Generator] = None) -> StepDraws:
    """The step's draws from ``gen`` (on ``device``). With ``aug_prob`` > 0
    the AugWrapper's gates and flips come from ``coins``, a CPU generator
    (``gen`` itself when it is one), and its other draws after the rest,
    so that they leave the draws of a run without augmentation as they
    are; with ``aug_prob`` 0 nothing more is drawn. ``cfg.batch_size`` is
    the global batch: over several ranks this rank keeps its slice
    (``local_draws``)."""
    accum, batch = cfg.gradient_accumulate_every, cfg.batch_size
    d = [draw_gen(gen, batch, cfg, device) for _ in range(accum)]
    g = [draw_gen(gen, batch, cfg, device) for _ in range(accum)]
    pl = ([torch.randn((batch, cfg.num_layers - 2, cfg.latent_dim), generator=gen, device=device)
           for _ in range(accum)] if apply_pl else None)
    if cfg.aug_prob <= 0.0:
        return local_draws(StepDraws(d, g, pl))
    if coins is None:
        if gen.device.type != "cpu":
            raise ValueError("aug_prob > 0 on a device generator needs a CPU generator for "
                             "the AugWrapper's coins")
        coins = gen

    def aug():
        return draw_aug(gen, coins, batch, cfg.image_size, cfg.image_size, cfg.aug_prob,
                        cfg.aug_types, device)

    d_aug = [(aug(), aug()) for _ in range(accum)]
    g_aug = [aug() for _ in range(accum)]
    return local_draws(StepDraws(d, g, pl, d_aug, g_aug))


def local_draws(draws: StepDraws) -> StepDraws:
    """This rank's slice of the global batch's draws: every per-sample
    draw; the cutoff and the AugWrapper's gate and flip are the batch's.
    The draws themselves at one rank."""
    if parallel.world_size() == 1:
        return draws
    cut = parallel.local_slice

    def gen(d: GenDraws) -> GenDraws:
        return GenDraws(cut(d.z1), cut(d.z2), d.cutoff, cut(d.noise))

    def aug(a: AugDraws) -> AugDraws:
        return dataclasses.replace(a, values=[[cut(v) for v in vs] for vs in a.values])

    return StepDraws(
        [gen(d) for d in draws.d], [gen(d) for d in draws.g],
        None if draws.pl is None else [cut(p) for p in draws.pl],
        None if draws.d_aug is None else [(aug(f), aug(r)) for f, r in draws.d_aug],
        None if draws.g_aug is None else [aug(a) for a in draws.g_aug])


def sample_w_rows(S: nn.Module, draws: GenDraws, num_rows: int) -> torch.Tensor:
    """(B, num_rows, latent) per-block w: w(z1) below the cutoff, w(z2)
    from it on (mixed_list / noise_list, histoGAN/histoGAN.py:174-176)."""
    w1, w2 = S(draws.z1), S(draws.z2)
    rows = torch.arange(num_rows, device=w1.device)[None, :, None]
    return torch.where(rows < draws.cutoff, w1[:, None, :], w2[:, None, :])


def generate(models: Models, hist_batch: torch.Tensor, draws: GenDraws, num_layers: int,
             dtype: torch.dtype = torch.float32):
    """G forward from the draws, with z, the histogram and the noise in
    ``dtype`` (steps.py:114-129); returns (NCHW images, w_styles, h_rows)."""
    z = dataclasses.replace(draws, z1=draws.z1.to(dtype), z2=draws.z2.to(dtype))
    w_styles = sample_w_rows(models.S, z, num_layers - 2)
    h_w = models.H(hist_batch.to(dtype))
    h_rows = torch.stack([h_w, h_w], dim=1)  # histoGAN/histoGAN.py:900-902
    return models.G(w_styles, h_rows, draws.noise.to(dtype)), w_styles, h_rows


def dequantize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32(u8) / 255 on the device (steps.py:92-103);
    float images pass through."""
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def d_input(images: torch.Tensor, dtype: torch.dtype, aug: Optional[AugDraws]) -> torch.Tensor:
    """``images`` cast to ``dtype`` and, with ``aug``, through the AugWrapper."""
    x = images.to(dtype)
    return x if aug is None else aug_wrapper(x, aug)


def d_apply(D: Callable, images: torch.Tensor, dtype: torch.dtype, aug: Optional[AugDraws]):
    """D (updating its codebook) on ``d_input(images, dtype, aug)``
    (``_apply_d``, steps.py:139-157); returns (logits, quantize loss), both
    fp32."""
    logits, q = D(d_input(images, dtype, aug), train_stats=True)
    return logits.float(), q.float()


def d_loss(D: Callable, fake: torch.Tensor, real: torch.Tensor, apply_gp: bool,
           dtype: torch.dtype = torch.float32, aug: Optional[Tuple[AugDraws, AugDraws]] = None,
           vq: bool = False):
    """Hinge D loss on NCHW fakes and reals; returns (loss, divergence,
    quantize loss, gp). D runs on images cast to ``dtype``, each half
    through its AugWrapper draws of ``aug`` (fakes, reals); its logits are
    cast to fp32.

    Without VQ (``vq`` False) on non-GP steps the two halves go through D
    as one batch of 2B (steps.py:160-186: equal, since D works per
    sample). Otherwise the fakes and then the reals go through D, each
    updating the codebook (steps.py:233-268); on GP steps one real forward
    gives both the hinge logits and the penalty, the real images entering
    it fp32 and before the augmentation, so their gradient is fp32 and
    taken through it (steps.py:246-258)."""
    aug_f, aug_r = aug if aug is not None else (None, None)
    if not apply_gp and not vq:
        b = fake.shape[0]
        logits, q = d_apply(D, torch.cat([d_input(fake, dtype, aug_f),
                                          d_input(real, dtype, aug_r)]), dtype, None)
        div = losses.hinge_divergence(logits[b:], logits[:b])
        return div + q, div, q, real.new_zeros(())
    fake_logits, fake_q = d_apply(D, fake, dtype, aug_f)
    if apply_gp:
        with span("step.gp"):
            real_logits, real_q, gp = losses.shared_forward_gradient_penalty(
                lambda x: d_apply(D, x, dtype, aug_r), real, has_aux=True)
    else:
        (real_logits, real_q), gp = d_apply(D, real, dtype, aug_r), real.new_zeros(())
    div = losses.hinge_divergence(real_logits, fake_logits)
    q = torch.mean(fake_q + real_q)
    return div + q + gp, div, q, gp


def g_loss(models: Models, hist_batch: torch.Tensor, draws: GenDraws,
           pl_noise: Optional[torch.Tensor], pl_mean: torch.Tensor, cfg, apply_pl: bool,
           aug: Optional[AugDraws] = None):
    """G loss; returns (loss, adversarial, histogram, mean path length).
    ``models`` run in ``compute_dtype(cfg)`` (``cast_models``); the losses
    and the histogram are fp32 (steps.py:274-314). D sees G's images
    through the AugWrapper draws ``aug``."""
    dtype = compute_dtype(cfg)
    images, w_styles, h_rows = generate(models, hist_batch, draws, cfg.num_layers, dtype)
    # the G phase updates the codebook too (steps.py:277-279)
    adv = torch.mean(d_apply(models.D, images, dtype, aug)[0])
    gen_hists = histogram_feature(
        F.relu(images.float()).permute(0, 2, 3, 1), h=cfg.hist_bin, insz=cfg.hist_insz,
        resizing=cfg.hist_resizing, method=cfg.hist_method, sigma=cfg.hist_sigma)
    hist = losses.hellinger_histogram_loss(hist_batch, gen_hists, cfg.alpha)
    loss = adv + hist
    avg_pl = hist.new_zeros(())
    if apply_pl:
        # path-length regularisation (histoGAN/histoGAN.py:965-975) in fp32
        # with the JAX package's safe std: var + 1e-12 keeps the sqrt's
        # gradient finite when a w coordinate is equal across the batch (as
        # it can be under bf16); the variance is the global batch's
        with span("step.pl"):
            w32 = w_styles.float()
            sigma = torch.sqrt(parallel.batch_var(w32) + 1e-12)
            std = 0.1 / (sigma + EPS)
            w2 = w32 + pl_noise / (std + EPS)
            pl_images = models.G(w2.to(dtype), h_rows, draws.noise.to(dtype))
            pl_lengths = losses.path_length_lengths(pl_images.float(), images.float())
            avg_pl = torch.mean(pl_lengths)
            loss = loss + losses.path_length_penalty(pl_lengths, pl_mean)
    return loss, adv, hist, avg_pl


def _accumulate(total, grads):
    if total is None:
        return list(grads)
    torch._foreach_add_(total, list(grads))
    return total


def _update(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor], grads, accum: int) -> None:
    """One optimizer step of ``params`` (the optimizer's: shards of a
    sharded module) on the mean of the summed micro-batch gradients
    ``grads`` (full size), averaged across the ranks, a shard's
    reduce-scattered onto it (``grads`` then holds the shard's)."""
    with span("step.update", stream=True):
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        fsdp.reduce_gradients_(params, grads)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None


def d_phase(state: HistoGANState, batch: Dict[str, torch.Tensor], draws: StepDraws, cfg,
            apply_gp: bool) -> Dict[str, torch.Tensor]:
    dtype = compute_dtype(cfg)
    *full_g, full_d = fsdp.gather_parameters([state.S, state.H, state.G, state.D])
    with torch.no_grad():
        gen = cast_models(Models(state.S, state.H, state.G, None), dtype, [*full_g, None])
    D = cast_module(state.D, dtype, full_d)
    params = fsdp.phase_parameters([state.D], [full_d])
    accum = cfg.gradient_accumulate_every
    grads, divs, qs, gp = None, [], [], None
    for a in range(accum):
        with torch.no_grad():
            fake, _, _ = generate(gen, batch["d_hists"][a], draws.d[a], cfg.num_layers, dtype)
        real = to_nchw(dequantize_images(batch["d_images"][a]))
        loss, div, q, gp = d_loss(D, fake, real, apply_gp, dtype,
                                  draws.d_aug[a] if draws.d_aug else None, state.D.has_vq)
        grads = _accumulate(grads, torch.autograd.grad(loss, params))
        divs.append(div.detach())
        qs.append(q.detach())
    del gen, D, params, full_g, full_d  # the gathered parameters go before the update
    _update(state.opt_d, list(state.D.parameters()), grads, accum)
    return {"d_loss": torch.stack(divs).mean(), "q_loss": torch.stack(qs).mean(),
            "gp_loss": gp.detach()}


def g_phase(state: HistoGANState, batch: Dict[str, torch.Tensor], draws: StepDraws, cfg,
            apply_pl: bool) -> Dict[str, torch.Tensor]:
    dtype = compute_dtype(cfg)
    gen = (state.S, state.H, state.G)
    *full_g, full_d = fsdp.gather_parameters([*gen, state.D])
    models = cast_models(Models(*gen, None), dtype, [*full_g, None])
    with torch.no_grad():  # no gradient is taken on D here
        models = models._replace(D=cast_module(state.D, dtype, full_d))
    params = fsdp.phase_parameters(gen, full_g)
    accum = cfg.gradient_accumulate_every
    grads, advs, hists, avg_pl = None, [], [], None
    for a in range(accum):
        pl_noise = draws.pl[a] if apply_pl else None
        loss, adv, hist, avg_pl = g_loss(models, batch["g_hists"][a], draws.g[a], pl_noise,
                                         state.pl_mean, cfg, apply_pl,
                                         draws.g_aug[a] if draws.g_aug else None)
        grads = _accumulate(grads, torch.autograd.grad(loss, params))
        advs.append(adv.detach())
        hists.append(hist.detach())
    del models, params, full_g, full_d
    _update(state.opt_g, state.g_params(), grads, accum)
    if apply_pl:  # the last micro-batch's mean path length, as the JAX scan carries it
        avg_pl = parallel.mean_across_ranks(avg_pl.detach())
        state.pl_mean = torch.where(torch.isnan(avg_pl), state.pl_mean,
                                    state.pl_mean * 0.99 + 0.01 * avg_pl)
    return {"g_loss": torch.stack(advs).mean(), "h_loss": torch.stack(hists).mean(),
            "pl_mean": state.pl_mean}


def train_step(state: HistoGANState, batch: Dict[str, torch.Tensor], draws: StepDraws, cfg,
               apply_gp: bool, apply_pl: bool, apply_ema: bool = False) -> Dict[str, torch.Tensor]:
    """One D phase, one G phase against the updated D, then the moving
    averages. ``batch``: {'d_images': (A, B, S, S, C) uint8 or float NHWC,
    'd_hists', 'g_hists': (A, B, 3, h, h)}, on the state's device.
    Over several ranks ``batch`` and ``draws`` are the rank's slices.
    Returns the step's metrics as 0-d tensors (no host sync), averaged
    across the ranks."""
    with (cpu_bf16_double_backward_guard(state.pl_mean.device, compute_dtype(cfg)),
          span("step.d_phase", stream=True)):
        metrics = d_phase(state, batch, draws, cfg, apply_gp)
    with span("step.g_phase", stream=True):
        metrics.update(g_phase(state, batch, draws, cfg, apply_pl))
    if apply_ema:
        with span("step.ema", stream=True):
            state.update_ema()
    state.step += 1
    return parallel.mean_metrics_across_ranks(metrics)
