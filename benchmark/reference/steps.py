"""The training steps, the recolor and the sampler of HistoGAN and
reHistoGAN in plain float32 PyTorch, on the modules of ``models.py``.

A training step is a D phase then a G phase against the updated D, each
summing its gradients over the micro-batches and dividing by their count
before one DiffGrad update (histoGAN.py:853-1020, rehistoGAN.py:895-1052):
hinge divergence with the gradient penalty on the flagged steps; for
HistoGAN the adversarial mean plus the Hellinger loss on the histogram of
relu(G), with the path-length penalty on the flagged steps, then
``pl_mean`` and the EMA; for reHistoGAN gamma times the adversarial mean,
the Hellinger loss, beta times the Laplacian reconstruction loss and the
variance loss. The step's random draws and its batch are inputs.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import histogram

SCALE = 1.0 / math.sqrt(2.0)
EPS = 1e-8


class DiffGrad:
    """DiffGrad (Dubey et al., 2019) with betas (0.5, 0.9), eps 1e-8, per
    tensor, in float32. ``state[i]``: (m, v, previous gradient)."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas=(0.5, 0.9), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.t = 0
        self.state = [None] * len(params)

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        size = self.lr * math.sqrt(1.0 - b2 ** self.t) / (1.0 - b1 ** self.t)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.state[i] is None:
                self.state[i] = (torch.zeros_like(p), torch.zeros_like(p), torch.zeros_like(p))
            m, v, prev = self.state[i]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            dfc = torch.sigmoid((prev - g).abs())
            p.add_(-size * dfc * m / (v.sqrt() + self.eps))
            prev.copy_(g)


def hinge(real_logits, fake_logits):
    return torch.mean(F.relu(1.0 + real_logits) + F.relu(1.0 - fake_logits))


def hellinger(target, generated, alpha):
    diff = torch.sqrt(target) - torch.sqrt(generated)
    return alpha * SCALE * torch.sqrt(diff.square().sum()) / target.shape[0]


def gradient_penalty(D, real, weight=10.0):
    """(logits, gp): one real forward gives both."""
    real = real.detach().requires_grad_(True)
    logits = D(real)
    (g,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
    norms = g.reshape(g.shape[0], -1).norm(dim=1)
    return logits, weight * torch.mean((norms - 1.0).square())


def d_loss(D, fake, real, apply_gp):
    if not apply_gp:
        logits = D(torch.cat([fake, real]))
        b = fake.shape[0]
        div = hinge(logits[b:], logits[:b])
        return div, div, real.new_zeros(())
    fake_logits = D(fake)
    real_logits, gp = gradient_penalty(D, real)
    div = hinge(real_logits, fake_logits)
    return div + gp, div, gp


def hist_of(images_nchw, cfg):
    return histogram.hist_of(F.relu(images_nchw).permute(0, 2, 3, 1), cfg)


def to_nchw(u8):
    return (u8.float() / 255.0).permute(0, 3, 1, 2)


# ----------------------------------------------------------------- HistoGAN
def generate(m, hist, d, num_layers):
    """G from draws ``d`` {'z1', 'z2', 'cutoff', 'noise'}: style rows
    below the cutoff take w(z1), the rest w(z2); H(hist) drives the last
    two blocks. Returns (images, w_styles, h_rows)."""
    w1, w2 = m["S"](d["z1"]), m["S"](d["z2"])
    rows = torch.arange(num_layers - 2, device=w1.device)[None, :, None]
    w = torch.where(rows < d["cutoff"], w1[:, None], w2[:, None])
    h_w = m["H"](hist)
    h_rows = torch.stack([h_w, h_w], dim=1)
    return m["G"](w, h_rows, d["noise"]), w, h_rows


def histogan_step(m, opt_d, opt_g, batch, draws, cfg, apply_gp, apply_pl, apply_ema,
                  pl_mean, grads_out=None, between=None):
    """One step on the modules ``m`` (S, H, G, D, SE, HE, GE), in place.
    ``batch``: {'d_images' (A, B, S, S, 3) uint8, 'd_hists', 'g_hists'
    (A, B, 3, h, h)}; ``draws``: {'d', 'g': [draws per micro-batch], 'pl':
    [noise per micro-batch] or None}. ``between``, where given, is called
    with ``m`` after D's update and before the G phase. Returns (metrics,
    new pl_mean)."""
    nl = m["G"].num_layers
    accum = len(draws["d"])
    d_params = list(m["D"].parameters())
    g_params = [p for k in ("S", "H", "G") for p in m[k].parameters()]
    grads, divs, gp = None, [], torch.zeros(())
    for a in range(accum):
        with torch.no_grad():
            fake = generate(m, batch["d_hists"][a], draws["d"][a], nl)[0]
        loss, div, gp = d_loss(m["D"], fake, to_nchw(batch["d_images"][a]), apply_gp)
        gs = torch.autograd.grad(loss, d_params)
        grads = list(gs) if grads is None else [x + y for x, y in zip(grads, gs)]
        divs.append(div.detach())
    grads = [g / accum for g in grads]
    if grads_out is not None:
        grads_out["D"] = grads
    opt_d.step(grads)
    if between is not None:
        between(m)

    grads, advs, hists, avg_pl = None, [], [], None
    for a in range(accum):
        d = draws["g"][a]
        images, w, h_rows = generate(m, batch["g_hists"][a], d, nl)
        adv = torch.mean(m["D"](images))
        hist = hellinger(batch["g_hists"][a], hist_of(images, cfg), cfg["alpha"])
        loss = adv + hist
        if apply_pl:
            std = 0.1 / (torch.sqrt(torch.var(w, dim=0, keepdim=True) + 1e-12) + EPS)
            pl_images = m["G"](w + draws["pl"][a] / (std + EPS), h_rows, d["noise"])
            lengths = torch.mean((pl_images - images).square(), dim=(1, 2, 3))
            avg_pl = lengths.mean()
            pen = torch.mean((lengths - pl_mean).square())
            loss = loss + torch.where(torch.isnan(pen), torch.zeros_like(pen), pen)
        gs = torch.autograd.grad(loss, g_params)
        grads = list(gs) if grads is None else [x + y for x, y in zip(grads, gs)]
        advs.append(adv.detach())
        hists.append(hist.detach())
    grads = [g / accum for g in grads]
    if grads_out is not None:
        grads_out["G"] = grads
    opt_g.step(grads)
    if apply_pl:
        avg_pl = avg_pl.detach()
        pl_mean = torch.where(torch.isnan(avg_pl), pl_mean, pl_mean * 0.99 + 0.01 * avg_pl)
    if apply_ema:
        with torch.no_grad():
            for e, live in (("SE", "S"), ("HE", "H"), ("GE", "G")):
                for pe, pl in zip(m[e].parameters(), m[live].parameters()):
                    pe.mul_(0.995).add_(pl, alpha=0.005)
    metrics = {"d_loss": torch.stack(divs).mean(), "g_loss": torch.stack(advs).mean(),
               "h_loss": torch.stack(hists).mean(), "gp_loss": gp.detach()}
    return metrics, pl_mean


@torch.no_grad()
def sample_truncated(m, hist, z, noise, av, psi, chunk):
    """EMA samples: w = psi (S(z) - av) + av for every style row, H(hist)
    tile-doubled to the batch, G in chunks of ``chunk``; NHWC in [0, 1]."""
    n = z.shape[0]
    w = psi * (m["SE"](z) - av) + av
    w = w[:, None].expand(n, m["GE"].num_layers - 2, w.shape[-1])
    h_w = m["HE"](hist)
    h_rows = torch.stack([h_w, h_w], dim=1)
    for _ in range(int(np.log2(np.sqrt(n)))):
        h_rows = torch.cat([h_rows, h_rows])
    h_rows = h_rows[:n]
    out = torch.cat([m["GE"](w[s:s + chunk], h_rows[s:s + chunk], noise[s:s + chunk])
                     for s in range(0, n, chunk)])
    return out.permute(0, 2, 3, 1).clamp(0.0, 1.0)


# --------------------------------------------------------------- reHistoGAN
def recolor(m, images_nchw, hist, noise):
    """ED reads the image (and the histogram, for the skip latents),
    H(hist) styles both head blocks; NCHW out."""
    x, latent1, latent2 = m["ED"](images_nchw, hist)
    return m["G"](x, m["H"](hist), noise, latent1, latent2)


def gaussian_kernel(size=15, sigma=5.0):
    c = np.arange(size, dtype=np.float32)
    xg, yg = np.meshgrid(c, c, indexing="xy")
    mean = (size - 1) / 2.0
    k = np.exp(-((xg - mean) ** 2 + (yg - mean) ** 2) / (2.0 * sigma ** 2)) / (2.0 * math.pi
                                                                                * sigma ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def laplacian(x):
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], device=x.device)
    return F.conv2d(x, k.expand(1, x.shape[1], 3, 3), padding=1)


def variance_loss(hist, hist_of_hist, x_in, x_gen, beta):
    k = gaussian_kernel().to(x_in.device)
    c = x_in.shape[1]

    def std2(x):
        x = F.conv2d(x, k.expand(c, 1, *k.shape), groups=c)
        return torch.std(torch.std(x, dim=2), dim=2)

    color = torch.sum(torch.abs(hist - hist_of_hist))
    return -(beta / 10.0) * color * torch.mean(torch.abs(std2(x_in) - std2(x_gen)))


def rehistogan_step(m, opt_d, opt_g, batch, draws, cfg, apply_gp, grads_out=None):
    """One recoloring step on ``m`` (ED, H, G, D), in place. ``batch`` adds
    'g_images'; ``draws``: {'d', 'g': [(B, S, S, 1) noise per
    micro-batch]}."""
    alpha, beta, gamma = cfg["alpha"], cfg["beta"], cfg["gamma"]
    accum = len(draws["d"])
    d_params = list(m["D"].parameters())
    g_params = [p for k in ("ED", "H", "G") for p in m[k].parameters()]
    grads, divs, gp = None, [], torch.zeros(())
    for a in range(accum):
        real = to_nchw(batch["d_images"][a])
        with torch.no_grad():
            fake = recolor(m, real, batch["d_hists"][a], draws["d"][a])
        loss, div, gp = d_loss(m["D"], fake, real, apply_gp)
        gs = torch.autograd.grad(loss, d_params)
        grads = list(gs) if grads is None else [x + y for x, y in zip(grads, gs)]
        divs.append(div.detach())
    grads = [g / accum for g in grads]
    if grads_out is not None:
        grads_out["D"] = grads
    opt_d.step(grads)

    grads, terms = None, []
    for a in range(accum):
        x = to_nchw(batch["g_images"][a])
        h = batch["g_hists"][a]
        gen = recolor(m, x, h, draws["g"][a])
        adv = gamma * torch.mean(m["D"](gen))
        hist = hellinger(h, hist_of(gen, cfg), alpha)
        rec = beta * torch.mean(torch.abs(laplacian(x) - laplacian(gen)))
        loss = adv + hist + rec
        var = torch.zeros(())
        if cfg["variance_loss"]:
            hoh = hist_of(h, cfg)
            var = variance_loss(h, hoh, x, gen, beta)
            loss = loss + var
        gs = torch.autograd.grad(loss, g_params, allow_unused=True, materialize_grads=True)
        grads = list(gs) if grads is None else [x + y for x, y in zip(grads, gs)]
        terms.append(torch.stack([t.detach() for t in (adv, hist, rec, var)]))
    grads = [g / accum for g in grads]
    if grads_out is not None:
        grads_out["G"] = grads
    opt_g.step(grads)
    means = torch.stack(terms).mean(dim=0)
    metrics = dict(zip(("g_loss", "h_loss", "r_loss", "var_loss"), means))
    metrics.update(d_loss=torch.stack(divs).mean(), gp_loss=gp.detach())
    return metrics


def pool_interp(pool: Dict[int, torch.Tensor], pair, r):
    """r * pool[i] + (1 - r) * pool[j] per item: the target histograms of
    a batch from its draws."""
    a = torch.stack([pool[int(i)] for i in pair[0]])
    b = torch.stack([pool[int(j)] for j in pair[1]])
    r = r[:, None, None, None]
    return r * a + (1.0 - r) * b
