"""Plain float32 PyTorch of HistoGAN's discriminator options and of the
training step that uses them: the benchmark's reference for a
configuration with ``attn_layers``, ``fq_layers`` and ``aug_prob``
(histoGAN.py of github.com/mahmoudnafifi/HistoGAN, its D at :572-631 with
the wiring of :594-601, AugWrapper at :312-331, the D phase at :853-950).

The modules are the third-party ones histoGAN.py imports, written out:
``ImageLinearAttention`` (linear_attention_transformer's images.py) in
Residual(Rezero(.)), two per selected layer; the EMA ``VectorQuantize``
(vector_quantize_pytorch) in its ``PermuteToFrom`` wrapper; DiffAugment's
translation and cutout (utils/diff_augment.py) behind the AugWrapper's
gate and flip. The conv blocks, G, S, H, the losses and DiffGrad are
``models.py``'s and ``steps.py``'s, imported. NCHW, under the reference
state-dict names, so that one state dict (the codebook's buffers
included) loads here and into the program. Nothing here imports the
program or JAX. TF32 is set off on import: a float32 product here is
float32.

Departures from the published modules, none of value at these settings:
- ``to_q``, ``to_k`` and ``to_v`` have no bias: the signature the program
  and the JAX package's converter (histogan_tpu/train/convert.py:114)
  load. The images.py that builds them with ``nn.Conv2d``'s default adds a
  bias to each; k's cancels in its softmax over the pixels, v's adds a
  constant per channel that ``to_out``'s bias can absorb (both softmaxes
  sum to 1), q's alone would change the function. ``to_out`` has its bias
  in both.
- The attention takes no ``context`` and keeps kernel size 1, stride 1,
  padding 0 and ``chan_out`` = ``chan``: the only form histoGAN.py builds.
- The quantize loss is a 0-d tensor, not shape (1,); D returns (logits,
  quantize loss) with the logits squeezed on their last axis only.
- The random draws are inputs: DiffAugment's per-sample offsets and the
  AugWrapper's gate and flip arrive as the program recorded them
  (``StepDraws.d_aug``, ``g_aug``, as ``dataclasses.asdict`` gives them)
  in place of ``torch.randint`` and ``random()``. Only ``translation`` and
  ``cutout`` are written out: the configuration's ``aug_types``.
- The codebook's update runs under ``torch.no_grad`` (published: in place
  on ``.data``), with the same arithmetic.
- ``VectorQuantize.pins``: where the program's nearest code for a row
  differs from this one's and lies within the rounding of the distance
  (``pin_margin``), the row takes the program's code; ``pinned`` and
  ``flipped`` count the rows taken and the rows that differ beyond it.
  Without pins it is the published lookup. ``VectorQuantize.seen``, a
  list, collects the codebook each call finds (its ``embed`` and
  ``cluster_size``).

The step (``histogan_step``) is ``steps.histogan_step`` with D's options:
per D micro-batch the fakes and then the reals go through D (each through
its own AugWrapper draws, each updating the codebook), on GP steps the
penalty taken from the real forward's logits with respect to the real
images before their augmentation; the quantize loss of both calls joins
the hinge divergence (``disc_loss + (fake_q_loss + real_q_loss).mean()``);
the G phase's D call goes through the fakes' AugWrapper draws and updates
the codebook too, and its quantize loss is not G's.
"""

from __future__ import annotations

from math import log2

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import models, steps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

UNIT = 2.0 ** -24  # float32's unit roundoff


# ---------------------------------------------------------------- attention
class ImageLinearAttention(nn.Module):
    def __init__(self, chan, key_dim=64, value_dim=64, heads=8, norm_queries=True):
        super().__init__()
        self.key_dim, self.value_dim, self.heads = key_dim, value_dim, heads
        self.norm_queries = norm_queries
        self.to_q = nn.Conv2d(chan, key_dim * heads, 1, bias=False)
        self.to_k = nn.Conv2d(chan, key_dim * heads, 1, bias=False)
        self.to_v = nn.Conv2d(chan, value_dim * heads, 1, bias=False)
        self.to_out = nn.Conv2d(value_dim * heads, chan, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        q, k, v = (t.reshape(b, self.heads, -1, h * w) for t in (q, k, v))
        q, k = (t * (self.key_dim ** -0.25) for t in (q, k))
        k = k.softmax(dim=-1)
        if self.norm_queries:
            q = q.softmax(dim=-2)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhdn,bhde->bhen", q, context)
        return self.to_out(out.reshape(b, -1, h, w))


class Rezero(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.fn(x) * self.g


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


def attention_pair(chan):
    """histoGAN.py:594-598: two Residual(Rezero(attention)) in a row."""
    return nn.Sequential(*[Residual(Rezero(ImageLinearAttention(chan))) for _ in range(2)])


# ------------------------------------------------------ vector quantization
def pin_margin(flat, e_own, e_prog, dim):
    """Per row, the widest gap between two codes' squared distances at
    which fp32 rounding alone can make the program and this reference pick
    different codes for the same row. Each distance |f|^2 - 2 f.e + |e|^2
    is three sums of ``dim`` products and two additions, off by at most
    (dim + 2) u (|f|^2 + 2 |f| |e| + |e|^2) (u the unit roundoff, |e| the
    larger code's norm); a gap is the difference of two distances, and
    the two sides' gaps err in opposite directions: 4 (dim + 2) u (...)."""
    nf = flat.norm(dim=1)
    ne = torch.maximum(e_own.norm(dim=1), e_prog.norm(dim=1))
    return 4.0 * (dim + 2) * UNIT * (nf.square() + 2.0 * nf * ne + ne.square())


class VectorQuantize(nn.Module):
    def __init__(self, dim, n_embed, decay=0.8, commitment=1.0, eps=1e-5):
        super().__init__()
        self.dim, self.n_embed = dim, n_embed
        self.decay, self.commitment, self.eps = decay, commitment, eps
        self.register_buffer("embed", torch.randn(dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", self.embed.clone())
        self.pins = None  # the program's codes of each call, in order (a shared list)
        self.pinned = self.flipped = 0
        self.seen = None  # the codebook each call finds, in order (a shared list)

    def _pin(self, own, dist, flat):
        prog = self.pins.pop(0) if self.pins else None
        if prog is None or prog.shape != own.shape:
            return own
        prog = prog.to(own.device)
        differ = own != prog
        if not bool(differ.any()):
            return own
        gap = (dist.gather(1, prog[:, None]) - dist.gather(1, own[:, None]))[:, 0]
        e = self.embed.t()
        take = differ & (gap <= pin_margin(flat, e[own], e[prog], self.dim))
        self.pinned += int(take.sum())
        self.flipped += int((differ & ~take).sum())
        return torch.where(take, prog, own)

    def forward(self, input):
        if self.seen is not None:
            self.seen.append({"embed": self.embed.clone(),
                              "cluster_size": self.cluster_size.clone()})
        flatten = input.reshape(-1, self.dim)
        with torch.no_grad():
            dist = (flatten.pow(2).sum(1, keepdim=True) - 2 * flatten @ self.embed
                    + self.embed.pow(2).sum(0, keepdim=True))
            _, embed_ind = (-dist).max(1)
            if self.pins is not None:
                embed_ind = self._pin(embed_ind, dist, flatten)
            embed_onehot = F.one_hot(embed_ind, self.n_embed).type(input.dtype)
            embed_ind = embed_ind.view(*input.shape[:-1])
            quantize = F.embedding(embed_ind, self.embed.transpose(0, 1))
            if self.training:
                self.cluster_size.mul_(self.decay).add_(embed_onehot.sum(0), alpha=1 - self.decay)
                embed_sum = flatten.transpose(0, 1) @ embed_onehot
                self.embed_avg.mul_(self.decay).add_(embed_sum, alpha=1 - self.decay)
                n = self.cluster_size.sum()
                smoothed = (self.cluster_size + self.eps) / (n + self.n_embed * self.eps) * n
                self.embed.copy_(self.embed_avg / smoothed.unsqueeze(0))
        loss = F.mse_loss(quantize, input) * self.commitment
        return input + (quantize - input).detach(), embed_ind, loss


class PermuteToFrom(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        out, _, loss = self.fn(x.permute(0, 2, 3, 1))
        return out.permute(0, 3, 1, 2), loss


# ----------------------------------------------------------- discriminator
class Discriminator(nn.Module):
    """``models.Discriminator`` with attention after the ``attn_layers`` and
    a quantizer after the ``fq_layers`` (numbered from 1)."""

    def __init__(self, image_size, capacity, attn_layers=(), fq_layers=(), fq_dict_size=256):
        super().__init__()
        n = int(log2(image_size) - 1)
        filters = [3] + [capacity * 2 ** i for i in range(n + 1)]
        pairs = list(zip(filters[:-1], filters[1:]))
        self.blocks = nn.ModuleList(models.DiscriminatorBlock(i, o, downsample=k != len(pairs) - 1)
                                    for k, (i, o) in enumerate(pairs))
        self.attn_blocks = nn.ModuleList(attention_pair(o) if k + 1 in attn_layers else None
                                         for k, (_, o) in enumerate(pairs))
        self.quantize_blocks = nn.ModuleList(
            PermuteToFrom(VectorQuantize(o, fq_dict_size)) if k + 1 in fq_layers else None
            for k, (_, o) in enumerate(pairs))
        self.to_logit = nn.Linear(4 * pairs[-1][1], 1)

    def quantizers(self):
        return [q.fn for q in self.quantize_blocks if q is not None]

    def forward(self, x):
        quantize_loss = x.new_zeros(())
        for block, attn, vq in zip(self.blocks, self.attn_blocks, self.quantize_blocks):
            x = block(x)
            if attn is not None:
                x = attn(x)
            if vq is not None:
                x, loss = vq(x)
                quantize_loss = quantize_loss + loss
        return self.to_logit(x.reshape(x.shape[0], -1)).squeeze(-1), quantize_loss


def build_modules(cfg, device="cpu"):
    """``models.build_modules`` with D's options from the configuration."""
    mods = models.build_modules(cfg, device)
    with torch.device(device):
        mods["D"] = Discriminator(cfg["image_size"], cfg["network_capacity"],
                                  cfg.get("attn_layers", ()), cfg.get("fq_layers", ()),
                                  cfg.get("fq_dict_size", 256))
    return mods


def load_flat(mods, flat):
    """``models.load_flat``, and each buffer set to a copy of its tensor in
    ``flat`` (the codebook is updated in place)."""
    models.load_flat(mods, flat)
    for prefix, m in mods.items():
        for name, _ in list(m.named_buffers()):
            owner = m.get_submodule(name.rpartition(".")[0])
            owner.register_buffer(name.rpartition(".")[2], flat[f"{prefix}.{name}"].clone())
    return mods


def buffer_table(mods):
    """(key, shape) of every buffer: the codebooks."""
    return [(f"{p}.{n}", tuple(t.shape)) for p, m in mods.items() for n, t in m.named_buffers()]


# ------------------------------------------------------------- DiffAugment
def rand_translation(x, translation_x, translation_y):
    b, _, h, w = x.shape
    grid_batch, grid_x, grid_y = torch.meshgrid(
        torch.arange(b, device=x.device), torch.arange(h, device=x.device),
        torch.arange(w, device=x.device), indexing="ij")
    grid_x = torch.clamp(grid_x + translation_x.view(-1, 1, 1) + 1, 0, h + 1)
    grid_y = torch.clamp(grid_y + translation_y.view(-1, 1, 1) + 1, 0, w + 1)
    x_pad = F.pad(x, [1, 1, 1, 1, 0, 0, 0, 0])
    return x_pad.permute(0, 2, 3, 1).contiguous()[grid_batch, grid_x, grid_y].permute(0, 3, 1, 2)


def rand_cutout(x, offset_x, offset_y, ratio=0.5):
    b, _, h, w = x.shape
    size = int(h * ratio + 0.5), int(w * ratio + 0.5)
    grid_batch, grid_x, grid_y = torch.meshgrid(
        torch.arange(b, device=x.device), torch.arange(size[0], device=x.device),
        torch.arange(size[1], device=x.device), indexing="ij")
    grid_x = torch.clamp(grid_x + offset_x.view(-1, 1, 1) - size[0] // 2, min=0, max=h - 1)
    grid_y = torch.clamp(grid_y + offset_y.view(-1, 1, 1) - size[1] // 2, min=0, max=w - 1)
    mask = torch.ones(b, h, w, dtype=x.dtype, device=x.device)
    mask[grid_batch, grid_x, grid_y] = 0
    return x * mask.unsqueeze(1)


AUGMENT_FNS = {"translation": [rand_translation], "cutout": [rand_cutout]}


def aug_wrapper(images, draws):
    """AugWrapper on one D call's draws {'apply', 'flip', 'values', 'types'}
    (None: no augmentation): when the gate is on, the whole batch flipped
    along W when the flip is, then DiffAugment in the order of ``types``."""
    if draws is None or not draws["apply"]:
        return images
    if draws["flip"]:
        images = torch.flip(images, dims=(3,))
    fns = [f for t in draws["types"] for f in AUGMENT_FNS[t]]
    for f, values in zip(fns, draws["values"], strict=True):
        images = f(images, *values)
    return images.contiguous()


# -------------------------------------------------------------------- step
def gradient_penalty(images, output, weight=10.0):
    (gradients,) = torch.autograd.grad(output.sum(), images, create_graph=True)
    gradients = gradients.reshape(images.shape[0], -1)
    return weight * ((gradients.norm(2, dim=1) - 1) ** 2).mean()


def histogan_step(m, opt_d, opt_g, batch, draws, cfg, apply_gp, apply_pl, apply_ema, pl_mean,
                  grads_out=None, between=None):
    """``steps.histogan_step`` with D's options; ``draws`` adds 'd_aug'
    [(fakes', reals') per D micro-batch] and 'g_aug' [per G micro-batch],
    each None without augmentation. ``between``, where given, is called
    with ``m`` after D's update and before the G phase. Returns (metrics
    with 'q_loss', the mean over the D micro-batches of both calls'
    quantize losses; new pl_mean)."""
    nl = m["G"].num_layers
    D = m["D"]
    accum = len(draws["d"])
    d_aug = draws.get("d_aug") or [(None, None)] * accum
    g_aug = draws.get("g_aug") or [None] * accum
    d_params = list(D.parameters())
    g_params = [p for k in ("S", "H", "G") for p in m[k].parameters()]
    grads, divs, qs, gp = None, [], [], torch.zeros(())
    for a in range(accum):
        with torch.no_grad():
            fake = steps.generate(m, batch["d_hists"][a], draws["d"][a], nl)[0]
        real = steps.to_nchw(batch["d_images"][a])
        if apply_gp:
            real = real.detach().requires_grad_(True)
        fake_logits, fake_q = D(aug_wrapper(fake, d_aug[a][0]))
        real_logits, real_q = D(aug_wrapper(real, d_aug[a][1]))
        div = steps.hinge(real_logits, fake_logits)
        q = (fake_q + real_q).mean()
        loss = div + q
        if apply_gp:
            gp = gradient_penalty(real, real_logits)
            loss = loss + gp
        gs = torch.autograd.grad(loss, d_params)
        grads = list(gs) if grads is None else [x + y for x, y in zip(grads, gs)]
        divs.append(div.detach())
        qs.append(q.detach())
    grads = [g / accum for g in grads]
    if grads_out is not None:
        grads_out["D"] = grads
    opt_d.step(grads)
    if between is not None:
        between(m)

    grads, advs, hists, avg_pl = None, [], [], None
    for a in range(accum):
        d = draws["g"][a]
        images, w, h_rows = steps.generate(m, batch["g_hists"][a], d, nl)
        adv = torch.mean(D(aug_wrapper(images, g_aug[a]))[0])
        hist = steps.hellinger(batch["g_hists"][a], steps.hist_of(images, cfg), cfg["alpha"])
        loss = adv + hist
        if apply_pl:
            std = 0.1 / (torch.sqrt(torch.var(w, dim=0, keepdim=True) + 1e-12) + steps.EPS)
            pl_images = m["G"](w + draws["pl"][a] / (std + steps.EPS), h_rows, d["noise"])
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
    metrics = {"d_loss": torch.stack(divs).mean(), "q_loss": torch.stack(qs).mean(),
               "g_loss": torch.stack(advs).mean(), "h_loss": torch.stack(hists).mean(),
               "gp_loss": gp.detach()}
    return metrics, pl_mean
