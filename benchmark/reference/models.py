"""Plain float32 PyTorch modules of HistoGAN and reHistoGAN, the
benchmark's own reference (histoGAN.py and rehistoGAN.py of
github.com/mahmoudnafifi/HistoGAN, as the port computes them).

NCHW, under the reference state-dict names, so that one state dict made by
the benchmark loads into these modules and into the program alike. No
kernel, remat, attention, vector quantisation or bf16 path: the
benchmark's configurations use none of them. Nothing here imports the
program or JAX.

Quirks of the published code kept, as the port keeps them:
- the modulated convolution is the input-scale / output-demod form of
  ``conv(x_b, W * (s_b + 1))`` with ``rsqrt(sum W^2 (s + 1)^2 + 1e-8)``;
- the generator block's noise is projected from the (B, h, w, 1) crop and
  permuted to (B, F, w, h), so the value at (i, j) is sampled at (j, i);
- the reHistoGAN head ignores the rgb it is passed, so the decoder's rgb
  branch reaches no output;
- the skip projections to the head take their widths from the encoder's
  filter list after its in-place reverse (4c and 2c), and the head's first
  block adds the skip latent made at S/2, its second the one made at S.
"""

from __future__ import annotations

from math import log2

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-8


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def conv2d_mod(x, weight, style, demod=True):
    """x (B, Cin, H, W), weight (Cout, Cin, k, k), style (B, Cin)."""
    s = style + 1.0
    out = F.conv2d(x * s[:, :, None, None], weight, padding=(weight.shape[2] - 1) // 2)
    if demod:
        d = torch.rsqrt(torch.einsum("oihw,bi->bo", weight.square(), s.square()) + EPS)
        out = out * d[:, :, None, None]
    return out


class Conv2DMod(nn.Module):
    def __init__(self, cin, cout, k, demod=True):
        super().__init__()
        self.demod = demod
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x, style):
        return conv2d_mod(x, self.weight, style, self.demod)


class RGBBlock(nn.Module):
    def __init__(self, latent, cin, upsample):
        super().__init__()
        self.upsample = upsample
        self.to_style = nn.Linear(latent, cin)
        self.conv = Conv2DMod(cin, 3, 1, demod=False)

    def forward(self, x, prev_rgb, istyle):
        x = self.conv(x, self.to_style(istyle))
        if prev_rgb is not None:
            x = x + prev_rgb
        return upsample2x(x) if self.upsample else x


class GeneratorBlock(nn.Module):
    def __init__(self, latent, cin, filters, upsample=True, upsample_rgb=True):
        super().__init__()
        self.upsample = upsample
        self.to_style1 = nn.Linear(latent, cin)
        self.to_noise1 = nn.Linear(1, filters)
        self.conv1 = Conv2DMod(cin, filters, 3)
        self.to_style2 = nn.Linear(latent, filters)
        self.to_noise2 = nn.Linear(1, filters)
        self.conv2 = Conv2DMod(filters, filters, 3)
        self.to_rgb = RGBBlock(latent, filters, upsample_rgb)

    def forward(self, x, prev_rgb, istyle, inoise, latent=None):
        if self.upsample:
            x = upsample2x(x)
        crop = inoise[:, : x.shape[2], : x.shape[3], :]
        noise1 = self.to_noise1(crop).permute(0, 3, 2, 1)
        noise2 = self.to_noise2(crop).permute(0, 3, 2, 1)
        x = lrelu(self.conv1(x, self.to_style1(istyle)) + noise1)
        if latent is not None:
            x = x + latent
        x = lrelu(self.conv2(x, self.to_style2(istyle)) + noise2)
        return x, self.to_rgb(x, prev_rgb, istyle)


def generator_pairs(image_size, capacity):
    n = int(log2(image_size) - 1)
    filters = [4 * capacity] + [capacity * 2 ** (i + 1) for i in range(n)][::-1]
    return list(zip(filters[:-1], filters[1:]))


class Generator(nn.Module):
    def __init__(self, image_size, latent, capacity):
        super().__init__()
        self.num_layers = int(log2(image_size) - 1)
        self.initial_block = nn.Parameter(torch.empty(4 * capacity, 4, 4))
        self.blocks = nn.ModuleList(
            GeneratorBlock(latent, i, o, upsample=k != 0, upsample_rgb=k != self.num_layers - 1)
            for k, (i, o) in enumerate(generator_pairs(image_size, capacity)))

    def forward(self, styles, hists, noise):
        """styles (B, L-2, latent), hists (B, 2, latent), noise (B, S, S, 1)."""
        x = self.initial_block[None].expand(styles.shape[0], -1, -1, -1)
        rows = torch.cat([styles, hists], dim=1)
        rgb = None
        for k, block in enumerate(self.blocks):
            x, rgb = block(x, rgb, rows[:, k], noise)
        return rgb


def _mlp(widths):
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        layers += [nn.Linear(a, b), nn.LeakyReLU(0.2)]
    return nn.Sequential(*layers)


class StyleVectorizer(nn.Module):
    def __init__(self, emb, depth):
        super().__init__()
        self.net = _mlp([emb] * (depth + 1))

    def forward(self, z):
        return self.net(z)


class HistVectorizer(nn.Module):
    def __init__(self, bins, emb, depth):
        super().__init__()
        self.fcs = _mlp([3 * bins * bins, 2 * emb] + [emb] * (depth - 1))

    def forward(self, h):
        return self.fcs(h.reshape(h.shape[0], -1))


class DiscriminatorBlock(nn.Module):
    def __init__(self, cin, filters, downsample=True):
        super().__init__()
        self.conv_res = nn.Conv2d(cin, filters, 1)
        self.net = nn.Sequential(nn.Conv2d(cin, filters, 3, padding=1), nn.LeakyReLU(0.2),
                                 nn.Conv2d(filters, filters, 3, padding=1), nn.LeakyReLU(0.2))
        self.downsample = (nn.Conv2d(filters, filters, 3, stride=2, padding=1)
                           if downsample else None)

    def forward(self, x):
        x = self.net(x) + self.conv_res(x)
        return self.downsample(x) if self.downsample is not None else x


class Discriminator(nn.Module):
    def __init__(self, image_size, capacity):
        super().__init__()
        n = int(log2(image_size) - 1)
        filters = [3] + [capacity * 2 ** i for i in range(n + 1)]
        pairs = list(zip(filters[:-1], filters[1:]))
        self.blocks = nn.ModuleList(DiscriminatorBlock(i, o, downsample=k != len(pairs) - 1)
                                    for k, (i, o) in enumerate(pairs))
        self.to_logit = nn.Linear(4 * pairs[-1][1], 1)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.to_logit(x.reshape(x.shape[0], -1)).squeeze(-1)


class RecoloringGAN(nn.Module):
    """The last two generator blocks, styled by H(hist) in both."""

    def __init__(self, image_size, latent, capacity):
        super().__init__()
        (a, b), (c, d) = generator_pairs(image_size, capacity)[-2:]
        self.blocks = nn.ModuleList([GeneratorBlock(latent, a, b, True, True),
                                     GeneratorBlock(latent, c, d, True, False)])

    def forward(self, x, hists, noise, latent1=None, latent2=None):
        x, rgb = self.blocks[0](x, None, hists, noise, latent1)
        return self.blocks[1](x, rgb, hists, noise, latent2)[1]


class EncoderBlock(nn.Module):
    def __init__(self, cin, filters):
        super().__init__()
        self.conv_res = nn.Conv2d(cin, filters, 1)
        self.net = nn.Sequential(
            nn.Conv2d(cin, filters, 3, padding=1), nn.InstanceNorm2d(filters), nn.LeakyReLU(0.2),
            nn.Conv2d(filters, filters, 3, padding=1), nn.InstanceNorm2d(filters),
            nn.LeakyReLU(0.2))
        self.downsample = nn.Conv2d(filters, filters, 3, stride=2, padding=1)

    def forward(self, x):
        """(the block's output, downsampled; the same at full size)."""
        y = self.net(x) + self.conv_res(x)
        return self.downsample(y), y


class DecoderBlock(nn.Module):
    def __init__(self, cin, filters):
        super().__init__()
        self.block1 = nn.Sequential(nn.Conv2d(cin, cin, 3, padding=1), nn.LeakyReLU(0.2))
        self.block2 = nn.Sequential(nn.Conv2d(2 * cin, filters, 3, padding=1), nn.LeakyReLU(0.2))
        self.conv_res = nn.Conv2d(cin, filters, 1)
        self.conv_out_latent = nn.Sequential(nn.Conv2d(filters, filters, 3, padding=1),
                                             nn.LeakyReLU(0.2))
        self.conv_out_rgb = nn.Conv2d(filters, 3, 1)

    def forward(self, x, prev_latent):
        processed = self.block2(torch.cat([self.block1(x), prev_latent], dim=1))
        return upsample2x(self.conv_out_latent(self.conv_res(x) + processed))


class RecoloringEncoderDecoder(nn.Module):
    """The encoder, the decoder and the 1x1 mapping to 8c channels, and
    with ``skip`` (skip connections to the GAN, without the internal
    histogram) the two skip latents: the target histogram through its own
    HistVectorizer styles a modulated 3x3 convolution of the second
    encoder block's full-size output (at S/2) and one of the first's (at
    S). The decoder's rgb branch reaches no output (the head ignores it),
    so it is left out of the forward; its weights stay in the state
    dict."""

    def __init__(self, image_size, capacity, bins, latent, depth, skip):
        super().__init__()
        enc = [capacity] + [capacity * 2 ** (i + 1) for i in range(int(log2(image_size) - 2))]
        dec = enc[::-1][: int(log2(image_size) - 4) + 1]
        self.skip = skip
        self.mapping = nn.Conv2d(3, capacity, 3, padding=1)
        self.encoder_blocks = nn.ModuleList(EncoderBlock(i, o) for i, o in zip(enc[:-1], enc[1:]))
        self.decoder_blocks = nn.ModuleList(DecoderBlock(i, o) for i, o in zip(dec[:-1], dec[1:]))
        self.decoder_mapping = nn.Conv2d(dec[-1], 8 * capacity, 1)
        if skip:
            self.hist_projection = HistVectorizer(bins, latent, depth)
            self.to_latent_1 = nn.Linear(latent, enc[2])
            self.to_latent_2 = nn.Linear(latent, enc[1])
            self.conv_latent_1 = Conv2DMod(enc[2], 4 * capacity, 3)
            self.conv_latent_2 = Conv2DMod(enc[1], 2 * capacity, 3)

    def forward(self, x, hists):
        """(the latent at S/4; the skip latents at S/2 and S, or None)."""
        x = self.mapping(x)
        downs, fulls = [], []
        for block in self.encoder_blocks:
            x, full = block(x)
            downs.append(x)
            fulls.append(full)
        for block, prev in zip(self.decoder_blocks, downs[::-1]):
            x = block(x, prev)
        x = self.decoder_mapping(x)
        if not self.skip:
            return x, None, None
        h_w = self.hist_projection(hists)
        return (x, self.conv_latent_1(fulls[1], self.to_latent_1(h_w)),
                self.conv_latent_2(fulls[0], self.to_latent_2(h_w)))


def histogan_modules(cfg):
    """{prefix: module} of a HistoGAN trainer's state dict: S, H, G, D and
    the EMA copies SE, HE, GE."""
    c, lat, depth = cfg["network_capacity"], cfg["latent_dim"], cfg["style_depth"]
    mods = {"S": StyleVectorizer(lat, depth), "H": HistVectorizer(cfg["hist_bin"], lat, depth),
            "G": Generator(cfg["image_size"], lat, c), "D": Discriminator(cfg["image_size"], c)}
    mods.update(SE=StyleVectorizer(lat, depth), HE=HistVectorizer(cfg["hist_bin"], lat, depth),
                GE=Generator(cfg["image_size"], lat, c))
    return mods


def rehistogan_modules(cfg):
    """{prefix: module} of a recoloring trainer's state dict: ED, H, G, D."""
    c, lat, depth = cfg["network_capacity"], cfg["latent_dim"], cfg["style_depth"]
    if cfg["internal_hist"]:
        raise NotImplementedError("the reference has no internal histogram")
    return {"ED": RecoloringEncoderDecoder(cfg["image_size"], c, cfg["hist_bin"], lat, depth,
                                           cfg["skip_conn_to_GAN"]),
            "H": HistVectorizer(cfg["hist_bin"], lat, depth),
            "G": RecoloringGAN(cfg["image_size"], lat, c),
            "D": Discriminator(cfg["image_size"], c)}


def build_modules(cfg, device="cpu"):
    """The configuration's modules on ``device`` (``meta`` for shapes and
    counts alone), parameters uninitialised."""
    with torch.device(device):
        mods = histogan_modules(cfg) if cfg["model"] == "histogan" else rehistogan_modules(cfg)
    return mods


def load_flat(mods, flat):
    """Point every parameter of ``mods`` at its tensor in the flat
    ``{prefix.name: tensor}`` dict (no copy)."""
    for prefix, m in mods.items():
        for name, p in list(m.named_parameters()):
            owner = m.get_submodule(name.rpartition(".")[0]) if "." in name else m
            setattr(owner, name.rpartition(".")[2], nn.Parameter(flat[f"{prefix}.{name}"]))
    return mods
