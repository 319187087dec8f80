"""Generator and discriminator building blocks (NCHW nn.Modules under
the reference state-dict names), the counterpart of
``histogan_tpu/models/blocks.py``.

Style and noise override keyword arguments reproduce the reference's
``forward_`` paths that the projection tools use
(histoGAN/histoGAN.py:392-401, 481-502). Overrides are in this module's
layout: styles (B, C), noises (B, F, H, W).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from histogan_tpu_torch.models.layers import DConv, TorchLinear, leaky_relu
from histogan_tpu_torch.ops.conv2dmod import conv2d_mod
from histogan_tpu_torch.ops.resize import upsample2x
from histogan_tpu_torch.utils import inits


class Conv2DMod(nn.Module):
    """Modulated conv parameter holder (histoGAN/histoGAN.py:404-440);
    ``weight`` is OIHW. ``style`` is the already-projected per-channel
    modulation (B, Cin)."""

    def __init__(self, in_chan: int, out_chan: int, kernel: int, demod: bool = True):
        super().__init__()
        self.demod = demod
        self.weight = nn.Parameter(torch.empty(out_chan, in_chan, kernel, kernel))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        inits.kaiming_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        return conv2d_mod(x, self.weight, style, demod=self.demod)


class RGBBlock(nn.Module):
    """Per-resolution to-RGB head (histoGAN/histoGAN.py:368-401)."""

    def __init__(self, latent_dim: int, input_channel: int, upsample: bool, rgba: bool = False):
        super().__init__()
        self.upsample = upsample
        self.to_style = TorchLinear(latent_dim, input_channel)
        self.conv = Conv2DMod(input_channel, 4 if rgba else 3, 1, demod=False)

    def forward(self, x: torch.Tensor, prev_rgb: Optional[torch.Tensor],
                istyle: Optional[torch.Tensor] = None, *,
                style: Optional[torch.Tensor] = None) -> torch.Tensor:
        if style is None:
            style = self.to_style(istyle)
        x = self.conv(x, style)
        if prev_rgb is not None:
            x = x + prev_rgb
        if self.upsample:
            x = upsample2x(x)
        return x


class GeneratorBlock(nn.Module):
    """StyleGAN2-style synthesis block (histoGAN/histoGAN.py:443-502).

    Noise quirk kept: the reference projects the cropped (B, h, w, 1)
    noise and permutes it to (B, F, w, h) before adding it to the NCHW
    activation, so the noise value at spatial (i, j) is sampled at (j, i).
    """

    def __init__(self, latent_dim: int, input_channels: int, filters: int,
                 upsample: bool = True, upsample_rgb: bool = True, rgba: bool = False):
        super().__init__()
        self.upsample = upsample
        self.to_style1 = TorchLinear(latent_dim, input_channels)
        self.to_noise1 = TorchLinear(1, filters, zero_init=True)
        self.conv1 = Conv2DMod(input_channels, filters, 3)
        self.to_style2 = TorchLinear(latent_dim, filters)
        self.to_noise2 = TorchLinear(1, filters, zero_init=True)
        self.conv2 = Conv2DMod(filters, filters, 3)
        self.to_rgb = RGBBlock(latent_dim, filters, upsample_rgb, rgba)

    def forward(
        self,
        x: torch.Tensor,
        prev_rgb: Optional[torch.Tensor],
        istyle: Optional[torch.Tensor] = None,
        inoise: Optional[torch.Tensor] = None,
        latent: Optional[torch.Tensor] = None,
        *,
        style1: Optional[torch.Tensor] = None,
        style2: Optional[torch.Tensor] = None,
        rgb_style: Optional[torch.Tensor] = None,
        noise1: Optional[torch.Tensor] = None,
        noise2: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.upsample:
            x = upsample2x(x)

        if noise1 is None or noise2 is None:
            if inoise is None:
                raise ValueError("No noise is given")
            crop = inoise[:, : x.shape[2], : x.shape[3], :]
            noise1 = self.to_noise1(crop).permute(0, 3, 2, 1)
            noise2 = self.to_noise2(crop).permute(0, 3, 2, 1)

        if style1 is None:
            style1 = self.to_style1(istyle)
        x = leaky_relu(self.conv1(x, style1) + noise1)
        if latent is not None:
            x = x + latent
        if style2 is None:
            style2 = self.to_style2(istyle)
        x = leaky_relu(self.conv2(x, style2) + noise2)

        rgb = self.to_rgb(x, prev_rgb, istyle, style=rgb_style)
        return x, rgb


class DiscriminatorBlock(nn.Module):
    """Residual downsampling block (histoGAN/histoGAN.py:505-526) as the
    JAX package computes it: ``net(x) + conv_res(x)``, then the strided
    ``downsample`` conv. Reference names: ``conv_res``, ``net.0``,
    ``net.2``, ``downsample``."""

    def __init__(self, input_channels: int, filters: int, downsample: bool = True):
        super().__init__()
        self.conv_res = DConv(input_channels, filters, 1)
        self.net = nn.Sequential(
            DConv(input_channels, filters, 3, padding=1), nn.LeakyReLU(0.2),
            DConv(filters, filters, 3, padding=1), nn.LeakyReLU(0.2),
        )
        self.downsample = (DConv(filters, filters, 3, stride=2, padding=1)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.net(x) + self.conv_res(x)
        if self.downsample is not None:
            x = self.downsample(x)
        return x
