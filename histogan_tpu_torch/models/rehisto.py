"""ReHistoGAN: the recoloring encoder-decoder and the two-block GAN head,
the counterpart of ``histogan_tpu/models/rehisto.py`` (reference
rehistoGAN.py:449-718), NCHW, under the reference's state-dict names.

Quirks kept:
- ``RecoloringGAN.forward`` discards the ``rgb`` it is passed and starts
  from None (rehistoGAN.py:479).
- The reference aliases ``decoder_filters = encoder_filters`` and reverses
  the list IN PLACE (rehistoGAN.py:565-566), so its later reads of
  ``encoder_filters[-3]`` and ``[-2]`` (rehistoGAN.py:579-580) hit the
  REVERSED list: ``to_latent_1`` projects to reversed[-3] (4 * capacity)
  and ``to_latent_2`` to reversed[-2] (2 * capacity). The sizes are read
  from the reversed list explicitly.
- The skip latents: the encoder-decoder returns (processed_latent_1,
  processed_latent_2) and the reference trainer swaps their names twice
  (rehistoGAN.py:940-944), so the head's latent1 is conv_latent_1's
  output. They are returned and passed straight through, in direct order.
"""

from __future__ import annotations

from math import log2
from typing import List, Optional, Tuple

import torch
from torch import nn

from histogan_tpu_torch.models.blocks import Conv2DMod, GeneratorBlock
from histogan_tpu_torch.models.generator import generator_filters
from histogan_tpu_torch.models.layers import InstanceNorm, TorchConv, TorchLinear
from histogan_tpu_torch.models.remat import call_block
from histogan_tpu_torch.models.vectorizers import HistVectorizer
from histogan_tpu_torch.ops.resize import upsample2x


class RecoloringGAN(nn.Module):
    """The last two generator blocks (rehistoGAN.py:449-482), ``blocks.0``
    and ``blocks.1``."""

    def __init__(self, image_size: int, latent_dim: int = 512, network_capacity: int = 16,
                 transparent: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat  # checkpoint each block (models/remat.py)
        pairs = generator_filters(image_size, network_capacity)[-2:]
        self.blocks = nn.ModuleList([
            GeneratorBlock(latent_dim, pairs[0][0], pairs[0][1], upsample=True,
                           upsample_rgb=True, rgba=transparent),
            GeneratorBlock(latent_dim, pairs[1][0], pairs[1][1], upsample=True,
                           upsample_rgb=False, rgba=transparent),
        ])

    def forward(self, x: torch.Tensor, rgb: Optional[torch.Tensor], hists: torch.Tensor,
                input_noise: torch.Tensor, latent1: Optional[torch.Tensor] = None,
                latent2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, 8c, S/4, S/4); hists: (B, latent) style of both blocks;
        input_noise: (B, S, S, 1) NHWC. Returns (B, 3|4, S, S)."""
        rgb = None  # reference quirk: the passed rgb is ignored (rehistoGAN.py:479)
        x, rgb = call_block(self.blocks[0], self.remat, x, rgb, hists, input_noise, latent1)
        x, rgb = call_block(self.blocks[1], self.remat, x, rgb, hists, input_noise, latent2)
        return rgb


class EncoderBlock(nn.Module):
    """Residual conv block with InstanceNorm (rehistoGAN.py:485-504):
    ``net`` = [conv, norm, lrelu, conv, norm, lrelu], the 1x1 ``conv_res``
    and the strided ``downsample``. Returns (downsampled, full-size)."""

    def __init__(self, input_channels: int, filters: int):
        super().__init__()
        self.conv_res = TorchConv(input_channels, filters, 1)
        self.net = nn.Sequential(
            TorchConv(input_channels, filters, 3, padding=1), InstanceNorm(), nn.LeakyReLU(0.2),
            TorchConv(filters, filters, 3, padding=1), InstanceNorm(), nn.LeakyReLU(0.2),
        )
        self.downsample = TorchConv(filters, filters, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.net(x) + self.conv_res(x)
        return self.downsample(y), y


class DecoderBlock(nn.Module):
    """U-Net style decoder block (rehistoGAN.py:507-546). The skip latent
    it concatenates has ``input_channels`` channels; under
    ``internal_hist`` it is first modulated by the projected histogram."""

    def __init__(self, input_channels: int, filters: int, latent_dim: int,
                 internal_hist: bool = False):
        super().__init__()
        self.internal_hist = internal_hist
        self.block1 = nn.Sequential(TorchConv(input_channels, input_channels, 3, padding=1),
                                    nn.LeakyReLU(0.2))
        self.block2 = nn.Sequential(TorchConv(2 * input_channels, filters, 3, padding=1),
                                    nn.LeakyReLU(0.2))
        self.conv_res = TorchConv(input_channels, filters, 1)
        self.conv_out_latent = nn.Sequential(TorchConv(filters, filters, 3, padding=1),
                                             nn.LeakyReLU(0.2))
        self.conv_out_rgb = TorchConv(filters, 3, 1)
        if internal_hist:
            self.to_latent = TorchLinear(latent_dim, input_channels)
            self.conv_latent = Conv2DMod(input_channels, input_channels, 3)

    def forward(self, x: torch.Tensor, prev_rgb: Optional[torch.Tensor],
                prev_latent: torch.Tensor, h: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        curr_latent = self.block1(x)
        if self.internal_hist:
            prev_latent = self.conv_latent(prev_latent, self.to_latent(h))
        processed = self.block2(torch.cat([curr_latent, prev_latent], dim=1))
        x = self.conv_out_latent(self.conv_res(x) + processed)
        rgb = self.conv_out_rgb(x)
        if prev_rgb is not None:
            rgb = rgb + prev_rgb
        return upsample2x(x), upsample2x(rgb)


def encoder_filters(image_size: int, network_capacity: int) -> List[int]:
    """[c, 2c, 4c, ...]: log2(S) - 2 encoder blocks (rehistoGAN.py:560-563)."""
    enc_layers = int(log2(image_size) - 2)
    return [network_capacity] + [network_capacity * (2 ** (i + 1)) for i in range(enc_layers)]


class RecoloringEncoderDecoder(nn.Module):
    """Encoder-decoder giving (latent, rgb[, latent1, latent2])
    (rehistoGAN.py:549-634). ``hists`` is the (B, 3, h, h) target
    histogram, or under ``internal_hist`` its (B, latent) projection."""

    def __init__(self, image_size: int, network_capacity: int = 16, hist: int = 64,
                 latent_dim: int = 512, style_depth: int = 8, skip_conn_to_GAN: bool = False,
                 internal_hist: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat  # checkpoint the encoder and decoder blocks (models/remat.py)
        self.skip_conn_to_GAN = skip_conn_to_GAN
        self.internal_hist = internal_hist
        cap = network_capacity
        enc = encoder_filters(image_size, cap)
        dec_layers = int(log2(image_size) - 4)
        rev = enc[::-1]  # the reference's in-place reverse
        dec = rev[: dec_layers + 1]

        self.mapping = TorchConv(3, cap, 3, padding=1)
        self.encoder_blocks = nn.ModuleList(
            EncoderBlock(i, o) for i, o in zip(enc[:-1], enc[1:]))
        self.decoder_blocks = nn.ModuleList(
            DecoderBlock(i, o, latent_dim, internal_hist) for i, o in zip(dec[:-1], dec[1:]))
        self.decoder_mapping = TorchConv(dec[-1], 8 * cap, 1)
        if skip_conn_to_GAN:
            if not internal_hist:
                self.hist_projection = HistVectorizer(hist, latent_dim, style_depth)
            # sizes read from the REVERSED list (the reference's alias quirk)
            self.to_latent_1 = TorchLinear(latent_dim, rev[-3])
            self.to_latent_2 = TorchLinear(latent_dim, rev[-2])
            self.conv_latent_1 = Conv2DMod(enc[2], 4 * cap, 3)
            self.conv_latent_2 = Conv2DMod(enc[1], 2 * cap, 3)

    def forward(self, x: torch.Tensor, hists: Optional[torch.Tensor] = None):
        """x: (B, 3, S, S) images. Returns the (B, 8c, S/4, S/4) latent and
        the (B, 3, S/4, S/4) rgb, and with ``skip_conn_to_GAN`` the skip
        latents at S/2 and S."""
        x = self.mapping(x)
        downs, ups = [], []
        for block in self.encoder_blocks:
            x, up = call_block(block, self.remat, x)
            downs.append(x)
            ups.append(up)

        rgb = None
        for block, prev_latent in zip(self.decoder_blocks, downs[::-1]):
            x, rgb = call_block(block, self.remat, x, rgb, prev_latent, hists)
        x = self.decoder_mapping(x)
        if not self.skip_conn_to_GAN:
            return x, rgb
        h_w = hists if self.internal_hist else self.hist_projection(hists)
        latent1 = self.conv_latent_1(ups[1], self.to_latent_1(h_w))
        latent2 = self.conv_latent_2(ups[0], self.to_latent_2(h_w))
        return x, rgb, latent1, latent2
