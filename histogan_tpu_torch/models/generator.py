"""HistoGAN generator (histoGAN/histoGAN.py:529-568), the counterpart of
``histogan_tpu/models/generator.py``.

StyleGAN2-style synthesis whose last two blocks are driven by the
histogram projection. ``num_layers = log2(image_size) - 1``; filter
schedule ``[4c, c*2^n, ..., 2c]``.
"""

from __future__ import annotations

from math import log2
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from histogan_tpu_torch.models.blocks import GeneratorBlock
from histogan_tpu_torch.models.remat import call_block


def generator_filters(image_size: int, network_capacity: int) -> List[Tuple[int, int]]:
    """(in, out) channel pairs per block (histoGAN/histoGAN.py:537-541)."""
    num_layers = int(log2(image_size) - 1)
    init_channels = 4 * network_capacity
    filters = [init_channels] + [
        network_capacity * (2 ** (i + 1)) for i in range(num_layers)
    ][::-1]
    return list(zip(filters[:-1], filters[1:]))


class Generator(nn.Module):
    def __init__(self, image_size: int, latent_dim: int = 512, network_capacity: int = 16,
                 transparent: bool = False, remat: bool = False):
        super().__init__()
        self.image_size = image_size
        self.remat = remat  # checkpoint each block (models/remat.py); no parameter
        self.num_layers = int(log2(image_size) - 1)
        self.initial_block = nn.Parameter(torch.empty(4 * network_capacity, 4, 4))
        self.reset_parameters()
        pairs = generator_filters(image_size, network_capacity)
        self.blocks = nn.ModuleList(
            GeneratorBlock(
                latent_dim, in_chan, out_chan,
                upsample=ind != 0,
                upsample_rgb=ind != (self.num_layers - 1),
                rgba=transparent,
            )
            for ind, (in_chan, out_chan) in enumerate(pairs)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.initial_block.normal_(0.0, 1.0, generator=generator)  # reference: torch.randn

    def forward(
        self,
        styles: torch.Tensor,
        hists: torch.Tensor,
        input_noise: torch.Tensor,
        *,
        block_styles: Optional[Sequence[Optional[Tuple]]] = None,
        block_noises: Optional[Sequence[Optional[Tuple]]] = None,
    ) -> torch.Tensor:
        """Synthesize images.

        Args:
          styles: (B, num_layers-2, latent) per-block w vectors.
          hists: (B, 2, latent) histogram projection rows, driving the
            final two blocks.
          input_noise: (B, image_size, image_size, 1) uniform noise (NHWC,
            as the JAX package takes it).
          block_styles / block_noises: optional per-block overrides
            ((style1, style2, rgb_style) / (noise1, noise2) tuples); None
            entries take the standard path.

        Returns: (B, 3|4, image_size, image_size) rgb, NCHW.
        """
        b = styles.shape[0]
        x = self.initial_block[None].expand(b, -1, -1, -1)
        all_styles = torch.cat([styles, hists], dim=1)  # (B, L, latent)

        rgb = None
        for ind, block in enumerate(self.blocks):
            overrides = {}
            if block_styles is not None and block_styles[ind] is not None:
                s1, s2, rs = block_styles[ind]
                overrides.update(style1=s1, style2=s2, rgb_style=rs)
            if block_noises is not None and block_noises[ind] is not None:
                n1, n2 = block_noises[ind]
                overrides.update(noise1=n1, noise2=n2)
            if overrides:  # the projection tools' path is never checkpointed
                x, rgb = block(x, rgb, all_styles[:, ind], input_noise, **overrides)
            else:
                x, rgb = call_block(block, self.remat, x, rgb, all_styles[:, ind], input_noise)
        return rgb
