"""HistoGAN discriminator (histoGAN/histoGAN.py:572-631), the counterpart
of ``histogan_tpu/models/discriminator.py``: a residual conv downsampling
stack, an NCHW flatten and one logit.

The attention (``attn_layers``) and vector-quantize (``fq_layers``)
options are not ported yet; asking for them raises.
"""

from __future__ import annotations

from math import log2
from typing import Sequence

import torch
from torch import nn

from histogan_tpu_torch.models.blocks import DiscriminatorBlock
from histogan_tpu_torch.models.layers import TorchLinear


def discriminator_filters(image_size: int, network_capacity: int, transparent: bool = False):
    """(in, out) channel pairs per block (histoGAN/histoGAN.py:581-583)."""
    num_layers = int(log2(image_size) - 1)
    filters = [4 if transparent else 3] + [network_capacity * (2 ** i)
                                           for i in range(num_layers + 1)]
    return list(zip(filters[:-1], filters[1:]))


class Discriminator(nn.Module):
    def __init__(self, image_size: int, network_capacity: int = 16,
                 fq_layers: Sequence[int] = (), fq_dict_size: int = 256,
                 attn_layers: Sequence[int] = (), transparent: bool = False):
        super().__init__()
        if len(fq_layers) or len(attn_layers):
            raise NotImplementedError(
                "the discriminator's attention and vector-quantize layers "
                "(attn_layers, fq_layers) are not ported yet")
        pairs = discriminator_filters(image_size, network_capacity, transparent)
        self.blocks = nn.ModuleList(
            DiscriminatorBlock(in_chan, out_chan, downsample=ind != len(pairs) - 1)
            for ind, (in_chan, out_chan) in enumerate(pairs)
        )
        self.to_logit = TorchLinear(2 * 2 * pairs[-1][1], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3|4, S, S) NCHW images -> (B,) logits."""
        for block in self.blocks:
            x = block(x)
        # (B, C, 2, 2) flattened in NCHW order, as the reference's to_logit reads it
        return self.to_logit(x.reshape(x.shape[0], -1)).squeeze(-1)
