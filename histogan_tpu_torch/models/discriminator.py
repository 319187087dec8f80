"""HistoGAN discriminator (histoGAN/histoGAN.py:572-631), the counterpart
of ``histogan_tpu/models/discriminator.py``: a residual conv downsampling
stack with optional linear attention (``attn_layers``) and vector-quantize
(``fq_layers``) blocks after the selected layers, an NCHW flatten and one
logit.
"""

from __future__ import annotations

from math import log2
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from histogan_tpu_torch.models.attention import RezeroResidual
from histogan_tpu_torch.models.blocks import DiscriminatorBlock
from histogan_tpu_torch.models.layers import TorchLinear
from histogan_tpu_torch.models.remat import call_block
from histogan_tpu_torch.models.vq import PermuteToFrom, VectorQuantize

# Why bf16 and a vector-quantize layer with a D block after it are refused
BF16_VQ_REASON = (
    "a vector-quantize layer (fq_layers) with a discriminator block after it cannot run "
    "under precision='bf16': its fp32 codebook makes its output fp32, and the next block's "
    "bf16 convolution refuses fp32 input, as in the JAX package (lax.conv_general_dilated "
    "raises TypeError there). Put the layer at the last block (fq_layers={last}) or train "
    "in fp32")


def discriminator_filters(image_size: int, network_capacity: int, transparent: bool = False):
    """(in, out) channel pairs per block (histoGAN/histoGAN.py:581-583)."""
    num_layers = int(log2(image_size) - 1)
    filters = [4 if transparent else 3] + [network_capacity * (2 ** i)
                                           for i in range(num_layers + 1)]
    return list(zip(filters[:-1], filters[1:]))


def vq_before_a_block(image_size: int, fq_layers: Sequence[int]) -> List[int]:
    """The ``fq_layers`` entries that have a D block after them (layers
    are numbered from 1; the last has none)."""
    last = len(discriminator_filters(image_size, 1))
    return [n for n in fq_layers if 1 <= n < last]


def refuse_bf16_vq(precision: str, image_size: int, fq_layers: Sequence[int]) -> None:
    """ValueError for bf16 with a VQ layer before a D block (BF16_VQ_REASON)."""
    if precision == "bf16" and vq_before_a_block(image_size, fq_layers):
        raise ValueError(BF16_VQ_REASON.format(
            last=len(discriminator_filters(image_size, 1))))


class Discriminator(nn.Module):
    def __init__(self, image_size: int, network_capacity: int = 16,
                 fq_layers: Sequence[int] = (), fq_dict_size: int = 256,
                 attn_layers: Sequence[int] = (), transparent: bool = False,
                 remat: bool = False):
        super().__init__()
        # checkpoint the conv blocks (models/remat.py); attention and VQ never
        self.remat = remat
        pairs = discriminator_filters(image_size, network_capacity, transparent)
        self.blocks = nn.ModuleList(
            DiscriminatorBlock(in_chan, out_chan, downsample=ind != len(pairs) - 1)
            for ind, (in_chan, out_chan) in enumerate(pairs)
        )
        # a layer without the option holds None, as the reference's lists do
        self.attn_blocks = nn.ModuleList(
            nn.Sequential(RezeroResidual(out_chan), RezeroResidual(out_chan))
            if ind + 1 in attn_layers else None
            for ind, (_, out_chan) in enumerate(pairs))
        self.quantize_blocks = nn.ModuleList(
            PermuteToFrom(VectorQuantize(out_chan, fq_dict_size))
            if ind + 1 in fq_layers else None
            for ind, (_, out_chan) in enumerate(pairs))
        self.to_logit = TorchLinear(2 * 2 * pairs[-1][1], 1)

    @property
    def has_vq(self) -> bool:
        return any(q is not None for q in self.quantize_blocks)

    def forward(self, x: torch.Tensor, train_stats: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3|4, S, S) NCHW images -> ((B,) logits, quantize loss). With
        ``train_stats`` the VQ layers update their codebooks."""
        dtype = x.dtype
        quantize_loss = x.new_zeros(())
        last = len(self.blocks) - 1
        for ind, (block, attn, vq) in enumerate(
                zip(self.blocks, self.attn_blocks, self.quantize_blocks)):
            x = call_block(block, self.remat, x)
            if attn is not None:
                x = attn(x)
            if vq is not None:
                x, loss = vq(x, train_stats)
                quantize_loss = quantize_loss + loss
                if x.dtype != dtype and ind != last:
                    raise ValueError(BF16_VQ_REASON.format(last=last + 1))
        # (B, C, 2, 2) flattened in NCHW order, as the reference's to_logit reads it
        x = x.reshape(x.shape[0], -1)
        w, b = self.to_logit.weight, self.to_logit.bias
        # a VQ output promotes the logit as JAX's x @ kernel does
        logits = F.linear(x, w.to(x.dtype), b.to(x.dtype))
        return logits.squeeze(-1), quantize_loss
