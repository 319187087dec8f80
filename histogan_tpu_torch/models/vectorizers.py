"""Latent mapping networks (counterpart of
``histogan_tpu/models/vectorizers.py``), under the reference's
state-dict names: ``net.{2i}`` and ``fcs.{2i}`` (Linear, LeakyReLU pairs).

- StyleVectorizer: z -> w MLP (histoGAN/histoGAN.py:354-365).
- HistVectorizer: flattened histogram -> latent MLP
  (histoGAN/histoGAN.py:335-351), widths 3h^2 -> 2 emb -> emb -> ... emb.
"""

from __future__ import annotations

import torch
from torch import nn

from histogan_tpu_torch.models.layers import TorchLinear


def _mlp(widths) -> nn.Sequential:
    layers = []
    for w_in, w_out in zip(widths[:-1], widths[1:]):
        layers += [TorchLinear(w_in, w_out), nn.LeakyReLU(0.2)]
    return nn.Sequential(*layers)


class StyleVectorizer(nn.Module):
    def __init__(self, emb: int = 512, depth: int = 8):
        super().__init__()
        self.net = _mlp([emb] * (depth + 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class HistVectorizer(nn.Module):
    """Input: histogram feature (B, 3, h, h) or pre-flattened (B, 3*h*h)."""

    def __init__(self, insize: int = 64, emb: int = 512, depth: int = 8):
        super().__init__()
        self.fcs = _mlp([3 * insize * insize, 2 * emb] + [emb] * (depth - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fcs(x.reshape(x.shape[0], -1))
