"""Linear image attention for the discriminator, the counterpart of
``histogan_tpu/models/attention.py``: the third-party
``ImageLinearAttention`` the reference wires as Residual(Rezero(attn)), two
per selected layer (histoGAN/histoGAN.py:90-106, 594-598). NCHW; the two
contractions are plain ``torch.einsum``s, as the JAX package computes them
outside any Pallas kernel.

Traced (``utils/logging.py``), each ``RezeroResidual`` forward is span
``d.attn`` with its CUDA events (the GP's create-graph forward included;
the backward runs outside it) and one of counter ``attn``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from histogan_tpu_torch.models.layers import DConv
from histogan_tpu_torch.utils.logging import count, span


class ImageLinearAttention(nn.Module):
    """1x1 convs to q, k and v (no bias) split per head as (B, heads, dim,
    H*W), both scaled by dim ** -0.25; k takes a softmax over the pixels
    and q over the key dim; the context k v^T, q through it, and a 1x1
    conv out (with bias)."""

    def __init__(self, chan: int, key_dim: int = 64, value_dim: int = 64, heads: int = 8,
                 norm_queries: bool = True):
        super().__init__()
        self.key_dim, self.value_dim, self.heads = key_dim, value_dim, heads
        self.norm_queries = norm_queries
        self.to_q = DConv(chan, key_dim * heads, 1, bias=False)
        self.to_k = DConv(chan, key_dim * heads, 1, bias=False)
        self.to_v = DConv(chan, value_dim * heads, 1, bias=False)
        self.to_out = DConv(value_dim * heads, chan, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        scale = self.key_dim ** -0.25
        q = self.to_q(x).reshape(b, self.heads, self.key_dim, h * w) * scale
        k = self.to_k(x).reshape(b, self.heads, self.key_dim, h * w) * scale
        v = self.to_v(x).reshape(b, self.heads, self.value_dim, h * w)
        k = k.softmax(dim=-1)  # over the pixels
        if self.norm_queries:
            q = q.softmax(dim=-2)  # over the key dim
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhdn,bhde->bhen", q, context)
        return self.to_out(out.reshape(b, self.heads * self.value_dim, h, w))


class Rezero(nn.Module):
    """fn(x) * g, g a learned scalar starting at 0."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.g.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) * self.g


class RezeroResidual(nn.Module):
    """Residual(Rezero(ImageLinearAttention(chan))): x + g * attn(x), under
    the reference's names ``fn.g`` and ``fn.fn.to_{q,k,v,out}``."""

    def __init__(self, chan: int):
        super().__init__()
        self.fn = Rezero(ImageLinearAttention(chan))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("d.attn", stream=True):
            count("attn")
            return self.fn(x) + x
