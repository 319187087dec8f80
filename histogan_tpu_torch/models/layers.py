"""Primitive layers with the reference's initialisation
(counterpart of ``histogan_tpu/models/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from histogan_tpu_torch.ops.conv2d import conv2d
from histogan_tpu_torch.utils import inits


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """Reference default activation (histoGAN/histoGAN.py:192-193)."""
    return F.leaky_relu(x, negative_slope)


class TorchLinear(nn.Linear):
    """nn.Linear with kaiming-normal weight and torch-default uniform bias;
    ``zero_init`` zeroes both (the noise projections)."""

    def __init__(self, in_features: int, out_features: int, zero_init: bool = False):
        self.zero_init = zero_init
        super().__init__(in_features, out_features)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.zero_init:
            self.weight.zero_()
            self.bias.zero_()
            return
        inits.kaiming_normal_(self.weight, generator)
        inits.torch_default_bias_(self.bias, self.in_features, generator)


class TorchConv(nn.Conv2d):
    """nn.Conv2d with kaiming-normal weight and torch-default uniform bias
    (``histogan_tpu/models/layers.py::TorchConv``), NCHW / OIHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         bias=bias)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        inits.kaiming_normal_(self.weight, generator)
        if self.bias is not None:
            inits.torch_default_bias_(self.bias, self.weight[0].numel(), generator)


class DConv(TorchConv):
    """The discriminator's TorchConv: the same parameters, names and
    initialisation, run through ``ops/conv2d.py::conv2d``, whose double
    backward (the gradient penalty's) takes the weight gradient from the
    layer's own weight-gradient kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d with torch's defaults: no affine parameters, no
    running statistics, biased variance over H and W, eps 1e-5 (the
    reHistoGAN EncoderBlock's, reference rehistoGAN.py:490-495). NCHW."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, eps=self.eps)
