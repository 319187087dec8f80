"""Parameter initialisers matching the reference's torch init scheme,
drawn from an explicit ``torch.Generator``.

Every nn.Linear / conv weight is kaiming_normal_(a=0, mode='fan_in',
nonlinearity='leaky_relu'), i.e. N(0, 2/fan_in); biases keep torch's
default U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the noise projections are
zeroed (histoGAN/histoGAN.py:686-696).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


@torch.no_grad()
def kaiming_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    fan_in = w[0].numel()
    return w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


@torch.no_grad()
def torch_default_bias_(b: torch.Tensor, fan_in: int,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return b.uniform_(-bound, bound, generator=generator)


def reset_parameters_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``model`` from ``generator``, module by
    module in registration order. Each parameter-owning module of this
    package has a ``reset_parameters(generator)``."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model
