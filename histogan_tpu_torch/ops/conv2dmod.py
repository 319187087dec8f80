"""StyleGAN2 modulated convolution, the counterpart of
``histogan_tpu/ops/conv2dmod.py``, with the same factorisation:

    conv(x_b, W * (s_b + 1))  ==  conv(x_b * (s_b + 1), W)
    demod d_b[o] = rsqrt(sum_{i,kh,kw} W[o,i]^2 * (s_b[i] + 1)^2 + eps)

One shared-weight convolution over the batch instead of the reference's
per-sample weights and ``groups=batch``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-8  # reference histoGAN/histoGAN.py:53


def same_padding(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> int:
    """Reference padding rule; for stride 1 and dilation 1 it is (kernel-1)//2."""
    return ((size - 1) * (stride - 1) + dilation * (kernel - 1)) // 2


def conv2d_mod(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    demod: bool = True,
    eps: float = EPS,
) -> torch.Tensor:
    """Modulated conv2d.

    Args:
      x: (B, Cin, H, W) NCHW input.
      weight: (Cout, Cin, kh, kw) OIHW shared filter.
      style: (B, Cin) per-sample modulation; sample b's effective filter
        is ``weight * (style[b] + 1)`` per input channel.
      demod: apply weight demodulation.

    Returns: (B, Cout, H, W).
    """
    pad = same_padding(x.shape[2], weight.shape[2])
    s = style + 1.0
    out = F.conv2d(x * s[:, :, None, None], weight, padding=pad)
    if demod:
        d = torch.rsqrt(
            torch.einsum("oihw,bi->bo", torch.square(weight), torch.square(s)) + eps)
        out = out * d[:, :, None, None]
    return out
