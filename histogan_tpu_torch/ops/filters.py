"""Fixed-kernel image filters of the reHistoGAN losses, the counterpart of
``histogan_tpu/ops/filters.py`` (reference rehistoGAN.py:207-254), NCHW.

Quirks kept:
- The Gaussian blur is depthwise with VALID padding (the reference's
  nn.Conv2d has padding=0), so the blurred image shrinks by k - 1.
- The Laplacian and Sobel filters are a (1, C, 3, 3) kernel: ONE output
  channel that sums the response of every input channel, SAME padding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_LAPLACIAN = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], np.float32)
_SOBEL_X = np.array([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]], np.float32)
_SOBEL_Y = np.array([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]], np.float32)


def gaussian_kernel(kernel_size: int = 15, sigma: float = 3.0) -> torch.Tensor:
    """(k, k) 2-D Gaussian normalised to sum 1 (rehistoGAN.py:207-216)."""
    coords = np.arange(kernel_size, dtype=np.float32)
    xg, yg = np.meshgrid(coords, coords, indexing="xy")
    mean = (kernel_size - 1) / 2.0
    var = sigma ** 2
    k = (1.0 / (2.0 * math.pi * var)) * np.exp(
        -((xg - mean) ** 2 + (yg - mean) ** 2) / (2.0 * var))
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def gaussian_op(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise blur of (B, C, H, W) with a (k, k) kernel, VALID padding:
    (B, C, H - k + 1, W - k + 1)."""
    c, k = x.shape[1], kernel.shape[-1]
    w = kernel.to(x.device, x.dtype).expand(c, 1, k, k)
    return F.conv2d(x, w, groups=c)


def _sum_channel_conv(x: torch.Tensor, k3: np.ndarray) -> torch.Tensor:
    """A 3x3 kernel over every channel, summed into one output channel,
    SAME padding: (B, C, H, W) -> (B, 1, H, W) (rehistoGAN.py:235-254)."""
    w = torch.from_numpy(k3).to(x.device, x.dtype).expand(1, x.shape[1], 3, 3)
    return F.conv2d(x, w, padding=1)


def laplacian_op(x: torch.Tensor) -> torch.Tensor:
    return _sum_channel_conv(x, _LAPLACIAN)


def sobel_op(x: torch.Tensor, direction: int = 0) -> torch.Tensor:
    return _sum_channel_conv(x, _SOBEL_X if direction == 0 else _SOBEL_Y)
