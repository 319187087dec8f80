"""Bilinear resizing with torch-interpolate semantics (NCHW), the
counterpart of ``histogan_tpu/ops/resize.py``: half-pixel centers, no
antialias."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NCHW tensor (reference
    nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False))."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False,
                         antialias=False)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (H, W), no antialias."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)
