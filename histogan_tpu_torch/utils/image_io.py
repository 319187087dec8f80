"""Image grid saving (copied from ``histogan_tpu/utils/image_io.py``).
PIL is imported only when a file is written."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """(N, H, W, C) [0,1] -> grid (H', W', C), torchvision layout
    (nrow = images per row)."""
    images = np.clip(np.asarray(images), 0.0, 1.0)
    n, h, w, c = images.shape
    ncol = int(math.ceil(n / nrow))
    grid = np.full(
        (ncol * (h + padding) + padding, nrow * (w + padding) + padding, c),
        pad_value, dtype=np.float32,
    )
    for k in range(n):
        r, col = divmod(k, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[k]
    return grid


def save_image_grid(images: np.ndarray, path, nrow: int = 8) -> None:
    from PIL import Image

    grid = make_grid(images, nrow=nrow)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    Image.fromarray((grid[..., :3] * 255).astype(np.uint8)).save(str(path))
