"""Image decoding (``load_rgb`` of ``histogan_tpu/data/dataset.py``).
The training data pipeline is ported with training. PIL is imported
only when a file is read."""

from __future__ import annotations

import numpy as np


def load_rgb(path, transparent: bool = False) -> np.ndarray:
    """Decode to float32 [0,1] HWC; greyscale expanded, RGBA handled like
    the reference transforms (histoGAN/histoGAN.py:227-244)."""
    from PIL import Image

    img = Image.open(path)
    mode = "RGBA" if transparent else "RGB"
    if img.mode != mode:
        img = img.convert(mode)
    return np.asarray(img, dtype=np.float32) / 255.0
