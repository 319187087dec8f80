"""Laplacian-pyramid detail transfer for upscaling recolored outputs,
copied from ``histogan_tpu/post/pyramid.py``. cv2 is imported when the
function runs.

Reference: utils/pyramid_upsampling.py:7-82. Build Gaussian/Laplacian
pyramids of the (low-res, recolored) target and the (full-res) reference;
swap the lowest ``swapping_levels`` Laplacian levels from target into
reference (color comes from the coarse levels of the recolored image,
detail from the original); optionally blend the remaining levels
linearly; reconstruct.

Input/output are NHWC float arrays (the reference takes torch NCHW
tensors — callers here pass plain numpy HWC).
"""

from __future__ import annotations

import numpy as np

from histogan_tpu_torch.post.imresize import imresize


def pyramid_upsampling(target: np.ndarray, reference: np.ndarray,
                       levels: int = 5, swapping_levels: int = 1,
                       blending: bool = False) -> np.ndarray:
    """target: (H', W', 3) recolored low-res; reference: (H, W, 3) original
    full-res; both float [0,1]. Returns (H_pad, W_pad, 3)."""
    import cv2 as cv

    target = np.clip(np.asarray(target, np.float64), 0.0, 1.0)
    reference = np.asarray(reference, np.float64)

    h, w = reference.shape[:2]
    m = 2 ** levels
    new_h = h if h % m == 0 else h + m - h % m
    new_w = w if w % m == 0 else w + m - w % m
    if (h, w) != (new_h, new_w):
        reference = imresize(reference, output_shape=(new_h, new_w))
    target = imresize(target, output_shape=reference.shape[:2])

    def gaussian_pyr(img):
        g = img.copy()
        pyr = [g]
        for _ in range(levels):
            g = cv.pyrDown(g)
            pyr.append(g)
        return pyr

    def laplacian_pyr(gp):
        lp = [gp[levels - 1]]
        for i in range(levels - 1, 0, -1):
            up = cv.pyrUp(gp[i])
            lp.append(gp[i - 1] - up)
        return lp

    lp_t = laplacian_pyr(gaussian_pyr(target))
    lp_r = laplacian_pyr(gaussian_pyr(reference))

    for i in range(swapping_levels):
        lp_r[i] = lp_t[i]
    if blending:
        weights = np.linspace(0.0, 1.0, levels - swapping_levels + 1)
        for i in range(swapping_levels, levels):
            lp_r[i] = (1 - weights[i]) * lp_t[i] + weights[i] * lp_r[i]

    out = lp_r[0]
    for i in range(1, levels):
        out = cv.pyrUp(out) + lp_r[i]
    return out
