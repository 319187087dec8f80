"""MATLAB-semantics imresize (bicubic/bilinear, antialiased, symmetric
boundary), copied from ``histogan_tpu/post/imresize.py`` (which this
package may not import). numpy only.

Matches the behavior the reference relies on (utils/imresize.py, itself a
port of MATLAB's imresize): kernel widened by 1/scale when downscaling
(antialiasing), sample positions u = x/scale + 0.5*(1 - 1/scale),
symmetric (reflect-with-repeat) boundary handling, dimensions processed
in ascending-scale order, float64 accumulation, uint8 round-trip.

Implementation differs: per-dimension contributions are assembled into a
dense (out, in) weight matrix and applied as a tensordot — simpler and
much faster than the reference's per-row loops.
"""

from __future__ import annotations

from math import ceil
from typing import Optional, Sequence, Tuple

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))


def _triangle(x: np.ndarray) -> np.ndarray:
    return (x + 1.0) * ((x >= -1) & (x < 0)) + (1.0 - x) * ((x >= 0) & (x <= 1))


_KERNELS = {"bicubic": (_cubic, 4.0), "bilinear": (_triangle, 2.0)}


def _weight_matrix(in_len: int, out_len: int, scale: float, method: str) -> np.ndarray:
    kernel, k_width = _KERNELS[method]
    if scale < 1.0:  # antialias: widen kernel by 1/scale
        h = lambda x: scale * kernel(scale * x)  # noqa: E731
        width = k_width / scale
    else:
        h = kernel
        width = k_width
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - width / 2.0)
    p = int(ceil(width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1  # 0-based source columns
    w = h(u[:, None] - idx - 1.0)
    w /= w.sum(axis=1, keepdims=True)
    # symmetric boundary: ... 2 1 0 | 0 1 2 ... n-1 | n-1 n-2 ...
    mirror = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx = mirror[np.mod(idx.astype(np.int64), mirror.size)]
    mat = np.zeros((out_len, in_len), np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_len), p), idx.ravel()), w.ravel())
    return mat


def imresize(
    image: np.ndarray,
    scalar_scale: Optional[float] = None,
    method: str = "bicubic",
    output_shape: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Resize HxW or HxWxC with MATLAB imresize semantics."""
    if method not in _KERNELS:
        raise ValueError(f"Unidentified method {method!r}")
    in_h, in_w = image.shape[:2]
    if scalar_scale is not None:
        scale = (float(scalar_scale), float(scalar_scale))
        out_shape = (int(ceil(scale[0] * in_h)), int(ceil(scale[1] * in_w)))
    elif output_shape is not None:
        out_shape = (int(output_shape[0]), int(output_shape[1]))
        scale = (out_shape[0] / in_h, out_shape[1] / in_w)
    else:
        raise ValueError("scalar_scale OR output_shape should be defined!")

    is_uint8 = image.dtype == np.uint8
    out = image.astype(np.float64)
    squeeze = out.ndim == 2
    if squeeze:
        out = out[..., None]

    mats = [
        _weight_matrix(in_h, out_shape[0], scale[0], method),
        _weight_matrix(in_w, out_shape[1], scale[1], method),
    ]
    # MATLAB processes dims in ascending-scale order; uint8 inputs are
    # quantized back to uint8 after EACH dimension pass (reference
    # imresizevec, utils/imresize.py:91-95)
    for dim in np.argsort(np.asarray(scale)):
        if dim == 0:
            out = np.einsum("oi,ijc->ojc", mats[0], out)
        else:
            out = np.einsum("oj,ijc->ioc", mats[1], out)
        if is_uint8:
            out = np.around(np.clip(out, 0, 255))

    if squeeze:
        out = out[..., 0]
    return out.astype(np.uint8) if is_uint8 else out
