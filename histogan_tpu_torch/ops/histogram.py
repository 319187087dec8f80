"""Differentiable color-histogram features in PyTorch.

The counterpart of ``histogan_tpu/ops/histogram.py``: the same function
of an NHWC batch, with the reference's quirks kept (``sampling`` picks
``h`` rows, the resize squashes both sides to ``insz``, fp32 bin
centers, EPS 1e-6 in the log, the sqrt and the normalisation).

The configuration the hand-written kernels cover (rgb-uv,
inverse-quadratic, intensity scale on, 64 bins on [-3, 3], all three
planes) goes through ``histogram_cuda.histogram_feature_cuda``: the
kernels on a CUDA tensor, their plain versions (forward and backward) on
a CPU tensor. Every other configuration is the plain batched einsum
below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from histogan_tpu_torch.ops import histogram_cuda

EPS = 1e-6

_SPACES = ("rgb-uv", "rg-chroma", "lab")


def resize_if_needed(x: torch.Tensor, insz: int, h: int, resizing: str) -> torch.Tensor:
    """NHWC resize with the reference's semantics: only when a side
    exceeds ``insz``; ``interpolation`` squashes to (insz, insz),
    bilinear, half-pixel centers, no antialias; ``sampling`` picks ``h``
    rows and columns at floor(linspace(0, dim, h, endpoint=False))."""
    _, hh, ww, _ = x.shape
    if hh <= insz and ww <= insz:
        return x
    if resizing == "interpolation":
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(insz, insz), mode="bilinear",
                          align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1)
    if resizing == "sampling":
        rows = torch.from_numpy(
            np.linspace(0, hh, num=h, endpoint=False).astype(np.int64)).to(x.device)
        cols = torch.from_numpy(
            np.linspace(0, ww, num=h, endpoint=False).astype(np.int64)).to(x.device)
        return x.index_select(1, rows).index_select(2, cols)
    raise ValueError(
        f"Wrong resizing method. It should be: interpolation or sampling. "
        f"But the given value is {resizing}."
    )


def _bin_kernel(diff: torch.Tensor, method: str, sigma: float, thresh_eps: float) -> torch.Tensor:
    if method == "thresholding":
        return (diff <= thresh_eps / 2).float()
    d2 = torch.square(diff) / (sigma ** 2)
    if method == "RBF":
        return torch.exp(-d2)
    if method == "inverse-quadratic":
        return 1.0 / (1.0 + d2)
    raise ValueError(
        f"Wrong kernel method. It should be either thresholding, RBF, "
        f"inverse-quadratic. But the given value is {method}."
    )


def _kernel_covers(space, h, method, intensity_scale, lo, hi, green_only) -> bool:
    return (space == "rgb-uv" and h == histogram_cuda.H_BINS
            and method == "inverse-quadratic" and intensity_scale
            and not green_only and (lo, hi) == (-3.0, 3.0))


def histogram_feature(
    x: torch.Tensor,
    *,
    space: str = "rgb-uv",
    h: int = 64,
    insz: int = 150,
    resizing: str = "interpolation",
    method: str = "inverse-quadratic",
    sigma: float = 0.02,
    intensity_scale: bool = True,
    boundary: Tuple[float, float] = (-3.0, 3.0),
    green_only: bool = False,
) -> torch.Tensor:
    """Differentiable color histogram of an NHWC (B, H, W, 3+) batch.

    Arguments as in ``histogan_tpu.ops.histogram.histogram_feature``.
    Returns (B, C, h, h) float32, L1-normalised over all C*h*h bins per
    image (C = 3 for rgb-uv, 1 with ``green_only`` and for the other
    spaces)."""
    if space not in _SPACES:
        raise ValueError(f"unknown space {space!r}; expected one of {_SPACES}")
    lo, hi = float(boundary[0]), float(boundary[1])
    if lo > hi:
        lo, hi = hi, lo
    if _kernel_covers(space, h, method, intensity_scale, lo, hi, green_only):
        # the kernels' autograd op: K1/K2 on a CUDA tensor, their plain
        # versions on a CPU tensor
        return histogram_cuda.histogram_feature_cuda(
            x, h=h, insz=insz, resizing=resizing, sigma=sigma)
    thresh_eps = (abs(lo) + abs(hi)) / h

    x = torch.clamp(x.float(), 0.0, 1.0)
    x = resize_if_needed(x, insz, h, resizing)
    if x.shape[-1] > 3:
        x = x[..., :3]
    flat = x.reshape(x.shape[0], -1, 3)
    r, g, bl = flat[..., 0], flat[..., 1], flat[..., 2]

    centers = torch.from_numpy(
        np.linspace(lo, hi, num=h).astype(np.float32)).to(x.device)

    if space == "rgb-uv":
        log_r = torch.log(r + EPS)
        log_g = torch.log(g + EPS)
        log_b = torch.log(bl + EPS)
        if green_only:
            pairs = [(log_g - log_r, log_g - log_b)]
        else:
            pairs = [
                (log_r - log_g, log_r - log_b),
                (log_g - log_r, log_g - log_b),
                (log_b - log_r, log_b - log_g),
            ]
        iy = torch.sqrt(r * r + g * g + bl * bl + EPS) if intensity_scale else torch.ones_like(r)
    elif space == "rg-chroma":
        s = r + g + bl + EPS
        pairs = [(r / s, g / s)]
        iy = torch.sqrt(r * r + g * g + bl * bl + EPS) if intensity_scale else torch.ones_like(r)
    else:  # lab: channels are (L, a, b); chroma planes over (a, b)
        pairs = [(g, bl)]
        iy = r if intensity_scale else torch.ones_like(r)

    planes = []
    for u, v in pairs:
        ku = _bin_kernel(torch.abs(u[..., None] - centers), method, sigma, thresh_eps)
        kv = _bin_kernel(torch.abs(v[..., None] - centers), method, sigma, thresh_eps)
        planes.append(torch.einsum("bnu,bnv->buv", iy[..., None] * ku, kv))

    hists = torch.stack(planes, dim=1)
    total = torch.sum(hists, dim=(1, 2, 3), keepdim=True)
    return hists / (total + EPS)


@dataclasses.dataclass(frozen=True)
class HistBlock:
    """Reference-shaped wrapper around :func:`histogram_feature`.

    Accepts a tensor or a numpy array, NHWC by default or NCHW with
    ``data_format='NCHW'``; a 3-dim input is one image. The input's
    device decides where the histogram is computed."""

    space: str = "rgb-uv"
    h: int = 64
    insz: int = 150
    resizing: str = "interpolation"
    method: str = "inverse-quadratic"
    sigma: float = 0.02
    intensity_scale: bool = True
    hist_boundary: Optional[Sequence[float]] = None
    green_only: bool = False
    data_format: str = "NHWC"

    def _boundary(self) -> Tuple[float, float]:
        if self.hist_boundary is not None:
            b = sorted(float(v) for v in self.hist_boundary)
            return (b[0], b[-1])
        return (-3.0, 3.0) if self.space == "rgb-uv" else (0.0, 1.0)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.ndim == 3:
            x = x[None]
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        return histogram_feature(
            x,
            space=self.space,
            h=self.h,
            insz=self.insz,
            resizing=self.resizing,
            method=self.method,
            sigma=self.sigma,
            intensity_scale=self.intensity_scale,
            boundary=self._boundary(),
            green_only=self.green_only,
        )


def RGBuvHistBlock(**kwargs) -> HistBlock:
    """RGB-uv log-chroma histogram (reference RGBuvHistBlock)."""
    kwargs.setdefault("intensity_scale", True)
    kwargs.pop("device", None)  # reference API; the input's device decides
    return HistBlock(space="rgb-uv", **kwargs)


def rgChromaHistBlock(**kwargs) -> HistBlock:
    """rg-chroma histogram (reference rgChromaHistBlock)."""
    kwargs.setdefault("intensity_scale", False)
    kwargs.pop("device", None)
    kwargs.pop("green_only", None)
    return HistBlock(space="rg-chroma", **kwargs)


def LabHistBlock(**kwargs) -> HistBlock:
    """Lab a/b histogram (reference LabHistBlock). Input must already be
    Lab-encoded and scaled to [0, 1]."""
    kwargs.setdefault("intensity_scale", False)
    kwargs.pop("device", None)
    kwargs.pop("green_only", None)
    return HistBlock(space="lab", **kwargs)
