"""The RGB-uv histogram feature in plain float32 PyTorch: one einsum per
plane over all pixels (RGBuvHistBlock of github.com/mahmoudnafifi/HistoGAN,
inverse-quadratic kernel, intensity scale on, bins on [-3, 3]), after the
configuration's resize. The dataset's histogram pool resizes the decoded
float photo on the host (OpenCV's float bilinear, or the same rows) before
the same histogram: the same function of the photo."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6


def resize(x, h, insz, resizing):
    """NHWC ``x`` resized as RGBuvHistBlock does when a side exceeds
    ``insz``: ``interpolation`` squashes both sides to ``insz`` (bilinear,
    half-pixel centres, no antialias); ``sampling`` keeps ``h`` rows and
    columns at floor(linspace(0, n, h))."""
    hh, ww = x.shape[1], x.shape[2]
    if hh <= insz and ww <= insz:
        return x
    if resizing == "interpolation":
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(insz, insz), mode="bilinear",
                          align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1)
    if resizing != "sampling":
        raise ValueError(f"unknown resizing {resizing!r}")
    rows = torch.from_numpy(np.linspace(0, hh, h, endpoint=False).astype(np.int64)).to(x.device)
    cols = torch.from_numpy(np.linspace(0, ww, h, endpoint=False).astype(np.int64)).to(x.device)
    return x.index_select(1, rows).index_select(2, cols)


def rgb_uv_hist(x, h=64, insz=150, sigma=0.02, resizing="sampling"):
    """(B, H, W, 3) NHWC in [0, 1] -> (B, 3, h, h), L1-normalised."""
    x = resize(torch.clamp(x.float(), 0.0, 1.0), h, insz, resizing)[..., :3]
    flat = x.reshape(x.shape[0], -1, 3)
    r, g, b = flat[..., 0], flat[..., 1], flat[..., 2]
    lr, lg, lb = torch.log(r + EPS), torch.log(g + EPS), torch.log(b + EPS)
    iy = torch.sqrt(r * r + g * g + b * b + EPS)
    centers = torch.from_numpy(np.linspace(-3.0, 3.0, h).astype(np.float32)).to(x.device)
    planes = []
    for u, v in ((lr - lg, lr - lb), (lg - lr, lg - lb), (lb - lr, lb - lg)):
        ku = 1.0 / (1.0 + (u[..., None] - centers).square() / sigma ** 2)
        kv = 1.0 / (1.0 + (v[..., None] - centers).square() / sigma ** 2)
        planes.append(torch.einsum("bnu,bnv->buv", iy[..., None] * ku, kv))
    hists = torch.stack(planes, dim=1)
    return hists / (hists.sum(dim=(1, 2, 3), keepdim=True) + EPS)


def hist_of(x, cfg):
    """``rgb_uv_hist`` of NHWC ``x`` at the configuration's bins, input
    size, sigma and resize."""
    return rgb_uv_hist(x, cfg["hist_bin"], cfg["hist_insz"], cfg["hist_sigma"],
                       cfg["hist_resizing"])
