"""Bilinear resizing with torch-interpolate semantics (NCHW), the
counterpart of ``histogan_tpu/ops/resize.py``: half-pixel centers, no
antialias.

``upsample2x`` on a CUDA tensor runs ``csrc/upsample2x.cu``: U1 forward
and U2 backward, one thread per input element (aten's NCHW kernel loops
over every plane in each thread of an output pixel). On a CPU tensor it is
``F.interpolate``. ``upsample2x_plain`` and ``upsample2x_bwd_plain`` write
out the kernels' stencils in torch, with their weights, edges and order of
operations: U2 equals its plain version bit for bit, U1 equals aten's
forward (it keeps aten's fmas) and its plain version, which rounds each
step alone, to 2 ulps. ``resize_bilinear`` (any size) stays
``F.interpolate``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from histogan_tpu_torch.ops import cuda_build
from histogan_tpu_torch.utils.logging import count

# x or g, out, planes, h, w, dtype, device, stream
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES = {"upsample2x_fwd": _ARGS, "upsample2x_bwd": _ARGS}
# float64 for the float64 oracles that check the port on the card
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

# Kernel launches since the last reset, U1 and U2 apart; only a successful
# launch of the CUDA kernel adds to its count.
launches = 0
bwd_launches = 0


def _taps(n: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """For the 2n outputs along an axis of n inputs: the two source
    indices and their weights, aten's for a scale of 2 (source 0.5 (o +
    0.5) - 0.5, clamped at 0): output 2i takes i - 1 and i at 0.25 and
    0.75, output 0 takes 0 at 1 and min(1, n - 1) at 0, output 2i + 1
    takes i and min(i + 1, n - 1) at 0.75 and 0.25. The weights take x's
    device and dtype."""
    i = torch.arange(n, device=x.device)
    first = torch.stack([torch.clamp(i - 1, min=0), i], dim=1).reshape(-1)
    second = torch.stack([torch.where(i > 0, i, torch.clamp(i + 1, max=n - 1)),
                          torch.clamp(i + 1, max=n - 1)], dim=1).reshape(-1)
    w0 = torch.tensor([0.25, 0.75], device=x.device, dtype=x.dtype).repeat(n)
    w0[0] = 1.0
    w1 = 1.0 - w0
    return first, second, w0, w1


def _computed(t: torch.Tensor) -> torch.Tensor:
    """t in the type the kernels compute in: fp32, or fp64 for fp64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """U1 in torch: (N, C, H, W) -> (N, C, 2H, 2W), aten's
    h0 (w0 a + w1 b) + h1 (w0 c + w1 d) in fp32 (fp64 for fp64), each step
    rounded alone (U1 keeps aten's fmas), rounded once to x's dtype."""
    _, _, h, w = x.shape
    xf = _computed(x)
    r0, r1, h0, h1 = _taps(h, xf)
    c0, c1, w0, w1 = _taps(w, xf)
    top, bottom = xf[:, :, r0], xf[:, :, r1]
    h0, h1 = h0[:, None], h1[:, None]
    out = (h0 * (w0 * top[..., c0] + w1 * top[..., c1])
           + h1 * (w0 * bottom[..., c0] + w1 * bottom[..., c1]))
    return out.to(x.dtype)


def _gather_weights(n: int, g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The weights of taps 2i - 1 .. 2i + 2 of input i's gradient: 0.25,
    0.75, 0.75, 0.25 inside; at i = 0 the first is 0 and the second 1 (its
    output 0 takes it at 1), at i = n - 1 the last is 0 and the third 1
    (output 2n - 1 takes it at 0.75 + 0.25). The weights take g's device
    and dtype."""
    i = torch.arange(n, device=g.device)
    inner, last = i > 0, i < n - 1
    return tuple(torch.where(cond, a, b).to(g.dtype) for cond, a, b in
                 ((inner, 0.25, 0.0), (inner, 0.75, 1.0), (last, 0.75, 1.0), (last, 0.25, 0.0)))


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """U2 in torch: d(loss)/dx (N, C, H, W) from g = d(loss)/dy (N, C, 2H,
    2W), a gather in fp32 (fp64 for fp64): for each row of g the columns
    2j - 1 .. 2j + 2 in order, ((k0 v0 + k1 v1) + k2 v2) + k3 v3 with a tap
    past the edge read as 0, then the rows 2i - 1 .. 2i + 2 alike; rounded
    once to g's dtype."""
    _, _, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    gp = F.pad(_computed(g), (1, 1, 1, 1))  # (2H + 2, 2W + 2): the taps past the edges read 0
    k = _gather_weights(w, gp)
    rows = (k[0] * gp[..., 0:2 * w:2] + k[1] * gp[..., 1:2 * w + 1:2]
            + k[2] * gp[..., 2:2 * w + 2:2] + k[3] * gp[..., 3:2 * w + 3:2])
    k = [t[:, None] for t in _gather_weights(h, gp)]
    out = (k[0] * rows[:, :, 0:2 * h:2] + k[1] * rows[:, :, 1:2 * h + 1:2]
           + k[2] * rows[:, :, 2:2 * h + 2:2] + k[3] * rows[:, :, 3:2 * h + 3:2])
    return out.to(g.dtype)


def _launch(fn_name: str, src: torch.Tensor, out: torch.Tensor, h: int, w: int) -> None:
    lib = cuda_build.library("upsample2x", _ARGTYPES)
    dev = src.device
    err = getattr(lib, fn_name)(
        src.data_ptr(), out.data_ptr(), src.shape[0] * src.shape[1], h, w, _DTYPES[src.dtype],
        cuda_build.device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, "upsample2x", fn_name, err)


def _check(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_cuda:
        raise ValueError(f"{what} is on {t.device}; the upsample kernel takes a CUDA tensor")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} must be float32, bfloat16 or float64 for the upsample "
                        f"kernel, got {t.dtype}")
    if t.ndim != 4 or min(t.shape) < 1:
        raise ValueError(f"{what} must be a non-empty NCHW tensor, got {tuple(t.shape)}")
    return t.contiguous()


def upsample2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """U1: (N, C, H, W) -> (N, C, 2H, 2W) on a CUDA tensor."""
    global launches
    x = _check(x, "x")
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), device=x.device, dtype=x.dtype)
    _launch("upsample2x_fwd", x, out, h, w)
    launches += 1
    count("upsample2x")
    return out


def upsample2x_bwd_cuda(g: torch.Tensor) -> torch.Tensor:
    """U2: d(loss)/dx (N, C, H, W) from g (N, C, 2H, 2W) on a CUDA tensor.
    ``g`` as autograd hands it over may be strided; it is made contiguous
    here."""
    global bwd_launches
    g = _check(g, "g")
    n, c, h2, w2 = g.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"g must have an even height and width, got {tuple(g.shape)}")
    if g.data_ptr() % (2 * g.element_size()):
        raise ValueError("g must start on a boundary of two elements (U2 reads pairs)")
    out = torch.empty((n, c, h2 // 2, w2 // 2), device=g.device, dtype=g.dtype)
    _launch("upsample2x_bwd", g, out, h2 // 2, w2 // 2)
    bwd_launches += 1
    return out


class _Upsample2x(torch.autograd.Function):
    """U1 forward and U2 backward on a CUDA tensor."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x_cuda(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return upsample2x_bwd_cuda(grad)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NCHW tensor (reference
    nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False)):
    U1 and U2 on a CUDA tensor, F.interpolate elsewhere."""
    if x.is_cuda:
        return _Upsample2x.apply(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False,
                         antialias=False)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (H, W), no antialias."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)
