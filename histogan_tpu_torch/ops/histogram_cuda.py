"""RGB-uv histogram through CUDA kernels written for Hopper (sm_90a).

The counterpart of ``histogan_tpu/ops/histogram_pallas.py``. Clip,
resize and log-chroma packing are plain torch; the contraction
``hist[b, c] = (iy * ku)^T kv`` over the packed pixels is
``csrc/histogram_fwd.cu`` (K1) and its gradient with respect to the
packed pixels is ``csrc/histogram_bwd.cu`` (K2), the two halves of one
``torch.autograd.Function``. The kernels cover the configuration the
Pallas kernels cover: rgb-uv, inverse-quadratic, intensity scale on, 64
bins on [-3, 3].

``hist_core`` takes the plain versions, ``hist_core_reference`` and
``hist_core_bwd_reference``, only for a tensor on the CPU. For a CUDA
tensor it launches the kernels or raises: a missing ``nvcc``, a failed
build or a refused launch is an error, never a silent fall back to the
einsum.

Each kernel is built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from histogan_tpu_torch.ops import cuda_build

EPS = 1e-6
H_BINS = 64
TILE = 64  # pixels per shared-memory tile in K1; chunks are multiples of it
MIN_CHUNK = 256  # fewest pixels a block takes before the split stops
BLOCKS_PER_SM = 2  # K1's blocks resident on one SM (registers and shared memory)
REFERENCE_TILE = 512  # pixels per tile of the plain version, as on the TPU


# Kernel launches since the last reset, K1 and K2 apart; only a
# successful launch of the CUDA kernel adds to its count.
launches = 0
bwd_launches = 0


def _centers(device=None) -> torch.Tensor:
    return torch.from_numpy(
        np.linspace(-3.0, 3.0, H_BINS).astype(np.float32)).to(device)


def pack_pixels(x: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) clamped pixels -> (B, N, 8) [u0 v0 u1 v1 u2 v2 iy 0].

    Unlike the TPU version the pixel count is not padded: the kernel
    masks the ragged edge itself."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    lr, lg, lb = torch.log(r + EPS), torch.log(g + EPS), torch.log(b + EPS)
    iy = torch.sqrt(r * r + g * g + b * b + EPS)
    return torch.stack(
        [lr - lg, lr - lb, lg - lr, lg - lb, lb - lr, lb - lg,
         iy, torch.zeros_like(iy)],
        dim=-1,
    )


def hist_core_reference(packed: torch.Tensor, inv_sigma2: float) -> torch.Tensor:
    """Plain torch version of the kernel: (B, N, 8) -> (B, 3, 64, 64).

    Like the TPU kernel it contracts 512-pixel tiles (zero-padded: a
    padded pixel has iy = 0) and then sums the tiles, so fp32 rounding
    grows with the tile and not with the image: one fp32 GEMM over all
    62 500 pixels of a 250x250 image drifts by about 1e-4 relative."""
    b, n, _ = packed.shape
    packed = F.pad(packed, (0, 0, 0, (-n) % REFERENCE_TILE))
    tiles = packed.reshape(b, -1, REFERENCE_TILE, 8)
    centers = _centers(packed.device)
    iy = tiles[..., 6:7]
    planes = []
    for c in range(3):
        u = tiles[..., 2 * c : 2 * c + 1]
        v = tiles[..., 2 * c + 1 : 2 * c + 2]
        ku = 1.0 / (1.0 + torch.square(u - centers) * inv_sigma2)
        kv = 1.0 / (1.0 + torch.square(v - centers) * inv_sigma2)
        planes.append(torch.einsum("btnu,btnv->btuv", iy * ku, kv).sum(dim=1))
    return torch.stack(planes, dim=1)


def hist_core_bwd_reference(packed: torch.Tensor, g: torch.Tensor,
                            inv_sigma2: float) -> torch.Tensor:
    """Plain torch version of the backward kernel: d(loss)/d(packed)
    (B, N, 8) from g = d(loss)/d(hist) (B, 3, 64, 64), written out as the
    Pallas ``_bwd_kernel``'s docstring states it, over the same 512-pixel
    tiles. Per plane, with ``kvg = kv @ g^T`` and ``kug = (iy ku) @ g``:
    du = sum_i iy kvg (-2 (u - c_i) inv_sigma2) ku^2, dv likewise over
    kug and kv, and diy = sum over the planes of sum_i ku kvg; column 7
    is 0."""
    b, n, _ = packed.shape
    tiles = F.pad(packed, (0, 0, 0, (-n) % REFERENCE_TILE)).reshape(b, -1, REFERENCE_TILE, 8)
    centers = _centers(packed.device)
    iy = tiles[..., 6:7]
    cols = []
    diy = torch.zeros_like(iy)
    for c in range(3):
        du_arg = tiles[..., 2 * c : 2 * c + 1] - centers
        dv_arg = tiles[..., 2 * c + 1 : 2 * c + 2] - centers
        ku = 1.0 / (1.0 + torch.square(du_arg) * inv_sigma2)
        kv = 1.0 / (1.0 + torch.square(dv_arg) * inv_sigma2)
        gc = g[:, c, None]  # (B, 1, 64, 64), broadcast over the tiles
        kvg = torch.matmul(kv, gc.transpose(-1, -2))
        kug = torch.matmul(iy * ku, gc)
        du = iy * kvg * (-2.0 * du_arg * inv_sigma2 * torch.square(ku))
        dv = kug * (-2.0 * dv_arg * inv_sigma2 * torch.square(kv))
        cols += [du.sum(dim=-1, keepdim=True), dv.sum(dim=-1, keepdim=True)]
        diy = diy + (ku * kvg).sum(dim=-1, keepdim=True)
    out = torch.cat(cols + [diy, torch.zeros_like(diy)], dim=-1)
    return out.reshape(b, -1, 8)[:, :n]


def kernel_work(name: str, batch: int, n_pixels: int) -> Dict[str, int]:
    """The work of one call of kernel ``name`` (a key of SOURCES) on
    (batch, n_pixels) packed pixels: ``flop`` of the 64x64 products,
    ``elementwise`` fp32 operations of the plain formulas, and ``bytes``
    read once and written once.

    Per (pixel, plane, bin): ku and kv are 5 operations each (difference,
    square, scale, add, reciprocal) and iy*ku one; K1 does one product,
    2 * 64 FLOP. K2 does two, 4 * 64 FLOP, and its epilogue adds 7 (du:
    iy*kvg, the slope's four factors, the product, the sum), 6 (dv) and
    2 (diy)."""
    triples = 3 * batch * n_pixels * H_BINS
    packed = batch * n_pixels * 8 * 4
    hist = batch * 3 * H_BINS * H_BINS * 4
    if name == "histogram_fwd":
        return {"flop": 2 * H_BINS * triples, "elementwise": 11 * triples,
                "bytes": packed + hist}
    if name == "histogram_bwd":
        return {"flop": 4 * H_BINS * triples, "elementwise": 26 * triples,
                "bytes": 2 * packed + hist}
    raise KeyError(name)


# One H100 SXM at its full 700 W (NVIDIA's data sheet, dense): split TF32
# runs three TF32 tensor-core products for one fp32 product.
SPLIT_TF32_FLOPS = 495e12 / 3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_ms(work: Dict[str, int]) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``work`` (``kernel_work``), the largest of the products over the
    split-TF32 rate, the elementwise operations over the fp32 rate and the
    bytes over the memory rate."""
    ops_s = max(work["flop"] / SPLIT_TF32_FLOPS, work["elementwise"] / FP32_FLOPS)
    bytes_s = work["bytes"] / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def split_pixels(batch: int, n_pixels: int, num_sms: int) -> Tuple[int, int]:
    """(chunk, n_chunks): how K1 splits each image's pixels over blocks.
    As many chunks as let the batch's 3 * batch * n_chunks blocks run in
    one wave of ``BLOCKS_PER_SM`` blocks per SM (a second, partial wave
    would take as long as the first), but no chunk under ``MIN_CHUNK``
    pixels. Chunks are whole tiles and cover the pixels with no empty
    chunk."""
    want = BLOCKS_PER_SM * num_sms // (3 * batch)
    most = -(-n_pixels // MIN_CHUNK)
    n_chunks = max(1, min(want, most))
    chunk = -(-n_pixels // n_chunks)
    chunk = -(-chunk // TILE) * TILE
    return chunk, -(-n_pixels // chunk)


_ARGTYPES = {
    # packed, partial, out, batch, n_pixels, chunk, n_chunks, inv_sigma2, device, stream
    "histogram_fwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p],
    # packed, g, dpacked, batch, n_pixels, inv_sigma2, device, stream
    "histogram_bwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _library(name: str) -> ctypes.CDLL:
    return cuda_build.library(name, {name: _ARGTYPES[name]})


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_packed(packed: torch.Tensor) -> None:
    if packed.dtype != torch.float32:
        raise TypeError(f"packed must be float32, got {packed.dtype}")
    if packed.ndim != 3 or packed.shape[-1] != 8:
        raise ValueError(f"packed must be (B, N, 8), got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary (K1 copies 16 bytes at a time)")
    b, n, _ = packed.shape
    if not 1 <= b <= 65535 or n < 1:
        raise ValueError(f"packed shape {tuple(packed.shape)} is outside the kernel's range")


def _launch(packed: torch.Tensor, inv_sigma2: float) -> torch.Tensor:
    global launches
    _check_packed(packed)
    b, n, _ = packed.shape
    lib = _library("histogram_fwd")
    dev = packed.device
    index = cuda_build.device_index(dev)
    chunk, n_chunks = split_pixels(b, n, _num_sms(index))
    out = torch.empty((b, 3, H_BINS, H_BINS), device=dev, dtype=torch.float32)
    partial = (torch.empty((b, 3, n_chunks, H_BINS, H_BINS), device=dev,
                           dtype=torch.float32)
               if n_chunks > 1 else out)
    err = lib.histogram_fwd(
        packed.data_ptr(), partial.data_ptr(), out.data_ptr(), b, n, chunk,
        n_chunks, float(inv_sigma2), index, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, "histogram_fwd", "histogram_fwd", err)
    launches += 1
    return out


def _launch_bwd(packed: torch.Tensor, g: torch.Tensor, inv_sigma2: float) -> torch.Tensor:
    """K2: d(loss)/d(packed) from g = d(loss)/d(hist). ``g`` as autograd
    hands it over may be expanded or strided; it is made contiguous here."""
    global bwd_launches
    _check_packed(packed)
    b, n, _ = packed.shape
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if tuple(g.shape) != (b, 3, H_BINS, H_BINS):
        raise ValueError(f"g must be {(b, 3, H_BINS, H_BINS)}, got {tuple(g.shape)}")
    if g.device != packed.device:
        raise ValueError(f"g is on {g.device}, packed on {packed.device}")
    g = g.contiguous()
    lib = _library("histogram_bwd")
    dev = packed.device
    out = torch.empty_like(packed)
    err = lib.histogram_bwd(
        packed.data_ptr(), g.data_ptr(), out.data_ptr(), b, n, float(inv_sigma2),
        cuda_build.device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, "histogram_bwd", "histogram_bwd", err)
    bwd_launches += 1
    return out


class _HistCore(torch.autograd.Function):
    """The histogram contraction as an autograd op: K1 forward and K2
    backward on a CUDA tensor, their plain versions on a CPU tensor (so
    the CPU training path runs the formulas K2 implements)."""

    @staticmethod
    def forward(ctx, packed, inv_sigma2):
        ctx.save_for_backward(packed)
        ctx.inv_sigma2 = inv_sigma2
        if packed.is_cuda:
            return _launch(packed, inv_sigma2)
        return hist_core_reference(packed, inv_sigma2)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (packed,) = ctx.saved_tensors
        if packed.is_cuda:
            return _launch_bwd(packed, grad, ctx.inv_sigma2), None
        return hist_core_bwd_reference(packed, grad, ctx.inv_sigma2), None


def hist_core(packed: torch.Tensor, inv_sigma2: float) -> torch.Tensor:
    """(B, N, 8) packed pixels -> (B, 3, 64, 64) un-normalised histogram,
    differentiable with respect to ``packed``."""
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no histogram kernel for device {packed.device}")
    return _HistCore.apply(packed, float(inv_sigma2))


def histogram_feature_cuda(
    x: torch.Tensor,
    *,
    h: int = 64,
    insz: int = 150,
    resizing: str = "interpolation",
    sigma: float = 0.02,
) -> torch.Tensor:
    """histogram_feature(space='rgb-uv', method='inverse-quadratic',
    intensity_scale=True, h=64) of an NHWC batch, through the kernel on a
    CUDA tensor."""
    if h != H_BINS:
        raise ValueError(f"the histogram kernel is specialised for {H_BINS} bins, got {h}")
    from histogan_tpu_torch.ops.histogram import resize_if_needed

    x = torch.clamp(x.float(), 0.0, 1.0)
    x = resize_if_needed(x, insz, h, resizing)
    if x.shape[-1] > 3:
        x = x[..., :3]
    packed = pack_pixels(x.reshape(x.shape[0], -1, 3)).contiguous()
    hists = hist_core(packed, 1.0 / (sigma * sigma))
    total = torch.sum(hists, dim=(1, 2, 3), keepdim=True)
    return hists / (total + EPS)
