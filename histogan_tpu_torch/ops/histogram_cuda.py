"""RGB-uv histogram through a CUDA kernel written for Hopper (sm_90a).

The counterpart of ``histogan_tpu/ops/histogram_pallas.py``. Clip,
resize and log-chroma packing are plain torch; the contraction
``hist[b, c] = (iy * ku)^T kv`` over the packed pixels is
``csrc/histogram_fwd.cu``. The kernel covers the configuration the
Pallas kernel covers: rgb-uv, inverse-quadratic, intensity scale on, 64
bins on [-3, 3].

``hist_core`` takes the plain version, ``hist_core_reference``, only for
a tensor on the CPU. For a CUDA tensor it launches the kernel or raises:
a missing ``nvcc``, a failed build or a refused launch is an error, never
a silent fall back to the einsum.

The kernel is built with ``nvcc`` at first use into ``build/`` beside the
package (the repository's ignored build directory), keyed by a hash of
the source and flags, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6
H_BINS = 64
TILE = 64  # pixels per shared-memory tile in the kernel; chunks are multiples of it
MIN_CHUNK = 256  # fewest pixels a block takes before the split stops
BLOCKS_PER_SM = 2
REFERENCE_TILE = 512  # pixels per tile of the plain version, as on the TPU

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "histogram_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches since the last reset; only a successful launch of the
# CUDA kernel adds to it.
launches = 0


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


def split_pixels(batch: int, n_pixels: int, num_sms: int) -> Tuple[int, int]:
    """(chunk, n_chunks): how the kernel splits each image's pixels over
    blocks. Enough chunks that the batch's 3 * batch * n_chunks blocks
    fill ``BLOCKS_PER_SM`` blocks per SM, but no chunk under
    ``MIN_CHUNK`` pixels. Chunks are whole tiles and cover the pixels
    with no empty chunk."""
    want = -(-BLOCKS_PER_SM * num_sms // (3 * batch))
    most = -(-n_pixels // MIN_CHUNK)
    n_chunks = max(1, min(want, most))
    chunk = -(-n_pixels // n_chunks)
    chunk = -(-chunk // TILE) * TILE
    return chunk, -(-n_pixels // chunk)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the "
            f"histogram kernel is built from {SOURCE} at first use")
    return found


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhistogram_fwd-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel unless this source's library is already built.
    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.histogram_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.histogram_fwd.restype = ctypes.c_int
    lib.histogram_fwd_error_string.argtypes = [ctypes.c_int]
    lib.histogram_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(packed: torch.Tensor, inv_sigma2: float) -> torch.Tensor:
    global launches
    if packed.dtype != torch.float32:
        raise TypeError(f"packed must be float32, got {packed.dtype}")
    if packed.ndim != 3 or packed.shape[-1] != 8:
        raise ValueError(f"packed must be (B, N, 8), got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    b, n, _ = packed.shape
    if not 1 <= b <= 65535 or n < 1:
        raise ValueError(f"packed shape {tuple(packed.shape)} is outside the kernel's range")
    lib = _library()
    dev = packed.device
    chunk, n_chunks = split_pixels(
        b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, 3, H_BINS, H_BINS), device=dev, dtype=torch.float32)
    partial = (torch.empty((b, 3, n_chunks, H_BINS, H_BINS), device=dev,
                           dtype=torch.float32)
               if n_chunks > 1 else out)
    err = lib.histogram_fwd(
        packed.data_ptr(), partial.data_ptr(), out.data_ptr(), b, n, chunk,
        n_chunks, float(inv_sigma2), dev.index if dev.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"histogram_fwd launch failed: CUDA error {err} "
            f"({lib.histogram_fwd_error_string(err).decode()})")
    launches += 1
    return out


class _HistCore(torch.autograd.Function):
    """The kernel as an autograd op. Its backward (the Pallas
    ``_bwd_kernel``) is ported with training."""

    @staticmethod
    def forward(ctx, packed, inv_sigma2):
        return _launch(packed, inv_sigma2)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the histogram kernel's backward is not ported yet; it comes "
            "with training")


def hist_core(packed: torch.Tensor, inv_sigma2: float) -> torch.Tensor:
    """(B, N, 8) packed pixels -> (B, 3, 64, 64) un-normalised histogram."""
    if packed.device.type == "cpu":
        return hist_core_reference(packed, inv_sigma2)
    if packed.device.type != "cuda":
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
