"""Bilateral Guided Upsampling (Chen, Adams, Hasinoff, SIGGRAPH 2016),
copied from ``histogan_tpu/post/bgu.py``.

The reference ships this as a MATLAB-compiled Windows binary invoked via
``os.system('BGU.exe ...')`` (ReHistoGAN/rehistoGAN.py:1139-1141;
upsampling/*.m). Here it is a native in-process implementation.

Math (upsampling/bguFit.m:74-281): fit an affine bilateral grid gamma of
shape (gh, gw, gd, O, I+1) minimizing

    || W^1/2 (apply(slice(gamma; coords)) - output_ds) ||^2
  + lambda_s^2 (y/x first-derivative terms)
  + lambda_z^2 (z second-derivative + boundary first-derivative terms)

then slice at full resolution with a luminance guide and apply the
per-pixel affine model (bguSlice.m:24-69).

Solver: the MATLAB code solves the stacked rectangular system with
sparse QR (``A \\ b``). Key structural fact: the system is block-diagonal
over OUTPUT channels with IDENTICAL blocks (the data rows share the same
slice-apply pattern, the smoothness rows are per-(o,i) copies), so we
form the normal equations once, factorize once (sparse Cholesky via
SuperLU), and back-substitute one rhs per output channel — O(3) solves
on an ~11.5k-unknown SPD system instead of one 35k-unknown QR.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

LUMA_COEFFS = np.array([0.25, 0.5, 0.25])  # rgb2luminance.m:19-27

DEFAULT_LAMBDA_SPATIAL = 1.0          # bguFit.m:78
DEFAULT_SECOND_DERIV_LAMBDA_Z = 4e-7  # bguFit.m:83


def rgb2luminance(rgb: np.ndarray) -> np.ndarray:
    if rgb.ndim == 2:
        return rgb
    return rgb @ LUMA_COEFFS


def default_grid_size(input_image: np.ndarray, output_image: np.ndarray) -> Tuple[int, ...]:
    """round([h/16, w/16, 8, out_ch, in_ch+1]) — getDefaultAffineGridSize.m."""
    h, w = input_image.shape[:2]
    in_ch = input_image.shape[2] if input_image.ndim == 3 else 1
    out_ch = output_image.shape[2] if output_image.ndim == 3 else 1
    return (int(round(h / 16)), int(round(w / 16)), 8, out_ch, in_ch + 1)


def _slice_apply_matrix(input_image: np.ndarray, edge_image: np.ndarray,
                        gh: int, gw: int, gd: int) -> sp.csr_matrix:
    """Sparse (num_pixels, gh*gw*gd*(I+1)) matrix S such that
    (S gamma_o)[p] = sum_i input1[p,i] * trilerp(gamma[:,:,:,o,i]; p).

    Vectorized equivalent of buildAffineSliceMatrix + apply-affine
    (bguFit.m:206-235) for one output channel.
    """
    h, w = input_image.shape[:2]
    n_pix = h * w
    in1 = np.concatenate(
        [input_image.reshape(h, w, -1), np.ones((h, w, 1))], axis=-1
    ).reshape(n_pix, -1)  # (P, I+1)
    n_in = in1.shape[1]

    px = np.arange(w)
    py = np.arange(h)
    cx = (px + 0.5) * (gw - 1) / w                     # grid x coords
    cy = (py + 0.5) * (gh - 1) / h
    cz = edge_image * (gd - 1)                          # (h, w)

    x0 = np.floor(cx).astype(np.int64)
    y0 = np.floor(cy).astype(np.int64)
    z0 = np.floor(cz).astype(np.int64)
    dx = np.broadcast_to((cx - x0)[None, :], (h, w)).ravel()
    dy = np.broadcast_to((cy - y0)[:, None], (h, w)).ravel()
    dz = (cz - z0).ravel()
    x0 = np.broadcast_to(x0[None, :], (h, w)).ravel()
    y0 = np.broadcast_to(y0[:, None], (h, w)).ravel()
    z0 = z0.ravel()

    # 8 trilinear corners (bit order: x, y, z)
    rows, cols, vals = [], [], []
    pix_idx = np.arange(n_pix)
    for corner in range(8):
        ox, oy, oz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
        wx = dx if ox else (1.0 - dx)
        wy = dy if oy else (1.0 - dy)
        wz = dz if oz else (1.0 - dz)
        weight = wx * wy * wz
        xi, yi, zi = x0 + ox, y0 + oy, z0 + oz
        ok = (xi >= 0) & (xi < gw) & (yi >= 0) & (yi < gh) & (zi >= 0) & (zi < gd)
        # voxel linear index matching MATLAB sub2ind(grid_size, y, x, z, u, v)
        # with (i-channel) as the outermost block: idx = ((i*gd + z)*gw + x)*gh + y
        base = (zi[ok] * gw + xi[ok]) * gh + yi[ok]
        wv = weight[ok]
        pv = pix_idx[ok]
        for i in range(n_in):
            rows.append(pv)
            cols.append(i * (gh * gw * gd) + base)
            vals.append(wv * in1[pv, i])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(n_pix, gh * gw * gd * n_in)
    ).tocsr()


def _diff_matrix_1d(n: int) -> sp.csr_matrix:
    """(n-1, n) forward difference."""
    return sp.diags([-np.ones(n - 1), np.ones(n - 1)], [0, 1],
                    shape=(n - 1, n), format="csr")


def _smoothness_normal(gh: int, gw: int, gd: int, n_in: int,
                       bin_y: float, bin_x: float, bin_z: float,
                       lambda_s: float, lambda_z: float) -> sp.csr_matrix:
    """Sum of D^T D for y/x first-derivative and z second-derivative (+
    z boundary first-derivative) terms, for ONE (o, i) slab stack of
    n_in slabs. Voxel index layout: ((i*gd + z)*gw + x)*gh + y."""
    iy = sp.identity(gh, format="csr")
    ix = sp.identity(gw, format="csr")
    iz = sp.identity(gd, format="csr")

    dy = _diff_matrix_1d(gh)
    dx = _diff_matrix_1d(gw)

    # kron order: index = (z*gw + x)*gh + y -> y fastest => A = kron(z, kron(x, y))
    a_dy = (bin_x * bin_z / bin_y) * lambda_s * sp.kron(iz, sp.kron(ix, dy))
    a_dx = (bin_y * bin_z / bin_x) * lambda_s * sp.kron(iz, sp.kron(dx, iy))

    # z second derivative (interior) + first-derivative boundaries
    # (buildSecondDerivZMatrix.m)
    if gd >= 3:
        e = np.ones(gd - 2)
        d2z = sp.diags([e, -2 * e, e], [0, 1, 2], shape=(gd - 2, gd), format="csr")
    else:
        d2z = sp.csr_matrix((0, gd))
    bz = _diff_matrix_1d(gd)
    z_first = sp.vstack([bz[:1], bz[-1:] * -1.0])  # boundary rows: first & (negated) last
    zc = (bin_x * bin_y) / (bin_z * bin_z) * lambda_z
    a_z2 = zc * sp.kron(sp.vstack([z_first[:1], d2z, z_first[1:]]),
                        sp.kron(ix, iy))

    slab = (a_dy.T @ a_dy + a_dx.T @ a_dx + a_z2.T @ a_z2).tocsr()
    return sp.block_diag([slab] * n_in, format="csr")


def bgu_fit(input_ds: np.ndarray, edge_ds: np.ndarray, output_ds: np.ndarray,
            weight_ds: Optional[np.ndarray] = None,
            grid_size: Optional[Tuple[int, ...]] = None,
            lambda_spatial: float = DEFAULT_LAMBDA_SPATIAL,
            lambda_z: float = DEFAULT_SECOND_DERIV_LAMBDA_Z) -> np.ndarray:
    """Fit the affine bilateral grid. Returns gamma (gh, gw, gd, O, I+1)."""
    input_ds = np.asarray(input_ds, np.float64)
    output_ds = np.asarray(output_ds, np.float64)
    edge_ds = np.asarray(edge_ds, np.float64)
    if grid_size is None:
        grid_size = default_grid_size(input_ds, output_ds)
    gh, gw, gd, n_out, n_in = grid_size
    h, w = input_ds.shape[:2]

    bin_x = w / gw
    bin_y = h / gh
    bin_z = 1.0 / gd

    s = _slice_apply_matrix(input_ds, edge_ds, gh, gw, gd)  # (P, n)
    if weight_ds is not None:
        sw = np.sqrt(np.asarray(weight_ds, np.float64).reshape(h * w, -1))
    else:
        sw = None

    reg = _smoothness_normal(gh, gw, gd, n_in, bin_y, bin_x, bin_z,
                             lambda_spatial, lambda_z)

    out_flat = output_ds.reshape(h * w, n_out)
    gamma = np.zeros((gh * gw * gd * n_in, n_out))
    if sw is None or np.ptp(sw) == 0:
        scale = 1.0 if sw is None else float(sw.flat[0]) ** 2
        normal = (s.T @ s) * scale + reg
        solve = spla.factorized(normal.tocsc())
        for o in range(n_out):
            gamma[:, o] = solve(s.T @ (out_flat[:, o] * scale))
    else:
        for o in range(n_out):
            wo = sw[:, min(o, sw.shape[1] - 1)] ** 2
            sws = s.multiply(wo[:, None])
            normal = (s.T @ sws) + reg
            gamma[:, o] = spla.spsolve(normal.tocsc(), s.T @ (wo * out_flat[:, o]))

    # (n_in, gd, gw, gh) -> (gh, gw, gd, n_out, n_in)
    gamma = gamma.reshape(n_in, gd, gw, gh, n_out)
    return np.transpose(gamma, (3, 2, 1, 4, 0))


def bgu_slice(gamma: np.ndarray, input_fs: np.ndarray,
              edge_fs: np.ndarray) -> np.ndarray:
    """Trilinearly slice gamma at full resolution and apply the per-pixel
    affine model (bguSlice.m:24-69)."""
    gh, gw, gd, n_out, n_in = gamma.shape
    h, w = input_fs.shape[:2]

    cx = (np.arange(w) + 0.5) * (gw - 1) / w
    cy = (np.arange(h) + 0.5) * (gh - 1) / h
    cz = np.clip(np.asarray(edge_fs, np.float64), 0.0, 1.0) * (gd - 1)

    x0 = np.clip(np.floor(cx).astype(np.int64), 0, gw - 2)
    y0 = np.clip(np.floor(cy).astype(np.int64), 0, gh - 2)
    z0 = np.clip(np.floor(cz).astype(np.int64), 0, gd - 2)
    fx = cx - x0
    fy = cy - y0
    fz = cz - z0

    fx2 = np.broadcast_to(fx[None, :], (h, w))
    fy2 = np.broadcast_to(fy[:, None], (h, w))
    x02 = np.broadcast_to(x0[None, :], (h, w))
    y02 = np.broadcast_to(y0[:, None], (h, w))

    g = gamma.reshape(gh, gw, gd, n_out * n_in)
    model = np.zeros((h, w, n_out * n_in))
    for corner in range(8):
        ox, oy, oz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
        wgt = ((fx2 if ox else 1 - fx2)
               * (fy2 if oy else 1 - fy2)
               * (fz if oz else 1 - fz))
        model += wgt[..., None] * g[y02 + oy, x02 + ox, z0 + oz]

    model = model.reshape(h, w, n_out, n_in)
    in1 = np.concatenate(
        [input_fs.reshape(h, w, -1), np.ones((h, w, 1))], axis=-1
    )
    return np.einsum("hwoi,hwi->hwo", model, in1)


def bgu_upsample(input_fs: np.ndarray, output_ds: np.ndarray,
                 max_ds: int = 300, backend: str = None) -> np.ndarray:
    """The BGU.m driver: cap the low-res output at ``max_ds`` px, resize
    the full-res input down to it, luminance guides, fit, slice.

    backend: 'scipy' (direct sparse solve, default) or 'native' (C++
    matrix-free PCG — histogan_tpu_torch/native/bgu_solver.cpp); also settable
    via HISTOGAN_BGU env var."""
    import os

    backend = backend or os.environ.get("HISTOGAN_BGU", "scipy")
    if backend == "native":
        from histogan_tpu_torch.post.bgu_native import bgu_upsample_native

        return bgu_upsample_native(input_fs, output_ds, max_ds)
    if backend != "scipy":
        raise ValueError(f"unknown BGU backend {backend!r}; use 'scipy' or 'native'")
    from histogan_tpu_torch.post.imresize import imresize

    input_fs = np.asarray(input_fs, np.float64)
    output_ds = np.asarray(output_ds, np.float64)
    if output_ds.shape[0] > max_ds or output_ds.shape[1] > max_ds:
        output_ds = imresize(output_ds, output_shape=(max_ds, max_ds))
    input_ds = imresize(input_fs, output_shape=output_ds.shape[:2])
    edge_ds = rgb2luminance(input_ds)
    edge_fs = rgb2luminance(input_fs)
    gamma = bgu_fit(input_ds, edge_ds, output_ds)
    out = bgu_slice(gamma, input_fs, edge_fs)
    return np.clip(out, 0.0, 1.0)
