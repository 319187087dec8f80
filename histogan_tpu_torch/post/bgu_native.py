"""ctypes bindings for the native C++ BGU solver
(histogan_tpu_torch/native/bgu_solver.cpp), copied from
``histogan_tpu/post/bgu_native.py``.

The solver is a block-Jacobi preconditioned conjugate gradient. Each
output channel reports its iterations and its final relative residual; a
fit in which any channel stops short of ``tol`` raises ``RuntimeError``,
so an unconverged grid is never returned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from histogan_tpu_torch.native import load_library
from histogan_tpu_torch.post.bgu import default_grid_size, rgb2luminance
from histogan_tpu_torch.post.bgu import (
    DEFAULT_LAMBDA_SPATIAL,
    DEFAULT_SECOND_DERIV_LAMBDA_Z,
)


def _cptr(a: np.ndarray):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# the solver's per-channel status (bgu_solver.cpp)
STATUS = {0: "converged", 1: "reached max_iters above tol", 2: "broke on p.Ap <= 0"}


class FitReport(NamedTuple):
    """Per output channel: CG iterations, final relative residual
    |b - A x| / |b|, and status (a key of ``STATUS``)."""
    iters: Tuple[int, ...]
    residual: Tuple[float, ...]
    status: Tuple[int, ...]


def bgu_fit_native(*args, **kwargs) -> np.ndarray:
    """Fit the affine bilateral grid (as ``post.bgu.bgu_fit``) by the
    native solver. Returns gamma (gh, gw, gd, O, I+1); takes the arguments
    of ``bgu_fit_native_report``."""
    return bgu_fit_native_report(*args, **kwargs)[0]


def bgu_fit_native_report(input_ds: np.ndarray, edge_ds: np.ndarray,
                          output_ds: np.ndarray,
                          weight_ds: Optional[np.ndarray] = None,
                          grid_size: Optional[Tuple[int, ...]] = None,
                          lambda_spatial: float = DEFAULT_LAMBDA_SPATIAL,
                          lambda_z: float = DEFAULT_SECOND_DERIV_LAMBDA_Z,
                          max_iters: int = 2000, tol: float = 1e-9
                          ) -> Tuple[np.ndarray, FitReport]:
    """``bgu_fit_native``'s gamma with the solver's ``FitReport``. Raises
    RuntimeError when a channel does not reach ``tol``."""
    import ctypes

    lib = load_library()
    input_ds = np.ascontiguousarray(input_ds, np.float64)
    edge_ds = np.ascontiguousarray(edge_ds, np.float64)
    output_ds = np.ascontiguousarray(output_ds, np.float64)
    if input_ds.ndim == 2:
        input_ds = input_ds[..., None]
    if output_ds.ndim == 2:
        output_ds = output_ds[..., None]
    if grid_size is None:
        grid_size = default_grid_size(input_ds, output_ds)
    gh, gw, gd, n_out, n_in = grid_size
    h, w, in_ch = input_ds.shape
    assert n_in == in_ch + 1

    wptr = None
    if weight_ds is not None:
        weight_arr = np.ascontiguousarray(
            np.asarray(weight_ds, np.float64).reshape(h, w, -1)[..., 0]
        )
        wptr = _cptr(weight_arr)

    gamma = np.zeros((gh, gw, gd, n_out, n_in), np.float64)
    iters = np.zeros(n_out, np.int32)
    residual = np.zeros(n_out, np.float64)
    status = np.zeros(n_out, np.int32)
    ip = ctypes.POINTER(ctypes.c_int)
    most = lib.bgu_fit_native(
        _cptr(input_ds), _cptr(edge_ds), _cptr(output_ds), wptr,
        h, w, in_ch, n_out, gh, gw, gd,
        float(lambda_spatial), float(lambda_z), int(max_iters), float(tol),
        _cptr(gamma), iters.ctypes.data_as(ip), _cptr(residual), status.ctypes.data_as(ip),
    )
    if most < 0:
        raise RuntimeError(f"native BGU fit refused its arguments (image {h}x{w}x{in_ch}, "
                           f"grid {grid_size})")
    report = FitReport(tuple(int(i) for i in iters), tuple(float(r) for r in residual),
                       tuple(int(s) for s in status))
    for o, (it, res, st) in enumerate(zip(*report)):
        if st != 0:
            raise RuntimeError(
                f"native BGU fit did not converge: output channel {o} {STATUS[st]} after "
                f"{it} iterations, relative residual {res:.3e} (tol {tol:g}, max_iters "
                f"{max_iters})")
    return gamma, report


def bgu_slice_native(gamma: np.ndarray, input_fs: np.ndarray,
                     edge_fs: np.ndarray) -> np.ndarray:
    lib = load_library()
    gamma = np.ascontiguousarray(gamma, np.float64)
    input_fs = np.ascontiguousarray(input_fs, np.float64)
    edge_fs = np.ascontiguousarray(edge_fs, np.float64)
    if input_fs.ndim == 2:
        input_fs = input_fs[..., None]
    gh, gw, gd, n_out, n_in = gamma.shape
    h, w = input_fs.shape[:2]
    out = np.zeros((h, w, n_out), np.float64)
    lib.bgu_slice_native(
        _cptr(gamma), gh, gw, gd, n_out, n_in,
        _cptr(input_fs), _cptr(edge_fs), h, w, _cptr(out),
    )
    return out


def bgu_upsample_native(input_fs: np.ndarray, output_ds: np.ndarray,
                        max_ds: int = 300) -> np.ndarray:
    """Native equivalent of post.bgu.bgu_upsample (BGU.m driver)."""
    from histogan_tpu_torch.post.imresize import imresize

    input_fs = np.asarray(input_fs, np.float64)
    output_ds = np.asarray(output_ds, np.float64)
    if output_ds.shape[0] > max_ds or output_ds.shape[1] > max_ds:
        output_ds = imresize(output_ds, output_shape=(max_ds, max_ds))
    input_ds = imresize(input_fs, output_shape=output_ds.shape[:2])
    gamma = bgu_fit_native(input_ds, rgb2luminance(input_ds), output_ds)
    out = bgu_slice_native(gamma, input_fs, rgb2luminance(input_fs))
    return np.clip(out, 0.0, 1.0)
