"""Monge-Kantorovich linear color transfer, copied from
``histogan_tpu/post/mkl.py``.

Reference: utils/color_transfer_MKL.py:6-38. Closed-form linear map
between the 3x3 color covariances of source and target:
T = Ua Da^-1 Uc Dc Uc^T Da^-1 Ua^T with C = Da Ua^T B Ua Da.
"""

from __future__ import annotations

import numpy as np

EPS = 2.2204e-16  # MATLAB eps, as in the reference


def MKL(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    Da2, Ua = np.linalg.eig(A)
    Da2 = np.diag(Da2)
    Da2[Da2 < 0] = 0
    Da = np.sqrt(Da2 + EPS)
    C = Da @ Ua.T @ B @ Ua @ Da
    Dc2, Uc = np.linalg.eig(C)
    Dc2 = np.diag(Dc2)
    Dc2[Dc2 < 0] = 0
    Dc = np.sqrt(Dc2 + EPS)
    Da_inv = np.diag(1.0 / np.diag(Da))
    return Ua @ Da_inv @ Uc @ Dc @ Uc.T @ Da_inv @ Ua.T


def color_transfer_MKL(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """source/target: (H, W, 3) float in [0,1]; returns recolored source."""
    assert source.ndim == 3, "Images should have 3 dimensions"
    assert source.shape[-1] == 3, "Images should have 3 channels"
    x0 = np.reshape(source, (-1, 3), "F")
    x1 = np.reshape(target, (-1, 3), "F")
    a = np.cov(x0, rowvar=False)
    b = np.cov(x1, rowvar=False)
    t = MKL(a, b)
    mx0 = np.mean(x0, axis=0)
    mx1 = np.mean(x1, axis=0)
    xr = (x0 - mx0) @ t + mx1
    ir = np.real(np.reshape(xr, source.shape, "F"))
    return np.clip(ir, 0.0, 1.0)
