"""Fréchet Inception Distance for quality tracking, the counterpart of
``histogan_tpu/metrics/fid.py``: activation statistics, the Fréchet
distance (numpy float64, an eigendecomposition-based sqrtm) and a scorer
that walks real and generated batches through a feature extractor.

The extractor is InceptionV3's pool3 (``metrics/inception.py``).
Pretrained weights are read from a file (``INCEPTION_WEIGHTS`` or an
explicit path); without one, ``random_inception_extractor`` is the same
graph with the JAX package's seeded He-initialized weights, a relative
quality signal only. Every extractor carries its ``provenance``
('pretrained', 'random-features'; 'custom' for a user's callable), and
every score is reported with it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mu, sigma)."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Real part of sqrtm(a @ b) for symmetric PSD a, b via
    eigendecomposition of the symmetrized product:
    sqrtm(A B) similar to A^1/2 (A^1/2 B A^1/2)^1/2 A^-1/2; trace equals
    trace of (A^1/2 B A^1/2)^1/2 which is what FID needs."""
    w, v = np.linalg.eigh(a)
    w = np.clip(w, 0.0, None)
    a_half = (v * np.sqrt(w)) @ v.T
    inner = a_half @ b @ a_half
    w2, v2 = np.linalg.eigh((inner + inner.T) / 2.0)
    w2 = np.clip(w2, 0.0, None)
    return (v2 * np.sqrt(w2)) @ v2.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrtm(s1 s2))."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = _sqrtm_product(sigma1 + offset, sigma2 + offset)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def inception_extractor(weights_path: Optional[str] = None, device="cuda") -> Callable:
    """InceptionV3 pool3 features on ``device`` from a pretrained
    torchvision state dict export (.pt/.pth/.npz) at ``weights_path`` or
    ``INCEPTION_WEIGHTS``; raises FileNotFoundError without one."""
    import os

    from histogan_tpu_torch.metrics import inception

    path = weights_path or os.environ.get("INCEPTION_WEIGHTS")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "InceptionV3 weights not found; set INCEPTION_WEIGHTS to a "
            "pt/npz export of torchvision's inception_v3, pass a custom "
            "extractor to FIDScorer, or use random_inception_extractor().")
    fn = inception.make_extractor(inception.load_weights_file(path), device)
    fn.provenance = "pretrained"
    return fn


def random_inception_extractor(seed: int = 0, device="cuda") -> Callable:
    """The InceptionV3 graph with deterministic He-initialized weights
    (``inception.random_params``) on ``device``: a relative quality signal
    when no pretrained file is given."""
    from histogan_tpu_torch.metrics import inception

    fn = inception.make_extractor(inception.random_params(seed), device)
    fn.provenance = "random-features"
    return fn


def default_extractor(device="cuda") -> Callable:
    """The pretrained extractor if INCEPTION_WEIGHTS is set, else the
    seeded random-weight one. A set but missing path raises: a quiet
    fallback would fill fid_scores.txt with random-feature scores."""
    import os

    path = os.environ.get("INCEPTION_WEIGHTS")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"INCEPTION_WEIGHTS points at a missing file: {path}")
        return inception_extractor(path, device)
    return random_inception_extractor(device=device)


class FIDScorer:
    """Accumulate real/generated features and report FID."""

    def __init__(self, extractor: Callable):
        self.extractor = extractor
        self._real = []
        self._fake = []

    @property
    def provenance(self) -> str:
        """Which extractor produced the scores: 'pretrained',
        'random-features', or 'custom' for user-supplied callables."""
        return getattr(self.extractor, "provenance", "custom")

    def add_real(self, images) -> None:
        self._real.append(np.asarray(self.extractor(images)))

    def add_generated(self, images) -> None:
        self._fake.append(np.asarray(self.extractor(images)))

    def score(self) -> float:
        mu_r, s_r = compute_statistics(np.concatenate(self._real))
        mu_f, s_f = compute_statistics(np.concatenate(self._fake))
        return frechet_distance(mu_r, s_r, mu_f, s_f)

    def reset(self, real: bool = True, fake: bool = True) -> None:
        """Drop accumulated features. Trainer reuse: real stats are kept
        across FID evaluations (the dataset doesn't change), generated
        stats are recomputed each time."""
        if real:
            self._real = []
        if fake:
            self._fake = []

    @property
    def num_real(self) -> int:
        return int(sum(f.shape[0] for f in self._real))
