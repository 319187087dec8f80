"""Loss functions for HistoGAN and reHistoGAN training, the counterpart
of ``histogan_tpu/ops/losses.py`` (reference histoGAN/histoGAN.py:54,
156-163, 913, 955-975; rehistoGAN.py:303-326, 1019-1028). Images are
NCHW.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from histogan_tpu_torch import parallel
from histogan_tpu_torch.ops import filters

SCALE = 1.0 / np.sqrt(2.0)  # reference histoGAN/histoGAN.py:54


def hellinger_histogram_loss(target_hist: torch.Tensor, generated_hist: torch.Tensor,
                             alpha: float = 2.0) -> torch.Tensor:
    """alpha * (1/sqrt(2)) * ||sqrt(h_t) - sqrt(h_g)||_2 / B.

    The reference takes the 2-norm over the WHOLE batch tensor and then
    divides by the batch size (histoGAN/histoGAN.py:957-960), not a
    per-sample mean; kept. Under data parallelism the norm and B are the
    global batch's over the ranks (``parallel.global_sum``, the identity
    in one process)."""
    diff = torch.sqrt(target_hist) - torch.sqrt(generated_hist)
    sq = parallel.global_sum(torch.sum(torch.square(diff)))
    return alpha * SCALE * torch.sqrt(sq) / (target_hist.shape[0] * parallel.world_size())


def hinge_divergence(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """mean(relu(1 + real) + relu(1 - fake)), histoGAN/histoGAN.py:913.
    The reference's sign: D is trained to push real logits negative."""
    return torch.mean(F.relu(1.0 + real_logits) + F.relu(1.0 - fake_logits))


def _penalty(img_grads: torch.Tensor, weight: float) -> torch.Tensor:
    norms = torch.linalg.vector_norm(img_grads.reshape(img_grads.shape[0], -1), dim=1)
    return weight * torch.mean(torch.square(norms - 1.0))


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                     weight: float = 10.0) -> torch.Tensor:
    """weight * mean((||d sum(D(x)) / d x||_2 - 1)^2) on real images
    (histoGAN/histoGAN.py:156-163), differentiable with respect to D's
    parameters (``create_graph``)."""
    return shared_forward_gradient_penalty(d_apply, images, weight)[1]


def shared_forward_gradient_penalty(
    forward: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
    weight: float = 10.0, has_aux: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The gradient penalty from the same real forward that gives the
    hinge logits. Returns (logits, gp): one forward feeds both the logits
    and ``torch.autograd.grad(..., create_graph=True)`` of their sum. With
    ``has_aux`` the forward returns (logits, aux), and this (logits, aux,
    gp), as ``jax.vjp(..., has_aux=True)`` in the JAX package."""
    images = images.detach().requires_grad_(True)
    out = forward(images)
    logits = out[0] if has_aux else out
    (img_grads,) = torch.autograd.grad(logits.sum(), images, create_graph=True)
    gp = _penalty(img_grads, weight)
    return (logits, out[1], gp) if has_aux else (logits, gp)


def path_length_lengths(pl_images: torch.Tensor, generated_images: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared pixel change over every non-batch axis
    (histoGAN/histoGAN.py:969), so NCHW and NHWC give the same values."""
    d = pl_images - generated_images
    return torch.mean(torch.square(d), dim=tuple(range(1, d.ndim)))


def path_length_penalty(pl_lengths: torch.Tensor, pl_mean: torch.Tensor) -> torch.Tensor:
    """mean((pl_lengths - pl_mean)^2), 0 where it is NaN, like the
    reference (histoGAN/histoGAN.py:973-975)."""
    loss = torch.mean(torch.square(pl_lengths - pl_mean))
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)


def reconstruction_loss(input_img: torch.Tensor, target_img: torch.Tensor,
                        variant: str = "2nd gradient") -> torch.Tensor:
    """The reHistoGAN reconstruction term (rehistoGAN.py:303-326):
    'L1', '1st gradient' (L1 of the Sobel magnitudes) or '2nd gradient'
    (L1 of the Laplacians)."""
    if variant == "L1":
        return torch.mean(torch.abs(input_img - target_img))
    if variant == "1st gradient":
        def magnitude(x):
            return torch.sqrt(torch.square(filters.sobel_op(x, 0))
                              + torch.square(filters.sobel_op(x, 1)))

        return torch.mean(torch.abs(magnitude(input_img) - magnitude(target_img)))
    if variant == "2nd gradient":
        return torch.mean(torch.abs(filters.laplacian_op(input_img)
                                    - filters.laplacian_op(target_img)))
    raise ValueError(f"unknown reconstruction loss variant {variant!r}")


def variance_loss(hist_batch: torch.Tensor, input_hist_of_hist: torch.Tensor,
                  input_images: torch.Tensor, generated_images: torch.Tensor,
                  gauss_kernel: torch.Tensor, beta: float) -> torch.Tensor:
    """The reHistoGAN variance term (rehistoGAN.py:1019-1028):

        -(beta / 10) * sum|h_t - H(relu(h_t))|
                     * mean|std(std(blur(x_in), H), W) - the same of x_gen|

    The reference feeds the histogram TENSOR back through a histogram
    block as an image (rehistoGAN.py:1020); the caller passes that
    hist-of-hist as ``input_hist_of_hist``. ``torch.std`` is unbiased
    (correction 1), over H and then over W, leaving (B, C). Under data
    parallelism the sum and the mean are the global batch's over the
    ranks (the identity in one process)."""
    def std2(x):
        return torch.std(torch.std(x, dim=2, correction=1), dim=2, correction=1)

    blur_in = filters.gaussian_op(input_images, gauss_kernel)
    blur_gen = filters.gaussian_op(generated_images, gauss_kernel)
    color_term = parallel.global_sum(torch.sum(torch.abs(hist_batch - input_hist_of_hist)))
    structure_term = parallel.global_mean(torch.abs(std2(blur_in) - std2(blur_gen)))
    return -1.0 * (beta / 10.0) * color_term * structure_term
