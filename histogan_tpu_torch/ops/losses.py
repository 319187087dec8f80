"""Loss functions for HistoGAN training, the counterpart of
``histogan_tpu/ops/losses.py`` (reference histoGAN/histoGAN.py:54,
156-163, 913, 955-975). The reconstruction and variance losses of
reHistoGAN are ported with reHistoGAN.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SCALE = 1.0 / np.sqrt(2.0)  # reference histoGAN/histoGAN.py:54


def hellinger_histogram_loss(target_hist: torch.Tensor, generated_hist: torch.Tensor,
                             alpha: float = 2.0) -> torch.Tensor:
    """alpha * (1/sqrt(2)) * ||sqrt(h_t) - sqrt(h_g)||_2 / B.

    The reference takes the 2-norm over the WHOLE batch tensor and then
    divides by the batch size (histoGAN/histoGAN.py:957-960), not a
    per-sample mean; kept."""
    diff = torch.sqrt(target_hist) - torch.sqrt(generated_hist)
    return alpha * SCALE * torch.sqrt(torch.sum(torch.square(diff))) / target_hist.shape[0]


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
    weight: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient penalty from the same real forward that gives the
    hinge logits. Returns (logits, gp): one forward feeds both the logits
    and ``torch.autograd.grad(..., create_graph=True)`` of their sum."""
    images = images.detach().requires_grad_(True)
    logits = forward(images)
    (img_grads,) = torch.autograd.grad(logits.sum(), images, create_graph=True)
    return logits, _penalty(img_grads, weight)


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
