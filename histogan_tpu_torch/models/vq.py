"""EMA vector quantization of discriminator feature maps, the counterpart
of ``histogan_tpu/models/vq.py``: the third-party ``VectorQuantize`` the
reference wraps in ``PermuteToFrom`` (histoGAN/histoGAN.py:32, 600-601).

The codebook is three buffers, ``embed`` (dim, n_embed), ``cluster_size``
and ``embed_avg``, fp32 at every precision (``cast_module`` casts
parameters only). A forward picks each row's nearest code by JAX's
negative squared distance and argmax, from the codebook as it stands;
with ``train_stats`` it then moves the codebook by the EMA update, in
place and under ``torch.no_grad``. Mixed dtypes are promoted as JAX
promotes them, so a bf16 input gives an fp32 output and loss. Over
several data-parallel ranks the update's counts and sums are the global
batch's (summed across the ranks), so every rank keeps JAX's codebook.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from histogan_tpu_torch import parallel
from histogan_tpu_torch.utils.logging import span


class VectorQuantize(nn.Module):
    def __init__(self, dim: int, n_embed: int, decay: float = 0.8, commitment: float = 1.0,
                 eps: float = 1e-5):
        super().__init__()
        self.dim, self.n_embed = dim, n_embed
        self.decay, self.commitment, self.eps = decay, commitment, eps
        self.register_buffer("embed", torch.empty(dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.empty(dim, n_embed))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """embed N(0, 1); embed_avg a copy of it (never an alias); no counts."""
        self.embed.normal_(generator=generator)
        self.cluster_size.zero_()
        self.embed_avg.copy_(self.embed)

    @staticmethod
    def nearest(dist: torch.Tensor) -> torch.Tensor:
        """Each row's code: the first largest entry of ``dist``."""
        return dist.argmax(dim=1)

    def forward(self, x: torch.Tensor, train_stats: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x`` (..., dim) -> (straight-through quantized x, commitment loss)."""
        flat = x.reshape(-1, self.dim)
        wide = torch.promote_types(x.dtype, self.embed.dtype)
        with torch.no_grad():
            f = flat.detach()
            embed = self.embed.to(wide)
            dist = (-f.square().sum(dim=1, keepdim=True).to(wide)
                    + 2.0 * (f.to(wide) @ embed)
                    - embed.square().sum(dim=0, keepdim=True))
            idx = self.nearest(dist)
            quantized = embed.t()[idx].reshape(x.shape)
            if train_stats:
                onehot = F.one_hot(idx, self.n_embed).to(f.dtype)
                # the global batch's statistics over the data-parallel ranks
                counts, sums = onehot.sum(0), f.t() @ onehot
                parallel.sum_across_ranks_([counts, sums])
                new_cluster = self.decay * self.cluster_size + (1 - self.decay) * counts
                new_avg = self.decay * self.embed_avg + (1 - self.decay) * sums
                n = new_cluster.sum()
                smoothed = (new_cluster + self.eps) / (n + self.n_embed * self.eps) * n
                self.cluster_size.copy_(new_cluster)
                self.embed_avg.copy_(new_avg)
                self.embed.copy_(new_avg / smoothed[None, :])
        loss = self.commitment * torch.mean(torch.square(quantized - x))
        return x + (quantized - x).detach(), loss


class PermuteToFrom(nn.Module):
    """``fn`` on the NHWC view of an NCHW map, its output back to NCHW
    (the reference's wrapper: rows are pixels in NHWC order)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, train_stats: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("d.vq", stream=True):
            out, loss = self.fn(x.permute(0, 2, 3, 1), train_stats)
            return out.permute(0, 3, 1, 2), loss
