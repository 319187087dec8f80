"""Stochastic rounding fp32 -> bf16, the counterpart of
``histogan_tpu/ops/rounding.py``.

The bf16 EMA (``ema_dtype='bf16'``) adds, per update, 0.5 % of the
distance to the live weights. bf16 keeps 8 bits of mantissa, so
round-to-nearest drops every increment under half an ulp and the EMA
stalls; stochastic rounding keeps the store unbiased, E[round(x)] == x,
and the EMA converges in expectation.

The random bits are an input, not drawn here: the caller draws them from
its own generator (``random_bits``), and a test can feed the JAX package
and this one the same bits. Plain torch ops, elementwise.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

LOW_BITS = 0xFFFF
HIGH_MASK = -65536  # 0xFFFF0000 as an int32


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Unbiasedly round an fp32 tensor to bf16.

    ``bits``: int32 of ``x``'s shape; its low 16 bits are the random draw
    (uniform on [0, 2^16)). They are added to the raw fp32 pattern and the
    low 16 bits masked off: x rounds up with probability equal to its
    position between its two bf16 neighbours. Representable values pass
    through exactly, a mantissa carry bumps the exponent, and the sign is
    untouched. int32 addition gives the bit pattern of JAX's uint32
    addition (two's complement)."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic_round_bf16 expects float32, got {x.dtype}")
    rounded = (x.view(torch.int32) + (bits & LOW_BITS)) & HIGH_MASK
    # the masked pattern is exactly representable in bf16: the cast is exact
    return rounded.view(torch.float32).to(torch.bfloat16)


def random_bits(shape, generator: torch.Generator, device) -> torch.Tensor:
    """int32 draws uniform on [0, 2^16) for ``stochastic_round_bf16``."""
    return torch.randint(0, LOW_BITS + 1, tuple(shape), dtype=torch.int32,
                         generator=generator, device=device)


def stochastic_round_list(xs: Sequence[torch.Tensor],
                          generator: torch.Generator) -> List[torch.Tensor]:
    """Round each fp32 tensor of ``xs`` to bf16, with bits drawn from
    ``generator`` in list order (one draw per tensor)."""
    return [stochastic_round_bf16(x, random_bits(x.shape, generator, x.device)) for x in xs]
