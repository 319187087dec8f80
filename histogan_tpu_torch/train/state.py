"""Training state, the counterpart of ``histogan_tpu/train/state.py``.

JAX keeps the state as an immutable pytree that each step returns anew;
here it is the modules and optimizers themselves, which a step updates in
place (no second copy of the weights, the EMA or the optimizer moments).

With ``ema_dtype='bf16'`` the EMA modules SE/HE/GE hold bf16 parameters:
a reset is a round-to-nearest cast of the live weights, an update is
computed in fp32 and stored by stochastic rounding (``ops/rounding.py``)
with bits from ``ema_gen``, a generator that nothing else draws from, so
the step's own draws do not depend on ``ema_dtype``.

Under ``param_sharding='fsdp'`` over several ranks (``parallel/fsdp.py``)
the modules hold this rank's shards of the parameters, and DiffGrad's
state follows them. ``reference_state_dict`` then gathers, on every rank;
``update_ema`` and ``reset_ema`` run on the shards, elementwise, and the
bf16 EMA draws its rounding bits in each parameter's full shape and keeps
its slice of them, so the EMA does not depend on the layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from histogan_tpu_torch.ops.rounding import random_bits, stochastic_round_bf16
from histogan_tpu_torch.optim.diffgrad import DiffGrad
from histogan_tpu_torch.parallel import fsdp

# modules by their reference state-dict prefix: live S/H/G/D, EMA SE/HE/GE
LIVE = ("S", "H", "G", "D")
EMA = {"SE": "S", "HE": "H", "GE": "G"}


@dataclasses.dataclass
class HistoGANState:
    """Everything a training step reads and updates and a checkpoint
    holds (the reference saves the GAN's state dict; the optimizers'
    state, ``pl_mean`` and the step are kept too, so a resume continues
    the same run)."""

    S: nn.Module
    H: nn.Module
    G: nn.Module
    D: nn.Module
    SE: nn.Module
    HE: nn.Module
    GE: nn.Module
    opt_g: DiffGrad
    opt_d: DiffGrad
    pl_mean: torch.Tensor  # 0-d fp32 on the training device
    step: int = 0
    ema_gen: Optional[torch.Generator] = None  # the bf16 EMA's rounding bits

    def modules(self) -> Dict[str, nn.Module]:
        return {k: getattr(self, k) for k in (*LIVE, *EMA)}

    def g_params(self) -> List[torch.Tensor]:
        """The generator side's parameters, S then H then G (params_g)."""
        return [p for k in ("S", "H", "G") for p in getattr(self, k).parameters()]

    def ema_pairs(self):
        """(EMA module, live module) for SE/HE/GE."""
        return [(getattr(self, e), getattr(self, live)) for e, live in EMA.items()]

    def reference_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights in the flat reference layout (``GAN.state_dict()``),
        each in its stored dtype; sharded ones gathered (every rank calls
        it)."""
        return fsdp.unshard_state_dict(self.modules())

    @torch.no_grad()
    def reset_ema(self) -> None:
        """reset_parameter_averaging (histoGAN/histoGAN.py:999-1000); into
        a bf16 EMA a round-to-nearest cast."""
        for ema, live in self.ema_pairs():
            torch._foreach_copy_(list(ema.parameters()), list(live.parameters()))

    @torch.no_grad()
    def update_ema(self, beta: float = 0.995) -> None:
        """EMA <- beta * EMA + (1 - beta) * live (histoGAN/histoGAN.py:996-998);
        into a bf16 EMA computed in fp32 and stochastically rounded."""
        for ema, live in self.ema_pairs():
            e, p = list(ema.parameters()), list(live.parameters())
            if e[0].dtype == torch.float32:
                torch._foreach_mul_(e, beta)
                torch._foreach_add_(e, p, alpha=1.0 - beta)
                continue
            e32 = [x.float() for x in e]
            torch._foreach_mul_(e32, beta)
            torch._foreach_add_(e32, p, alpha=1.0 - beta)
            # one draw per tensor in list order, in its full shape
            leaves = fsdp.param_leaves([ema])
            torch._foreach_copy_(e, [
                stochastic_round_bf16(x, fsdp.local_part(random_bits(
                    x.shape if leaf is None else leaf.shape, self.ema_gen, x.device), leaf))
                for x, leaf in zip(e32, leaves)])


@dataclasses.dataclass
class ReHistoGANState:
    """The recoloring trainer's state (``histogan_tpu/train/state.py``
    ReHistoGANState): the encoder-decoder ED, the histogram projection H,
    the GAN head G and D, a DiffGrad for ED/H/G and one for D, and the
    step. No EMA and no path-length mean (the reference recoloringTrainer
    keeps neither)."""

    ED: nn.Module
    H: nn.Module
    G: nn.Module
    D: nn.Module
    opt_g: DiffGrad
    opt_d: DiffGrad
    step: int = 0

    def modules(self) -> Dict[str, nn.Module]:
        return {k: getattr(self, k) for k in ("ED", "H", "G", "D")}

    def g_params(self) -> List[torch.Tensor]:
        """The generator side's parameters, ED then H then G (params_g)."""
        return [p for k in ("ED", "H", "G") for p in getattr(self, k).parameters()]

    def reference_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights in the flat reference layout (ED, H, G, D); sharded
        ones gathered (every rank calls it)."""
        return fsdp.unshard_state_dict(self.modules())
