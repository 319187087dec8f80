"""Block-boundary rematerialization, the counterpart of the JAX package's
``nn.remat`` blocks (``histogan_tpu/models/generator.py:92-99``,
``discriminator.py:52``, ``rehisto.py:41-55, 132-159``).

``call_block(block, remat, *args)`` runs ``block(*args)``, or with
``remat`` (and grad mode on) under non-reentrant
``torch.utils.checkpoint``: the block's activations are dropped after the
forward and recomputed in the backward. The values, the gradients (the
gradient penalty's double backward included) and the parameter names are
those of the plain call.

The recompute runs the block on the parameters its forward saw, not on
whatever the module holds when the backward runs. Under bf16 the train
step runs the models through ``torch.func.functional_call`` on bf16
copies of the fp32 masters (``train/steps.py::cast_module``), and the swap
is undone before the backward; a recompute that read ``self.weight``
would see the fp32 masters. So the checkpointed function is a
``functional_call`` on the block's parameters as captured at its forward:
under sharded state (``parallel/fsdp.py``) those are the phase's gathered
full tensors, which the recompute reads again without gathering.
A block that cannot be checkpointed raises; there is no fallback to the
plain call.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def call_block(block: nn.Module, remat: bool, *args):
    """``block(*args)``, checkpointed when ``remat`` and grad mode is on."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    params = dict(block.named_parameters())  # the cast copies inside functional_call

    def run(*inputs):
        return torch.func.functional_call(block, params, inputs)

    return checkpoint(run, *args, use_reentrant=False)
