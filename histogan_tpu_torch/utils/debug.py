"""Debug-mode NaN checking, the counterpart of ``histogan_tpu/utils/debug.py``.

Training keeps the reference's semantics: the losses are read on the host
and a NaN rolls the weights back to the last checkpoint
(histoGAN/histoGAN.py:143-145, 1003-1010). To find where a NaN is born,
wrap the step with :func:`checkify_step`: under a ``TorchDispatchMode``
every floating output of every aten op, the backward's included, is
checked, and the first NaN or Inf raises :class:`FloatCheckError` naming
the op. Each check reads a flag back from the device, so the step runs
several times slower: for debugging only, as in the JAX package.

The mode is thread-local. The autograd engine runs a CUDA backward on a
thread of its own and carries the dispatch modes over to it, so the mode
sees the backward's ops on a GPU as on the CPU (``chip_smoke.py``'s debug
phase counts them there).
"""

from __future__ import annotations

import collections
import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops whose output is uninitialised memory until something writes it
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided", "new_empty_strided",
                  "resize_")


class FloatCheckError(FloatingPointError):
    """A NaN or Inf out of ``op``."""

    def __init__(self, op: str, what: str):
        super().__init__(f"{what} in the output of {op}")
        self.op = op


class FloatChecks(TorchDispatchMode):
    """Raises at the first aten op with a NaN or Inf in a floating output;
    ``ops`` counts the ops it checked, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _UNINITIALISED:
            return out
        self.ops[name] += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                if not bool(torch.isfinite(t).all()):
                    raise FloatCheckError(str(func), "NaN" if bool(t.isnan().any()) else "Inf")
        return out


def checkify_step(step_fn: Callable) -> Callable:
    """``step_fn`` with float error checking: the same signature and
    result, and :class:`FloatCheckError` at the first NaN or Inf that any
    op inside it (forward or backward) produces. Noticeably slower; debug
    only. ``wrapper.checks`` holds the last call's :class:`FloatChecks`."""

    @functools.wraps(step_fn)
    def wrapper(*args, **kwargs):
        wrapper.checks = FloatChecks()
        with wrapper.checks:
            return step_fn(*args, **kwargs)

    return wrapper
