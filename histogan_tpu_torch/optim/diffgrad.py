"""DiffGrad (Dubey et al., 2019) as a ``torch.optim.Optimizer``, the
counterpart of ``histogan_tpu/optim/diffgrad.py``. The reference trains G
and D with torch_optimizer.DiffGrad(lr, betas=(0.5, 0.9))
(histoGAN/histoGAN.py:28, 670-671). Per element, at step t:

    m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
    dfc = sigmoid(|g_prev - g|)
    p += -lr sqrt(1 - b2^t) / (1 - b1^t) * dfc * m / (sqrt(v) + eps)

The state (m, v, g_prev) is fp32, or with ``state_dtype=torch.bfloat16``
stored in bf16 (``--opt_state_dtype bf16``): it is widened to fp32 for the
update, all of whose math is fp32, and rounded to nearest on the store, as
the JAX package's ``astype`` does. Parameters stay fp32. The update runs
as ``torch._foreach_*`` passes over all parameters that have a gradient (a
handful of multi-tensor launches on a GPU, not one per parameter and
operation).
"""

from __future__ import annotations

import math

import torch

STATE_KEYS = ("exp_avg", "exp_avg_sq", "previous_grad")


class DiffGrad(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 2e-4, betas=(0.5, 0.9), eps: float = 1e-8,
                 state_dtype=None):
        if state_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"state_dtype must be None, float32 or bfloat16, got {state_dtype}")
        self.state_dtype = None if state_dtype == torch.float32 else state_dtype
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    def load_state_dict(self, state_dict) -> None:
        """torch's load casts every floating state tensor to its
        parameter's dtype; a bf16 state is cast back to bf16, so a bf16
        resume stays bf16 and an fp32 checkpoint is rounded to nearest."""
        super().load_state_dict(state_dict)
        if self.state_dtype is not None:
            for state in self.state.values():
                for k in STATE_KEYS:
                    if k in state:
                        state[k] = state[k].to(self.state_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DiffGrad.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads, stored = [], {k: [] for k in STATE_KEYS}
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for k in STATE_KEYS:
                        state[k] = torch.zeros_like(p, dtype=self.state_dtype,
                                                    memory_format=torch.preserve_format)
                state["step"] += 1
                grads.append(p.grad)
                for k in STATE_KEYS:
                    stored[k].append(state[k])
            t = self.state[params[0]]["step"]
            step_size = group["lr"] * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            # fp32 views of the state: the tensors themselves when fp32
            m, v, prev = ([x.float() for x in stored[k]] for k in STATE_KEYS)

            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            dfc = torch._foreach_sub(prev, grads)
            torch._foreach_abs_(dfc)
            torch._foreach_sigmoid_(dfc)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_mul_(dfc, -step_size)
            torch._foreach_mul_(dfc, m)
            torch._foreach_div_(dfc, denom)
            torch._foreach_add_(params, dfc)
            if self.state_dtype is not None:  # round to nearest on the store
                torch._foreach_copy_(stored["exp_avg"], m)
                torch._foreach_copy_(stored["exp_avg_sq"], v)
            torch._foreach_copy_(stored["previous_grad"], grads)
        return None
