"""DiffGrad (Dubey et al., 2019) as a ``torch.optim.Optimizer``, the
counterpart of ``histogan_tpu/optim/diffgrad.py``. The reference trains G
and D with torch_optimizer.DiffGrad(lr, betas=(0.5, 0.9))
(histoGAN/histoGAN.py:28, 670-671). Per element, at step t:

    m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
    dfc = sigmoid(|g_prev - g|)
    p += -lr sqrt(1 - b2^t) / (1 - b1^t) * dfc * m / (sqrt(v) + eps)

State is fp32. The update runs as ``torch._foreach_*`` passes over all
parameters that have a gradient (a handful of multi-tensor launches on a
GPU, not one per parameter and operation).
"""

from __future__ import annotations

import math

import torch


class DiffGrad(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 2e-4, betas=(0.5, 0.9), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DiffGrad.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads, m, v, prev = [], [], [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for k in ("exp_avg", "exp_avg_sq", "previous_grad"):
                        state[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["step"] += 1
                grads.append(p.grad)
                m.append(state["exp_avg"])
                v.append(state["exp_avg_sq"])
                prev.append(state["previous_grad"])
            t = self.state[params[0]]["step"]
            step_size = group["lr"] * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)

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
            torch._foreach_copy_(prev, grads)
        return None
