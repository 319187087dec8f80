"""Runtime setup: the device and the fp32 policy, in one place."""

from __future__ import annotations

import torch


def setup_runtime(device="cuda") -> torch.device:
    """Resolve ``device`` and turn TF32 off for matmuls and cuDNN
    convolutions (cuDNN otherwise runs fp32 convolutions in TF32), so the
    fp32 slice computes in fp32. Raises if CUDA was asked for and there is
    no GPU: there is no silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch.cuda.is_available() "
            f"is False; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
