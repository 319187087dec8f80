"""Checkpoints with the reference's on-disk contract, the counterpart of
``histogan_tpu/train/checkpoint.py``.

The reference saves the whole GAN's state dict to
``models/<name>/model_<k>.pt`` every ``save_every`` steps, resumes from
the largest k, and keeps the architecture in ``.config.json``, which it
trusts over the command-line flags on load (histoGAN/histoGAN.py:806-825,
1107-1139). Here ``model_<k>.pt`` holds

    {"GAN": the flat reference-layout state dict (S, H, G, D, SE, HE, GE),
     "opt_g", "opt_d": the DiffGrad state dicts, "pl_mean": float,
     "step": int}

so a resume continues the same run (the reference loses the optimizer
state). It is written to a temporary file and renamed into place. In a
data-parallel run the trainers save on rank 0 and every rank waits at a
barrier until the file is in place; every rank loads it. Under
``param_sharding='fsdp'`` every rank gathers the full state first and the
file is the full, unsharded state (as the JAX package's
``train/checkpoint.py:40-58``): it loads under either layout and at any
world size, each rank keeping its slices.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch


class CheckpointStore:
    def __init__(self, models_dir, name: str):
        self.dir = Path(models_dir) / name
        self.dir.mkdir(parents=True, exist_ok=True)

    @property
    def config_path(self) -> Path:
        return self.dir / ".config.json"

    def path(self, num: int) -> Path:
        return self.dir / f"model_{num}.pt"

    def saved_nums(self) -> List[int]:
        nums = []
        for p in self.dir.glob("model_*.pt"):
            m = re.fullmatch(r"model_(\d+)\.pt", p.name)
            if m:
                nums.append(int(m.group(1)))
        return sorted(nums)

    def latest(self) -> Optional[int]:
        nums = self.saved_nums()
        return nums[-1] if nums else None

    def save(self, payload: Dict[str, Any], num: int) -> Path:
        path = self.path(num)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # atomic: a reader sees the old file or the new one
        return path

    def restore(self, num: int) -> Dict[str, Any]:
        return torch.load(self.path(num), map_location="cpu", weights_only=True)

    def clear(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True, exist_ok=True)
