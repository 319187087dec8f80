"""HistoGAN configuration (copied from ``histogan_tpu/utils/config.py``,
which this package may not import). Booleans are real booleans; the
reference's ``.config.json`` contract is kept: the persisted
architecture keys are trusted over command-line flags on load."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass
class HistoGANConfig:
    # model
    image_size: int = 256
    network_capacity: int = 16
    latent_dim: int = 512
    style_depth: int = 8
    transparent: bool = False
    fq_layers: Tuple[int, ...] = ()
    fq_dict_size: int = 256
    attn_layers: Tuple[int, ...] = ()
    # histogram
    hist_bin: int = 64
    hist_insz: int = 150
    hist_method: str = "inverse-quadratic"
    hist_resizing: str = "sampling"
    hist_sigma: float = 0.02
    # training
    batch_size: int = 2
    gradient_accumulate_every: int = 8
    learning_rate: float = 2e-4
    mixed_prob: float = 0.9
    alpha: float = 2.0
    aug_prob: float = 0.0
    aug_types: Tuple[str, ...] = ("translation", "cutout")
    dataset_aug_prob: float = 0.0
    save_every: int = 1000
    trunc_psi: float = 0.75
    # the train step's compute dtype: "fp32", or "bf16" on fp32 masters
    # (train/steps.py compute_dtype); sampling is fp32 at either
    precision: str = "fp32"
    # recompute each model block's activations in the backward pass
    # (torch.utils.checkpoint at the JAX package's block boundaries,
    # models/remat.py): the same values and parameters, less activation
    # memory for more compute
    remat: bool = False

    @property
    def num_layers(self) -> int:
        from math import log2

        if not log2(self.image_size).is_integer():
            raise ValueError("image size must be a power of 2 (64, 128, 256, 512, 1024)")
        return int(log2(self.image_size) - 1)

    # ---- the reference's persisted .config.json contract
    # (histoGAN/histoGAN.py:806-825)
    PERSISTED_KEYS = (
        "image_size",
        "network_capacity",
        "transparent",
        "fq_layers",
        "fq_dict_size",
        "attn_layers",
    )

    def persisted(self) -> dict:
        d = {k: getattr(self, k) for k in self.PERSISTED_KEYS}
        d["fq_layers"] = list(d["fq_layers"])
        d["attn_layers"] = list(d["attn_layers"])
        return d

    def write_config(self, path: Path) -> None:
        Path(path).write_text(json.dumps(self.persisted()))

    def load_config(self, path: Path) -> "HistoGANConfig":
        p = Path(path)
        if not p.exists():
            return self
        cfg = json.loads(p.read_text())
        changes = {
            "image_size": cfg["image_size"],
            "network_capacity": cfg["network_capacity"],
            "transparent": cfg["transparent"],
            "fq_layers": tuple(cfg["fq_layers"]),
            "fq_dict_size": cfg["fq_dict_size"],
            "attn_layers": tuple(cfg.get("attn_layers", [])),
        }
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ReHistoGANConfig(HistoGANConfig):
    """The recoloring fields over HistoGANConfig (copied from
    ``histogan_tpu/utils/config.py``; reference rehistoGAN.py:721-733).
    Its ``precision`` sets the recoloring step's compute dtype and, unlike
    HistoGAN's sampling, the recolor's too (the JAX package's ``_recolor``
    runs in it)."""

    rec_loss: str = "laplacian"  # None -> 'L1', 'sobel', 'laplacian'
    variance_loss: bool = True
    internal_hist: bool = False
    skip_conn_to_GAN: bool = False
    fixed_gan_weights: bool = False
    initialize_gan: bool = False
    change_hyperparameters: bool = False
    change_hyperparameters_after: int = 100000
    alpha: float = 32.0
    beta: float = 1.5
    gamma: float = 4.0
    hist_sampling: bool = True
