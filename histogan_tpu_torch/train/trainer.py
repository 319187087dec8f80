"""HistoGAN Trainer, sampling subset: the counterpart of
``histogan_tpu/train/trainer.py``'s init_GAN / load / evaluate /
generate_truncated (histoGAN/histoGAN.py:718-1139). Training (D, losses,
optimizer, EMA updates, checkpoints, data) is ported later.

The trainer runs on an explicit ``device``. Weights are drawn on the CPU
from a ``torch.Generator`` seeded with ``seed`` (so a seed gives the same
weights on every device) and moved to the device; the sampler's latents
and noise come from a second generator on the device, seeded the same.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from histogan_tpu_torch.models.generator import Generator
from histogan_tpu_torch.models.vectorizers import HistVectorizer, StyleVectorizer
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.utils.config import HistoGANConfig
from histogan_tpu_torch.utils.image_io import save_image_grid
from histogan_tpu_torch.utils.inits import reset_parameters_
from histogan_tpu_torch.utils.platform import setup_runtime


class Trainer:
    def __init__(self, name="default", results_dir="results", models_dir="models",
                 image_size=128, network_capacity=16, transparent=False,
                 batch_size=4, trunc_psi=0.6,
                 hist_method="inverse-quadratic", hist_resizing="sampling",
                 hist_sigma=0.02, hist_bin=64, hist_insz=150,
                 latent_dim=512, style_depth=8, seed=42, precision="fp32",
                 device="cuda"):
        if precision != "fp32":
            raise NotImplementedError(
                f"precision {precision!r}: this port samples in fp32 only so far")
        self.cfg = HistoGANConfig(
            image_size=image_size, network_capacity=network_capacity,
            latent_dim=latent_dim, style_depth=style_depth, transparent=transparent,
            hist_bin=hist_bin, hist_insz=hist_insz, hist_method=hist_method,
            hist_resizing=hist_resizing, hist_sigma=hist_sigma,
            batch_size=batch_size, trunc_psi=trunc_psi, precision=precision,
        )
        self.name = name
        self.results_dir = Path(results_dir)
        self.config_path = Path(models_dir) / name / ".config.json"
        self.device = setup_runtime(device)
        self.seed = int(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.av: Optional[torch.Tensor] = None
        self.S = self.H = self.G = None
        self.SE = self.HE = self.GE = None

    # ------------------------------------------------------------ setup
    def init_GAN(self) -> None:
        """S/H/G and their EMA copies SE/HE/GE (reset_parameter_averaging
        starts the EMA as a copy). The discriminator comes with training."""
        cfg = self.cfg
        init_gen = torch.Generator().manual_seed(self.seed)
        self.S = reset_parameters_(StyleVectorizer(cfg.latent_dim, cfg.style_depth), init_gen)
        self.H = reset_parameters_(
            HistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth), init_gen)
        self.G = reset_parameters_(
            Generator(cfg.image_size, cfg.latent_dim, cfg.network_capacity, cfg.transparent),
            init_gen)
        self.SE, self.HE, self.GE = (copy.deepcopy(m) for m in (self.S, self.H, self.G))
        for m in self.models().values():
            m.to(self.device).eval().requires_grad_(False)
        self.av = None

    def models(self) -> Dict[str, nn.Module]:
        """The modules by their reference state-dict prefix."""
        return {"S": self.S, "H": self.H, "G": self.G,
                "SE": self.SE, "HE": self.HE, "GE": self.GE}

    def reference_state_dict(self) -> Dict[str, torch.Tensor]:
        """The S/H/G/SE/HE/GE weights in the flat reference layout."""
        return {f"{prefix}.{k}": v for prefix, m in self.models().items()
                for k, v in m.state_dict().items()}

    def load_state_dict(self, sd) -> List[str]:
        """Load a flat reference-layout state dict, strictly on each
        sampler prefix. Returns the keys not loaded (``D.*`` until the
        discriminator is ported)."""
        parts, others = convert.split_by_prefix(sd)
        for prefix, module in self.models().items():
            module.load_state_dict(parts[prefix], strict=True)
        self.av = None
        return others

    def load_pt(self, path) -> List[str]:
        """Install a reference-layout ``.pt`` (``--load_pt``)."""
        return self.load_state_dict(convert.load_reference_pt(path))

    def load_config(self) -> None:
        """Trust the persisted architecture (models/<name>/.config.json)
        over the flags, as the reference does, then build the models."""
        self.cfg = self.cfg.load_config(self.config_path)
        self.init_GAN()

    # ------------------------------------------------------------- eval
    @torch.inference_mode()
    def evaluate(self, num=0, hist_batch=None, num_image_tiles: int = 4,
                 latents=None, n=None, save_noise_latent: bool = False,
                 load_noise_file=None, load_latent_file=None) -> np.ndarray:
        """Sample with the EMA weights; returns (N, S, S, 3|4) in [0, 1]
        and, unless ``num`` is None, saves the grid as
        ``results/<name>/<num>-ema.jpg``."""
        cfg = self.cfg
        if hist_batch is None:
            raise ValueError("hist_batch is required: the training histogram "
                             "pool is not ported yet")
        num_rows = num_image_tiles
        ext = "jpg" if not cfg.transparent else "png"
        dev = self.device

        if latents is None and load_latent_file is not None:
            latents = np.load(load_latent_file)
        if n is None:
            if load_noise_file is not None:
                n = np.load(load_noise_file)
            else:
                rows = num_rows ** 2 if latents is None else len(latents)
                n = torch.rand((rows, cfg.image_size, cfg.image_size, 1),
                               generator=self.gen, device=dev)
        n = torch.as_tensor(n, dtype=torch.float32, device=dev)
        if latents is None:
            latents = torch.randn((len(n), cfg.latent_dim), generator=self.gen, device=dev)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        hist_batch = torch.as_tensor(hist_batch, dtype=torch.float32, device=dev)

        images = self.generate_truncated(
            self._ema_params(), hist_batch, latents, n, trunc_psi=cfg.trunc_psi
        ).cpu().numpy()
        if num is not None:
            save_image_grid(images, self.results_dir / self.name / f"{num}-ema.{ext}",
                            nrow=num_rows)
        if save_noise_latent:
            tmp = Path("temp") / self.name
            tmp.mkdir(parents=True, exist_ok=True)
            np.save(tmp / f"{num}-noise.npy", n.cpu().numpy())
            np.save(tmp / f"{num}-latents.npy", latents.cpu().numpy())
        return images

    def _ema_params(self) -> Dict[str, nn.Module]:
        return {"S": self.SE, "H": self.HE, "G": self.GE}

    @torch.inference_mode()
    def compute_av(self, S: nn.Module) -> torch.Tensor:
        """Mean w over 2000 z draws (truncation center,
        histoGAN/histoGAN.py:1068-1072)."""
        z = torch.randn((2000, self.cfg.latent_dim), generator=self.gen, device=self.device)
        return S(z).mean(dim=0, keepdim=True)

    @torch.inference_mode()
    def generate_truncated(self, models, hist_batch: torch.Tensor, style: torch.Tensor,
                           noi: torch.Tensor, trunc_psi: float = 0.75) -> torch.Tensor:
        """Sampling with truncation (histoGAN/histoGAN.py:1064-1091).

        ``models``: {'S', 'H', 'G'} modules (the EMA ones in evaluate);
        ``style``: (N, latent) z batch; ``noi``: (N, S, S, 1) noise;
        ``hist_batch``: (k, 3, h, h), tile-doubled here to N rows.
        ``av`` is resolved once and kept; G runs in chunks of
        ``cfg.batch_size``. Returns NHWC images clipped to [0, 1].
        """
        cfg = self.cfg
        if self.av is None:
            self.av = self.compute_av(models["S"])
        av = torch.as_tensor(self.av, dtype=torch.float32, device=self.device)
        nl = cfg.num_layers
        n = style.shape[0]

        w = models["S"](style)
        w = trunc_psi * (w - av) + av
        w_styles = w[:, None, :].expand(n, nl - 2, w.shape[-1])
        h_w = models["H"](hist_batch)
        h_rows = torch.stack([h_w, h_w], dim=1)
        # tile doubling to match the latent batch (histoGAN/histoGAN.py:1085-1086)
        for _ in range(int(np.log2(np.sqrt(n)))):
            h_rows = torch.cat([h_rows, h_rows], dim=0)
        h_rows = h_rows[:n]

        # chunked generation (evaluate_in_chunks, histoGAN/histoGAN.py:206-212)
        bs = cfg.batch_size
        outs = [models["G"](w_styles[s : s + bs], h_rows[s : s + bs], noi[s : s + bs])
                for s in range(0, n, bs)]
        images = torch.cat(outs, dim=0).permute(0, 2, 3, 1)
        return torch.clamp(images, 0.0, 1.0)
