"""ReHistoGAN's RecoloringTrainer, the counterpart of
``histogan_tpu/train/rehisto_trainer.py`` (reference recoloringTrainer,
rehistoGAN.py:721-1226): init_GAN / load_histogan_head / set_data_src /
train / evaluate / save / load / clear / print_log, with the reference's
GP schedule, hyperparameter switch, NaN rollback, save and evaluation
schedule.

As in ``train/trainer.py`` the trainer runs on an explicit ``device``:
weights are drawn on the CPU from a ``torch.Generator`` seeded with
``seed`` and moved there; the step's noise and the recolor noise come
from a generator on the device, seeded the same. ``precision='bf16'``
trains and recolors in bf16 on fp32 masters (``train/rehisto_steps.py``),
as the JAX package's trainer does: its ``recolor`` and ``evaluate`` run
in the step's compute dtype, and ``evaluate`` widens the images to fp32
before it writes or post-processes them. ``evaluate`` upscales to the
input photo's resolution (``post/pyramid.py``, ``post/bgu.py``), resizes
down to it, and recolors the original by MKL (``post/mkl.py``), on the
host, as in the JAX package.

The discriminator's attention (``attn_layers``) and vector-quantize
(``fq_layers``) layers train as in HistoGAN (``train/rehisto_steps.py``);
under ``precision='bf16'`` a VQ layer with a D block after it is refused
with a ValueError, as in ``train/trainer.py``.

The data and the sync, as in ``train/trainer.py``: ``device_dataset``
"auto" holds the cache and the pool on the device (``DeviceDataSource``,
with each image's own histogram for ``sampling=False`` and images for the
G phase) when it can, else the streaming loader feeds the step;
``sync_every`` N > 1 reads the metrics, logs and checks for NaN every N
steps and on save steps only.

Not ported yet, and refused with NotImplementedError when asked for:
``remat``, and more than one device or FSDP.
"""

from __future__ import annotations

import math
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from histogan_tpu_torch.data import device_source
from histogan_tpu_torch.models.discriminator import Discriminator, refuse_bf16_vq
from histogan_tpu_torch.models.rehisto import RecoloringEncoderDecoder, RecoloringGAN
from histogan_tpu_torch.models.vectorizers import HistVectorizer
from histogan_tpu_torch.optim.diffgrad import DiffGrad
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.train.checkpoint import CheckpointStore
from histogan_tpu_torch.train.rehisto_steps import RecolorModels, draw_step, recolor_forward, \
    train_step
from histogan_tpu_torch.train.state import ReHistoGANState
from histogan_tpu_torch.train.steps import cast_models, compute_dtype
from histogan_tpu_torch.train.trainer import DTYPES, NanException, _check_choice, \
    _refuse_deferred
from histogan_tpu_torch.utils.config import ReHistoGANConfig
from histogan_tpu_torch.utils.image_io import save_image_grid
from histogan_tpu_torch.utils.inits import reset_parameters_
from histogan_tpu_torch.utils.logging import MetricsLogger
from histogan_tpu_torch.utils.platform import setup_runtime

LIVE = convert.REHISTO_PREFIXES  # ED, H, G, D


class RecoloringTrainer:
    def __init__(self, name="default", results_dir="results", models_dir="models",
                 image_size=256, network_capacity=16, transparent=False,
                 batch_size=4, gradient_accumulate_every=1, lr=2e-4,
                 save_every=1000, fq_layers=(), fq_dict_size=256, attn_layers=(),
                 hist_method="inverse-quadratic", hist_resizing="sampling",
                 hist_sigma=0.02, hist_bin=64, hist_insz=150,
                 fixed_gan_weights=False, skip_conn_to_GAN=False,
                 rec_loss="laplacian", initialize_gan=False, variance_loss=True,
                 internal_hist=False, change_hyperparameters=False,
                 change_hyperparameters_after=100000, latent_dim=512,
                 style_depth=8, num_devices=None, seed=42,
                 precision="fp32", sync_every=1, device_dataset="auto",
                 param_sharding="replicated", opt_state_dtype=None,
                 remat=False, num_workers=None, device="cuda"):
        _check_choice("precision", precision, ("fp32", "bf16"))
        _check_choice("param_sharding", param_sharding, ("replicated", "fsdp"))
        _check_choice("opt_state_dtype", opt_state_dtype, (None, "fp32", "bf16"))
        _refuse_deferred(
            remat=bool(remat),
            num_devices=(num_devices or 1) > 1,
            param_sharding=param_sharding == "fsdp",
        )
        refuse_bf16_vq(precision, image_size, fq_layers)
        self.cfg = ReHistoGANConfig(
            image_size=image_size, network_capacity=network_capacity,
            latent_dim=latent_dim, style_depth=style_depth, transparent=transparent,
            fq_layers=tuple(fq_layers), fq_dict_size=fq_dict_size,
            attn_layers=tuple(attn_layers),
            hist_bin=hist_bin, hist_insz=hist_insz, hist_method=hist_method,
            hist_resizing=hist_resizing, hist_sigma=hist_sigma,
            batch_size=batch_size, gradient_accumulate_every=gradient_accumulate_every,
            learning_rate=lr, save_every=save_every,
            rec_loss=rec_loss, variance_loss=variance_loss,
            internal_hist=internal_hist, skip_conn_to_GAN=skip_conn_to_GAN,
            fixed_gan_weights=fixed_gan_weights, initialize_gan=initialize_gan,
            change_hyperparameters=change_hyperparameters,
            change_hyperparameters_after=change_hyperparameters_after, precision=precision,
        )
        self.name = name
        self.results_dir = Path(results_dir)
        (self.results_dir / name).mkdir(parents=True, exist_ok=True)
        self.store = CheckpointStore(models_dir, name)
        self.device = setup_runtime(device)
        self.seed = int(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.opt_state_dtype = DTYPES[opt_state_dtype]
        self.num_workers = int(num_workers) if num_workers else None
        self.sync_every = max(1, int(sync_every))
        self.device_dataset = device_source.normalise_flag(device_dataset)
        self.steps = 0
        self.state: Optional[ReHistoGANState] = None
        self.dataset = self.pool = self.loader = None
        self._staged = None  # the streaming path's next batch, on its way
        self._eval_rng = np.random.default_rng(99)

        # the reference's print_log surface
        self.d_loss = self.g_loss = self.h_loss = self.r_loss = 0.0
        self.var_loss = self.last_gp_loss = self.last_cr_loss = self.q_loss = 0.0
        self.metrics_logger = MetricsLogger(
            results_dir, name, every=50, imgs_per_step=batch_size * gradient_accumulate_every)

    # ------------------------------------------------------------ setup
    def init_GAN(self) -> None:
        """ED, H, G and D, and a DiffGrad(lr, betas=(0.5, 0.9)) for ED/H/G
        and one for D, their state in ``opt_state_dtype``."""
        cfg = self.cfg
        init_gen = torch.Generator().manual_seed(self.seed)
        modules = [
            RecoloringEncoderDecoder(cfg.image_size, cfg.network_capacity, cfg.hist_bin,
                                     cfg.latent_dim, cfg.style_depth, cfg.skip_conn_to_GAN,
                                     cfg.internal_hist),
            HistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
            RecoloringGAN(cfg.image_size, cfg.latent_dim, cfg.network_capacity,
                          cfg.transparent),
            Discriminator(cfg.image_size, cfg.network_capacity, cfg.fq_layers,
                          cfg.fq_dict_size, cfg.attn_layers, cfg.transparent),
        ]
        live = {k: reset_parameters_(m, init_gen).to(self.device)
                for k, m in zip(LIVE, modules)}
        opt = dict(lr=cfg.learning_rate, betas=(0.5, 0.9), state_dtype=self.opt_state_dtype)
        self.state = ReHistoGANState(
            **live,
            opt_g=DiffGrad([p for k in ("ED", "H", "G") for p in live[k].parameters()], **opt),
            opt_d=DiffGrad(live["D"].parameters(), **opt),
        )

    def _module(self, prefix: str) -> Optional[nn.Module]:
        return None if self.state is None else getattr(self.state, prefix)

    ED = property(lambda self: self._module("ED"))
    H = property(lambda self: self._module("H"))
    G = property(lambda self: self._module("G"))
    D = property(lambda self: self._module("D"))

    def models(self) -> Dict[str, nn.Module]:
        """The modules by their reference state-dict prefix."""
        return self.state.modules()

    def reference_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights in the flat reference layout (ED, H, G, D)."""
        return self.state.reference_state_dict()

    def load_state_dict(self, sd) -> List[str]:
        """Load a flat reference-layout state dict, strictly on each of ED,
        H, G and D. A dict from another variant raises (its keys say which,
        ``convert.detect_rehistogan_variant``). Returns the keys under no
        prefix of the model."""
        for flag, want in convert.detect_rehistogan_variant(sd).items():
            have = getattr(self.cfg, flag)
            if want != have:
                raise ValueError(f"checkpoint was trained with {flag}={want}, but the "
                                 f"trainer is configured with {flag}={have}")
        parts, others = convert.split_by_prefix(sd, LIVE)
        for prefix, module in self.models().items():
            module.load_state_dict(parts[prefix], strict=True)
        return others

    def load_pt(self, path) -> List[str]:
        """Install a reference-layout recoloring ``.pt`` (``--load_pt``)."""
        return self.load_state_dict(convert.load_reference_pt(path))

    def export_pt(self, path) -> int:
        """Write the weights as a reference-layout ``.pt`` (``--export_pt``);
        returns the number of tensors."""
        sd = {k: v.detach().cpu().contiguous() for k, v in self.reference_state_dict().items()}
        torch.save(sd, path)
        return len(sd)

    @torch.no_grad()
    def load_histogan_head(self, histogan_trainer) -> None:
        """Transplant a HistoGAN Trainer's EMA head: GE.blocks[n-2] and
        [n-1] become G.blocks.0 and .1, HE becomes H
        (rehistoGAN.py:355-357); a bf16 EMA is widened."""
        if self.state is None:
            raise RuntimeError("init_GAN first")
        donor = histogan_trainer.state
        n = histogan_trainer.cfg.num_layers
        for dst, src in ((self.G.blocks[0], donor.GE.blocks[n - 2]),
                         (self.G.blocks[1], donor.GE.blocks[n - 1]), (self.H, donor.HE)):
            dst.load_state_dict(src.state_dict(), strict=True)

    # ------------------------------------------------------------- data
    def set_data_src(self, folder: str, sampling: bool = True) -> None:
        """Images and histogram pool from ``folder``; with ``sampling`` the
        targets are pool interpolations, else each image's own histogram.
        The batches come from the ``DeviceDataSource`` or the streaming
        loader as ``device_dataset`` resolves (both seeded 11, as in the
        JAX package)."""
        from histogan_tpu_torch.data.dataset import HistogramPool, ImageFolderDataset

        cfg = self.cfg
        self.dataset = ImageFolderDataset(folder, cfg.image_size, cfg.transparent,
                                          cache_dir=str(self.store.dir))
        self.pool = HistogramPool(self.dataset.paths, cfg.hist_insz, cfg.hist_bin,
                                  cfg.hist_method, cfg.hist_resizing, cfg.hist_sigma,
                                  cfg.transparent, cache_dir=str(self.store.dir),
                                  device=self.device)
        self.close()
        self.loader = device_source.make_source(
            self.device_dataset, self.dataset, self.pool, cfg.batch_size,
            cfg.gradient_accumulate_every, seed=11, num_workers=self.num_workers,
            self_hist=not sampling, include_g_images=True, device=self.device)
        self._eval_rng = np.random.default_rng(99)

    def close(self) -> None:
        """Stop the loader's prefetch thread."""
        self._staged = None
        if self.loader is not None:
            self.loader.close()
            self.loader = None

    # ------------------------------------------------------------ train
    def train(self, alpha: float = 32.0, beta: float = 1.5,
              gamma: float = 4.0) -> Optional[Dict[str, float]]:
        """One training step on the next batch. Returns its metrics as
        floats on a step that syncs (every step at ``sync_every`` 1; else
        every ``sync_every``-th step and every save step), else None."""
        if self.loader is None:
            raise RuntimeError("You must first initialize the data source with "
                               "`.set_data_src(<folder of images>)`")
        if self.state is None:
            self.init_GAN()
        cfg, steps = self.cfg, self.steps
        if cfg.change_hyperparameters and steps >= cfg.change_hyperparameters_after:
            alpha, gamma, beta = 8.0, 2.0, 1.0  # rehistoGAN.py:900-905
        apply_gp = steps % 4 == 0

        batch = device_source.take_batch(self.loader, self._staged, self.device)
        draws = draw_step(self.gen, cfg, self.device)
        metrics = train_step(self.state, batch, draws, cfg, apply_gp,
                             float(alpha), float(beta), float(gamma))
        self._staged = device_source.stage_next_batch(self.loader, self.device)

        checkpoint_num = steps // cfg.save_every
        m = None
        if self.sync_every == 1 or steps % self.sync_every == 0 or steps % cfg.save_every == 0:
            names = sorted(metrics)
            m = dict(zip(names, torch.stack([metrics[k] for k in names]).tolist()))  # one sync
            self.metrics_logger.log(steps, m)
            self.d_loss, self.g_loss, self.h_loss = m["d_loss"], m["g_loss"], m["h_loss"]
            self.r_loss, self.var_loss, self.q_loss = m["r_loss"], m["var_loss"], m["q_loss"]
            if apply_gp:
                self.last_gp_loss = m["gp_loss"]

            if math.isnan(self.g_loss) or math.isnan(self.d_loss):
                print(f"NaN detected for generator or discriminator. "
                      f"Loading from checkpoint #{checkpoint_num}")
                self.load(checkpoint_num)
                raise NanException

        if steps % cfg.save_every == 0:
            self.save(checkpoint_num)
        if steps % 1000 == 0 or (steps % 100 == 0 and steps < 2500):
            self.evaluate(steps // 1000, triple_hist=not cfg.fixed_gan_weights)
        self.steps += 1
        return m

    # ------------------------------------------------------------- eval
    @torch.inference_mode()
    def recolor(self, image_batch: torch.Tensor, hist_batch: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Recolor (N, S, S, 3) NHWC images toward (N, 3, h, h) histograms;
        returns NHWC images clipped to [0, 1], in the compute dtype (bf16
        under ``precision='bf16'``, as the JAX package's ``_recolor``).
        ``noise`` (N, S, S, 1) defaults to a draw from the trainer's
        generator."""
        image_batch = torch.as_tensor(image_batch, dtype=torch.float32, device=self.device)
        hist_batch = torch.as_tensor(hist_batch, dtype=torch.float32, device=self.device)
        if noise is None:
            noise = torch.rand((*image_batch.shape[:3], 1), generator=self.gen,
                               device=self.device)
        models = cast_models(RecolorModels(self.ED, self.H, self.G, None),
                             compute_dtype(self.cfg))
        out = recolor_forward(models, image_batch.permute(0, 3, 1, 2), hist_batch,
                              torch.as_tensor(noise, device=self.device), self.cfg)
        return torch.clamp(out.permute(0, 2, 3, 1), 0.0, 1.0)

    def _eval_batches(self, triple_hist: bool, double_hist: bool):
        if self.pool is None:
            raise RuntimeError("evaluate without image_batch and hist_batch draws from "
                               "the data: call set_data_src first")
        rng = self._eval_rng
        idx = rng.integers(0, len(self.dataset), size=4)
        images = np.stack([self.dataset.get_image_u8(int(i), rng) for i in idx]) / 255.0
        hists = [self.pool.sample_interpolated(rng, 4)]
        copies = 3 if triple_hist else 2 if double_hist else 1
        hists += [self.pool.sample_interpolated(rng, 4) for _ in range(copies - 1)]
        return np.concatenate([images] * copies).astype(np.float32), np.concatenate(hists)

    def evaluate(self, num=0, image_batch=None, hist_batch=None, triple_hist: bool = False,
                 double_hist: bool = False, resizing=None, resizing_method=None,
                 swapping_levels: int = 1, pyramid_levels: int = 5, level_blending: bool = False,
                 original_size=None, input_image_name=None, original_image=None,
                 post_recoloring: bool = False, save_input: bool = True) -> np.ndarray:
        """Recolor and save ``results/<name>/<num>-generated.jpg`` (and
        ``<num>-input.jpg``). Without batches, 4 dataset images toward 4
        pool interpolations, each image repeated toward 3 (``triple_hist``)
        or 2 (``double_hist``) sets of targets, a row per image.

        Then, as ``histogan_tpu/train/rehisto_trainer.py:386-417`` does, on
        the host: ``resizing='upscaling'`` replaces the file with the first
        image brought to the resolution of ``input_image_name`` by
        ``resizing_method`` 'BGU' or 'pyramid' (the padded size, a multiple
        of 2**``pyramid_levels``); 'downscaling' resizes the written file to
        ``original_size`` (W, H) with PIL; ``post_recoloring`` overwrites
        the file with ``original_image`` (the full-resolution photo in
        [0, 1]) recolored by MKL toward the first image. Returns the
        (N, S, S, 3) recolored images, fp32."""
        cfg = self.cfg
        if image_batch is None or hist_batch is None:
            image_batch, hist_batch = self._eval_batches(triple_hist, double_hist)
            img_bt_sz = 4
        else:
            img_bt_sz = len(image_batch)
        # widened to fp32 before the clip's output is written or post-processed
        generated = self.recolor(image_batch, hist_batch).float().cpu().numpy()
        grouped = double_hist or triple_hist
        num_rows = img_bt_sz if grouped else int(np.ceil(np.sqrt(len(hist_batch))))
        ext = "jpg" if not cfg.transparent else "png"
        out_dir = self.results_dir / self.name
        output_name = out_dir / f"{num}-generated.{ext}"
        save_image_grid(generated, output_name, nrow=num_rows)

        if resizing == "upscaling":
            print("Upsampling")
            from histogan_tpu_torch.data.dataset import load_rgb

            reference_img = load_rgb(input_image_name)
            if resizing_method == "BGU":
                from histogan_tpu_torch.post.bgu import bgu_upsample

                out = bgu_upsample(reference_img, generated[0])
                save_image_grid(out[None], output_name, nrow=1)
            elif resizing_method == "pyramid":
                from histogan_tpu_torch.post.pyramid import pyramid_upsampling

                out = pyramid_upsampling(generated[0], reference_img, levels=pyramid_levels,
                                         swapping_levels=swapping_levels,
                                         blending=level_blending)
                save_image_grid(np.clip(out, 0, 1)[None], output_name, nrow=1)
        elif resizing == "downscaling" and original_size is not None:
            print("Resizing")
            from PIL import Image

            img = Image.open(output_name)
            img.resize((original_size[0], original_size[1])).save(output_name)

        if post_recoloring:
            print("Post-recoloring")
            from histogan_tpu_torch.post.mkl import color_transfer_MKL

            # the reference's quirk: this overwrites any upsampled file
            save_image_grid(color_transfer_MKL(original_image, generated[0])[None], output_name,
                            nrow=1)

        if save_input:
            save_image_grid(np.asarray(image_batch)[:img_bt_sz], out_dir / f"{num}-input.{ext}",
                            nrow=img_bt_sz if grouped else num_rows)
        return generated

    # ------------------------------------------------------ persistence
    def save(self, num: int) -> None:
        s = self.state
        self.store.save({
            "GAN": {k: v.detach().cpu() for k, v in s.reference_state_dict().items()},
            "opt_g": s.opt_g.state_dict(), "opt_d": s.opt_d.state_dict(), "step": s.step,
        }, num)
        self.cfg.write_config(self.store.config_path)

    def load(self, num: int = -1) -> int:
        """Trust the persisted architecture (``.config.json``), build the
        models and restore checkpoint ``num`` (the latest for -1). Returns
        -1 when there is none, else 0."""
        self.cfg = self.cfg.load_config(self.store.config_path)
        refuse_bf16_vq(self.cfg.precision, self.cfg.image_size, self.cfg.fq_layers)
        self.init_GAN()
        name = num
        if num == -1:
            latest = self.store.latest()
            if latest is None:
                return -1
            name = latest
            print(f"continuing from previous epoch - {name}")
        self.steps = name * self.cfg.save_every
        payload = self.store.restore(name)
        self.load_state_dict(payload["GAN"])
        self.state.opt_g.load_state_dict(payload["opt_g"])
        self.state.opt_d.load_state_dict(payload["opt_d"])
        self.state.step = int(payload["step"])
        return 0

    def clear(self) -> None:
        self.store.clear()
        shutil.rmtree(self.results_dir / self.name, ignore_errors=True)
        (self.results_dir / self.name).mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------- logging
    def print_log(self) -> None:
        print(
            f"\nG: {self.g_loss:.2f} | H: {self.h_loss:.2f} | "
            f"D: {self.d_loss:.2f} | R: {self.r_loss:.2f} "
            f"| V: {self.var_loss:.2f} | GP: {self.last_gp_loss:.2f}"
            f" | CR: {self.last_cr_loss:.2f} | Q: {self.q_loss:.2f}"
        )
