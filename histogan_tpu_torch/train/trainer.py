"""HistoGAN Trainer, the counterpart of ``histogan_tpu/train/trainer.py``
(reference Trainer, histoGAN/histoGAN.py:718-1139): init_GAN /
set_data_src / train / evaluate / generate_truncated / save / load /
clear / print_log, with the same periodic save, periodic evaluation,
GP / path-length / EMA schedules and NaN rollback.

The trainer runs on an explicit ``device``. Weights are drawn on the CPU
from a ``torch.Generator`` seeded with ``seed`` (so a seed gives the same
weights on every device) and moved to the device; the training step's
draws and the sampler's latents and noise come from a second generator
on the device, seeded the same; the bf16 EMA's rounding bits from a third.

The bf16 policy, as the JAX package has it: ``precision='bf16'`` trains
in bf16 on fp32 master weights (``train/steps.py``);
``opt_state_dtype='bf16'`` stores DiffGrad's state in bf16;
``ema_dtype='bf16'`` stores SE/HE/GE in bf16, updated by stochastic
rounding. Sampling (``evaluate``, ``generate_truncated``) is fp32 at any
setting: a bf16 EMA is widened first, as in the JAX package.

The discriminator's options: DiffAugment (``aug_prob`` > 0, ``aug_types``;
the AugWrapper's gates and flips drawn on a host generator of their own,
seeded seed + COIN_SEED_OFFSET, so that they cost no sync), linear
attention (``attn_layers``) and the vector-quantize codebook
(``fq_layers``, ``fq_dict_size``), whose buffers ride in D's state dict.
Under ``precision='bf16'`` a VQ layer with a D block after it is refused
with a ValueError, as the JAX package cannot run it either.

The data: ``device_dataset`` "auto" (the default, as in the JAX package)
holds the decoded uint8 cache and the histogram pool in device memory and
gathers each batch there (``data/device_source.py``) when a cache exists,
no dataset augmentation needs the host and it fits the budget; else the
streaming loader feeds the step, its next batch copied to the device
behind the step. ``sync_every`` N > 1 reads the step's metrics back to the
host only every N steps (and on save steps): the log, the NaN check and
the rollback run on those steps only.

FID (``calculate_fid_every``): every N steps ``calculate_fid`` scores
``fid_num_samples`` EMA samples against the dataset's images with
InceptionV3's pool3 features (``metrics/``), and appends
``step,fid,provenance`` to ``results/<name>/fid_scores.txt``. Its draws
come from generators of its own, so it leaves the training draws as they
are.

Not ported yet, and refused with NotImplementedError when asked for:
``remat``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from histogan_tpu_torch.data import device_source
from histogan_tpu_torch.models.discriminator import Discriminator, refuse_bf16_vq
from histogan_tpu_torch.models.generator import Generator
from histogan_tpu_torch.models.vectorizers import HistVectorizer, StyleVectorizer
from histogan_tpu_torch.optim.diffgrad import DiffGrad
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.train.checkpoint import CheckpointStore
from histogan_tpu_torch.train.state import EMA, LIVE, HistoGANState
from histogan_tpu_torch.train.steps import draw_step, train_step
from histogan_tpu_torch.utils.config import HistoGANConfig
from histogan_tpu_torch.utils.image_io import save_image_grid
from histogan_tpu_torch.utils.inits import reset_parameters_
from histogan_tpu_torch.utils.logging import MetricsLogger
from histogan_tpu_torch.utils.platform import setup_runtime


class NanException(Exception):
    pass


# the bf16 EMA's generator is seeded with seed + this ("EMA", as the JAX
# step folds it into its key)
EMA_SEED_OFFSET = 0x454D41
# the AugWrapper's host generator is seeded with seed + this ("AUG")
COIN_SEED_OFFSET = 0x415547
# FID's streams (the JAX package's seeds): the real images, the target
# histograms (+ the step) and the latents and noise
FID_REAL_SEED, FID_HIST_SEED, FID_DRAW_SEED = 4242, 4243, 24242
DTYPES = {None: torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16}


def _check_choice(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def _refuse_deferred(**given) -> None:
    for name, asked in given.items():
        if asked:
            raise NotImplementedError(f"{name}: not ported to the PyTorch package yet")


class Trainer:
    def __init__(self, name="default", results_dir="results", models_dir="models",
                 image_size=128, network_capacity=16, transparent=False,
                 batch_size=4, mixed_prob=0.9, gradient_accumulate_every=1,
                 lr=2e-4, save_every=1000, trunc_psi=0.6,
                 fq_layers=(), fq_dict_size=256, attn_layers=(),
                 hist_method="inverse-quadratic", hist_resizing="sampling",
                 hist_sigma=0.02, hist_bin=64, hist_insz=150,
                 aug_prob=0.0, dataset_aug_prob=0.0, aug_types=None,
                 latent_dim=512, style_depth=8, seed=42, precision="fp32",
                 sync_every=1, calculate_fid_every=None, fid_num_samples=256,
                 fid_extractor=None, device_dataset="auto", opt_state_dtype=None,
                 ema_dtype=None, remat=False, num_workers=None, device="cuda"):
        _check_choice("precision", precision, ("fp32", "bf16"))
        _check_choice("opt_state_dtype", opt_state_dtype, (None, "fp32", "bf16"))
        _check_choice("ema_dtype", ema_dtype, (None, "fp32", "bf16"))
        _refuse_deferred(remat=bool(remat))
        refuse_bf16_vq(precision, image_size, fq_layers)
        self.cfg = HistoGANConfig(
            image_size=image_size, network_capacity=network_capacity,
            latent_dim=latent_dim, style_depth=style_depth, transparent=transparent,
            fq_layers=tuple(fq_layers), fq_dict_size=fq_dict_size,
            attn_layers=tuple(attn_layers),
            hist_bin=hist_bin, hist_insz=hist_insz, hist_method=hist_method,
            hist_resizing=hist_resizing, hist_sigma=hist_sigma,
            batch_size=batch_size, gradient_accumulate_every=gradient_accumulate_every,
            learning_rate=lr, mixed_prob=mixed_prob, aug_prob=aug_prob,
            aug_types=tuple(aug_types or ("translation", "cutout")),
            dataset_aug_prob=dataset_aug_prob, save_every=save_every,
            trunc_psi=trunc_psi, precision=precision,
        )
        self.name = name
        self.results_dir = Path(results_dir)
        (self.results_dir / name).mkdir(parents=True, exist_ok=True)
        self.store = CheckpointStore(models_dir, name)
        self.config_path = self.store.config_path
        self.device = setup_runtime(device)
        self.seed = int(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.coin_gen = torch.Generator().manual_seed(self.seed + COIN_SEED_OFFSET)
        self.opt_state_dtype, self.ema_dtype = DTYPES[opt_state_dtype], DTYPES[ema_dtype]
        self.num_workers = int(num_workers) if num_workers else None
        self.sync_every = max(1, int(sync_every))
        self.device_dataset = device_source.normalise_flag(device_dataset)
        self.steps = 0
        self.av: Optional[torch.Tensor] = None
        self.state: Optional[HistoGANState] = None
        self.dataset = self.pool = self.loader = None
        self._staged = None  # the streaming path's next batch, on its way
        self._eval_rng = np.random.default_rng(1234)

        self.calculate_fid_every = calculate_fid_every
        self.fid_num_samples = int(fid_num_samples)
        self._fid_extractor = fid_extractor  # None: metrics.default_extractor
        self._fid_scorer = None
        self.last_fid: Optional[float] = None
        self.fid_provenance: Optional[str] = None

        # the reference's print_log surface
        self.d_loss = self.g_loss = self.h_loss = 0.0
        self.last_gp_loss = self.last_cr_loss = self.q_loss = 0.0
        self.pl_mean = 0.0
        self.metrics_logger = MetricsLogger(
            results_dir, name, every=50, imgs_per_step=batch_size * gradient_accumulate_every)

    # ------------------------------------------------------------ setup
    def init_GAN(self) -> None:
        """S/H/G/D, the EMA copies SE/HE/GE (reset_parameter_averaging
        starts the EMA as a copy, cast to ``ema_dtype``) and a
        DiffGrad(lr, betas=(0.5, 0.9)) for each side, its state in
        ``opt_state_dtype``."""
        cfg = self.cfg
        init_gen = torch.Generator().manual_seed(self.seed)
        S = reset_parameters_(StyleVectorizer(cfg.latent_dim, cfg.style_depth), init_gen)
        H = reset_parameters_(HistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
                              init_gen)
        G = reset_parameters_(
            Generator(cfg.image_size, cfg.latent_dim, cfg.network_capacity, cfg.transparent),
            init_gen)
        D = reset_parameters_(
            Discriminator(cfg.image_size, cfg.network_capacity, cfg.fq_layers,
                          cfg.fq_dict_size, cfg.attn_layers, cfg.transparent),
            init_gen)
        live = {k: m.to(self.device) for k, m in zip(LIVE, (S, H, G, D))}
        ema = {e: copy.deepcopy(live[k]).to(self.ema_dtype).eval().requires_grad_(False)
               for e, k in EMA.items()}
        opt = dict(lr=cfg.learning_rate, betas=(0.5, 0.9), state_dtype=self.opt_state_dtype)
        self.state = HistoGANState(
            **live, **ema,
            opt_g=DiffGrad([p for k in ("S", "H", "G") for p in live[k].parameters()], **opt),
            opt_d=DiffGrad(live["D"].parameters(), **opt),
            pl_mean=torch.zeros((), device=self.device),
            ema_gen=torch.Generator(device=self.device).manual_seed(
                self.seed + EMA_SEED_OFFSET),
        )
        self.av = None

    def _module(self, prefix: str) -> Optional[nn.Module]:
        return None if self.state is None else getattr(self.state, prefix)

    # the modules as the reference Trainer's GAN names them
    S = property(lambda self: self._module("S"))
    H = property(lambda self: self._module("H"))
    G = property(lambda self: self._module("G"))
    D = property(lambda self: self._module("D"))
    SE = property(lambda self: self._module("SE"))
    HE = property(lambda self: self._module("HE"))
    GE = property(lambda self: self._module("GE"))

    def models(self) -> Dict[str, nn.Module]:
        """The modules by their reference state-dict prefix."""
        return self.state.modules()

    def reference_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights in the flat reference layout, all fp32 (a bf16 EMA
        widened, as the JAX package's ``bundle_from_trainer`` does)."""
        return {k: v.float() for k, v in self.state.reference_state_dict().items()}

    def load_state_dict(self, sd) -> List[str]:
        """Load a flat reference-layout state dict, strictly on each
        prefix; each tensor is cast to its module's dtype (into a bf16 EMA
        rounded to nearest). Returns the keys under no prefix of the GAN
        (a published checkpoint's ``D_aug.*`` copy of D)."""
        parts, others = convert.split_by_prefix(sd)
        for prefix, module in self.models().items():
            module.load_state_dict(parts[prefix], strict=True)
        self.av = None
        return others

    def load_pt(self, path) -> List[str]:
        """Install a reference-layout ``.pt`` (``--load_pt``)."""
        return self.load_state_dict(convert.load_reference_pt(path))

    def export_pt(self, path) -> int:
        """Write the weights as a reference-layout ``.pt`` (``--export_pt``);
        returns the number of tensors."""
        sd = {k: v.detach().cpu().contiguous() for k, v in self.reference_state_dict().items()}
        torch.save(sd, path)
        return len(sd)

    # ------------------------------------------------------------- data
    def set_data_src(self, folder: str) -> None:
        """Images and histogram pool from ``folder``, and the batch source:
        the ``DeviceDataSource`` when ``device_dataset`` resolves to it, else
        the streaming ``TrainLoader`` (both seeded 7, as in the JAX
        package)."""
        from histogan_tpu_torch.data.dataset import HistogramPool, ImageFolderDataset

        cfg = self.cfg
        self.dataset = ImageFolderDataset(folder, cfg.image_size, cfg.transparent,
                                          cfg.dataset_aug_prob, cache_dir=str(self.store.dir))
        self.pool = HistogramPool(self.dataset.paths, cfg.hist_insz, cfg.hist_bin,
                                  cfg.hist_method, cfg.hist_resizing, cfg.hist_sigma,
                                  cfg.transparent, cache_dir=str(self.store.dir),
                                  device=self.device)
        self.close()
        self.loader = device_source.make_source(
            self.device_dataset, self.dataset, self.pool, cfg.batch_size,
            cfg.gradient_accumulate_every, seed=7, num_workers=self.num_workers,
            device=self.device)
        self._fid_scorer = None  # new data: new real statistics
        self._eval_rng = np.random.default_rng(1234)

    def close(self) -> None:
        """Stop the loader's prefetch thread."""
        self._staged = None
        if self.loader is not None:
            self.loader.close()
            self.loader = None

    # ------------------------------------------------------------ train
    def train(self, alpha: float = 2.0) -> Optional[Dict[str, float]]:
        """One training step on the next batch. On a step that syncs (every
        step at ``sync_every`` 1; else every ``sync_every``-th step and
        every save step) returns its metrics as floats, after the log and
        the NaN check; on any other step returns None, its metrics left on
        the device unread."""
        if self.loader is None:
            raise RuntimeError("You must first initialize the data source with "
                               "`.set_data_src(<folder of images>)`")
        if self.state is None:
            self.init_GAN()
        if alpha != self.cfg.alpha:
            self.cfg = dataclasses.replace(self.cfg, alpha=alpha)
        cfg, steps = self.cfg, self.steps

        apply_gp = steps % 4 == 0
        apply_pl = steps % 32 == 0
        # EMA schedule (histoGAN/histoGAN.py:996-1000)
        apply_ema = steps > 20000 and steps % 10 == 0
        apply_reset = steps <= 25000 and steps % 1000 == 2

        batch = device_source.take_batch(self.loader, self._staged, self.device)
        draws = draw_step(self.gen, cfg, self.device, apply_pl, coins=self.coin_gen)
        metrics = train_step(self.state, batch, draws, cfg, apply_gp, apply_pl, apply_ema)
        self._staged = device_source.stage_next_batch(self.loader, self.device)
        if apply_reset:
            self.state.reset_ema()

        checkpoint_num = steps // cfg.save_every
        m = None
        if self.sync_every == 1 or steps % self.sync_every == 0 or steps % cfg.save_every == 0:
            names = sorted(metrics)
            m = dict(zip(names, torch.stack([metrics[k] for k in names]).tolist()))  # one sync
            self.metrics_logger.log(steps, m)
            self.d_loss, self.g_loss, self.h_loss = m["d_loss"], m["g_loss"], m["h_loss"]
            self.q_loss = m["q_loss"]
            if apply_gp:
                self.last_gp_loss = m["gp_loss"]
            self.pl_mean = m["pl_mean"]

            if math.isnan(self.g_loss) or math.isnan(self.d_loss):
                print(f"NaN detected for generator or discriminator. "
                      f"Loading from checkpoint #{checkpoint_num}")
                self.load(checkpoint_num)
                raise NanException

        if steps % cfg.save_every == 0:
            self.save(checkpoint_num)
        if steps % 1000 == 0 or (steps % 100 == 0 and steps < 2500):
            self.evaluate(steps // 1000)
        # 0 disables it, as None does (the CLI's flag is an int)
        if self.calculate_fid_every and steps % self.calculate_fid_every == 0:
            fid = self.calculate_fid()
            prov = self.fid_provenance
            print(f"FID @ step {steps}: {fid:.4f} [{prov}]")
            with open(self.results_dir / self.name / "fid_scores.txt", "a") as f:
                f.write(f"{steps},{fid:.4f},{prov}\n")

        self.steps += 1
        self.av = None
        return m

    # ------------------------------------------------------------- eval
    def _eval_hist_batch(self, n: int = 4) -> np.ndarray:
        if self.pool is None:
            raise RuntimeError("evaluate without hist_batch draws from the data's "
                               "histogram pool: call set_data_src first")
        return self.pool.self_hist(self._eval_rng.integers(0, len(self.pool), size=n))

    @torch.inference_mode()
    def evaluate(self, num=0, hist_batch=None, num_image_tiles: int = 4,
                 latents=None, n=None, save_noise_latent: bool = False,
                 load_noise_file=None, load_latent_file=None) -> np.ndarray:
        """Sample with the EMA weights; returns (N, S, S, 3|4) in [0, 1]
        and, unless ``num`` is None, saves the grid as
        ``results/<name>/<num>-ema.jpg``. Without ``hist_batch`` the
        target histograms are drawn from the data's histogram pool."""
        cfg = self.cfg
        if hist_batch is None:
            hist_batch = self._eval_hist_batch(4)
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
        """The EMA modules for sampling, fp32: a bf16 EMA is widened into
        copies (trainer.py:572-581 of the JAX package)."""
        ema = {"S": self.SE, "H": self.HE, "G": self.GE}
        if self.ema_dtype == torch.float32:
            return ema
        return {k: copy.deepcopy(m).float() for k, m in ema.items()}

    def _fid_draws(self, step: int, s: int, take: int):
        """The latents (take, latent) and noise (take, S, S, 1) of FID's
        samples ``s .. s + take`` at ``step``, from a CPU generator seeded
        from (FID_DRAW_SEED, step, s), on the device."""
        seed = np.random.SeedSequence((FID_DRAW_SEED, step, s)).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed))
        size = self.cfg.image_size
        latents = torch.randn((take, self.cfg.latent_dim), generator=gen)
        noise = torch.rand((take, size, size, 1), generator=gen)
        return latents.to(self.device), noise.to(self.device)

    @torch.inference_mode()
    def calculate_fid(self, num_samples: Optional[int] = None) -> float:
        """FID between ``num_samples`` EMA samples (truncated at
        ``trunc_psi``, toward histograms of random pool entries) and the
        dataset's images (center crops). The real features are computed
        once and kept; the samples' each call. The extractor is
        ``fid_extractor``, else the pretrained InceptionV3 behind
        ``INCEPTION_WEIGHTS``, else the seeded random-weight one
        (``metrics/fid.py``); ``fid_provenance`` says which. The draws
        (``_fid_draws``, the histogram and image indices, and the
        truncation center when none is cached) come from generators of
        their own: the training draws are as without FID."""
        if self.pool is None:
            raise RuntimeError("calculate_fid scores against the data: call set_data_src first")
        from histogan_tpu_torch.metrics import FIDScorer, default_extractor

        if self._fid_scorer is None:
            self._fid_scorer = FIDScorer(self._fid_extractor or default_extractor(self.device))
        scorer = self._fid_scorer
        n = int(num_samples or self.fid_num_samples)
        bs = max(1, self.cfg.batch_size)

        if scorer.num_real < n:
            scorer.reset()
            rng = np.random.default_rng(FID_REAL_SEED)
            for s in range(0, n, bs):
                idx = rng.integers(0, len(self.dataset), size=min(bs, n - s))
                # rng None: the deterministic center crop
                imgs = np.stack([self.dataset.get_image(int(i), None) for i in idx])
                scorer.add_real(imgs[..., :3])  # the extractor's stem is RGB

        scorer.reset(real=False)
        params = self._ema_params()
        hist_rng = np.random.default_rng(FID_HIST_SEED + self.steps)
        cached_av = self.av
        if cached_av is None:
            gen = torch.Generator(device=self.device).manual_seed(FID_DRAW_SEED + self.steps)
            self.av = self.compute_av(params["S"], gen)
        try:
            for s in range(0, n, bs):
                take = min(bs, n - s)
                idx = hist_rng.integers(0, len(self.pool), size=take)
                hist = torch.from_numpy(self.pool.self_hist(idx)).to(self.device)
                latents, noise = self._fid_draws(self.steps, s, take)
                imgs = self.generate_truncated(params, hist, latents, noise,
                                               trunc_psi=self.cfg.trunc_psi)
                scorer.add_generated(imgs[..., :3].cpu().numpy())  # RGB only
        finally:
            self.av = cached_av
        self.last_fid = scorer.score()
        self.fid_provenance = scorer.provenance
        return self.last_fid

    @torch.inference_mode()
    def compute_av(self, S: nn.Module, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Mean w over 2000 z draws (truncation center,
        histoGAN/histoGAN.py:1068-1072), from ``generator`` or the
        trainer's."""
        z = torch.randn((2000, self.cfg.latent_dim), generator=generator or self.gen,
                        device=self.device)
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

    # ------------------------------------------------------ persistence
    def config(self) -> dict:
        return self.cfg.persisted()

    def write_config(self) -> None:
        self.cfg.write_config(self.config_path)

    def load_config(self) -> None:
        """Trust the persisted architecture (models/<name>/.config.json)
        over the flags, as the reference does, then build the models."""
        self.cfg = self.cfg.load_config(self.config_path)
        refuse_bf16_vq(self.cfg.precision, self.cfg.image_size, self.cfg.fq_layers)
        self.init_GAN()

    def save(self, num: int) -> None:
        s = self.state
        self.store.save({
            "GAN": {k: v.detach().cpu() for k, v in s.reference_state_dict().items()},
            "opt_g": s.opt_g.state_dict(), "opt_d": s.opt_d.state_dict(),
            "pl_mean": float(s.pl_mean), "step": s.step,
        }, num)
        self.write_config()

    def load(self, num: int = -1) -> None:
        self.load_config()
        name = num
        if num == -1:
            latest = self.store.latest()
            if latest is None:
                return
            name = latest
            print(f"continuing from previous epoch - {name}")
        self.steps = name * self.cfg.save_every
        payload = self.store.restore(name)
        self.load_state_dict(payload["GAN"])
        s = self.state
        s.opt_g.load_state_dict(payload["opt_g"])
        s.opt_d.load_state_dict(payload["opt_d"])
        s.pl_mean = torch.tensor(payload["pl_mean"], dtype=torch.float32, device=self.device)
        s.step = int(payload["step"])

    def clear(self) -> None:
        self.store.clear()
        shutil.rmtree(self.results_dir / self.name, ignore_errors=True)
        (self.results_dir / self.name).mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------- logging
    def print_log(self) -> None:
        print(
            f"\nG: {self.g_loss:.2f} | H: {self.h_loss:.2f} | D: "
            f"{self.d_loss:.2f} | GP: {self.last_gp_loss:.2f}"
            f" | PL: {self.pl_mean:.2f} | CR: {self.last_cr_loss:.2f} | Q: "
            f"{self.q_loss:.2f}"
        )

    def model_name(self, num: int) -> str:
        return str(self.store.path(num))
