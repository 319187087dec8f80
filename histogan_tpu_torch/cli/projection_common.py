"""Shared plumbing for the two projection CLIs
(reference projection_gaussian.py:573-712 / projection_to_latent.py:617-757),
the counterpart of ``histogan_tpu/cli/projection_common.py``: its flags and
defaults, plus ``--device``."""

from __future__ import annotations

import argparse
import os

import numpy as np

from histogan_tpu_torch.cli.histogan import str2bool


def build_parser(default_results_dir: str,
                 defaults: dict = None) -> argparse.ArgumentParser:
    """Shared flag surface; ``defaults`` lets each console entry pin the
    EXACT defaults of its reference script (the two reference scripts
    disagree with each other on num_train_steps / save_every /
    style_reg_weight — projection_gaussian.py:587-614 vs
    projection_to_latent.py:632-659)."""
    parser = argparse.ArgumentParser(description="Project into HistoGAN latent "
                                                 "(PyTorch/CUDA).")
    add = parser.add_argument
    add("--results_dir", default=default_results_dir)
    add("--models_dir", default="./models")
    add("--input_image", default=None)
    add("--target_hist", default=None)
    add("--name", default="histoGAN_model")
    add("--load_from", type=int, default=-1)
    add("--image_size", type=int, default=256)
    add("--network_capacity", type=int, default=16)
    add("--transparent", type=str2bool, default=False)
    add("--num_train_steps", type=int, default=1000)
    add("--learning_rate", type=float, default=0.1)
    add("--save_every", type=int, default=100)
    add("--generate", type=str2bool, default=False)
    add("--latent_noise", type=str2bool, default=False)
    add("--optimize_noise", type=str2bool, default=False)
    add("--add_noise", type=str2bool, default=False)
    add("--random_styles", nargs="*", type=int, default=[])
    add("--pixel_loss", default="L1")
    add("--pixel_loss_weight", type=float, default=1.0)
    add("--vgg_loss_weight", type=float, default=0.001)
    add("--noise_reg_weight", type=float, default=0.0)
    add("--style_reg_weight", type=float, default=0.0)
    add("--trunc_psi", type=float, default=0.75)
    add("--fp16", type=str2bool, default=False)
    add("--fq_layers", nargs="*", type=int, default=[])
    add("--fq_dict_size", type=int, default=256)
    add("--attn_layers", nargs="*", type=int, default=[])
    add("--gpu", type=int, default=0)  # accepted for compat; use --device
    add("--hist_bin", type=int, default=64)
    add("--hist_insz", type=int, default=150)
    add("--hist_method", default="inverse-quadratic")
    add("--hist_resizing", default="interpolation")
    add("--hist_sigma", type=float, default=0.02)
    add("--post_recoloring", type=str2bool, default=False)
    add("--upsampling_output", type=str2bool, default=False)
    add("--upsampling_method", default="pyramid")
    add("--swapping_levels", type=int, default=1)
    add("--pyramid_levels", type=int, default=6)
    add("--level_blending", type=str2bool, default=False)
    # reference projection_gaussian.py:656-658 — accepted so scripts for
    # models trained with aug_prob > 0 carry over; here the saved
    # .config.json governs model reconstruction, so it has no effect.
    add("--aug_prob", type=float, default=0.0)
    add("--seed", type=int, default=0)
    add("--log_every", type=int, default=1)
    add("--device", default="cuda",
        help="torch device to project on (default cuda; cpu runs the plain "
             "versions of the kernels)")
    if defaults:
        parser.set_defaults(**defaults)
    return parser


def load_trainer(args):
    """The Trainer of ``--name`` on ``--device``, at checkpoint
    ``--load_from`` (the latest for -1; the seeded weights if there is
    none). ``load`` builds the models from the saved .config.json first."""
    from histogan_tpu_torch.train.trainer import Trainer

    model = Trainer(
        args.name, args.results_dir, args.models_dir,
        image_size=args.image_size, network_capacity=args.network_capacity,
        transparent=args.transparent, save_every=args.save_every,
        trunc_psi=args.trunc_psi, fq_layers=args.fq_layers,
        fq_dict_size=args.fq_dict_size, attn_layers=args.attn_layers,
        hist_insz=args.hist_insz, hist_bin=args.hist_bin,
        hist_sigma=args.hist_sigma, hist_resizing=args.hist_resizing,
        hist_method=args.hist_method, device=args.device,
    )
    model.load(args.load_from)
    return model


def iter_target_hists(args, trainer):
    """Yield (hist_array, source_name) for npy / image / directory targets
    (projection_gaussian.py:269-372); an image's histogram is computed on
    the trainer's device."""
    from histogan_tpu_torch.cli.histogan import load_target_hist
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock

    block = RGBuvHistBlock(
        insz=args.hist_insz, h=args.hist_bin, resizing=args.hist_resizing,
        method=args.hist_method, sigma=args.hist_sigma,
    )
    if args.target_hist is None:
        raise Exception("No target histogram is given")
    ext = os.path.splitext(args.target_hist)[1]
    if ext == "":
        files = [os.path.join(args.target_hist, f)
                 for f in sorted(os.listdir(args.target_hist))
                 if os.path.isfile(os.path.join(args.target_hist, f))]
    else:
        files = [args.target_hist]
    for f in files:
        h = load_target_hist(f, block, trainer.device)
        if h is None:
            print(f"Warning: File extension of {f} is not supported.")
            continue
        yield np.asarray(h, np.float32), f


def run(args, mode: str):
    from histogan_tpu_torch import projection

    model = load_trainer(args)
    if args.generate:
        for h, src in iter_target_hists(args, model):
            projection.recolor_projected(
                model, args.input_image, h, src, results_dir=args.results_dir,
                mode=mode, latent_noise=args.latent_noise,
                optimize_noise=args.optimize_noise, add_noise=args.add_noise,
                random_styles=args.random_styles,
                post_recoloring=args.post_recoloring,
                upsampling_output=args.upsampling_output,
                upsampling_method=args.upsampling_method,
                swapping_levels=args.swapping_levels,
                pyramid_levels=args.pyramid_levels,
                level_blending=args.level_blending, seed=args.seed,
            )
        return

    ext = os.path.splitext(args.input_image or "")[1].lower()
    if ext not in (".jpg", ".png", ".jpeg"):
        raise Exception("No target histogram or image is given")
    fn = (projection.project_gaussian if mode == "gaussian"
          else projection.project_to_latent)
    fn(model, args.input_image, results_dir=args.results_dir,
       latent_noise=args.latent_noise, optimize_noise=args.optimize_noise,
       pixel_loss_weight=args.pixel_loss_weight,
       vgg_loss_weight=args.vgg_loss_weight,
       noise_reg_weight=args.noise_reg_weight,
       style_reg_weight=args.style_reg_weight,
       num_train_steps=args.num_train_steps,
       learning_rate=args.learning_rate, pixel_loss=args.pixel_loss,
       save_every=args.save_every, seed=args.seed, log_every=args.log_every)
