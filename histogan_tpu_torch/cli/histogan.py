"""CLI: sample HistoGAN given target histogram(s), on a GPU or the CPU.

The counterpart of ``histogan_tpu/cli/histogan.py`` with the same flags
and defaults, plus ``--device``. This slice ports ``--generate``: npy /
image / directory targets with tile doubling. Training comes with a
later slice and raises NotImplementedError here.

    histogan-torch --generate True --target_hist t.jpg --load_pt m.pt
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes", "y")


def image_hist(img: np.ndarray, hist_block, device) -> np.ndarray:
    """Decoded (H, W, C) image in [0, 1] -> (1, 3, h, h) histogram,
    computed on ``device`` (through the histogram kernel on a GPU)."""
    x = torch.as_tensor(np.asarray(img, np.float32)[None], device=device)
    with torch.inference_mode():
        return hist_block(x).cpu().numpy()


def load_target_hist(path: str, hist_block, device) -> Optional[np.ndarray]:
    """npy histogram or image file -> (1, 3, h, h) numpy array."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        hist = np.load(path)
        if hist.ndim == 3:
            hist = hist[None]
        if hist.ndim == 5:  # pools saved as (N,1,3,h,h)
            hist = hist.reshape(-1, *hist.shape[-3:])[:1]
        return np.asarray(hist, np.float32)
    if ext in (".jpg", ".png", ".jpeg"):
        from histogan_tpu_torch.data.dataset import load_rgb

        return image_hist(load_rgb(path), hist_block, device)
    return None


def tile_double(h: np.ndarray, num_image_tiles: int) -> np.ndarray:
    """Reference tile doubling (histoGAN.py:117-120)."""
    if num_image_tiles > 1:
        num_image_tiles = num_image_tiles - num_image_tiles % 2
        for _ in range(int(np.log2(num_image_tiles))):
            h = np.concatenate([h, h], axis=0)
    return h


def sample_target(model, hist_block, *, image: Optional[np.ndarray] = None,
                  hist: Optional[np.ndarray] = None, num_image_tiles: int = 16,
                  samples_name: Optional[str] = None, **eval_kwargs) -> np.ndarray:
    """The per-target work of ``--generate``: a decoded image (H, W, C)
    or a (1, 3, h, h) histogram -> num_image_tiles**2 samples, saved as
    a grid unless ``samples_name`` is None."""
    if (image is None) == (hist is None):
        raise ValueError("give exactly one of image= and hist=")
    if image is not None:
        hist = image_hist(image, hist_block, model.device)
    return model.evaluate(samples_name, hist_batch=tile_double(hist, num_image_tiles),
                          num_image_tiles=num_image_tiles, **eval_kwargs)


def generate_from_folder(
    results_dir="./results", models_dir="./models", name="test", new=False,
    image_size=128, network_capacity=16, transparent=False, batch_size=2,
    save_noise_latent=False, target_noise_file=None, target_latent_file=None,
    num_image_tiles=8, trunc_psi=0.75, hist_method="inverse-quadratic",
    hist_resizing="sampling", hist_sigma=0.02, hist_bin=64, hist_insz=150,
    target_hist=None, seed=42, load_pt=None, precision="fp32", device="cuda",
):
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
    from histogan_tpu_torch.train.trainer import Trainer

    if target_hist is None:
        raise Exception("No target histogram or image is given")
    model = Trainer(
        name, results_dir, models_dir, batch_size=batch_size, image_size=image_size,
        network_capacity=network_capacity, transparent=transparent,
        trunc_psi=trunc_psi, hist_insz=hist_insz, hist_bin=hist_bin,
        hist_sigma=hist_sigma, hist_resizing=hist_resizing, hist_method=hist_method,
        seed=seed, precision=precision, device=device,
    )
    if new:
        model.init_GAN()
    else:
        model.load_config()
    if load_pt is not None:
        skipped = model.load_pt(load_pt)
        print(f"loaded reference checkpoint {load_pt}"
              + (f"; {len(skipped)} keys not loaded (the discriminator is not "
                 f"ported yet)" if skipped else ""))
    else:
        print(f"no --load_pt given: sampling from weights drawn with seed {seed}")

    timestamp = datetime.now().strftime("%m-%d-%Y_%H-%M-%S")
    if save_noise_latent:
        Path(f"temp/{name}").mkdir(parents=True, exist_ok=True)
    hist_block = RGBuvHistBlock(insz=hist_insz, h=hist_bin, resizing=hist_resizing,
                                method=hist_method, sigma=hist_sigma)

    def generate_one(hist_source: str):
        h = load_target_hist(hist_source, hist_block, model.device)
        if h is None:
            print(f"Warning: File extension of {hist_source} is not supported.")
            return
        base = os.path.basename(os.path.splitext(hist_source)[0])
        samples_name = f"generated-{base}-{timestamp}"
        sample_target(model, hist_block, hist=h, num_image_tiles=num_image_tiles,
                      samples_name=samples_name, save_noise_latent=save_noise_latent,
                      load_noise_file=target_noise_file,
                      load_latent_file=target_latent_file)
        print(f"sample images generated at {results_dir}/{name}/{samples_name}")

    ext = os.path.splitext(target_hist)[1]
    if ext == "":
        for f in sorted(os.listdir(target_hist)):
            if os.path.isfile(os.path.join(target_hist, f)):
                generate_one(os.path.join(target_hist, f))
    elif ext.lower() in (".npy", ".jpg", ".png", ".jpeg"):
        generate_one(target_hist)
    else:
        print("The file extension of target image is not supported.")
        raise NotImplementedError


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Sample HistoGAN (PyTorch/CUDA).")
    add = parser.add_argument
    add("--data", default="./dataset/")
    add("--results_dir", default="./results_HistoGAN")
    add("--models_dir", default="./models")
    add("--target_hist", default=None)
    add("--name", default="histoGAN_model")
    add("--new", type=str2bool, default=False)
    add("--load_from", type=int, default=-1)
    add("--load_pt", default=None, type=str,
        help="Load a reference-layout .pt checkpoint.")
    add("--export_pt", default=None, type=str,
        help="Not ported yet (needs the discriminator).")
    add("--image_size", type=int, default=256)
    add("--network_capacity", type=int, default=16)
    add("--transparent", type=str2bool, default=False)
    add("--batch_size", type=int, default=2)
    add("--gradient_accumulate_every", type=int, default=8)
    add("--num_train_steps", type=int, default=1500000)
    add("--learning_rate", type=float, default=2e-4)
    add("--num_workers", type=int, default=None)
    add("--save_every", type=int, default=5000)
    add("--generate", type=str2bool, default=False)
    add("--save_noise_latent", dest="save_n_l", type=str2bool, default=False)
    add("--target_noise_file", dest="target_n", default=None)
    add("--target_latent_file", dest="target_l", default=None)
    add("--num_image_tiles", type=int, default=16)
    add("--trunc_psi", type=float, default=0.75)
    add("--fp16", type=str2bool, default=False)
    add("--precision", choices=("fp32", "bf16"), default=None)
    add("--fq_layers", nargs="*", type=int, default=[])
    add("--fq_dict_size", type=int, default=256)
    add("--attn_layers", nargs="*", type=int, default=[])
    add("--gpu", type=int, default=0)  # accepted for compat; use --device
    add("--hist_bin", type=int, default=64)
    add("--hist_insz", type=int, default=150)
    add("--hist_method", default="inverse-quadratic")
    add("--hist_resizing", default="interpolation")
    add("--hist_sigma", type=float, default=0.02)
    add("--alpha", type=float, default=2)
    add("--aug_prob", type=float, default=0.0)
    add("--dataset_aug_prob", type=float, default=0.0)
    add("--aug_types", nargs="+", default=["translation", "cutout"])
    add("--seed", type=int, default=42)
    add("--device", default="cuda",
        help="torch device to sample on (default cuda; cpu runs the plain "
             "versions of the kernels)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if not args.generate or args.export_pt is not None:
        raise NotImplementedError(
            "histogan-torch ports sampling (--generate True) only; training "
            "and --export_pt are not ported yet")
    generate_from_folder(
        results_dir=args.results_dir, models_dir=args.models_dir, name=args.name,
        new=args.new, image_size=args.image_size,
        network_capacity=args.network_capacity, transparent=args.transparent,
        batch_size=args.batch_size, save_noise_latent=args.save_n_l,
        target_noise_file=args.target_n, target_latent_file=args.target_l,
        num_image_tiles=args.num_image_tiles, trunc_psi=args.trunc_psi,
        hist_method=args.hist_method, hist_resizing=args.hist_resizing,
        hist_sigma=args.hist_sigma, hist_bin=args.hist_bin, hist_insz=args.hist_insz,
        target_hist=args.target_hist, seed=args.seed, load_pt=args.load_pt,
        precision=args.precision or ("bf16" if args.fp16 else "fp32"),
        device=args.device,
    )


if __name__ == "__main__":
    main()
