"""CLI: train HistoGAN, or sample from it given target histogram(s), on
a GPU or the CPU.

The counterpart of ``histogan_tpu/cli/histogan.py`` with its flags and
defaults, plus ``--device``: training with NaN retry, ``--generate`` for
npy / image / directory targets with tile doubling, ``--load_pt`` and
``--export_pt`` (reference-layout ``.pt`` files).

    histogan-torch --data ./dataset --name m --new True
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


def train_from_folder(
    data="./dataset/", results_dir="./results", models_dir="./models",
    name="test", new=False, load_from=-1, image_size=128,
    network_capacity=16, transparent=False, batch_size=2,
    gradient_accumulate_every=8, num_train_steps=150000, learning_rate=2e-4,
    num_workers=None, save_every=1000, trunc_psi=0.75, fq_layers=(),
    fq_dict_size=256, attn_layers=(), hist_method="inverse-quadratic",
    hist_resizing="sampling", hist_sigma=0.02, hist_bin=64, hist_insz=150,
    alpha=2, aug_prob=0.0, dataset_aug_prob=0.0, aug_types=None, seed=42,
    load_pt=None, export_pt=None, precision="fp32", sync_every=1, device_dataset="auto",
    calculate_fid_every=None, opt_state_dtype=None, ema_dtype=None, remat=False,
    device="cuda",
):
    """Train from a folder of images (or, with ``export_pt``, write the
    loaded model as a reference-layout .pt and stop)."""
    from histogan_tpu_torch.train.trainer import NanException, Trainer

    model = Trainer(
        name, results_dir, models_dir, batch_size=batch_size,
        gradient_accumulate_every=gradient_accumulate_every,
        image_size=image_size, network_capacity=network_capacity,
        transparent=transparent, lr=learning_rate, save_every=save_every,
        trunc_psi=trunc_psi, fq_layers=fq_layers, fq_dict_size=fq_dict_size,
        attn_layers=attn_layers, hist_insz=hist_insz, hist_bin=hist_bin,
        hist_sigma=hist_sigma, hist_resizing=hist_resizing,
        hist_method=hist_method, aug_prob=aug_prob,
        dataset_aug_prob=dataset_aug_prob, aug_types=aug_types, seed=seed,
        precision=precision, sync_every=sync_every, device_dataset=device_dataset,
        calculate_fid_every=calculate_fid_every,
        opt_state_dtype=opt_state_dtype, ema_dtype=ema_dtype, remat=remat,
        num_workers=num_workers, device=device,
    )
    if not new:
        model.init_GAN()
        model.load(load_from)
    else:
        model.clear()
        model.init_GAN()

    if load_pt is not None:
        skipped = model.load_pt(load_pt)
        print(f"installed reference checkpoint {load_pt}"
              + (f"; {len(skipped)} keys outside the GAN's modules not loaded"
                 if skipped else ""))

    if export_pt is not None:
        if load_pt is None and model.store.latest() is None:
            print(f"no --load_pt and no checkpoint: exporting weights drawn with seed {seed}")
        count = model.export_pt(export_pt)
        print(f"exported reference-layout checkpoint to {export_pt} ({count} tensors)")
        return

    print("\nStart training....\n")
    print(f"Alpha = {alpha}")
    model.set_data_src(data)
    try:
        total = num_train_steps - model.steps
        for i in range(total):
            tries = 0
            while True:
                try:
                    model.train(alpha)
                    break
                except NanException:
                    tries += 1
                    if tries >= 3:
                        raise
            if i % 50 == 0:
                print(f"{name}<{data}>: step {model.steps} ({i + 1}/{total})")
                model.print_log()
    finally:
        model.close()


def generate_from_folder(
    results_dir="./results", models_dir="./models", name="test", new=False,
    image_size=128, network_capacity=16, transparent=False, batch_size=2,
    save_noise_latent=False, target_noise_file=None, target_latent_file=None,
    num_image_tiles=8, trunc_psi=0.75, hist_method="inverse-quadratic",
    hist_resizing="sampling", hist_sigma=0.02, hist_bin=64, hist_insz=150,
    target_hist=None, seed=42, load_pt=None, precision="fp32", device="cuda",
    load_from=-1,
):
    """Sample for each target; without ``new`` from the saved checkpoint
    ``load_from`` (the latest for -1), as the JAX CLI does."""
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
        model.load(load_from)
    if load_pt is not None:
        skipped = model.load_pt(load_pt)
        print(f"loaded reference checkpoint {load_pt}"
              + (f"; {len(skipped)} keys outside the GAN's modules not loaded"
                 if skipped else ""))
    elif new or model.store.latest() is None:
        print(f"no --load_pt and no checkpoint: sampling from weights drawn with seed {seed}")

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
        help="Write the loaded model as a reference-layout .pt and exit.")
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
    add("--fp16", type=str2bool, default=False,
        help="Reference flag; True means --precision bf16 (there is no fp16 path).")
    add("--precision", choices=("fp32", "bf16"), default=None,
        help="Training compute dtype (default fp32): bf16 runs S, H, G and D in "
             "bf16 on fp32 master weights, with fp32 losses and histograms. "
             "Sampling is fp32 at either.")
    add("--opt_state_dtype", default=None, choices=("fp32", "bf16"),
        help="Storage dtype of DiffGrad's moments and previous gradient "
             "(default fp32); their update math is fp32.")
    add("--ema_dtype", default=None, choices=("fp32", "bf16"),
        help="Storage dtype of the EMA weights (default fp32); bf16 updates "
             "them in fp32 and stores them by stochastic rounding, and "
             "widens them to fp32 to sample and to export.")
    add("--sync_every", type=int, default=1,
        help="Fetch step metrics every N steps (1 = reference parity; "
             "larger amortizes the per-step host sync).")
    add("--device_dataset", default="auto", choices=("auto", "true", "false"),
        help="Park the decoded dataset + hist pool in device memory and gather "
             "batches on the device (auto: when eligible).")
    add("--remat", type=str2bool, default=False)
    add("--calculate_fid_every", type=int, default=None,
        help="Score FID every N steps into results/<name>/fid_scores.txt (0 or "
             "unset: off); pretrained InceptionV3 weights from INCEPTION_WEIGHTS, "
             "else seeded random features.")
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
        help="torch device to train or sample on (default cuda; cpu runs "
             "the plain versions of the kernels)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    precision = args.precision or ("bf16" if args.fp16 else "fp32")
    if args.generate:
        return generate_from_folder(
            results_dir=args.results_dir, models_dir=args.models_dir, name=args.name,
            new=args.new, image_size=args.image_size,
            network_capacity=args.network_capacity, transparent=args.transparent,
            batch_size=args.batch_size, save_noise_latent=args.save_n_l,
            target_noise_file=args.target_n, target_latent_file=args.target_l,
            num_image_tiles=args.num_image_tiles, trunc_psi=args.trunc_psi,
            hist_method=args.hist_method, hist_resizing=args.hist_resizing,
            hist_sigma=args.hist_sigma, hist_bin=args.hist_bin, hist_insz=args.hist_insz,
            target_hist=args.target_hist, seed=args.seed, load_pt=args.load_pt,
            precision=precision, device=args.device, load_from=args.load_from,
        )
    return train_from_folder(
        data=args.data, results_dir=args.results_dir, models_dir=args.models_dir,
        name=args.name, new=args.new, load_from=args.load_from,
        image_size=args.image_size, network_capacity=args.network_capacity,
        transparent=args.transparent, batch_size=args.batch_size,
        gradient_accumulate_every=args.gradient_accumulate_every,
        num_train_steps=args.num_train_steps, learning_rate=args.learning_rate,
        num_workers=args.num_workers, save_every=args.save_every,
        trunc_psi=args.trunc_psi, fq_layers=args.fq_layers,
        fq_dict_size=args.fq_dict_size, attn_layers=args.attn_layers,
        hist_method=args.hist_method, hist_resizing=args.hist_resizing,
        hist_sigma=args.hist_sigma, hist_bin=args.hist_bin, hist_insz=args.hist_insz,
        alpha=args.alpha, aug_prob=args.aug_prob, dataset_aug_prob=args.dataset_aug_prob,
        aug_types=args.aug_types, seed=args.seed, load_pt=args.load_pt,
        export_pt=args.export_pt, precision=precision, sync_every=args.sync_every,
        device_dataset={"true": True, "false": False}.get(args.device_dataset, "auto"),
        calculate_fid_every=args.calculate_fid_every,
        opt_state_dtype=args.opt_state_dtype, ema_dtype=args.ema_dtype,
        remat=args.remat, device=args.device,
    )


if __name__ == "__main__":
    main()
