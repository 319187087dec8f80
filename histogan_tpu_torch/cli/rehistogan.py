"""CLI: train reHistoGAN, or recolor real images (``--generate True``), on
a GPU or the CPU.

The counterpart of ``histogan_tpu/cli/rehistogan.py`` with its flags and
defaults, plus ``--device``: the HistoGAN head transplant
(``--load_histoGAN_weights``), ``--load_pt`` and ``--export_pt``
(reference-layout ``.pt`` files), and recoloring toward an image, a
``.npy`` histogram or a folder of either, or under ``--sampling`` toward
five-way mixes of a histogram pool ``.npy`` (``histogan-create-hist-data-torch``
writes one). The output keeps the photo's resolution with
``--upsampling_output True`` (``--upsampling_method pyramid`` or ``BGU``;
a photo smaller than ``--image_size`` is resized down to its size),
``--post_recoloring True`` recolors the original photo by MKL toward the
output, and ``--face_extraction True`` aligns the face of each input photo
into ``./temp-faces/`` first (it needs a landmark detector: dlib, or one
registered with ``utils.face_preprocessing.set_landmark_detector``).
``--precision bf16`` (or ``--fp16 True``) trains and recolors in bf16.

    rehistogan-torch --data ./dataset --name m --new True
    rehistogan-torch --generate True --input_image in.jpg --target_hist t.jpg \
        --upsampling_output True --upsampling_method BGU
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from pathlib import Path

import numpy as np

from histogan_tpu_torch import parallel
from histogan_tpu_torch.cli.histogan import image_hist, str2bool

IMAGE_EXTS = (".jpg", ".png", ".jpeg")


def hist_interpolation(hists: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random convex combination of N histograms (rehistoGAN.py:54-61)."""
    ratios = np.abs(rng.random(hists.shape[0]))
    ratios = ratios / ratios.sum()
    return np.tensordot(ratios, hists, axes=(0, 0))


def process_image(model, name, input_image, target_hist, image_size=256,
                  upsampling_output=False, upsampling_method="pyramid", swapping_levels=1,
                  pyramid_levels=5, level_blending=False, post_recoloring=False, sampling=True,
                  target_number=1, results_dir="./results_ReHistoGAN/", hist_insz=150,
                  hist_bin=64, hist_method="inverse-quadratic", hist_resizing="sampling",
                  hist_sigma=0.02, histogram_pool="histogram_data/histograms.npy", rng=None):
    """Recolor one image file toward ``target_hist`` (an image, a ``.npy``
    or a folder of either), or with no target and ``sampling`` toward
    ``target_number`` five-way mixes of the pool ``histogram_pool``
    ((N, 1, 3, h, h)). Target images' histograms are computed on the
    model's device (through the histogram kernel on a GPU). With
    ``upsampling_output`` the output goes back to the photo's size
    (``RecoloringTrainer.evaluate``); ``post_recoloring`` recolors the
    original photo by MKL toward the output."""
    from PIL import Image

    from histogan_tpu_torch.data.dataset import load_rgb
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock

    rng = rng or np.random.default_rng()
    img_pil = Image.open(input_image).convert("RGB")
    original_img = np.asarray(img_pil) / 255.0

    # the resizing-mode decision (rehistoGAN.py:81-95)
    width = height = resizing_mode = None
    if upsampling_output:
        width, height = img_pil.size
        if width > image_size or height > image_size:
            resizing_mode = "upscaling"
        elif width < image_size or height < image_size:
            resizing_mode = "downscaling"
        else:
            resizing_mode = "none"

    if img_pil.size != (image_size, image_size):
        img_pil = img_pil.resize((image_size, image_size))
    img = np.asarray(img_pil, np.float32)[None] / 255.0  # (1, S, S, 3) NHWC

    timestamp = datetime.now().strftime("%m-%d-%Y_%H-%M-%S")
    postfix = round(float(rng.random()) * 1000)

    def run(h, samples_name):
        model.evaluate(samples_name, image_batch=img, hist_batch=np.asarray(h, np.float32),
                       resizing=resizing_mode, resizing_method=upsampling_method,
                       swapping_levels=swapping_levels, pyramid_levels=pyramid_levels,
                       level_blending=level_blending, original_size=[width, height],
                       input_image_name=input_image, original_image=original_img,
                       save_input=False, post_recoloring=post_recoloring)
        print(f"recolored images generated at {results_dir}/{name}/{samples_name}")

    if target_hist is None:
        if not sampling:
            raise Exception("No target histogram is given.")
        pool = np.load(histogram_pool)  # (N, 1, 3, h, h)
        for j in range(target_number):
            inds = rng.integers(0, pool.shape[0], size=5)
            run(hist_interpolation(pool[inds], rng), f"{j}-output-{timestamp}-{postfix}")
        return

    block = RGBuvHistBlock(insz=hist_insz, h=hist_bin, resizing=hist_resizing,
                           method=hist_method, sigma=hist_sigma)

    def hist_of(path):
        ext = os.path.splitext(path)[1].lower()
        if ext == ".npy":
            h = np.load(path)
            return h if h.ndim == 4 else h.reshape(-1, *h.shape[-3:])
        if ext in IMAGE_EXTS:
            return image_hist(load_rgb(path), block, model.device)
        return None

    if os.path.splitext(target_hist)[1] == "":
        for f in sorted(os.listdir(target_hist)):
            f = os.path.join(target_hist, f)
            if not os.path.isfile(f):
                continue
            h = hist_of(f)
            if h is None:
                print(f"Warning: File extension of {f} is not supported.")
                continue
            run(h, f"output-{Path(f).stem}-{timestamp}-{postfix}")
    else:
        h = hist_of(target_hist)
        if h is None:
            raise Exception("File extension is not supported!")
        run(h, f"output-{Path(target_hist).stem}-{timestamp}-{postfix}")


def train_from_folder(
    data="./dataset/", results_dir="./results_ReHistoGAN/", models_dir="./models/",
    histGAN_models_dir="./models/", name="test", new=False, load_from=-1, image_size=128,
    network_capacity=16, transparent=False, load_histogan_weights=True, batch_size=2,
    sampling=True, gradient_accumulate_every=8, num_train_steps=200000, learning_rate=2e-4,
    save_every=10000, generate=False, skip_conn_to_GAN=False, fq_layers=(),
    fq_dict_size=256, attn_layers=(), hist_method="inverse-quadratic",
    hist_resizing="sampling", hist_sigma=0.02, hist_bin=64, hist_insz=150,
    rec_loss="laplacian", alpha=32, beta=1.5, gamma=4, fixed_gan_weights=False,
    initialize_gan=False, variance_loss=False, target_hist=None, internal_hist=False,
    histoGAN_model_name=None, input_image=None, target_number=None,
    change_hyperparameters=False, change_hyperparameters_after=100000,
    upsampling_output=False, upsampling_method="pyramid", swapping_levels=1, pyramid_levels=6,
    level_blending=False, post_recoloring=False,
    histogram_pool="histogram_data/histograms.npy", seed=42, load_pt=None, export_pt=None,
    num_devices=None, precision="fp32", sync_every=1, device_dataset="auto",
    param_sharding="replicated", opt_state_dtype=None, remat=False, num_workers=None,
    device="cuda",
):
    """Train from a folder of images; or with ``export_pt`` write the
    loaded model as a reference-layout .pt and stop; or with ``generate``
    recolor ``input_image`` (a file or a folder)."""
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    from histogan_tpu_torch.train.trainer import NanException, Trainer

    model = RecoloringTrainer(
        name, results_dir, models_dir, batch_size=batch_size,
        gradient_accumulate_every=gradient_accumulate_every, image_size=image_size,
        network_capacity=network_capacity, transparent=transparent, lr=learning_rate,
        save_every=save_every, fq_layers=fq_layers, fq_dict_size=fq_dict_size,
        attn_layers=attn_layers, hist_insz=hist_insz, hist_bin=hist_bin,
        hist_sigma=hist_sigma, hist_resizing=hist_resizing, hist_method=hist_method,
        rec_loss=rec_loss, fixed_gan_weights=fixed_gan_weights,
        skip_conn_to_GAN=skip_conn_to_GAN, initialize_gan=initialize_gan,
        variance_loss=variance_loss, internal_hist=internal_hist,
        change_hyperparameters=change_hyperparameters,
        change_hyperparameters_after=change_hyperparameters_after, seed=seed,
        num_devices=num_devices, precision=precision, sync_every=sync_every,
        device_dataset=device_dataset, param_sharding=param_sharding,
        opt_state_dtype=opt_state_dtype, remat=remat, num_workers=num_workers, device=device,
    )

    def transplant():
        gan_name = (histoGAN_model_name if histoGAN_model_name is not None
                    else name.replace("_rehistoGAN", "_histoGAN"))
        if not (Path(histGAN_models_dir) / gan_name).exists():
            raise Exception("GAN does not exist!")
        donor = Trainer(
            gan_name, results_dir, histGAN_models_dir, batch_size=batch_size,
            image_size=image_size, network_capacity=network_capacity,
            transparent=transparent, lr=learning_rate, hist_insz=hist_insz,
            hist_bin=hist_bin, hist_sigma=hist_sigma, hist_resizing=hist_resizing,
            hist_method=hist_method, device=device,
        )
        donor.load(load_from)
        model.load_histogan_head(donor)

    if load_pt is not None:
        model.init_GAN()
        skipped = model.load_pt(load_pt)
        print(f"installed reference checkpoint {load_pt}"
              + (f"; {len(skipped)} keys outside the model's modules not loaded"
                 if skipped else ""))
    elif not new:
        status = model.load(load_from)
        if load_histogan_weights and status == -1:
            transplant()
    else:
        model.clear()
        model.init_GAN()
        if load_histogan_weights:
            transplant()

    if export_pt is not None:
        count = model.export_pt(export_pt)
        print(f"exported reference-layout checkpoint to {export_pt} ({count} tensors)")
        return

    if generate:
        if input_image is None:
            raise Exception("No input image is given")
        kwargs = dict(
            image_size=image_size, upsampling_output=upsampling_output,
            upsampling_method=upsampling_method, swapping_levels=swapping_levels,
            pyramid_levels=pyramid_levels, level_blending=level_blending,
            post_recoloring=post_recoloring, sampling=sampling, target_number=target_number,
            results_dir=results_dir, hist_insz=hist_insz, hist_bin=hist_bin,
            hist_method=hist_method, hist_resizing=hist_resizing, hist_sigma=hist_sigma,
            histogram_pool=histogram_pool, rng=np.random.default_rng(seed),
        )
        ext = os.path.splitext(input_image)[1].lower()
        if ext in IMAGE_EXTS:
            process_image(model, name, input_image, target_hist, **kwargs)
        elif ext == "":
            for f in sorted(os.listdir(input_image)):
                f = os.path.join(input_image, f)
                if os.path.isfile(f) and os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                    process_image(model, name, f, target_hist, **kwargs)
        else:
            raise Exception("File extension is not supported!")
        return

    print("\nStart training....\n")
    print(f"Alpha = {alpha}")
    print(f"Beta = {beta}")
    print(f"Gamma = {gamma}")
    model.set_data_src(data, not fixed_gan_weights)
    try:
        total = num_train_steps - model.steps
        for i in range(total):
            tries = 0
            while True:
                try:
                    model.train(alpha, beta, gamma)
                    break
                except NanException:
                    tries += 1
                    if tries >= 3:
                        raise
            if i % 50 == 0 and parallel.is_main():
                print(f"{name}<{data}>: step {model.steps} ({i + 1}/{total})")
                model.print_log()
    finally:
        model.close()


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train/Test ReHistoGAN (PyTorch/CUDA).")
    add = parser.add_argument
    add("--data", default="./dataset/")
    add("--results_dir", default="./results_ReHistoGAN")
    add("--models_dir", default="./models")
    add("--histGAN_models_dir", default="./models")
    add("--histoGAN_model_name", default=None, type=str)
    add("--target_hist", default=None)
    add("--input_image", default=None)
    add("--face_extraction", type=str2bool, default=False)
    add("--name", default="reHistoGAN_model")
    add("--sampling", type=str2bool, default=False)
    add("--target_number", type=int, default=50)
    add("--new", type=str2bool, default=False)
    add("--load_from", type=int, default=-1)
    add("--load_pt", default=None, type=str,
        help="Load a reference-layout recoloring .pt checkpoint.")
    add("--export_pt", default=None, type=str,
        help="Write the loaded model as a reference-layout .pt and exit.")
    add("--image_size", type=int, default=256)
    add("--network_capacity", type=int, default=16)
    add("--transparent", type=str2bool, default=False)
    add("--batch_size", type=int, default=2)
    add("--gradient_accumulate_every", type=int, default=8)
    add("--num_train_steps", type=int, default=200000)
    add("--learning_rate", type=float, default=2e-4)
    add("--num_workers", type=int, default=None)
    add("--save_every", type=int, default=10000)
    add("--trunc_psi", type=float, default=0.75)  # accepted; the recolor does not truncate
    add("--fp16", type=str2bool, default=False,
        help="Reference flag; True means --precision bf16.")
    add("--precision", choices=("fp32", "bf16"), default=None,
        help="Compute dtype of training and of the recolor (bf16 on fp32 "
             "masters); overrides --fp16.")
    add("--sync_every", type=int, default=1,
        help="Fetch step metrics every N steps (1 = reference parity).")
    add("--device_dataset", default="auto", choices=("auto", "true", "false"),
        help="Park the decoded dataset + hist pool in device memory (auto: when "
             "eligible).")
    add("--param_sharding", default="replicated", choices=("replicated", "fsdp"),
        help="'fsdp' shards the weights, DiffGrad's state and the EMA over the "
             "torchrun ranks (ZeRO-3-style); one process: the same as 'replicated'.")
    add("--opt_state_dtype", default=None, choices=("fp32", "bf16"),
        help="Storage dtype of DiffGrad's moments and previous gradient "
             "(default fp32); their update math is fp32.")
    add("--remat", type=str2bool, default=False)
    add("--fq_layers", nargs="*", type=int, default=[])
    add("--fq_dict_size", type=int, default=256)
    add("--attn_layers", nargs="*", type=int, default=[])
    add("--gpu", type=int, default=0)  # accepted for compat; use --device
    add("--num_devices", type=int, default=None)
    add("--hist_bin", type=int, default=64)
    add("--hist_insz", type=int, default=150)
    add("--hist_method", default="inverse-quadratic")
    add("--hist_resizing", default="sampling")
    add("--hist_sigma", type=float, default=0.02)
    add("--generate", type=str2bool, default=False)
    add("--alpha", type=float, default=32)
    add("--beta", type=float, default=1.5)
    add("--gamma", type=float, default=2)
    add("--change_hyperparameters", type=str2bool, default=False)
    add("--change_hyperparameters_after", type=int, default=100000)
    add("--rec_loss", default="laplacian", type=str)
    add("--internal_hist", type=str2bool, default=False)
    add("--skip_conn_to_GAN", type=str2bool, default=True)
    add("--fixed_gan_weights", type=str2bool, default=False)
    add("--load_histoGAN_weights", type=str2bool, default=False)
    add("--initialize_gan", type=str2bool, default=True)
    add("--variance_loss", type=str2bool, default=True)
    add("--upsampling_output", type=str2bool, default=False)
    add("--upsampling_method", default="pyramid", type=str)
    add("--pyramid_levels", type=int, default=6)
    add("--swapping_levels", type=int, default=1)
    add("--level_blending", type=str2bool, default=False)
    add("--post_recoloring", type=str2bool, default=False)
    add("--histogram_pool", default="histogram_data/histograms.npy")
    add("--seed", type=int, default=42)
    add("--device", default="cuda",
        help="torch device to train or recolor on (default cuda; cpu runs "
             "the plain versions of the kernels)")
    return parser.parse_args(argv)


def extract_faces(input_image: str, faces_dir: str = "./temp-faces/") -> str:
    """The ``--face_extraction`` pre-pass (histogan_tpu/cli/rehistogan.py:
    356-376): align the face of ``input_image`` (a file, or each image of a
    folder, after emptying ``faces_dir`` of files) into ``faces_dir``;
    returns what to recolor instead."""
    from histogan_tpu_torch.utils.face_preprocessing import face_extraction

    ext = os.path.splitext(input_image)[1].lower()
    if ext in IMAGE_EXTS:
        face_extraction(input_image, faces_dir)
        return os.path.join(faces_dir, os.path.split(input_image)[-1])
    if ext != "":
        raise Exception("File extension is not supported!")
    Path(faces_dir).mkdir(exist_ok=True)
    for f in os.listdir(faces_dir):
        if os.path.isfile(os.path.join(faces_dir, f)):
            os.remove(os.path.join(faces_dir, f))
    for f in sorted(os.listdir(input_image)):
        p = os.path.join(input_image, f)
        if os.path.isfile(p) and os.path.splitext(f)[1].lower() in IMAGE_EXTS:
            face_extraction(p, faces_dir)
    return faces_dir


def main(argv=None):
    args = get_args(argv)
    # under torchrun, before any CUDA work: NCCL for --device cuda, gloo for cpu
    parallel.maybe_initialize_distributed(device=args.device)
    input_image = args.input_image
    if args.generate and args.face_extraction:
        if input_image is None:
            raise Exception("No input image is given")
        input_image = extract_faces(input_image)
    return train_from_folder(
        data=args.data, results_dir=args.results_dir, models_dir=args.models_dir,
        name=args.name, new=args.new, histGAN_models_dir=args.histGAN_models_dir,
        load_from=args.load_from, load_histogan_weights=args.load_histoGAN_weights,
        image_size=args.image_size, network_capacity=args.network_capacity,
        transparent=args.transparent, batch_size=args.batch_size,
        gradient_accumulate_every=args.gradient_accumulate_every,
        num_train_steps=args.num_train_steps, learning_rate=args.learning_rate,
        save_every=args.save_every, generate=args.generate, fq_layers=args.fq_layers, fq_dict_size=args.fq_dict_size,
        attn_layers=args.attn_layers, hist_method=args.hist_method,
        hist_resizing=args.hist_resizing, hist_sigma=args.hist_sigma,
        hist_bin=args.hist_bin, hist_insz=args.hist_insz, target_hist=args.target_hist,
        alpha=args.alpha, beta=args.beta, gamma=args.gamma,
        skip_conn_to_GAN=args.skip_conn_to_GAN, fixed_gan_weights=args.fixed_gan_weights,
        sampling=args.sampling, rec_loss=args.rec_loss,
        initialize_gan=args.initialize_gan, variance_loss=args.variance_loss,
        input_image=input_image, internal_hist=args.internal_hist,
        histoGAN_model_name=args.histoGAN_model_name, target_number=args.target_number,
        change_hyperparameters=args.change_hyperparameters,
        change_hyperparameters_after=args.change_hyperparameters_after,
        upsampling_output=args.upsampling_output, upsampling_method=args.upsampling_method,
        swapping_levels=args.swapping_levels, pyramid_levels=args.pyramid_levels,
        level_blending=args.level_blending, post_recoloring=args.post_recoloring,
        histogram_pool=args.histogram_pool, seed=args.seed, load_pt=args.load_pt,
        export_pt=args.export_pt, num_devices=args.num_devices,
        precision=args.precision or ("bf16" if args.fp16 else "fp32"),
        sync_every=args.sync_every,
        device_dataset={"true": True, "false": False}.get(args.device_dataset, "auto"),
        param_sharding=args.param_sharding, opt_state_dtype=args.opt_state_dtype,
        remat=args.remat, num_workers=args.num_workers, device=args.device,
    )


if __name__ == "__main__":
    main()
