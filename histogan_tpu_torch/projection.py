"""GAN inversion (projection) for HistoGAN, the counterpart of
``histogan_tpu/projection.py``.

Two variants, matching the reference tools:

- :func:`project_gaussian` — optimize input z-space style rows (and
  optionally the noise image or per-block latent noise), reference
  projection_gaussian.py:197-570.
- :func:`project_to_latent` — optimize per-block POST-projection styles
  (style1/style2/torgb_style) directly, reference
  projection_to_latent.py:207-614.

Both freeze the EMA nets and run eager steps of Adam (the reference's
optimizer for projection, projection_gaussian.py:451-459; its update
m̂/(√v̂ + 1e-8) is optax's ``adam``, which the JAX package runs). Results
are saved as .npz with the JAX package's keys and layouts: styles (1, C),
latent noises (1, s, s, F) and ``in_noise`` (1, S, S, 1), NHWC, so that a
file written by either package recolors in the other. The noises are
turned to the generator's NCHW only at the call into it.

The target photo's histogram goes through the histogram kernel K1 on a
GPU (once per projection run, and once per image target of
``recolor_projected``'s caller).
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from histogan_tpu_torch.models.generator import generator_filters
from histogan_tpu_torch.utils.image_io import save_image


# --------------------------------------------------------------- helpers
def block_styles_from_latent(G: nn.Module, block_idx: int,
                             latent: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(style1, style2, rgb_style) for one block from a latent vector —
    the reference's block.to_style1/to_style2/to_rgb.to_style projections
    (projection_gaussian.py:432-440)."""
    blk = G.blocks[block_idx]
    return blk.to_style1(latent), blk.to_style2(latent), blk.to_rgb.to_style(latent)


def block_noise_from_image(G: nn.Module, block_idx: int, spatial: int,
                           in_noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noise1, noise2) for one block: crop, project, transpose quirk
    (projection_gaussian.py:419-429; histoGAN/histoGAN.py:465-467), in the
    JAX package's layout (1, s, s, F)."""
    blk = G.blocks[block_idx]
    crop = in_noise[:, :spatial, :spatial, :]
    n1 = torch.transpose(blk.to_noise1(crop), 1, 2)
    n2 = torch.transpose(blk.to_noise2(crop), 1, 2)
    return n1, n2


def block_spatials(image_size: int, network_capacity: int) -> List[int]:
    """Post-upsample spatial size per generator block (4, 8, 16, ...)."""
    n = len(generator_filters(image_size, network_capacity))
    return [4 * (2 ** max(0, i)) if i == 0 else 4 * (2 ** i) for i in range(n)]


def _forward(trainer, ema: Dict[str, nn.Module], histogram_latent: torch.Tensor, *,
             z_styles=None, style_lists=None, in_noise=None, noise_lists=None) -> torch.Tensor:
    """Unified manual unroll covering both tools' process_image paths;
    returns NHWC."""
    cfg = trainer.cfg
    nl = cfg.num_layers
    hist_rows = torch.stack([histogram_latent, histogram_latent], dim=1)

    block_styles = None
    if style_lists is not None:
        block_styles = [
            None if i >= nl - 2 else  # standard hist-driven path
            (style_lists["style1"][i], style_lists["style2"][i], style_lists["torgb"][i])
            for i in range(nl)
        ]

    block_noises = None
    if noise_lists is not None:
        # the JAX layout (1, s, s, F), transpose quirk applied, as the
        # blocks add it: NCHW
        block_noises = [
            (noise_lists["noise1"][i].permute(0, 3, 1, 2),
             noise_lists["noise2"][i].permute(0, 3, 1, 2))
            for i in range(nl)
        ]

    dev = histogram_latent.device
    if z_styles is not None:
        # z_styles: (1, n-2, latent) z rows; map each row through S
        styles_arg = ema["S"](z_styles)
    else:
        styles_arg = torch.zeros((1, nl - 2, cfg.latent_dim), device=dev)
    if in_noise is None:
        in_noise = torch.zeros((1, cfg.image_size, cfg.image_size, 1), device=dev)

    rgb = ema["G"](styles_arg, hist_rows, in_noise, block_styles=block_styles,
                   block_noises=block_noises)
    return rgb.permute(0, 2, 3, 1)


def _draws(seed: int, latent_dim: int, image_size: int) -> Dict[str, torch.Tensor]:
    """The random draws of one run, on the CPU from ``torch.Generator(seed)``
    (the same numbers on every device): ``z`` (1, latent) normal, the
    starting latent; ``noise`` (1, S, S, 1) uniform, the noise image (and
    the recolor's fresh or added noise); ``z_random_styles`` (1, latent)
    normal, the recolor's ``random_styles``. The JAX package draws these
    from ``PRNGKey(seed)``, so its numbers differ; the parity tests
    replace this function with one that returns JAX's."""
    g = torch.Generator().manual_seed(int(seed))
    return {"z": torch.randn((1, latent_dim), generator=g),
            "noise": torch.rand((1, image_size, image_size, 1), generator=g),
            "z_random_styles": torch.randn((1, latent_dim), generator=g)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(variables: dict) -> List[torch.Tensor]:
    return [x for v in variables.values() for x in (v if isinstance(v, list) else [v])]


def _run_optimization(loss_fn, optimizer, variables, num_train_steps, log_every,
                      save_every, on_log, on_save, chunk_steps=None, perf_out=None):
    """Eager Adam steps: ``loss_fn(variables) -> (loss, aux)``, backward,
    ``optimizer.step()``. ``on_log(t, aux)`` runs where ``t % log_every ==
    0`` (with the aux of step ``t``, from before its update) and
    ``on_save(t, variables)`` where ``(t + 1) % save_every == 0`` (after
    it): the JAX package's cadence.

    ``chunk_steps`` is the JAX package's argument, which splits its
    scanned dispatches with boundaries that carry no host event. Eager
    steps have no dispatch to split, so it changes nothing.
    ``perf_out`` (a dict) opts into steady-state timing: the window opens
    after the first step has synchronised and closes on a synchronise
    after the last, so first-call set-up and the renders, jpgs and npz
    around the loop are left out."""
    del chunk_steps
    device = _leaves(variables)[0].device
    t_mark, steps_at_mark = None, 0
    for t in range(num_train_steps):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(variables)
        loss.backward()
        optimizer.step()
        if perf_out is not None and t_mark is None:
            _sync(device)  # first step done: set-up paid
            t_mark, steps_at_mark = time.perf_counter(), t + 1
        if log_every and t % log_every == 0:
            on_log(t, tuple(a.detach() for a in aux))
        if (t + 1) % save_every == 0:
            on_save(t, variables)
    if perf_out is not None and t_mark is not None:
        _sync(device)
        dt = time.perf_counter() - t_mark
        steps = num_train_steps - steps_at_mark
        perf_out["opt_window_steps"] = steps
        perf_out["opt_window_seconds"] = dt
        if steps > 0 and dt > 0:
            perf_out["opt_steps_per_sec"] = steps / dt
    return variables


def _pixel_loss(kind: str, a, b):
    if kind == "L1":
        return torch.mean(torch.abs(a - b))
    return torch.mean(torch.square(a - b))  # L2 / mse


def _load_input(path: str, image_size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((image_size, image_size))
    return np.asarray(img, np.float32)[None] / 255.0


def _maybe_vgg(vgg_loss_weight: float):
    if vgg_loss_weight <= 0:
        return None
    try:
        from histogan_tpu_torch.ops.vgg import VGGPerceptualLoss

        return VGGPerceptualLoss()
    except FileNotFoundError as e:
        print(f"WARNING: {e}\nDisabling VGG loss (set --vgg_loss_weight 0 to "
              f"silence this).")
        return None


def _ema(trainer) -> Dict[str, nn.Module]:
    """The EMA S, H and G as stored, frozen, as the JAX package projects
    through ``trainer.state.ema``. The CLIs' trainer holds them in fp32;
    an EMA stored in bf16 (``ema_dtype='bf16'``) is refused by the first
    fp32 product in either package, as JAX's convolutions refuse it."""
    return {"S": trainer.SE, "H": trainer.HE, "G": trainer.GE}


def _to_image(rgb: torch.Tensor) -> np.ndarray:
    return np.clip(rgb[0].detach().float().cpu().numpy(), 0, 1)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------- optimization
@dataclasses.dataclass
class _Inversion:
    """What both tools share before their loop."""

    out_dir: Path
    filename: str
    ema: Dict[str, nn.Module]
    target: torch.Tensor  # (1, S, S, 3) in [0, 1]
    hist_latent: torch.Tensor  # H of the target's histogram
    draws: Dict[str, torch.Tensor]
    noise_vars: Dict[str, object]  # the noise variables to optimise, if any
    vgg: Optional[nn.Module]


def _setup(trainer, input_image: str, results_dir: str, seed: int, latent_noise: bool,
           optimize_noise: bool, vgg_loss_weight: float) -> _Inversion:
    from histogan_tpu_torch.ops.histogram import histogram_feature

    cfg = trainer.cfg
    dev = trainer.device
    filename = os.path.basename(os.path.splitext(input_image)[0])
    out_dir = Path(results_dir) / trainer.name / filename
    out_dir.mkdir(parents=True, exist_ok=True)

    ema = _ema(trainer)
    target = torch.from_numpy(_load_input(input_image, cfg.image_size)).to(dev)
    draws = {k: v.to(dev) for k, v in _draws(seed, cfg.latent_dim, cfg.image_size).items()}
    # no_grad, not inference_mode: these tensors enter the optimised graph,
    # and autograd saves them for backward
    with torch.no_grad():
        in_hist = histogram_feature(
            target, h=cfg.hist_bin, insz=cfg.hist_insz, resizing=cfg.hist_resizing,
            method=cfg.hist_method, sigma=cfg.hist_sigma,
        )
        hist_latent = ema["H"](in_hist)
        noise_vars: Dict[str, object] = {}
        in_noise = draws["noise"]
        if optimize_noise and latent_noise:
            spatials = block_spatials(cfg.image_size, cfg.network_capacity)
            pairs = [block_noise_from_image(ema["G"], i, s, in_noise)
                     for i, s in enumerate(spatials)]
            noise_vars["noise1"] = [a.clone() for a, _ in pairs]
            noise_vars["noise2"] = [b.clone() for _, b in pairs]
        elif optimize_noise:
            noise_vars["in_noise"] = in_noise.clone()
    vgg = _maybe_vgg(vgg_loss_weight)
    if vgg is not None:
        vgg = vgg.to(dev)
    return _Inversion(out_dir, filename, ema, target, hist_latent, draws, noise_vars, vgg)


def _noise_kwargs(v: dict, in_noise: torch.Tensor) -> dict:
    if "noise1" in v:
        return {"noise_lists": {"noise1": v["noise1"], "noise2": v["noise2"]}}
    return {"in_noise": v.get("in_noise", in_noise)}


def _optimize(run: _Inversion, variables, render, style_reg, dump, *, latent_noise,
              optimize_noise, pixel_loss_weight, vgg_loss_weight, noise_reg_weight,
              num_train_steps, learning_rate, pixel_loss, save_every, log_every, chunk_steps,
              perf_out) -> Path:
    """The loop both tools share: start render, Adam with the logs and
    saves, the final npz and render."""
    out_dir, filename, target, vgg = run.out_dir, run.filename, run.target, run.vgg
    for x in _leaves(variables):
        x.requires_grad_(True)

    def loss_fn(v):
        rgb = render(v)
        rec = pixel_loss_weight * _pixel_loss(pixel_loss, target, rgb)
        loss = rec
        zero = torch.zeros((), device=rgb.device)
        vl = zero
        if vgg is not None:
            vl = vgg_loss_weight * vgg(target, rgb)
            loss = loss + vl
        nl_loss = zero
        if optimize_noise:
            if latent_noise:
                terms = [torch.mean(a) ** 2 + torch.mean(b) ** 2
                         for a, b in zip(v["noise1"], v["noise2"])]
                nl_loss = noise_reg_weight * sum(terms) / len(terms)
            else:
                nl_loss = noise_reg_weight * torch.mean(v["in_noise"]) ** 2
            loss = loss + nl_loss
        sl = style_reg(v)
        loss = loss + sl
        return loss, (rec, vl, nl_loss, sl)

    optimizer = torch.optim.Adam(_leaves(variables), lr=learning_rate)

    with torch.no_grad():
        save_image(_to_image(render(variables)), out_dir / f"{filename}_start.jpg")

    def on_log(t, aux):
        rec, vl, nls, sl = aux
        print(f"Optimization step {t + 1}, rec. loss = {float(rec)}, "
              f"vgg loss = {float(vl)}, rec. noise reg loss = {float(nls)}, "
              f"style reg loss = {float(sl)}")

    def on_save(t, v):
        with torch.no_grad():
            save_image(_to_image(render(v)), out_dir / f"{filename}_{t + 1}.jpg")
        dump(v, str(t + 1))

    variables = _run_optimization(
        loss_fn, optimizer, variables, num_train_steps, log_every, save_every,
        on_log, on_save, chunk_steps=chunk_steps, perf_out=perf_out,
    )

    dump(variables, "final")
    with torch.no_grad():
        save_image(_to_image(render(variables)), out_dir / f"{filename}_final.jpg")
    print("End of optimization.")
    return out_dir


def _dump_noise(v: dict, data: dict) -> None:
    if "in_noise" in v:
        data["in_noise"] = _np(v["in_noise"])
    if "noise1" in v:
        for i, (a, b) in enumerate(zip(v["noise1"], v["noise2"])):
            data[f"noise1_{i}"] = _np(a)
            data[f"noise2_{i}"] = _np(b)


def project_gaussian(trainer, input_image: str, *, results_dir: str,
                     latent_noise: bool = False, optimize_noise: bool = True,
                     pixel_loss_weight: float = 1.0, vgg_loss_weight: float = 0.005,
                     noise_reg_weight: float = 0.0, style_reg_weight: float = 0.0,
                     num_train_steps: int = 10000, learning_rate: float = 2e-4,
                     pixel_loss: str = "L1", save_every: int = 500,
                     seed: int = 0, log_every: int = 1,
                     chunk_steps: int = None, perf_out: dict = None) -> Path:
    """Optimize z-space style rows (+ noise) to reconstruct
    ``input_image``; saves intermediate jpgs + npz and a final npz.
    Returns the output directory."""
    nl = trainer.cfg.num_layers
    run = _setup(trainer, input_image, results_dir, seed, latent_noise, optimize_noise,
                 vgg_loss_weight)

    # init: one z repeated over rows (noise_list, projection_gaussian.py:407-410)
    variables: Dict[str, object] = {"styles": run.draws["z"][:, None, :].repeat(1, nl - 2, 1)}
    variables.update(run.noise_vars)

    def render(v):
        return _forward(trainer, run.ema, run.hist_latent, z_styles=v["styles"],
                        **_noise_kwargs(v, run.draws["noise"]))

    def style_reg(v):
        return style_reg_weight * torch.mean(v["styles"]) ** 2 / v["styles"].shape[1]

    def dump(v, tag):
        data = {"styles": _np(v["styles"])}
        _dump_noise(v, data)
        np.savez(run.out_dir / f"{run.filename}_{tag}.npz", **data)

    return _optimize(
        run, variables, render, style_reg, dump, latent_noise=latent_noise,
        optimize_noise=optimize_noise, pixel_loss_weight=pixel_loss_weight,
        vgg_loss_weight=vgg_loss_weight, noise_reg_weight=noise_reg_weight,
        num_train_steps=num_train_steps, learning_rate=learning_rate,
        pixel_loss=pixel_loss, save_every=save_every, log_every=log_every,
        chunk_steps=chunk_steps, perf_out=perf_out)


def project_to_latent(trainer, input_image: str, *, results_dir: str,
                      latent_noise: bool = False, optimize_noise: bool = True,
                      pixel_loss_weight: float = 1.0, vgg_loss_weight: float = 0.005,
                      noise_reg_weight: float = 0.0, style_reg_weight: float = 0.0,
                      num_train_steps: int = 10000, learning_rate: float = 2e-4,
                      pixel_loss: str = "L1", save_every: int = 500,
                      seed: int = 0, log_every: int = 1,
                      chunk_steps: int = None, perf_out: dict = None) -> Path:
    """Optimize per-block post-projection styles directly
    (projection_to_latent.py:420-545)."""
    nl = trainer.cfg.num_layers
    run = _setup(trainer, input_image, results_dir, seed, latent_noise, optimize_noise,
                 vgg_loss_weight)

    with torch.no_grad():
        w = run.ema["S"](run.draws["z"])
        per_block = [block_styles_from_latent(run.ema["G"], i, w) for i in range(nl - 2)]
    variables: Dict[str, object] = {
        "style1": [s[0].clone() for s in per_block],
        "style2": [s[1].clone() for s in per_block],
        "torgb": [s[2].clone() for s in per_block],
    }
    variables.update(run.noise_vars)

    def render(v):
        # pad the optimized lists up to nl entries (last 2 use the hist path)
        style_lists = {
            "style1": list(v["style1"]) + [None, None],
            "style2": list(v["style2"]) + [None, None],
            "torgb": list(v["torgb"]) + [None, None],
        }
        return _forward(trainer, run.ema, run.hist_latent, style_lists=style_lists,
                        **_noise_kwargs(v, run.draws["noise"]))

    def style_reg(v):
        terms = [torch.mean(a) ** 2 + torch.mean(b) ** 2
                 for a, b in zip(v["style1"], v["style2"])]
        return style_reg_weight * sum(terms) / max(len(terms), 1)

    def dump(v, tag):
        data = {}
        for i in range(nl - 2):
            data[f"style1_{i}"] = _np(v["style1"][i])
            data[f"style2_{i}"] = _np(v["style2"][i])
            data[f"torgb_style_{i}"] = _np(v["torgb"][i])
        _dump_noise(v, data)
        np.savez(run.out_dir / f"{run.filename}_{tag}.npz", **data)

    return _optimize(
        run, variables, render, style_reg, dump, latent_noise=latent_noise,
        optimize_noise=optimize_noise, pixel_loss_weight=pixel_loss_weight,
        vgg_loss_weight=vgg_loss_weight, noise_reg_weight=noise_reg_weight,
        num_train_steps=num_train_steps, learning_rate=learning_rate,
        pixel_loss=pixel_loss, save_every=save_every, log_every=log_every,
        chunk_steps=chunk_steps, perf_out=perf_out)


# --------------------------------------------------------------- recolor
@torch.no_grad()
def recolor_projected(trainer, input_image: str, target_hist, target_hist_name: str, *,
                      results_dir: str, mode: str = "gaussian", latent_noise: bool = False,
                      optimize_noise: bool = True, add_noise: bool = False,
                      random_styles: Sequence[int] = (),
                      post_recoloring: bool = False,
                      upsampling_output: bool = False,
                      upsampling_method: str = "pyramid",
                      swapping_levels: int = 1, pyramid_levels: int = 5,
                      level_blending: bool = False, seed: int = 1) -> Path:
    """Render the projected latents with a SWAPPED target histogram
    (projection_gaussian.py:109-194 / projection_to_latent.py:93-204),
    with optional random style re-randomization and post ops.
    ``target_hist``: (1, 3, h, h), numpy or a tensor."""
    cfg = trainer.cfg
    nl = cfg.num_layers
    dev = trainer.device
    draws = {k: v.to(dev) for k, v in _draws(seed, cfg.latent_dim, cfg.image_size).items()}
    filename = os.path.basename(os.path.splitext(input_image)[0])
    out_dir = Path(results_dir) / trainer.name / filename
    with np.load(out_dir / f"{filename}_final.npz") as f:
        data = {k: torch.from_numpy(f[k]).to(dev) for k in f.files}
    ema = _ema(trainer)
    hist_latent = ema["H"](torch.as_tensor(target_hist, dtype=torch.float32, device=dev))

    kwargs: Dict[str, object] = {}
    if optimize_noise and latent_noise:
        kwargs["noise_lists"] = {
            "noise1": [data[f"noise1_{i}"] for i in range(nl)],
            "noise2": [data[f"noise2_{i}"] for i in range(nl)],
        }
    elif optimize_noise:
        in_noise = data["in_noise"]
        if add_noise:
            in_noise = (in_noise + draws["noise"]) / 2.0
        kwargs["in_noise"] = in_noise
    else:
        kwargs["in_noise"] = draws["noise"]

    rs = sorted(set(random_styles))
    if rs and max(rs) > nl - 2:
        raise AssertionError(f"random_styles must be at most {nl - 2}, got {max(rs)}")
    z = draws["z_random_styles"]
    if mode == "gaussian":
        styles = data["styles"].clone()
        for i in rs:
            styles[:, i - 1, :] = z
        rgb = _forward(trainer, ema, hist_latent, z_styles=styles, **kwargs)
    else:
        s1 = [data[f"style1_{i}"] for i in range(nl - 2)]
        s2 = [data[f"style2_{i}"] for i in range(nl - 2)]
        rg = [data[f"torgb_style_{i}"] for i in range(nl - 2)]
        if rs:
            w = ema["S"](z)
            for i in rs:
                s1[i - 1], s2[i - 1], rg[i - 1] = block_styles_from_latent(ema["G"], i - 1, w)
        style_lists = {"style1": s1 + [None, None], "style2": s2 + [None, None],
                       "torgb": rg + [None, None]}
        rgb = _forward(trainer, ema, hist_latent, style_lists=style_lists, **kwargs)

    from datetime import datetime

    timestamp = datetime.now().strftime("%m-%d-%Y_%H-%M-%S")
    base = os.path.basename(os.path.splitext(target_hist_name)[0])
    out_name = out_dir / f"generated-{filename}{base}-{timestamp}.jpg"
    rgb_np = _to_image(rgb)
    save_image(rgb_np, out_name)

    if post_recoloring:
        print("Post-recoloring")
        from histogan_tpu_torch.data.dataset import load_rgb
        from histogan_tpu_torch.post.mkl import color_transfer_MKL

        source = load_rgb(input_image)
        save_image(color_transfer_MKL(source, rgb_np), out_name)

    if upsampling_output:
        print("Upsampling ...")
        from histogan_tpu_torch.data.dataset import load_rgb

        reference = load_rgb(input_image)
        if upsampling_method == "BGU":
            from histogan_tpu_torch.post.bgu import bgu_upsample

            save_image(bgu_upsample(reference, rgb_np), out_name)
        elif upsampling_method == "pyramid":
            from histogan_tpu_torch.post.pyramid import pyramid_upsampling

            out = pyramid_upsampling(rgb_np, reference, levels=pyramid_levels,
                                     swapping_levels=swapping_levels,
                                     blending=level_blending)
            save_image(np.clip(out, 0, 1), out_name)
        else:
            raise Exception("Unknown upsampling method")

    print(f"sample images generated at {out_name}")
    return out_name
