"""Recoloring cells: a closed loop of one client, as ``rehistogan
--input_image --target_hist`` recolors a photo at a time.

A request is a decoded photo and a decoded target image, drawn from the
traffic's pools of each made from the seed, and the noise of the head's
blocks, drawn from the request's own stream. It runs from the photo and
the target in host memory to the recolored uint8 image in host memory:
the target's histogram on the device (the CLI's ``image_hist``, through
the histogram kernel), ``RecoloringTrainer.recolor`` (the
encoder-decoder, H and the head's two blocks) and the copy of the result
to the host, converted to uint8 as the image writer does. File decoding
and writing are outside the request.

Once the window has closed, the requests of a sample drawn from the seed
are recolored again by the plain reference from the same photo, target
and noise, and two numbers are compared: the widest gap of any pixel of
the image the user gets (before the uint8 conversion), and the widest gap
of the output before its clamp to [0, 1], over the reference's largest
value. With random weights the output spans hundreds, so few pixels of
the image lie inside [0, 1]; the second number sees every one. It is read
from the timed path itself: ``recolor_forward``, which
``RecoloringTrainer.recolor`` calls, is wrapped to keep its result."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import models as ref_models
from benchmark.reference import steps as ref_steps
from benchmark.reference.histogram import hist_of


WARMUP = 1 << 20  # the warm-up requests' indices, apart from the window's


class Requests:
    """The loop's requests: request i's photo and target indices (a
    sequence drawn from the seed) and its noise (its own stream)."""

    def __init__(self, ctx):
        cfg, tr = ctx.cfg, ctx.traffic
        size = cfg["image_size"]
        self.photos = harness.make_photos(tr["photos"], size, ctx.seed, "photos",
                                          ctx.device).astype(np.float32) / 255.0
        self.targets = harness.make_photos(tr["targets"], size, ctx.seed, "targets",
                                           ctx.device).astype(np.float32) / 255.0
        rng = np.random.default_rng(harness.stream_seed(ctx.seed, "order"))
        self.order = np.stack([rng.integers(0, tr["photos"], 1 << 16),
                               rng.integers(0, tr["targets"], 1 << 16)], axis=1)
        self.ctx = ctx

    def noise(self, i):
        s = self.ctx.cfg["image_size"]
        g = harness.generator(self.ctx.seed, "requests", self.ctx.device, i)
        return torch.rand((1, s, s, 1), generator=g, device=self.ctx.device)

    def photo(self, i):
        return self.photos[self.order[i % len(self.order), 0]]

    def target(self, i):
        return self.targets[self.order[i % len(self.order), 1]]


def build(ctx):
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    cfg = ctx.cfg
    t = RecoloringTrainer(
        name="bench", results_dir=str(ctx.workdir / "results"),
        models_dir=str(ctx.workdir / "models"), image_size=cfg["image_size"],
        network_capacity=cfg["network_capacity"], hist_method=cfg["hist_method"],
        hist_resizing=cfg["hist_resizing"], hist_sigma=cfg["hist_sigma"],
        hist_bin=cfg["hist_bin"], hist_insz=cfg["hist_insz"], latent_dim=cfg["latent_dim"],
        style_depth=cfg["style_depth"], rec_loss=cfg["rec_loss"],
        variance_loss=cfg["variance_loss"], internal_hist=cfg["internal_hist"],
        skip_conn_to_GAN=cfg["skip_conn_to_GAN"], seed=ctx.seed, precision=cfg["precision"],
        device=str(ctx.device))
    t.init_GAN()
    t.load_state_dict(harness.make_weights(cfg, ctx.seed, ctx.device))
    block = RGBuvHistBlock(insz=cfg["hist_insz"], h=cfg["hist_bin"],
                           resizing=cfg["hist_resizing"], method=cfg["hist_method"],
                           sigma=cfg["hist_sigma"])
    return t, block


class Unclamped:
    """Keeps the last output of the program's ``recolor_forward`` (NCHW,
    before the clamp) while it is installed."""

    def __init__(self):
        from histogan_tpu_torch.train import rehisto_trainer

        self.module, self.inner, self.last = rehisto_trainer, rehisto_trainer.recolor_forward, None

        def kept(*args, **kwargs):
            self.last = self.inner(*args, **kwargs)
            return self.last

        rehisto_trainer.recolor_forward = kept

    def close(self):
        self.module.recolor_forward = self.inner


def request(ctx, trainer, block, reqs, raw, i):
    """Request ``i``: (uint8 image, the float image it was made from, the
    output before its clamp, on the device)."""
    from histogan_tpu_torch.cli.histogan import image_hist

    hist = image_hist(reqs.target(i), block, ctx.device)
    out = trainer.recolor(reqs.photo(i)[None], hist, noise=reqs.noise(i))
    img = out.float().cpu().numpy()[0]
    if ctx.fault == "altered":  # an answer altered where it is produced
        img[0, 0, 0] += 0.5 if img[0, 0, 0] < 0.5 else -0.5
    return (img * 255).astype(np.uint8), img, raw.last[0]


def run(ctx) -> dict:
    tr = ctx.traffic
    reqs = Requests(ctx)
    trainer, block = build(ctx)
    raw = Unclamped()
    try:
        for i in range(tr["warmup_requests"]):
            request(ctx, trainer, block, reqs, raw, WARMUP + i)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.monotonic() - ctx.t0
        lat, _, kept, view = harness.serve(
            ctx, lambda i: request(ctx, trainer, block, reqs, raw, i)[1:],
            1, tr["checked_requests"], tr["profile_requests"])
    finally:
        raw.close()
    device = harness.device_info(ctx.device)
    del trainer
    harness.free_device_memory()
    gaps = reference_gaps(ctx, reqs, kept)
    controls = {c: reference_gaps(ctx, reqs, kept, tf32=True)
                for c in ctx.controls if c == "tf32"}
    checks = harness.judge(gaps, ctx.limits)
    harness.say(f"window: {len(lat)} requests in {sum(lat):.3f} s, p50 "
                f"{1e3 * harness.quantile(lat, 0.5):.3f} ms; setup {setup_s:.3f} s")
    out = {"correct": harness.passed(checks), "attempted": len(lat), "failed": 0,
           "metrics": {"setup_s": setup_s, tr["metric"]: 1e3 * harness.quantile(lat, 0.95)},
           "device": device, "checks": checks, "controls": controls}
    if view is not None:
        out["view"] = view
    return out


def reference_gaps(ctx, reqs, kept, tf32=False) -> dict:
    """Between the kept requests and the plain reference's recolor of the
    same photo, target and noise: ``recolor_gap``, the widest gap of a
    pixel of the image, and ``raw_gap``, the widest gap of the output
    before its clamp over the reference's largest value there, the worst
    request (with ``tf32``: the reference in TF32 against itself in
    float32, the control)."""
    cfg = ctx.cfg
    m = ref_models.load_flat(ref_models.build_modules(cfg, "meta"),
                             harness.make_weights(cfg, ctx.seed, ctx.device))
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    gaps = {"recolor_gap": 0.0, "raw_gap": 0.0}
    try:
        with torch.no_grad():
            for i, (img, raw) in sorted(kept.items()):
                outs = []
                for flag in ((False, True) if tf32 else (False,)):
                    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
                    t = torch.from_numpy(reqs.target(i)).to(ctx.device)[None]
                    hist = hist_of(t, cfg)
                    x = torch.from_numpy(reqs.photo(i)).to(ctx.device)[None].permute(0, 3, 1, 2)
                    outs.append(ref_steps.recolor(m, x, hist, reqs.noise(i))[0])
                ref = outs[0]
                other = outs[1] if tf32 else raw.float()
                image = (other.clamp(0.0, 1.0).permute(1, 2, 0) if tf32
                         else torch.from_numpy(img).to(ctx.device))
                gaps["recolor_gap"] = max(gaps["recolor_gap"], float(
                    (image - ref.clamp(0.0, 1.0).permute(1, 2, 0)).abs().max()))
                gaps["raw_gap"] = max(gaps["raw_gap"], float(
                    (other - ref).abs().max() / ref.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    return gaps
