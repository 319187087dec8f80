"""Sampling cells: a closed loop of requests, as ``histogan --generate``
serves one target: the target's histogram on the device (the CLI's
``sample_target`` through ``image_hist``, the histogram kernel), then
``num_image_tiles``² truncated samples from the EMA generator in chunks of
the traffic's batch, copied to the host. The truncation centre is
computed once in set-up, by the first request. Each request's latents and
noise come from its own stream of the seed.

Once the window has closed, the requests of a sample drawn from the seed
are sampled again by the plain reference from the same target, latents
and noise (and the truncation centre from the same 2000 draws), and the
widest gap of any pixel is compared."""

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
    def __init__(self, ctx):
        cfg, tr = ctx.cfg, ctx.traffic
        self.targets = harness.make_photos(tr["targets"], cfg["image_size"], ctx.seed,
                                           "targets", ctx.device).astype(np.float32) / 255.0
        rng = np.random.default_rng(harness.stream_seed(ctx.seed, "order"))
        self.order = rng.integers(0, tr["targets"], 1 << 16)
        self.n = tr["num_image_tiles"] ** 2
        self.ctx = ctx

    def target(self, i):
        return self.targets[self.order[i % len(self.order)]]

    def draws(self, i):
        """(latents (n, latent), noise (n, S, S, 1)) of request ``i``."""
        cfg, dev = self.ctx.cfg, self.ctx.device
        g = harness.generator(self.ctx.seed, "requests", dev, i)
        z = torch.randn((self.n, cfg["latent_dim"]), generator=g, device=dev)
        s = cfg["image_size"]
        return z, torch.rand((self.n, s, s, 1), generator=g, device=dev)


def build(ctx):
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
    from histogan_tpu_torch.train.trainer import Trainer

    cfg = ctx.cfg
    t = Trainer(name="bench", results_dir=str(ctx.workdir / "results"),
                models_dir=str(ctx.workdir / "models"), image_size=cfg["image_size"],
                network_capacity=cfg["network_capacity"], batch_size=ctx.traffic["batch_size"],
                trunc_psi=cfg["trunc_psi"], hist_method=cfg["hist_method"],
                hist_resizing=cfg["hist_resizing"], hist_sigma=cfg["hist_sigma"],
                hist_bin=cfg["hist_bin"], hist_insz=cfg["hist_insz"],
                latent_dim=cfg["latent_dim"], style_depth=cfg["style_depth"], seed=ctx.seed,
                precision=cfg["precision"], device=str(ctx.device))
    t.init_GAN()
    t.load_state_dict(harness.make_weights(cfg, ctx.seed, ctx.device))
    block = RGBuvHistBlock(insz=cfg["hist_insz"], h=cfg["hist_bin"],
                           resizing=cfg["hist_resizing"], method=cfg["hist_method"],
                           sigma=cfg["hist_sigma"])
    return t, block


def request(ctx, trainer, block, reqs, i):
    from histogan_tpu_torch.cli.histogan import sample_target

    z, noise = reqs.draws(i)
    tiles = ctx.traffic["num_image_tiles"]
    if ctx.fault == "half_batch":  # half of the samples made, the rest repeated
        h = reqs.n // 2
        z, noise = torch.cat([z[:h], z[:h]]), torch.cat([noise[:h], noise[:h]])
    images = sample_target(trainer, block, image=reqs.target(i), num_image_tiles=tiles,
                           samples_name=None, latents=z, n=noise)
    if ctx.fault == "altered":  # an answer altered where it is produced
        images[0, 0, 0, 0] += 0.5 if images[0, 0, 0, 0] < 0.5 else -0.5
    return images


def run(ctx) -> dict:
    tr = ctx.traffic
    reqs = Requests(ctx)
    trainer, block = build(ctx)
    av_state = trainer.gen.get_state()  # the first request draws the truncation centre
    for i in range(tr["warmup_requests"]):
        request(ctx, trainer, block, reqs, WARMUP + i)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - ctx.t0
    lat, elapsed, kept, view = harness.serve(ctx, lambda i: request(ctx, trainer, block, reqs, i),
                                             reqs.n, tr["checked_requests"],
                                             tr["profile_requests"])
    i = len(lat)
    device = harness.device_info(ctx.device)
    del trainer
    harness.free_device_memory()
    gap = reference_gap(ctx, reqs, kept, av_state)
    controls = {c: {"sample_gap": reference_gap(ctx, reqs, kept, av_state, tf32=True)}
                for c in ctx.controls if c == "tf32"}
    checks = harness.judge({"sample_gap": gap}, ctx.limits)
    harness.say(f"window: {i} requests, {i * reqs.n} images in {elapsed:.3f} s; "
                f"setup {setup_s:.3f} s")
    out = {"correct": harness.passed(checks), "attempted": i, "failed": 0,
           "metrics": {"setup_s": setup_s, tr["metric"]: i * reqs.n / elapsed},
           "device": device, "checks": checks, "controls": controls}
    if view is not None:
        out["view"] = view
    return out


def reference_gap(ctx, reqs, kept, av_state, tf32=False) -> float:
    """The widest gap between a kept request's samples and the plain
    reference's (with ``tf32``: the reference in TF32 against itself in
    float32, the control)."""
    cfg, dev = ctx.cfg, ctx.device
    m = ref_models.load_flat(ref_models.build_modules(cfg, "meta"),
                             harness.make_weights(cfg, ctx.seed, dev))
    g = torch.Generator(device=dev)
    g.set_state(av_state)
    z_av = torch.randn((2000, cfg["latent_dim"]), generator=g, device=dev)
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    gap = 0.0
    try:
        with torch.no_grad():
            for i, images in sorted(kept.items()):
                outs = []
                for flag in ((False, True) if tf32 else (False,)):
                    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
                    av = m["SE"](z_av).mean(dim=0, keepdim=True)
                    t = torch.from_numpy(reqs.target(i)).to(dev)[None]
                    hist = hist_of(t, cfg)
                    rows = hist.expand(ctx.traffic["num_image_tiles"], -1, -1, -1)
                    z, noise = reqs.draws(i)
                    outs.append(ref_steps.sample_truncated(m, rows, z, noise, av,
                                                           cfg["trunc_psi"],
                                                           ctx.traffic["batch_size"]))
                other = outs[1] if tf32 else torch.from_numpy(images).to(dev)
                gap = max(gap, float((other - outs[0]).abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    return gap
