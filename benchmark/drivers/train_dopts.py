"""Training cells with the discriminator's options (``attn_layers``,
``fq_layers``, ``aug_prob``): ``drivers/train.py``'s window, checks and
faults, on a trainer built with the options, weights that add the
attention and the codebook, and the reference of ``reference/d_options.py``.

Set-up is ``train.setup``'s (its Recorder keeps D, its parameters and
codebook, as the first G phase finds it), and besides it records, over
the first steps, the program's nearest code of every row of every VQ call
(``VectorQuantize.nearest``) and the codebook each call of the first step
finds. The reference follows the recorded steps, their augmentation draws
included, from the same weights and codebook; where its nearest code for
a row differs from the program's within the rounding of the distance
(``d_options.pin_margin``) it takes the program's. Its first G phase runs
against the program's D, loaded in place of its own after its D update
(``train.forcing``): without the forcing D's output on G's images
(``g_loss``) and G's gradients through it would differ by up to a few
hundredths between two correct sides.

The numbers are those of ``train.compare`` (``loss1_gap``, ``g_loss`` the
forced G phase's; ``dgrad1_gap``; ``dchange1_gap``, D's first update
against the reference's own) and ``code1_gap`` (``code_gap``), the codebook
as each VQ call of the first step found it, the G phase's call by the
reference's own codebook. The later steps part
the two sides by more than rounding, the forced D's update included: the
EMA codebook, whose used codes have become the means of the rows they
took, leaves many rows near two codes, so that a tenth of the later
steps' rows and more change codes, in the reference run twice as well,
and the change after three steps differs by up to a fifth of a leaf's
change on both. Readings: ``vq_pinned`` (rows that took the program's
code), ``vq_flipped1`` and ``vq_flipped`` (rows whose codes differ beyond
the margin, in the first step and in all). Which numbers the check
compares is the cell's ``limits/<cell>.json``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers.train import (FAULTS, _half_draws, changes, compare, forcing, own_data,
                                     parameters_of, reference_batch, schedule, setup, window)
from benchmark.reference import d_options
from benchmark.reference import steps as ref_steps


def make_weights(cfg, seed: int, device):
    """``harness.make_weights``' state dict, the same draw, and D's options:
    from index 1 of the weights stream the attention's convs N(0, 2 /
    fan_in), ``to_out``'s bias U(+-1/sqrt(fan_in)) and each Rezero ``g``
    U(0.5, 1); from index 2 each codebook N(0, 1), ``embed_avg`` a copy and
    no counts."""
    flat = harness.make_weights(cfg, seed, device)
    mods = d_options.build_modules(cfg, "meta")
    extra = [(f"D.{n}", tuple(p.shape)) for n, p in mods["D"].named_parameters()
             if f"D.{n}" not in flat]
    g = harness.generator(seed, "weights", device, 1)
    for k, s in extra:
        if k.endswith(".g"):
            flat[k] = 0.5 + 0.5 * torch.rand(s, generator=g, device=device)
        elif len(s) >= 2:
            std = math.sqrt(2.0 / math.prod(s[1:]))
            flat[k] = torch.randn(s, generator=g, device=device) * std
        else:
            fan_in = math.prod(dict(extra)[k[: -len("bias")] + "weight"][1:])
            flat[k] = (torch.rand(s, generator=g, device=device) * 2.0 - 1.0) / math.sqrt(fan_in)
    g = harness.generator(seed, "weights", device, 2)
    for q in (n for n, m in mods["D"].named_modules() if isinstance(m, d_options.VectorQuantize)):
        embed = torch.randn(tuple(mods["D"].get_submodule(q).embed.shape), generator=g,
                            device=device)
        flat[f"D.{q}.embed"] = embed
        flat[f"D.{q}.cluster_size"] = torch.zeros(embed.shape[1], device=device)
        flat[f"D.{q}.embed_avg"] = embed.clone()
    return flat


def parameter_keys(cfg):
    mods = d_options.build_modules(cfg, "meta")
    return [f"{p}.{n}" for p, m in mods.items() for n, _ in m.named_parameters()]


def codebook_of(vq):
    return {"embed": vq.embed.detach().clone(), "cluster_size": vq.cluster_size.detach().clone()}


class CodeRecorder:
    """Keeps, while open, the program's nearest codes of every VQ call
    (``codes``) and the codebook each call finds (``seen``); ``first()``,
    called after the first step, gives that step's codebooks (``seen1``)."""

    def __init__(self):
        from histogan_tpu_torch.models.vq import VectorQuantize

        self.cls, self.saved = VectorQuantize, (VectorQuantize.__dict__["nearest"],
                                                VectorQuantize.forward)
        self.codes, self.seen = [], []
        nearest, forward = self.saved[0].__func__, self.saved[1]

        def record_nearest(dist):
            idx = nearest(dist)
            self.codes.append(idx.detach().clone())
            return idx

        def record_forward(vq, x, train_stats=False):
            self.seen.append(codebook_of(vq))
            return forward(vq, x, train_stats)

        VectorQuantize.nearest = staticmethod(record_nearest)
        VectorQuantize.forward = record_forward

    def first(self) -> dict:
        return {"seen1": list(self.seen)}

    def close(self):
        self.cls.nearest, self.cls.forward = self.saved


def reference_readings(ctx, rec, codes, tf32=False, fault=None):
    """``train.reference_readings`` on ``reference/d_options.py``, the
    program's codes (``codes``, the CodeRecorder) pinned within the margin
    and its D at the first G phase (``rec.d_at_g``) taken in place of the
    reference's."""
    cfg, tr = ctx.cfg, ctx.traffic
    idx = np.concatenate([np.ravel(d[k]) for d in rec.data for k in d
                          if k.endswith(("idx", "pair"))])
    images, pool = own_data(ctx, idx)
    flat = make_weights(cfg, ctx.seed, ctx.device)
    keys = parameter_keys(cfg)
    start = {k: flat[k].clone() for k in keys}
    m = d_options.load_flat(d_options.build_modules(cfg, "meta"), flat)
    del flat
    quantizers = m["D"].quantizers()
    pins, seen = list(codes.codes), []
    for q in quantizers:
        q.pins, q.seen = pins, seen
    d_params = list(m["D"].parameters())
    g_params = [p for k in ("S", "H", "G") for p in m[k].parameters()]
    opt_d = ref_steps.DiffGrad(d_params, cfg["learning_rate"])
    opt_g = ref_steps.DiffGrad(g_params, cfg["learning_rate"])
    if fault == "altered":  # the first D leaf gets twice its gradient
        inner = opt_d.step
        opt_d.step = lambda grads: inner([grads[0] * 2.0] + list(grads[1:]))
    pl_mean = torch.zeros((), device=ctx.device)
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    losses, feed_gap, grad1, flipped1, change1 = [], 0.0, {}, 0, {}
    own = {}
    force_d = forcing(rec, start, own)

    def force(m):  # the reference's own codebooks noted too
        own["seen"] = [(len(seen) + j, codebook_of(q)) for j, q in enumerate(quantizers)]
        force_d(m)
    try:
        for i, (step, data) in enumerate(zip(rec.steps, rec.data)):
            batch = reference_batch(ctx, data, images, pool)
            for k in ("d_images", "g_images"):
                if k in batch:
                    diff = (step["batch"][k].int() - batch[k].int()).abs().max()
                    feed_gap = max(feed_gap, float(diff))
            draws = step["draws"]
            if fault == "half_batch":
                b = tr["batch_size"] // 2
                batch = {k: v[:, :b] for k, v in batch.items()}
                draws = _half_draws(draws, b)
            gp, pl, ema = schedule(cfg, tr["start_step"] + i)
            gout = {} if i == 0 else None
            metrics, pl_mean = d_options.histogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, pl,
                                                       ema, pl_mean, gout,
                                                       force if i == 0 else None)
            metrics["pl_mean"] = pl_mean
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                if fault == "altered":
                    gout["D"][0] = gout["D"][0] * 2.0
                names = [f"D.{n}" for n, _ in m["D"].named_parameters()] + [
                    f"{k}.{n}" for k in ("S", "H", "G") for n, _ in m[k].named_parameters()]
                norms = torch.stack([g.norm() for g in gout["D"] + gout["G"]]).tolist()
                grad1 = dict(zip(names, norms))
                flipped1 = sum(q.flipped for q in quantizers)
                for q in quantizers:
                    q.seen = None
                for j, book in own["seen"]:
                    seen[j] = book
                change1 = dict(changes(parameters_of(m), start), **own["change"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    return {"losses": losses, "grad1": grad1, "change": changes(parameters_of(m), start),
            "change1": change1, "feed_gap": feed_gap, "seen1": seen,
            "vq_pinned": sum(q.pinned for q in quantizers), "vq_flipped1": flipped1,
            "vq_flipped": sum(q.flipped for q in quantizers)}


def code_gap(prog_seen, ref_seen) -> float:
    """Each code the reference has used (a count above 0), as each VQ call
    of the first step found it: |program - reference| / |reference| of the
    code vector, the worst."""
    if len(prog_seen) != len(ref_seen):
        return math.nan
    worst = 0.0
    for p, r in zip(prog_seen, ref_seen):
        used = r["cluster_size"] > 0
        if bool(used.any()):
            e = r["embed"][:, used]
            gap = (p["embed"][:, used] - e).norm(dim=0) / e.norm(dim=0).clamp_min(1e-30)
            worst = max(worst, float(gap.max()))
    return worst


def compare_dopts(prog, ref, vq) -> dict:
    """``train.compare``'s numbers, ``code1_gap``, and the VQ readings of
    ``vq`` (the reference run pinned to the program's codes: ``ref``, or a
    control in the program's place)."""
    out = compare(prog, ref)
    out["code1_gap"] = code_gap(prog["seen1"], ref["seen1"])
    for k in ("vq_pinned", "vq_flipped1", "vq_flipped"):
        out[k] = vq[k]
    return out


def run(ctx) -> dict:
    tr = ctx.traffic
    trainer, kw, readings, rec, codes, unplant = setup(ctx, make_weights, CodeRecorder)
    setup_s = time.monotonic() - ctx.t0
    n, elapsed, view = window(ctx, trainer, kw)
    device = harness.device_info(ctx.device)
    unplant()
    trainer.close()
    del trainer
    harness.free_device_memory()
    ref = reference_readings(ctx, rec, codes)
    values = compare_dopts(readings, ref, ref)
    checks = harness.judge(values, ctx.limits)
    # the control, the faults, and the reference run again, each in the
    # program's place
    controls = {}
    for c in ctx.controls:
        other = reference_readings(ctx, rec, codes, tf32=c == "tf32",
                                   fault=c if c in FAULTS else None)
        controls[c] = compare_dopts(other, ref, other)
        del other
        harness.free_device_memory()
    imgs = n * tr["batch_size"] * tr["gradient_accumulate_every"]
    harness.say(f"window: {n} steps, {imgs} images in {elapsed:.3f} s; setup {setup_s:.3f} s")
    out = {"correct": harness.passed(checks), "attempted": n, "failed": 0,
           "metrics": {"setup_s": setup_s, tr["metric"]: imgs / elapsed},
           "device": device, "checks": checks, "readings": values, "controls": controls}
    if view is not None:
        out["view"] = view
    return out
