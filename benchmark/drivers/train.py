"""Training cells: the window drives the trainer's ``train()``, the body of
the CLI's loop, one step a call, in a job's steady state between saves.

Set-up makes the photos (JPEG files in the run's scratch directory), the
weights (``harness.make_weights``, loaded into the trainer), the trainer
and its data source (the device-resident cache and histogram pool), and
puts the step counter at the traffic's ``start_step``: the first steps then
run every step kind the window runs (for HistoGAN a GP+PL+EMA step), and
the reference follows the first three. Warm-up runs on to the next GP
step, where the window starts; it ends once ``--seconds`` have passed, on
the first step that closes a whole number of the schedule's longest
period (``period``) counted from its start, so that its mix of step kinds
does not depend on the rate it measures.

The comparison with the plain reference (``reference/steps.py``), once the
window has closed and the program's state is freed: each of the first
three steps' losses, each leaf's first gradient (as DiffGrad holds it
after one step), each leaf's change after the first step and after
three, by the norms of the worst leaf, and the batches the data source fed
against the photos. HistoGAN's reference runs its first G phase against
the program's D as that phase found it (``forcing``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import models as ref_models
from benchmark.reference import steps as ref_steps
from benchmark.reference.histogram import hist_of
from benchmark.trace import Profile, TraceView

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's
FAULTS = ("half_batch", "altered")  # planted in the reference put in the program's place
# D's options (histoGAN.py's --attn_layers, --fq_layers, --aug_prob ...), where a
# configuration has them
OPTIONS = ("attn_layers", "fq_layers", "fq_dict_size", "aug_prob", "aug_types")
# histoGAN.py's schedule: the GP every 4th step, the PL every 32nd, the EMA
# every 10th past step 20 000
GP_EVERY, PL_EVERY, EMA_EVERY, EMA_FROM = 4, 32, 10, 20000


def schedule(cfg, step: int):
    """(gp, pl, ema) of step ``step``; reHistoGAN has the GP alone."""
    gp = step % GP_EVERY == 0
    if cfg["model"] != "histogan":
        return gp, False, False
    return gp, step % PL_EVERY == 0, step > EMA_FROM and step % EMA_EVERY == 0


def kind(cfg, step: int) -> str:
    gp, pl, _ = schedule(cfg, step)
    return ("gp" if gp else "") + ("pl" if pl else "")


def period(cfg) -> int:
    """The schedule's longest period in steps: PL's 32 for HistoGAN, the
    GP's 4 for reHistoGAN. Whole periods from a GP step hold each GP and PL
    step kind in its own share, at any rate."""
    return PL_EVERY if cfg["model"] == "histogan" else GP_EVERY


def build_trainer(ctx):
    cfg, tr = ctx.cfg, ctx.traffic
    common = dict(
        name="bench", results_dir=str(ctx.workdir / "results"),
        models_dir=str(ctx.workdir / "models"), image_size=cfg["image_size"],
        network_capacity=cfg["network_capacity"], batch_size=tr["batch_size"],
        gradient_accumulate_every=tr["gradient_accumulate_every"], lr=cfg["learning_rate"],
        save_every=tr["save_every"], hist_method=cfg["hist_method"],
        hist_resizing=cfg["hist_resizing"], hist_sigma=cfg["hist_sigma"],
        hist_bin=cfg["hist_bin"], hist_insz=cfg["hist_insz"], latent_dim=cfg["latent_dim"],
        style_depth=cfg["style_depth"], seed=ctx.seed, precision=cfg["precision"],
        sync_every=tr["sync_every"], device_dataset=tr["device_dataset"],
        device=str(ctx.device))
    if cfg["model"] == "histogan":
        from histogan_tpu_torch.train import trainer as module

        t = module.Trainer(mixed_prob=cfg["mixed_prob"], trunc_psi=cfg["trunc_psi"],
                           **{k: cfg[k] for k in OPTIONS if k in cfg}, **common)
        return t, module, {"alpha": cfg["alpha"]}
    from histogan_tpu_torch.train import rehisto_trainer as module

    t = module.RecoloringTrainer(
        rec_loss=cfg["rec_loss"], variance_loss=cfg["variance_loss"],
        internal_hist=cfg["internal_hist"], skip_conn_to_GAN=cfg["skip_conn_to_GAN"],
        fixed_gan_weights=cfg["fixed_gan_weights"], **common)
    return t, module, {"alpha": cfg["alpha"], "beta": cfg["beta"], "gamma": cfg["gamma"]}


class Recorder:
    """Keeps, for the steps run while it is open, the batch the trainer fed
    its step, the step's random draws and the data source's own draws
    (image indices, histogram pairs and ratios); given ``steps``, the
    module whose ``g_phase`` the step calls (HistoGAN's), also D's state
    dict as the first G phase finds it (``d_at_g``, on the host), which
    ``forcing`` puts in the reference's D."""

    def __init__(self, trainer, module, steps=None):
        from histogan_tpu_torch.data.device_source import DeviceDataSource

        if not isinstance(trainer.loader, DeviceDataSource):
            raise RuntimeError("the training cells expect the device-resident data source")
        self.steps, self.data, self.d_at_g = [], [], None
        self.module, self.inner = module, module.train_step
        self.loader = trainer.loader
        inner_draws = self.loader._draws
        self.phases = steps
        if steps is not None:
            g_phase = self.g_phase = steps.g_phase

            def record_g_phase(state, *args, **kwargs):
                if self.d_at_g is None:  # in host memory: the card's peak stays the program's
                    self.d_at_g = {k: v.detach().to("cpu", copy=True)
                                   for k, v in state.D.state_dict().items()}
                return g_phase(state, *args, **kwargs)

            steps.g_phase = record_g_phase

        def data_draws():
            d = inner_draws()
            self.data.append({k: np.array(v, copy=True) for k, v in d.items()})
            return d

        def train_step(state, batch, draws, cfg, *args, **kwargs):
            self.steps.append({"batch": {k: v.detach().clone() for k, v in batch.items()},
                               "draws": copy.deepcopy(dataclasses.asdict(draws))})
            return self.inner(state, batch, draws, cfg, *args, **kwargs)

        self.loader._draws = data_draws
        module.train_step = train_step

    def close(self):
        self.module.train_step = self.inner
        del self.loader._draws
        if self.phases is not None:
            self.phases.g_phase = self.g_phase


def named_parameters(trainer) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p for k, m in trainer.state.modules().items()
            for n, p in m.named_parameters()}


def first_gradients(trainer) -> Dict[str, float]:
    """Each optimised leaf's gradient norm as DiffGrad holds it after one
    step (its previous gradient); NaN where it holds none."""
    s = trainer.state
    names = {id(p): k for k, p in named_parameters(trainer).items()}
    norms, keys = [], []
    for opt in (s.opt_d, s.opt_g):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                keys.append(names[id(p)])
                norms.append(st["previous_grad"].float().norm() if "previous_grad" in st
                             else torch.tensor(float("nan"), device=p.device))
    return dict(zip(keys, torch.stack(norms).tolist()))


def changes(params: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(start)
    with torch.no_grad():
        vals = torch.stack([(params[k].detach().float() - start[k]).norm() for k in keys])
    return dict(zip(keys, vals.tolist()))


def plant(ctx, trainer, module):
    """A fault planted in the program's step (the tests of the check).
    Returns what takes it out again."""
    if ctx.fault is None:
        return lambda: None
    if ctx.fault == "frozen":  # the step returns its state unchanged
        for opt in (trainer.state.opt_d, trainer.state.opt_g):
            opt.step = lambda closure=None: None
        if hasattr(trainer.state, "update_ema"):
            trainer.state.update_ema = lambda beta=0.995: None
        return lambda: None
    if ctx.fault == "half_batch":  # half of the batch left out, the mean over the rest
        inner = module.train_step

        def half(state, batch, draws, cfg, *args, **kwargs):
            b = batch["d_images"].shape[1] // 2
            batch = {k: v[:, :b] for k, v in batch.items()}
            return inner(state, batch, _half_draws(draws, b),
                         dataclasses.replace(cfg, batch_size=b), *args, **kwargs)

        module.train_step = half

        def undo():
            module.train_step = inner
        return undo
    if ctx.fault == "altered":  # the D phase's first leaf gets twice its gradient
        from histogan_tpu_torch.train import rehisto_steps, steps

        inner = steps._update

        def update(opt, params, grads, accum):
            if opt is trainer.state.opt_d:
                grads[0] = grads[0] * 2.0
            return inner(opt, params, grads, accum)

        steps._update = update
        rehisto_steps._update = update

        def undo():
            steps._update = rehisto_steps._update = inner
        return undo
    raise ValueError(f"unknown fault {ctx.fault!r}")


def _half_draws(draws, b):
    def cut(x):
        return x[:b] if torch.is_tensor(x) and x.dim() > 0 else x

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return cut(x)

    return walk(draws)


def setup(ctx, make_weights=harness.make_weights, watch=None):
    """The trainer at ``start_step`` with the benchmark's weights
    (``make_weights``) and data, its first steps run and read, warmed up to
    the window. ``watch``, where given, is made beside the Recorder over
    the first steps, and the readings its ``first()`` gives after the
    first step join the others. Returns (trainer, train kwargs, readings,
    the Recorder of the first steps, the closed watch or None, what takes
    a planted fault out)."""
    from histogan_tpu_torch.train import steps

    cfg, tr = ctx.cfg, ctx.traffic
    photos = harness.make_photos(tr["dataset_images"], cfg["image_size"], ctx.seed, "photos",
                                 ctx.device)
    folder = ctx.workdir / "photos"
    harness.write_jpegs(photos, folder)
    flat = make_weights(cfg, ctx.seed, ctx.device)
    trainer, module, kw = build_trainer(ctx)
    trainer.init_GAN()
    trainer.load_state_dict(flat)
    histogan = cfg["model"] == "histogan"
    if histogan:
        trainer.set_data_src(str(folder))
    else:
        trainer.set_data_src(str(folder), sampling=cfg["sampling"])
    trainer.steps = trainer.state.step = tr["start_step"]
    unplant = plant(ctx, trainer, module)

    start = {k: flat[k] for k in named_parameters(trainer)}
    del flat
    rec = Recorder(trainer, module, steps if histogan else None)
    seen = watch() if watch is not None else None
    readings = {"losses": []}
    try:
        for i in range(tr["checked_steps"]):
            readings["losses"].append(trainer.train(**kw))
            if i == 0:
                readings.update(grad1=first_gradients(trainer),
                                change1=changes(named_parameters(trainer), start),
                                **(seen.first() if seen is not None else {}))
    finally:
        rec.close()
        if seen is not None:
            seen.close()
    readings["change"] = changes(named_parameters(trainer), start)
    del start
    while trainer.steps % GP_EVERY:  # warm-up to the next GP step: the window's start
        trainer.train(**kw)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return trainer, kw, readings, rec, seen, unplant


def window(ctx, trainer, kw):
    """Steps from the GP step set-up ends on, until ``--seconds`` have
    passed and the steps taken are a whole number of ``period``s. For
    HistoGAN every 32 steps then hold one PL step and eight GP steps, and
    three EMA steps (each 10th) in each of the first three periods, so
    that a run slightly faster or slower than another runs the same mix.
    Traced, the ``profile_cycles`` GP cycles from the first GP step past a
    third of ``--seconds`` whose steps hold no PL step are profiled, and
    the window runs on past them. Returns (steps, seconds, view or None)."""
    tr, cfg = ctx.traffic, ctx.cfg
    profiled = GP_EVERY * tr["profile_cycles"]
    prof, prof_steps, prof_kinds = None, 0, []
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda *a: None)
    n = 0
    start = time.monotonic()
    while True:
        if (ctx.trace and prof is None and prof_steps == 0 and trainer.steps % GP_EVERY == 0
                and time.monotonic() - start >= ctx.seconds / 3
                and not any(schedule(cfg, trainer.steps + j)[1] for j in range(profiled))):
            prof = Profile()
            prof.start()
        if prof is not None:
            prof_kinds.append(kind(cfg, trainer.steps))
        trainer.train(**kw)
        n += 1
        if prof is not None:
            prof_steps += 1
            if prof_steps == profiled:
                path = prof.stop(ctx.workdir / "trace.json")
                prof = None
        if n % period(cfg) == 0 and time.monotonic() - start >= ctx.seconds \
                and (not ctx.trace or prof_steps >= profiled):
            break
    sync()
    elapsed = time.monotonic() - start
    view = None
    if ctx.trace:
        imgs = prof_steps * tr["batch_size"] * tr["gradient_accumulate_every"]
        view = TraceView(path, prof_kinds, imgs)
    return n, elapsed, view


def own_data(ctx, indices):
    """{index: uint8 image} decoded from the run's JPEG files, and {index:
    histogram} of each, by the plain reference."""
    folder = ctx.workdir / "photos"
    images = {int(i): torch.from_numpy(harness.read_jpeg(folder / f"{int(i):05d}.jpg")).to(
        ctx.device) for i in sorted(set(int(i) for i in indices))}
    pool = {}
    keys = sorted(images)
    for s in range(0, len(keys), 64):
        chunk = keys[s:s + 64]
        x = torch.stack([images[k] for k in chunk]).float() / 255.0
        pool.update(zip(chunk, hist_of(x, ctx.cfg)))
    return images, pool


def reference_batch(ctx, d, images, pool):
    """The batch of one step from the data source's draws."""
    a, b = ctx.traffic["gradient_accumulate_every"], ctx.traffic["batch_size"]
    dev = ctx.device

    def imgs(idx):
        return torch.stack([images[int(i)] for i in idx]).reshape(a, b, *images[int(idx[0])].shape)

    def hists(part):
        if f"{part}_pair" not in d:  # each image's own histogram
            return torch.stack([pool[int(i)] for i in d[f"{part}_idx"]]).reshape(
                a, b, *pool[int(d[f"{part}_idx"][0])].shape)
        r = torch.from_numpy(d[f"{part}_r"]).to(dev)
        h = ref_steps.pool_interp(pool, d[f"{part}_pair"], r)
        return h.reshape(a, b, *h.shape[1:])

    batch = {"d_images": imgs(d["d_idx"]), "d_hists": hists("d"), "g_hists": hists("g")}
    if "g_idx" in d:
        batch["g_images"] = imgs(d["g_idx"])
    return batch


def forcing(rec, start, own):
    """The ``between`` hook of the reference's first step: teacher forcing.
    It notes the reference's own D change after its first D update (from
    ``start``) in ``own['change']``, then loads the program's D as the
    program's first G phase found it (``rec.d_at_g``) in place of the
    reference's. DiffGrad's first update moves each weight by about a
    learning rate in the sign of its gradient, and where a gradient is near
    0 that sign follows the order of cuDNN's sums: without the forcing D's
    output on G's images (``g_loss``) and G's gradients through it differ
    between two correct sides by more than rounding. The D update that the
    forcing skips is read by itself: D's first gradient and its change
    after that update against the reference's own (``compare``'s
    ``dgrad1_gap``, ``dchange1_gap``)."""
    def force(m):
        own["change"] = changes({f"D.{n}": p for n, p in m["D"].named_parameters()},
                                {k: v for k, v in start.items() if k.startswith("D.")})
        m["D"].load_state_dict(rec.d_at_g)
    return force


def reference_readings(ctx, rec, tf32=False, fault=None):
    """The reference's readings over the recorded steps, run on the
    device in float32 (with ``tf32`` in TF32: the control), with a
    ``fault`` planted in it where the check's faults are read; HistoGAN's
    first G phase forced to the program's D (``forcing``)."""
    cfg, tr = ctx.cfg, ctx.traffic
    idx = np.concatenate([np.ravel(d[k]) for d in rec.data for k in d
                          if k.endswith(("idx", "pair"))])
    images, pool = own_data(ctx, idx)
    flat = harness.make_weights(cfg, ctx.seed, ctx.device)
    start = {k: v.clone() for k, v in flat.items()}
    m = ref_models.load_flat(ref_models.build_modules(cfg, "meta"), flat)
    d_params = list(m["D"].parameters())
    histogan = cfg["model"] == "histogan"
    g_side = ("S", "H", "G") if histogan else ("ED", "H", "G")
    g_params = [p for k in g_side for p in m[k].parameters()]
    opt_d = ref_steps.DiffGrad(d_params, cfg["learning_rate"])
    opt_g = ref_steps.DiffGrad(g_params, cfg["learning_rate"])
    pl_mean = torch.zeros((), device=ctx.device)
    own = {}
    force = forcing(rec, start, own) if histogan else None
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    losses, feed_gap, grad1, change1 = [], 0.0, {}, {}
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
            gout = {} if i == 0 or fault == "altered" else None
            if histogan:
                metrics, pl_mean = _histogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, pl,
                                                  ema, pl_mean, gout, fault,
                                                  force if i == 0 else None)
                metrics["pl_mean"] = pl_mean
            else:
                metrics = _rehisto_step(m, opt_d, opt_g, batch, draws, cfg, gp, gout, fault)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                names = [f"D.{n}" for n, _ in m["D"].named_parameters()] + [
                    f"{k}.{n}" for k in g_side for n, _ in m[k].named_parameters()]
                norms = torch.stack([g.norm() for g in gout["D"] + gout["G"]]).tolist()
                grad1 = dict(zip(names, norms))
                change1 = dict(changes(parameters_of(m), start), **own.get("change", {}))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    return {"losses": losses, "grad1": grad1, "change": changes(parameters_of(m), start),
            "change1": change1, "feed_gap": feed_gap}


def parameters_of(m) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p for k, mod in m.items() for n, p in mod.named_parameters()}


def _histogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, pl, ema, pl_mean, gout, fault,
                   between):
    if fault != "altered":
        return ref_steps.histogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, pl, ema, pl_mean,
                                       gout, between)
    inner = opt_d.step
    opt_d.step = lambda grads: inner([grads[0] * 2.0] + list(grads[1:]))
    try:
        out = ref_steps.histogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, pl, ema, pl_mean,
                                      gout, between)
    finally:
        opt_d.step = inner
    gout["D"][0] = gout["D"][0] * 2.0
    return out


def _rehisto_step(m, opt_d, opt_g, batch, draws, cfg, gp, gout, fault):
    if fault != "altered":
        return ref_steps.rehistogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, gout)
    inner = opt_d.step
    opt_d.step = lambda grads: inner([grads[0] * 2.0] + list(grads[1:]))
    try:
        out = ref_steps.rehistogan_step(m, opt_d, opt_g, batch, draws, cfg, gp, gout)
    finally:
        opt_d.step = inner
    gout["D"][0] = gout["D"][0] * 2.0
    return out


def compare(prog, ref) -> Dict[str, float]:
    """The compared numbers of a training cell:
    - loss1_gap, loss_gap: the first step's each loss, and each step's,
      |p - r| / max(|r|, 1), the worst;
    - grad1_gap: each leaf's first gradient norm, |p - r| / max(r, the
      median leaf's), the worst, over the leaves whose reference gradient
      is at least GRAD_FLOOR of the median leaf's; dgrad1_gap and
      ggrad1_gap the same over D's leaves alone and over the others alone;
    - change_gap, change1_gap: each leaf's change after three steps and
      after the first, the same way over grad1_gap's leaves (an EMA leaf
      by its live leaf's gradient); dchange1_gap the latter over D's
      leaves alone: D's first update, the stage that HistoGAN's forcing
      skips, against the reference's own;
    - feed_gap: the largest difference, in uint8 levels, between a batch's
      image and the photo it was drawn from.
    A cell's limits name the numbers it compares; the others are
    readings. HistoGAN's cells hold G's side (``ggrad1_gap``, and
    ``change1_gap`` beyond D's ``dchange1_gap``) as readings: at the
    published initialisation some seeds draw a first G gradient that two
    correct float32 sides, the reference with and without cuDNN among
    them, give apart by from a few hundredths to a half."""
    def worst_loss(pairs):
        gaps = [abs((p or {}).get(k, math.nan) - rv) / max(abs(rv), 1.0)
                for p, r in pairs for k, rv in r.items()]
        return max(gaps) if all(math.isfinite(x) for x in gaps) else math.nan

    def kept(grads):
        med = float(np.median(list(grads.values())))
        return {k for k, v in grads.items() if v >= GRAD_FLOOR * med}

    def grad_gap(keys):
        return _worst({k: prog["grad1"].get(k, math.nan) for k in keys},
                      {k: ref["grad1"][k] for k in keys})

    def live(k):
        prefix, _, rest = k.partition(".")
        return f"{harness.EMA_OF.get(prefix, prefix)}.{rest}"

    def changed(name, over=max, prefix=""):
        ck = [k for k in ref[name] if live(k) in leaves and k.startswith(prefix)]
        return _worst({k: prog[name].get(k, math.nan) for k in ck},
                      {k: ref[name][k] for k in ck}, over)

    pairs = list(zip(prog["losses"], ref["losses"]))
    g = ref["grad1"]
    leaves = kept(g)
    return {"loss1_gap": worst_loss(pairs[:1]), "loss_gap": worst_loss(pairs),
            "grad1_gap": grad_gap(leaves),
            "dgrad1_gap": grad_gap(kept({k: v for k, v in g.items() if k.startswith("D.")})),
            "ggrad1_gap": grad_gap(kept({k: v for k, v in g.items()
                                         if not k.startswith("D.")})),
            "change_gap": changed("change"), "change1_gap": changed("change1"),
            "dchange1_gap": changed("change1", prefix="D."),
            "change_med_gap": changed("change", np.median),
            "feed_gap": ref.get("feed_gap", 0.0)}


def _worst(prog: Dict[str, float], ref: Dict[str, float], over=max) -> float:
    """Each module's (the prefix of a key's) leaves' gaps, each against
    the larger of the leaf's reference norm and the module's median leaf's,
    so that the EMA's small moves are judged among themselves; ``over``
    (the worst leaf, or with ``np.median`` the median leaf) of each module,
    and the worst module."""
    worst = 0.0
    for prefix in {k.partition(".")[0] for k in ref}:
        mine = {k: v for k, v in ref.items() if k.partition(".")[0] == prefix}
        med = float(np.median(list(mine.values())))
        gaps = [abs(prog[k] - r) / max(r, med) for k, r in mine.items()]
        if not all(math.isfinite(g) for g in gaps):
            return math.nan
        worst = max(worst, float(over(gaps)))
    return worst


def run(ctx) -> dict:
    tr = ctx.traffic
    trainer, kw, readings, rec, _, unplant = setup(ctx)
    setup_s = time.monotonic() - ctx.t0
    n, elapsed, view = window(ctx, trainer, kw)
    device = harness.device_info(ctx.device)
    unplant()
    trainer.close()
    del trainer
    harness.free_device_memory()
    ref = reference_readings(ctx, rec)
    values = compare(readings, ref)
    checks = harness.judge(values, ctx.limits)
    # the control, the faults, and the reference run again (the card's own
    # spread between two float32 runs), each in the program's place
    controls = {c: compare(reference_readings(ctx, rec, tf32=c == "tf32",
                                              fault=c if c in FAULTS else None), ref)
                for c in ctx.controls}
    imgs = n * tr["batch_size"] * tr["gradient_accumulate_every"]
    harness.say(f"window: {n} steps, {imgs} images in {elapsed:.3f} s; setup {setup_s:.3f} s")
    out = {"correct": harness.passed(checks), "attempted": n, "failed": 0,
           "metrics": {"setup_s": setup_s,
                       tr["metric"]: imgs / elapsed},
           "device": device, "checks": checks, "readings": values, "controls": controls}
    if view is not None:
        out["view"] = view
    return out
