"""The port's GAN inversion (histogan_tpu_torch.projection) against the
JAX package's (histogan_tpu.projection), on the CPU.

One JAX Trainer holds random weights (a distinct EMA, which drives
projection); the port's Trainer takes them through the bridge. The port's
random draws (``projection._draws``) are pinned to the JAX package's
``PRNGKey(seed)`` draws. Tolerances: the helpers and ``_forward`` 2e-5;
the losses of each Adam step 1e-4 relative; after the first step, the
variables wherever the gradient's sign is settled (chip_smoke.py's rule
for a first optimizer step); the recolor of a JAX-written ``_final.npz``
2e-5.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from histogan_tpu import projection as jax_projection
from histogan_tpu.models import Discriminator as JaxDiscriminator
from histogan_tpu.models import Generator as JaxGenerator
from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import StyleVectorizer as JaxStyleVectorizer
from histogan_tpu.train import Trainer as JaxTrainer
from histogan_tpu.train import convert as jax_convert
from histogan_tpu.train.state import HistoGANState
from histogan_tpu_torch import projection
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.train.trainer import Trainer
from test_torch_models import random_params

torch.set_num_threads(1)

SMALL = dict(image_size=32, network_capacity=4, latent_dim=32, style_depth=2, hist_bin=64,
             hist_resizing="interpolation", batch_size=2, seed=0)
NAME = "proj"
ATOL = 2e-5
LOSS_RTOL = 1e-4
LR = 0.05
# After Adam's first step an entry moves by -lr * g / (|g| + 1e-8). Where
# |g_jax| exceeds its tensor's port-vs-JAX gradient gap the sign of g is
# the same on both sides; there the two may differ by fp32 rounding
# (PARAM_CLOSE) and lr times the two moves' difference. At least
# SETTLED_MIN of the entries must be settled.
PARAM_CLOSE = 1e-6
SETTLED_MIN = 0.5
STEP_KW = dict(num_train_steps=3, learning_rate=LR, save_every=1, log_every=1,
               vgg_loss_weight=0.0, noise_reg_weight=0.5, style_reg_weight=0.5,
               optimize_noise=True)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """A JAX Trainer with random weights, set as init_GAN sets them
    (without its eager flax inits)."""
    root = tmp_path_factory.mktemp("jax_projection")
    t = JaxTrainer(name=NAME, results_dir=str(root / "r"), models_dir=str(root / "m"),
                   num_devices=1, **SMALL)
    cfg = t.cfg
    t.S = JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth)
    t.H = JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth)
    t.G = JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity, cfg.transparent)
    nl, size = cfg.num_layers, cfg.image_size
    args = {"S": (jnp.zeros((1, cfg.latent_dim)),),
            "H": (jnp.zeros((1, 3, cfg.hist_bin, cfg.hist_bin)),),
            "G": (jnp.zeros((1, nl - 2, cfg.latent_dim)), jnp.zeros((1, 2, cfg.latent_dim)),
                  jnp.zeros((1, size, size, 1)))}

    def params(seed):
        return {k: random_params(getattr(t, k), seed + i, *args[k]) for i, k in enumerate("SHG")}

    t.state = HistoGANState(
        step=jnp.zeros((), jnp.int32), params_g=params(0),
        params_d=random_params(JaxDiscriminator(size, cfg.network_capacity), 5,
                               jnp.zeros((1, size, size, 3))),
        ema=params(10), opt_g=None, opt_d=None, pl_mean=jnp.zeros(()))
    return t


def _port(jax_trainer, root, **kw):
    t = Trainer(name=NAME, results_dir=str(root / "r"), models_dir=str(root / "m"),
                device="cpu", **SMALL, **kw)
    t.init_GAN()
    sd = convert.state_dict_from_jax(jax_convert.bundle_from_trainer(jax_trainer))
    assert t.load_state_dict(sd) == []
    return t


@pytest.fixture(scope="module")
def port_trainer(jax_trainer, tmp_path_factory):
    return _port(jax_trainer, tmp_path_factory.mktemp("port_projection"))


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    path = tmp_path_factory.mktemp("photo") / "input.jpg"
    rng = np.random.RandomState(0)
    arr = np.zeros((40, 40, 3), np.uint8)
    arr[:, :20] = [200, 80, 40]
    arr[:, 20:] = [40, 80, 200]
    Image.fromarray(np.clip(arr + rng.randint(0, 30, arr.shape), 0, 255).astype(np.uint8)
                    ).save(path)
    return str(path)


def jax_draws(kind):
    """``projection._draws`` with the JAX package's numbers: a projection
    splits PRNGKey(seed) into the latent's and the noise's keys; the
    recolor draws its noise from the key itself and its random styles
    from fold_in(key, 1)."""
    def draws(seed, latent_dim, image_size):
        key = jax.random.PRNGKey(seed)
        shape = (1, image_size, image_size, 1)
        if kind == "project":
            k1, k2 = jax.random.split(key)
            z, noise = jax.random.normal(k1, (1, latent_dim)), jax.random.uniform(k2, shape)
            z_random = z
        else:
            noise = jax.random.uniform(key, shape)
            z = z_random = jax.random.normal(jax.random.fold_in(key, 1), (1, latent_dim))
        return {k: torch.from_numpy(np.array(v)) for k, v in
                (("z", z), ("noise", noise), ("z_random_styles", z_random))}
    return draws


def _named(tree) -> dict:
    """{npz key: array} of a variables dict (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (list, tuple)):
            stem = "torgb_style" if k == "torgb" else k
            out.update({f"{stem}_{i}": np.asarray(x.detach() if torch.is_tensor(x) else x)
                        for i, x in enumerate(v)})
        else:
            out[k] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


LOG = re.compile(r"Optimization step (\d+), rec. loss = (\S+), vgg loss = (\S+), "
                 r"rec. noise reg loss = (\S+), style reg loss = (\S+)")


def _losses(out: str) -> np.ndarray:
    return np.array([[float(x) for x in m.groups()] for m in LOG.finditer(out)])


@pytest.fixture(scope="module", params=[("gaussian", False), ("gaussian", True),
                                        ("latent", False), ("latent", True)],
                ids=["gaussian-in_noise", "gaussian-latent_noise", "latent-in_noise",
                     "latent-latent_noise"])
def runs(request, jax_trainer, port_trainer, photo, tmp_path_factory):
    """Three Adam steps of one mode in both packages from the same weights
    and draws: {package: (out_dir, printed losses, step-0 gradients)}."""
    mode, latent_noise = request.param
    root = tmp_path_factory.mktemp(f"run_{mode}_{latent_noise}")
    mp = pytest.MonkeyPatch()
    jax_grads, port_grads = [], {}
    real_adam = optax.adam

    def recording_adam(lr):
        tx = real_adam(lr)

        def update(g, s, p=None):
            jax.debug.callback(lambda g: jax_grads.append(_named(g)), g)
            return tx.update(g, s, p)

        return optax.GradientTransformation(tx.init, update)

    real_run = projection._run_optimization

    def recording_run(loss_fn, optimizer, variables, n, log_every, save_every, on_log,
                      on_save, **kw):
        def log(t, aux):  # after step t's update; .grad holds step t's gradient
            if t == 0:
                port_grads.update(_named({k: ([x.grad for x in v] if isinstance(v, list)
                                              else v.grad) for k, v in variables.items()}))
            on_log(t, aux)
        return real_run(loss_fn, optimizer, variables, n, log_every, save_every, log, on_save,
                        **kw)

    mp.setattr(optax, "adam", recording_adam)
    mp.setattr(projection, "_run_optimization", recording_run)
    mp.setattr(projection, "_draws", jax_draws("project"))
    out = {}
    try:
        for name, pkg, t in (("jax", jax_projection, jax_trainer),
                             ("port", projection, port_trainer)):
            fn = pkg.project_gaussian if mode == "gaussian" else pkg.project_to_latent
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                d = fn(t, photo, results_dir=str(root / name), latent_noise=latent_noise,
                       **STEP_KW)
            out[name] = (d, _losses(buf.getvalue()))
    finally:
        mp.undo()
    out["jax"] += (jax_grads[0],)
    out["port"] += (port_grads,)
    return mode, latent_noise, out


def test_helpers_match_jax(jax_trainer, port_trainer):
    ema, G = jax_trainer.state.ema, port_trainer.GE
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((1, SMALL["latent_dim"]), dtype=np.float32)
    noise = rng.random((1, 32, 32, 1), dtype=np.float32)
    spatials = projection.block_spatials(32, 4)
    assert spatials == jax_projection.block_spatials(32, 4) == [4, 8, 16, 32]
    with torch.no_grad():
        for i, s in enumerate(spatials):
            want = jax_projection.block_styles_from_latent(ema["G"], i, jnp.asarray(latent))
            got = projection.block_styles_from_latent(G, i, torch.from_numpy(latent))
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
            want = jax_projection.block_noise_from_image(ema["G"], i, s, jnp.asarray(noise))
            got = projection.block_noise_from_image(G, i, s, torch.from_numpy(noise))
            for a, b in zip(got, want):
                assert a.shape == b.shape == (1, s, s, b.shape[-1])
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("kind", ["z_styles", "style_lists", "noise_lists"])
def test_forward_matches_jax(jax_trainer, port_trainer, kind):
    """_forward on z rows with the noise image, on per-block style lists,
    and on per-block noise lists."""
    cfg, nl = port_trainer.cfg, port_trainer.cfg.num_layers
    rng = np.random.default_rng(2)
    hl = rng.standard_normal((1, cfg.latent_dim), dtype=np.float32)
    noise = rng.random((1, 32, 32, 1), dtype=np.float32)
    kw_j, kw_p = {}, {}
    if kind == "z_styles":
        z = rng.standard_normal((1, nl - 2, cfg.latent_dim), dtype=np.float32)
        kw_j = dict(z_styles=jnp.asarray(z), in_noise=jnp.asarray(noise))
        kw_p = dict(z_styles=torch.from_numpy(z), in_noise=torch.from_numpy(noise))
    else:
        lists = {k: [rng.standard_normal((1, c), dtype=np.float32) for c in chans]
                 for k, chans in (("style1", (16, 64)), ("style2", (64, 32)),
                                  ("torgb", (64, 32)))}
        kw_j["style_lists"] = {k: [jnp.asarray(x) for x in v] + [None, None]
                               for k, v in lists.items()}
        kw_p["style_lists"] = {k: [torch.from_numpy(x) for x in v] + [None, None]
                               for k, v in lists.items()}
        if kind == "noise_lists":
            chans = [64, 32, 16, 8]
            nls = {k: [rng.standard_normal((1, s, s, c), dtype=np.float32)
                       for s, c in zip(projection.block_spatials(32, 4), chans)]
                   for k in ("noise1", "noise2")}
            kw_j["noise_lists"] = {k: [jnp.asarray(x) for x in v] for k, v in nls.items()}
            kw_p["noise_lists"] = {k: [torch.from_numpy(x) for x in v] for k, v in nls.items()}
        else:
            kw_j["in_noise"], kw_p["in_noise"] = jnp.asarray(noise), torch.from_numpy(noise)
    want = np.asarray(jax_projection._forward(jax_trainer, jax_trainer.state.ema,
                                              jnp.asarray(hl), **kw_j))
    with torch.no_grad():
        got = projection._forward(port_trainer, projection._ema(port_trainer),
                                  torch.from_numpy(hl), **kw_p).numpy()
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_a_bf16_ema_is_refused_as_in_jax(jax_trainer, tmp_path):
    """The JAX package projects through its EMA as stored, and its
    convolutions refuse a bf16 EMA against fp32 inputs; the port uses the
    EMA as stored too, and torch refuses it the same way."""
    rng = np.random.default_rng(3)
    hl = rng.standard_normal((1, SMALL["latent_dim"]), dtype=np.float32)
    z = rng.standard_normal((1, 2, SMALL["latent_dim"]), dtype=np.float32)
    ema = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jax_trainer.state.ema)
    with pytest.raises(TypeError):
        jax_projection._forward(jax_trainer, ema, jnp.asarray(hl), z_styles=jnp.asarray(z))
    port = _port(jax_trainer, tmp_path, ema_dtype="bf16")
    assert all(p.dtype == torch.bfloat16 for p in projection._ema(port)["G"].parameters())
    with pytest.raises(RuntimeError, match="dtype"), torch.no_grad():
        projection._forward(port, projection._ema(port), torch.from_numpy(hl),
                            z_styles=torch.from_numpy(z))


def test_adam_steps_match_jax(runs):
    mode, latent_noise, out = runs
    (jd, jloss, jgrads), (pd, ploss, pgrads) = out["jax"], out["port"]
    assert jloss.shape == ploss.shape == (3, 5)
    assert (jloss[:, 0] == np.arange(1, 4)).all() and (ploss[:, 0] == np.arange(1, 4)).all()
    np.testing.assert_allclose(ploss[:, 1:], jloss[:, 1:], rtol=LOSS_RTOL, atol=1e-9)
    assert (jloss[:, 3:] > 0).all()  # the regularisers take part

    stem = "input"
    after_j, after_p = np.load(jd / f"{stem}_1.npz"), np.load(pd / f"{stem}_1.npz")
    assert sorted(jgrads) == sorted(pgrads) == sorted(after_j.files)
    settled = total = 0
    for k in after_j.files:
        gj, gp = jgrads[k].astype(np.float64), pgrads[k].astype(np.float64)
        gap = np.abs(gj - gp).max()
        ok = np.abs(gj) > gap
        moves = [g / (np.abs(g) + 1e-8) for g in (gj, gp)]
        allowed = PARAM_CLOSE + LR * np.abs(moves[0] - moves[1])
        diff = np.abs(after_j[k].astype(np.float64) - after_p[k])
        assert not (ok & (diff > allowed)).any(), (k, diff[ok].max())
        settled += int(ok.sum())
        total += ok.size
    assert settled >= SETTLED_MIN * total, (settled, total)


def test_written_files_match_jax(runs):
    mode, latent_noise, out = runs
    jd, pd = out["jax"][0], out["port"][0]
    assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
    for f in sorted(os.listdir(jd)):
        if f.endswith(".npz"):
            a, b = np.load(jd / f), np.load(pd / f)
            assert a.files == b.files
            assert [a[k].shape for k in a.files] == [b[k].shape for k in b.files]
            assert all(b[k].dtype == np.float32 for k in b.files)
        else:
            assert Image.open(jd / f).size == Image.open(pd / f).size == (32, 32)


@pytest.mark.parametrize("random_styles,add_noise", [((), False), ((1, 2), True)])
def test_recolor_of_a_jax_projection_matches_jax(runs, jax_trainer, port_trainer, photo,
                                                 random_styles, add_noise, monkeypatch):
    """The port recolors the ``_final.npz`` that JAX wrote, toward a
    histogram, to JAX's pixels; with random styles and added noise too
    (their draws pinned)."""
    mode, latent_noise, out = runs
    results_dir = str(out["jax"][0].parents[1])
    hist = np.random.default_rng(5).random((1, 3, 64, 64), dtype=np.float32)
    hist /= hist.sum()
    pixels = {}
    monkeypatch.setattr(projection, "_draws", jax_draws("recolor"))
    for name, pkg, t in (("jax", jax_projection, jax_trainer),
                         ("port", projection, port_trainer)):
        monkeypatch.setattr(pkg, "save_image",
                            lambda img, path, name=name: pixels.setdefault(name, np.asarray(img)))
        with contextlib.redirect_stdout(io.StringIO()):
            pkg.recolor_projected(t, photo, hist, "target.npy", results_dir=results_dir,
                                  mode=mode, latent_noise=latent_noise, optimize_noise=True,
                                  add_noise=add_noise, random_styles=random_styles, seed=3)
    assert pixels["jax"].shape == pixels["port"].shape == (32, 32, 3)
    np.testing.assert_allclose(pixels["port"], pixels["jax"], atol=ATOL)


def test_run_optimization_cadence_chunk_steps_and_perf_window():
    """The JAX package's cadence on a toy loss (log where t % 3 == 0, save
    where (t + 1) % 4 == 0), the trajectory of Adam (float64 by hand, and
    optax's within its fp32 bias correction); an
    event-free ``chunk_steps`` changes nothing; ``perf_out``'s window
    covers every step after the first."""
    target = np.arange(4.0, dtype=np.float32)

    def jax_loss(v, c):
        loss = jnp.sum((v["x"] - c["target"]) ** 2)
        return loss, {"loss": loss}

    tx = optax.adam(0.1)
    v0 = {"x": jnp.zeros(4)}
    logs_j, saves_j = [], []
    want, _ = jax_projection._run_optimization(
        jax_loss, tx, v0, tx.init(v0), {"target": jnp.asarray(target)}, num_train_steps=10,
        log_every=3, save_every=4, on_log=lambda i, aux: logs_j.append((i, float(aux["loss"]))),
        on_save=lambda i, v: saves_j.append(i))

    def run(**kw):
        x = torch.zeros(4, requires_grad=True)
        logs, saves = [], []

        def loss_fn(v):
            loss = torch.sum((v["x"] - torch.from_numpy(target)) ** 2)
            return loss, (loss,)

        v = projection._run_optimization(
            loss_fn, torch.optim.Adam([x], lr=0.1), {"x": x}, 10, 3, 4,
            lambda i, aux: logs.append((i, float(aux[0]))), lambda i, v: saves.append(i), **kw)
        return v["x"].detach().numpy(), logs, saves

    got, logs, saves = run()
    assert [i for i, _ in logs] == [i for i, _ in logs_j] == [0, 3, 6, 9]
    assert saves == saves_j == [3, 7]
    # optax takes Adam's bias correction 1 - 0.999^t in fp32 (0.999 rounds
    # to 0.99900001), torch in float64: after 10 steps the JAX trajectory
    # sits ~1e-5 from a float64 Adam, the port's within fp32 rounding
    x, m, v, exact_losses = np.zeros(4), np.zeros(4), np.zeros(4), []
    for k in range(1, 11):
        g = 2 * (x - target)
        exact_losses.append(np.sum((x - target) ** 2))
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        x = x - 0.1 * (m / (1 - 0.9 ** k)) / (np.sqrt(v / (1 - 0.999 ** k)) + 1e-8)
    np.testing.assert_allclose(got, x, atol=1e-6)
    np.testing.assert_allclose([l for _, l in logs], [exact_losses[i] for i, _ in logs],
                               rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want["x"]), atol=1e-4)
    np.testing.assert_allclose([l for _, l in logs], [l for _, l in logs_j], rtol=1e-4)
    perf = {}
    chunked, logs2, saves2 = run(chunk_steps=2, perf_out=perf)
    assert logs2 == logs and saves2 == saves
    np.testing.assert_array_equal(chunked, got)
    assert perf["opt_window_steps"] == 9
    assert perf["opt_window_seconds"] > 0 and perf["opt_steps_per_sec"] > 0
