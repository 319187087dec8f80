"""The port's bf16 reHistoGAN (``precision='bf16'``) against the JAX
package's on the CPU.

One JAX recoloring step (``make_rehisto_train_step`` with
``precision='bf16'``, 32 px, capacity 4, latent 32, style depth 2, 64
histogram bins, skip connections to the head, the variance loss) with and
without the gradient penalty, and the port's ``train_step`` from the same
weights, batch and noise; the port's fp32 step on the same inputs is the
yardstick for how far bf16 moves a gradient. Then the bf16 recolor against
JAX's bf16 ``recolor_forward`` on the same noise, where the step computes
in bf16 and where in fp32, and the dtypes of the parameters, DiffGrad's
state and the outputs across a save and a load, through the trainer and
the CLI.

What the tolerances cover: bf16 rounds every activation to 8 bits, and
XLA-CPU and torch-CPU round in other places (see
``tests/test_torch_precision.py``). At seeded weights the recoloring step
is far more sensitive to that rounding than HistoGAN's: on the same
inputs JAX's own bf16 step lies from the fp32 step (the port's, equal to
JAX's fp32 step within 1e-4, ``tests/test_torch_rehisto_trainer.py``) by
8.8e-2 (with the GP) and 4.0e-2 (without) in g_loss, by gradient cosines
down to 0.81 (H, with the GP) per module and 0.96 over all tensors, with
20 % of the post-step parameters more than 1e-6 away, and its recolor by
1.5e-2 of the largest entry. So the gates of the bf16 policy
(``tests/test_torch_precision.py``: cosines 0.999 and 0.99, 95 % of the
parameters within 1e-6; the losses 2e-2) cannot hold here in either
package. Each gap between the port's bf16 result and JAX's is held to the
larger of that fixed gate and NOISE_FACTOR times the gap bf16 itself opens
between JAX's bf16 result and the fp32 one. Measured, the port's gaps are
0.9 to 2.2 times bf16's own (d_loss with the GP 1.98e-2 against 8.96e-3);
the factor is 3.

These magnitude gates cannot tell the port's bf16 from an fp32 computation:
JAX's bf16 on XLA-CPU keeps fp32 inside its fusions, so it rounds elsewhere
than torch does, and the port's bf16 lies from it about as far as fp32
does (0.9 to 2.2 times, above). Scaling the seeded weights down (by 0.5 or
0.3, outputs of O(1)) leaves that ratio at 0.7 to 1.4. Module by module on
the same bf16 inputs, the port's bf16 output equals JAX's bit for bit in
55 % (H), 8 to 18 % (ED) and 31 % (G) of the entries, and the port's fp32
output rounded to bf16 in 52 %, 10 to 22 % and 22 %. So where the port
computes in bf16 is held by dtypes, layer by layer:
``test_bf16_every_layer_runs_in_bf16_as_jax`` (every module's output in
ED, H, G and D, against flax's captured intermediates) and
``test_bf16_step_computes_where_jax_does`` (the fp32 losses, histogram
inputs and gradients).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.models import Discriminator as JaxDiscriminator
from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import RecoloringEncoderDecoder as JaxED
from histogan_tpu.models import RecoloringGAN as JaxRecoloringGAN
from histogan_tpu.optim import diffgrad as jax_diffgrad
from histogan_tpu.train import rehisto_steps as jax_rehisto_steps
from histogan_tpu.train.state import ReHistoGANState as JaxState
from histogan_tpu.utils.config import ReHistoGANConfig as JaxReConfig
from histogan_tpu_torch.cli import rehistogan as cli
from histogan_tpu_torch.ops import histogram as port_histogram
from histogan_tpu_torch.train import convert, rehisto_steps, steps
from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
from test_torch_rehisto import _jax_bundle
from test_torch_rehisto_trainer import HYPER, LR, STEP, _batch, _named_grads, jax_step_draws

torch.set_num_threads(1)

# The fixed gates: the losses relative; the gates of
# tests/test_torch_precision.py for the bf16 policy; the recolor relative
# to its largest entry (bf16's relative spacing is 2**-8 = 3.9e-3).
LOSS_RTOL = 2e-2
GRAD_COS_ALL = 0.999
GRAD_COS_MODULE = 0.99
PARAM_CLOSE = 1e-6
PARAM_SAME_MIN = 0.95
RECOLOR_RTOL = 1e-2
# ... or this many times the gap bf16 opens between JAX's bf16 result and
# the fp32 one, whichever is larger (the module docstring says why)
NOISE_FACTOR = 3.0
LIVE = ("ED", "H", "G", "D")


def _jax_models(cfg):
    return jax_rehisto_steps.RecolorModels(
        JaxED(cfg.image_size, cfg.network_capacity, cfg.hist_bin, cfg.latent_dim,
              cfg.style_depth, True, False),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxRecoloringGAN(cfg.image_size, cfg.latent_dim, cfg.network_capacity),
        JaxDiscriminator(cfg.image_size, cfg.network_capacity))


def _port_trainer(tmp, bundle, precision, **kw):
    t = RecoloringTrainer("p", str(tmp / f"r{precision}"), str(tmp / f"m{precision}"),
                          device="cpu", seed=0, gradient_accumulate_every=1,
                          precision=precision, **{**STEP, **kw})
    t.init_GAN()
    assert t.load_state_dict(convert.rehisto_state_dict_from_jax(bundle)) == []
    return t


@pytest.fixture(scope="module")
def bf16_steps(tmp_path_factory):
    """For the GP step and the plain step: JAX's bf16 step, and the port's
    bf16 and fp32 steps on its weights, batch and noise."""
    cfg = JaxReConfig(gradient_accumulate_every=1, precision="bf16", **STEP)
    bundle = _jax_bundle(True, False, seed=120, size=cfg.image_size, hbin=cfg.hist_bin)
    tx = jax_diffgrad(LR, 0.5, 0.9)
    step = jax_rehisto_steps.make_rehisto_train_step(_jax_models(cfg), tx, tx, cfg)
    tmp = tmp_path_factory.mktemp("rehisto_bf16")
    runs = {}
    for apply_gp in (True, False):
        state = JaxState(step=jnp.zeros((), jnp.int32), params_g=bundle["params_g"],
                         params_d=bundle["params_d"], opt_g=tx.init(bundle["params_g"]),
                         opt_d=tx.init(bundle["params_d"]))
        batch = _batch(1, seed=121 + apply_gp)
        key = jax.random.PRNGKey(123)
        new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                            apply_gp=apply_gp, **HYPER)
        new = jax.device_get(new)
        draws = jax_step_draws(key, cfg)
        port = {}
        for precision in ("bf16", "fp32"):
            t = _port_trainer(tmp / f"gp{int(apply_gp)}", bundle, precision)
            m = rehisto_steps.train_step(t.state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         copy.deepcopy(draws), t.cfg, apply_gp, **HYPER)
            grads = {**_named_grads(t.state, t.state.opt_g, ("ED", "H", "G")),
                     **_named_grads(t.state, t.state.opt_d, ("D",))}
            port[precision] = dict(trainer=t, metrics={k: v.item() for k, v in m.items()},
                                   grads=grads)
        runs[apply_gp] = dict(
            port=port, metrics={k: float(v) for k, v in metrics.items()},
            after=convert.rehisto_state_dict_from_jax({"params_g": new.params_g,
                                                       "params_d": new.params_d}),
            grads=convert.rehisto_state_dict_from_jax({"params_g": new.opt_g.previous_grad,
                                                       "params_d": new.opt_d.previous_grad}))
    return dict(bundle=bundle, runs=runs)


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                 dim=0).item()


def _check_losses(got, want, fp32, apply_gp):
    """Each loss of ``got`` within LOSS_RTOL of ``want``'s, or NOISE_FACTOR
    times ``want``'s distance from the fp32 step's."""
    assert set(got) == set(want) == set(fp32)
    for k, w in want.items():
        if k == "q_loss" or (k == "gp_loss" and not apply_gp):
            assert got[k] == w == 0.0, k
            continue
        tol = max(LOSS_RTOL * abs(w), NOISE_FACTOR * abs(w - fp32[k]))
        assert abs(got[k] - w) <= tol, (k, got[k], w, fp32[k])


def _gate(fixed, floor):
    return max(fixed, NOISE_FACTOR * floor)


@pytest.mark.parametrize("apply_gp", [True, False])
def test_bf16_rehisto_step_matches_jax(bf16_steps, apply_gp):
    r = bf16_steps["runs"][apply_gp]
    bf16, fp32 = r["port"]["bf16"], r["port"]["fp32"]
    _check_losses(bf16["metrics"], r["metrics"], fp32["metrics"], apply_gp)
    assert (r["metrics"]["gp_loss"] > 0) == apply_gp
    assert r["metrics"]["var_loss"] < 0 < r["metrics"]["r_loss"]  # both terms ran

    got, want, ref = bf16["grads"], r["grads"], fp32["grads"]
    assert set(got) == set(want) == set(ref)

    def cat(d, keys):
        return torch.cat([d[k].flatten() for k in keys])

    groups = {"all": list(got), **{p: [k for k in got if k.split(".")[0] == p] for p in LIVE}}
    for name, keys in groups.items():
        fixed = 1.0 - (GRAD_COS_ALL if name == "all" else GRAD_COS_MODULE)
        floor = 1.0 - _cos(cat(want, keys), cat(ref, keys))
        assert 1.0 - _cos(cat(got, keys), cat(want, keys)) <= _gate(fixed, floor), name

    def off_share(params):
        off = sum(int(((v - r["after"][k]).abs() > PARAM_CLOSE).sum()) for k, v in params.items())
        return off / sum(v.numel() for v in params.values())

    params = bf16["trainer"].reference_state_dict()
    assert set(params) == set(r["after"])
    assert off_share(params) <= _gate(1.0 - PARAM_SAME_MIN,
                                      off_share(fp32["trainer"].reference_state_dict()))


@pytest.mark.parametrize("apply_gp", [True, False])
def test_bf16_rehisto_step_against_fp32(bf16_steps, apply_gp):
    """The port's bf16 and fp32 steps on the same weights and noise: bf16
    really ran (the gradients moved), by about what it moves JAX's step."""
    r = bf16_steps["runs"][apply_gp]
    run = r["port"]
    got, ref = run["bf16"]["grads"], run["fp32"]["grads"]
    live = [k for k in got if ref[k].abs().max() > 0]
    assert sum(not torch.equal(got[k], ref[k]) for k in live) > 0.9 * len(live)
    flat = [torch.cat([d[k].flatten() for k in got]) for d in (got, ref, r["grads"])]
    assert 1.0 - _cos(flat[0], flat[1]) <= _gate(1.0 - GRAD_COS_ALL, 1.0 - _cos(flat[2], flat[1]))
    for k, v in run["fp32"]["metrics"].items():
        w = r["metrics"][k]
        assert abs(run["bf16"]["metrics"][k] - v) <= max(LOSS_RTOL * abs(v),
                                                         NOISE_FACTOR * abs(w - v)), k


def test_bf16_recolor_matches_jax(bf16_steps, tmp_path):
    cfg = JaxReConfig(precision="bf16", **STEP)
    # float32 leaves, as the jitted step sees them (random_params gives
    # some float64 ones, which cast_tree would leave uncast)
    bundle = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), bf16_steps["bundle"])
    rng = np.random.default_rng(130)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    hist = rng.random((2, 3, 64, 64), dtype=np.float32)
    hist /= hist.sum(axis=(1, 2, 3), keepdims=True)
    noise = rng.random((2, 32, 32, 1), dtype=np.float32)
    want, want32 = (np.asarray(jax.jit(
        lambda p, i, h, n, c=c: jax_rehisto_steps.recolor_forward(_jax_models(c), p, i, h, n, c))(
            bundle["params_g"], img, hist, noise), np.float32)
        for c in (cfg, JaxReConfig(**STEP)))
    # before the clip: the recolor's output reaches ~24 at these weights
    scale = np.abs(want32).max()
    floor = np.abs(want - want32).max() / scale
    port = {p: _port_trainer(tmp_path / p, bf16_steps["bundle"], p) for p in ("bf16", "fp32")}
    models = steps.cast_models(
        rehisto_steps.RecolorModels(port["bf16"].ED, port["bf16"].H, port["bf16"].G, None),
        torch.bfloat16)
    with torch.no_grad():
        raw = rehisto_steps.recolor_forward(models, torch.from_numpy(img).permute(0, 3, 1, 2),
                                            torch.from_numpy(hist), torch.from_numpy(noise),
                                            port["bf16"].cfg)
    assert raw.dtype == torch.bfloat16
    raw = raw.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(raw - want).max() / scale <= _gate(RECOLOR_RTOL, floor)
    # the trainer's recolor: the same forward, clipped, in bf16
    got = port["bf16"].recolor(img, hist, noise=torch.from_numpy(noise))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got.float().numpy(), np.clip(raw, 0.0, 1.0))
    fp32 = port["fp32"].recolor(img, hist, noise=torch.from_numpy(noise))
    assert fp32.dtype == torch.float32
    assert 0 < np.abs(got.float().numpy() - fp32.numpy()).max()  # bf16 ran


def test_bf16_step_computes_where_jax_does(bf16_steps, tmp_path, monkeypatch):
    """bf16 images and logits inside; fp32 losses, fp32 histogram input
    (what K1 and K2 take) and fp32 gradients on the fp32 masters."""
    t = _port_trainer(tmp_path, bf16_steps["bundle"], "bf16")
    dt = steps.compute_dtype(t.cfg)
    assert dt == torch.bfloat16
    models = steps.cast_models(
        rehisto_steps.RecolorModels(t.state.ED, t.state.H, t.state.G, t.state.D), dt)
    assert isinstance(models, rehisto_steps.RecolorModels)
    batch = _batch(1, seed=131)
    images = torch.from_numpy(batch["g_images"][0]).permute(0, 3, 1, 2).float() / 255.0
    hists = torch.from_numpy(batch["g_hists"][0])
    noise = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    out = rehisto_steps.recolor_forward(models, images, hists, noise, t.cfg)
    assert out.dtype == torch.bfloat16 and models.D(out)[0].dtype == torch.bfloat16
    seen = []
    real_feature = port_histogram.histogram_feature
    monkeypatch.setattr(rehisto_steps, "histogram_feature",
                        lambda x, **kw: seen.append(x.dtype) or real_feature(x, **kw))
    gauss = rehisto_steps.filters.gaussian_kernel(15, 5.0)
    loss, *parts = rehisto_steps.g_loss(models, images, hists, noise, t.cfg, gauss=gauss, **HYPER)
    assert seen == [torch.float32, torch.float32]  # G's output and the hist-of-hist
    assert all(x.dtype == torch.float32 for x in (loss, *parts))
    grads = torch.autograd.grad(loss, t.state.g_params(), allow_unused=True,
                                materialize_grads=True)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_bf16_every_layer_runs_in_bf16_as_jax(bf16_steps, tmp_path):
    """Every module of ED, H, G and D outputs bf16 under the bf16 policy, in
    the port (forward hooks) as in JAX (flax's captured intermediates), so
    no layer computes its output in fp32 where JAX's does not."""
    from histogan_tpu.train.steps import cast_tree

    cfg = JaxReConfig(precision="bf16", **STEP)
    bundle = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), bf16_steps["bundle"])
    params = cast_tree({**bundle["params_g"], "D": bundle["params_d"]}, jnp.bfloat16)
    rng = np.random.default_rng(132)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    hist = rng.random((2, 3, 64, 64), dtype=np.float32)
    hist /= hist.sum(axis=(1, 2, 3), keepdims=True)
    noise = rng.random((2, 32, 32, 1), dtype=np.float32)

    jm = _jax_models(cfg)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (img, hist, noise)]
    jax_dtypes = {}

    def capture(name, module, *args):  # shapes and dtypes only: nothing is computed
        out, state = jax.eval_shape(lambda *a: module.apply(
            {"params": params[name]}, *a, capture_intermediates=True,
            mutable=["intermediates"]), *args)
        jax_dtypes[name] = {str(x.dtype) for x in jax.tree_util.tree_leaves(state)}
        return out

    h_w = capture("H", jm.H, bf[1])
    ed = capture("ED", jm.ED, bf[0], bf[1])
    capture("D", jm.D, capture("G", jm.G, ed[0], ed[1], h_w, bf[2], ed[2], ed[3]))
    assert jax_dtypes == {k: {"bfloat16"} for k in LIVE}

    t = _port_trainer(tmp_path, bf16_steps["bundle"], "bf16")
    models = steps.cast_models(
        rehisto_steps.RecolorModels(t.state.ED, t.state.H, t.state.G, t.state.D), torch.bfloat16)
    port_dtypes = {k: [] for k in LIVE}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, _k=k: port_dtypes[_k].extend(
            x.dtype for x in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(x)))
        for k in LIVE for m in getattr(t.state, k).modules()]  # functional_call runs them
    try:
        with torch.no_grad():
            out = rehisto_steps.recolor_forward(models, torch.from_numpy(img).permute(0, 3, 1, 2),
                                                torch.from_numpy(hist), torch.from_numpy(noise),
                                                t.cfg)
            models.D(out)
    finally:
        for h in hooks:
            h.remove()
    assert all(len(v) > 1 and set(v) == {torch.bfloat16} for v in port_dtypes.values()), \
        {k: set(v) for k, v in port_dtypes.items()}


@pytest.fixture
def images(tmp_path):
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray((rng.random((40, 36, 3)) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return root


SMALL = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
             batch_size=2, gradient_accumulate_every=1, seed=0, skip_conn_to_GAN=True)


def _check_dtypes(t, opt_dtype):
    for m in t.models().values():
        assert all(p.dtype == torch.float32 for p in m.parameters())
    for opt in (t.state.opt_g, t.state.opt_d):
        assert opt.state and all(st[k].dtype == opt_dtype for st in opt.state.values()
                                 for k in ("exp_avg", "exp_avg_sq", "previous_grad"))


def test_bf16_trainer_dtypes_across_save_and_load(images, tmp_path):
    kw = dict(SMALL, precision="bf16", opt_state_dtype="bf16", save_every=1000)
    t = RecoloringTrainer("b", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", **kw)
    t.init_GAN()
    t.set_data_src(str(images))
    try:
        m = t.train(**HYPER)  # step 0: GP, save and evaluate
    finally:
        t.close()
    assert all(np.isfinite(v) for v in m.values()) and m["gp_loss"] > 0
    _check_dtypes(t, torch.bfloat16)
    assert (tmp_path / "r" / "b" / "0-generated.jpg").is_file()
    after = {k: v.clone() for k, v in t.reference_state_dict().items()}

    r = RecoloringTrainer("b", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", **kw)
    assert r.load(-1) == 0 and r.cfg.precision == "bf16"
    _check_dtypes(r, torch.bfloat16)
    assert all(torch.equal(v, after[k]) for k, v in r.reference_state_dict().items())
    saved = torch.load(r.store.dir / "model_0.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved["GAN"].values())
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in saved["opt_g"]["state"].values())
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    h = np.full((2, 3, 16, 16), 1.0 / (3 * 256), np.float32)
    assert r.recolor(x, h).dtype == torch.bfloat16
    out = r.evaluate(9, image_batch=x, hist_batch=h)
    assert out.dtype == np.float32 and out.shape == (2, 32, 32, 3)
    r.set_data_src(str(images))
    try:
        m = r.train(**HYPER)
    finally:
        r.close()
    assert all(np.isfinite(v) for v in m.values())
    _check_dtypes(r, torch.bfloat16)


def test_cli_trains_and_recolors_in_bf16(images, tmp_path):
    dirs = ["--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
            "--image_size", "32", "--network_capacity", "2", "--hist_bin", "16",
            "--device", "cpu", "--name", "b"]
    cli.main([*dirs, "--data", str(images), "--new", "True", "--batch_size", "2",
              "--gradient_accumulate_every", "1", "--num_train_steps", "1",
              "--precision", "bf16", "--opt_state_dtype", "bf16"])
    payload = torch.load(tmp_path / "mod" / "b" / "model_0.pt", weights_only=True)
    assert payload["GAN"]["G.blocks.0.conv1.weight"].dtype == torch.float32
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in payload["opt_g"]["state"].values())
    # --fp16 True is --precision bf16, as in the JAX CLI
    assert cli.get_args(["--fp16", "True"]).fp16 is True
    src = tmp_path / "in.jpg"
    Image.fromarray((np.random.default_rng(2).random((20, 24, 3)) * 255).astype(np.uint8)).save(src)
    cli.main([*dirs, "--generate", "True", "--fp16", "True", "--input_image", str(src),
              "--target_hist", str(src)])
    outs = list((tmp_path / "res" / "b").glob("output-in-*-generated.jpg"))
    assert len(outs) == 1 and Image.open(outs[0]).size == (36, 36)
