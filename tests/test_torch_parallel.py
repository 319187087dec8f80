"""Data-parallel training in the port (``parallel/``), on the CPU.

Two gloo ranks, each a process (``tools/dp_step.py``'s ``spawn``), take
the step-0 step (GP and PL) at a global batch of 4, 2 a rank, from the
same weights, batch and draws as the JAX package's step on a 2-device
``make_mesh(2)`` with ``shard_batch`` (tests/conftest.py sets up 8 CPU
devices): the plain HistoGAN step, a GP step with the discriminator's
options (DiffAugment, attention, a VQ codebook, whose statistics are the
global batch's) and a reHistoGAN GP step, each held to the JAX step with
the tolerances of ``tests/test_torch_steps.py`` and
``tests/test_torch_rehisto_trainer.py``; the two ranks' parameters after
it are bitwise equal. Two more ranks train two steps through
``Trainer.train`` on a folder (save, evaluate, FID at step 0), in a spawn
of its own that runs while JAX compiles: both ranks
draw the same initial weights, and only rank 0 writes files. The rest:
the refusals, the no-op at one process, and param_sharding='fsdp' at one
process (the replicated path). The JAX cases and their checks also serve
``tests/test_torch_fsdp.py`` (``sharded``: the JAX HistoGAN step under its
FSDP layout).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import RecoloringEncoderDecoder as JaxED
from histogan_tpu.models import RecoloringGAN as JaxRecoloringGAN
from histogan_tpu.optim import diffgrad as jax_diffgrad
from histogan_tpu.parallel import (make_mesh, replicate, shard_batch, shard_state,
                                   state_shardings)
from histogan_tpu.train import rehisto_steps as jax_rehisto_steps
from histogan_tpu.train import steps as jax_steps
from histogan_tpu.train.state import HistoGANState as JaxState
from histogan_tpu.train.state import ReHistoGANState as JaxReState
from histogan_tpu.utils.config import HistoGANConfig as JaxConfig
from histogan_tpu.utils.config import ReHistoGANConfig as JaxReConfig
from histogan_tpu_torch import parallel
from histogan_tpu_torch.cli import histogan as cli
from histogan_tpu_torch.cli import rehistogan as rehisto_cli
from histogan_tpu_torch.parallel import fsdp, mesh
from histogan_tpu_torch.tools import dp_step
from histogan_tpu_torch.train import convert, steps
from histogan_tpu_torch.train.trainer import Trainer
from test_torch_rehisto import _jax_bundle
from test_torch_rehisto_trainer import GRAD_RTOL as RE_GRAD_RTOL
from test_torch_rehisto_trainer import HYPER, NORMED_BIAS_RTOL, PARAM_OFF_SHARE, STEP, _u
from test_torch_steps import (CODEBOOK_RTOL, D_OPTIONS, GRAD_RTOL, LOSS_RTOL, LR, PARAM_ATOL,
                              PARAM_CLOSE, SMALL, JaxDiscriminator, JaxGenerator,
                              JaxStyleVectorizer, _jax_d, _jax_params, _jax_vq, jax_step_draws)
from test_torch_rehisto_trainer import jax_step_draws as jax_rehisto_draws

torch.set_num_threads(1)

GLOBAL_BATCH, RANKS = 4, 2
# Gradients with the D options, per tensor relative to its largest entry.
# At a global batch of 4 the port's single-process step is itself up to
# 2.7e-4 from the JAX 2-device step's on G's style projections (measured),
# over test_torch_steps.py's 2e-4 at batch 2: G's gradient goes through
# D's VQ layer, whose nearest codes and codebook rest on sums taken in
# other orders; two ranks measure 3.5e-4.
OPTIONS_GRAD_RTOL = 1e-3


def _hists(rng, accum, b, hbin=64):
    h = rng.random((accum, b, 3, hbin, hbin), dtype=np.float32)
    return h / h.sum(axis=(2, 3, 4), keepdims=True)


def _jax_placed(state, mesh, sharded):
    """``state`` on ``mesh``, replicated or under the FSDP layout, and the
    ``state_shardings`` a sharded step is built with (None replicated)."""
    if not sharded:
        return replicate(state, mesh), None
    sh = state_shardings(state, mesh)
    return shard_state(state, mesh, sh), sh


def _histogan_case(options, size, apply_pl, seed, sharded=False, tx_options=None):
    """The JAX step on the 2-device mesh (the state replicated, or under
    the FSDP layout with ``sharded``), and the port's case for it."""
    cfg = JaxConfig(gradient_accumulate_every=1,
                    **{**SMALL, "image_size": size, "batch_size": GLOBAL_BATCH}, **options)
    params_g, params_d = _jax_params(cfg, seed=seed)
    vq = _jax_vq(cfg, seed=seed + 5) if cfg.fq_layers else {}
    models = jax_steps.Models(
        JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity), _jax_d(cfg))
    tx = jax_diffgrad(LR, 0.5, 0.9, **(tx_options or {}))
    state = JaxState(step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
                     ema=params_g, opt_g=tx.init(params_g), opt_d=tx.init(params_d),
                     pl_mean=jnp.zeros(()), vq_stats=vq)
    rng = np.random.default_rng(seed + 1)
    batch = {"d_images": rng.integers(0, 256, (1, GLOBAL_BATCH, size, size, 3), dtype=np.uint8),
             "d_hists": _hists(rng, 1, GLOBAL_BATCH), "g_hists": _hists(rng, 1, GLOBAL_BATCH)}
    key = jax.random.PRNGKey(seed + 2)
    m2 = make_mesh(RANKS)
    placed, sh = _jax_placed(state, m2, sharded)
    new, metrics = jax_steps.make_train_step(models, tx, tx, cfg, state_shardings=sh)(
        placed, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, m2, batch_axis=1),
        key, apply_gp=True, apply_pl=apply_pl)
    new = jax.device_get(new)
    bundle = {"params_g": params_g, "params_d": params_d, "ema": params_g, "vq_stats": vq}
    case = {"kind": "histogan",
            "trainer": dict(name="p", seed=0, gradient_accumulate_every=1,
                            **{**SMALL, "image_size": size, "batch_size": GLOBAL_BATCH},
                            **options),
            "state": convert.state_dict_from_jax(bundle),
            "steps": [{"batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                       "draws": jax_step_draws(key, cfg, apply_pl,
                                               z_dtype=jnp.bfloat16 if cfg.precision == "bf16"
                                               else jnp.float32),
                       "gp": True, "pl": apply_pl}]}
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "after": convert.state_dict_from_jax({"params_g": new.params_g,
                                                  "params_d": new.params_d, "ema": new.ema,
                                                  "vq_stats": new.vq_stats}),
            "grads": convert.state_dict_from_jax({"params_g": new.opt_g.previous_grad,
                                                  "params_d": new.opt_d.previous_grad,
                                                  "ema": new.opt_g.previous_grad})}
    return case, want


def _rehisto_case(seed=60):
    cfg = JaxReConfig(gradient_accumulate_every=1, **{**STEP, "batch_size": GLOBAL_BATCH})
    bundle = _jax_bundle(True, False, seed=seed, size=cfg.image_size, hbin=cfg.hist_bin)
    models = jax_rehisto_steps.RecolorModels(
        JaxED(cfg.image_size, cfg.network_capacity, cfg.hist_bin, cfg.latent_dim,
              cfg.style_depth, True, False),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxRecoloringGAN(cfg.image_size, cfg.latent_dim, cfg.network_capacity),
        JaxDiscriminator(cfg.image_size, cfg.network_capacity))
    tx = jax_diffgrad(LR, 0.5, 0.9)
    state = JaxReState(step=jnp.zeros((), jnp.int32), params_g=bundle["params_g"],
                       params_d=bundle["params_d"], opt_g=tx.init(bundle["params_g"]),
                       opt_d=tx.init(bundle["params_d"]), vq_stats={})
    rng = np.random.default_rng(seed + 1)
    s = cfg.image_size
    batch = {"d_images": rng.integers(0, 256, (1, GLOBAL_BATCH, s, s, 3), dtype=np.uint8),
             "d_hists": _hists(rng, 1, GLOBAL_BATCH),
             "g_images": rng.integers(0, 256, (1, GLOBAL_BATCH, s, s, 3), dtype=np.uint8),
             "g_hists": _hists(rng, 1, GLOBAL_BATCH)}
    key = jax.random.PRNGKey(seed + 2)
    m2 = make_mesh(RANKS)
    new, metrics = jax_rehisto_steps.make_rehisto_train_step(models, tx, tx, cfg)(
        replicate(state, m2), shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, m2,
                                          batch_axis=1),
        key, apply_gp=True, **HYPER)
    new = jax.device_get(new)
    case = {"kind": "rehisto", "hyper": HYPER,
            "trainer": dict(name="p", seed=0, gradient_accumulate_every=1,
                            **{**STEP, "batch_size": GLOBAL_BATCH}),
            "state": convert.rehisto_state_dict_from_jax(bundle),
            "steps": [{"batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                       "draws": jax_rehisto_draws(key, cfg), "gp": True, "pl": False}]}
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "after": convert.rehisto_state_dict_from_jax({"params_g": new.params_g,
                                                          "params_d": new.params_d}),
            "grads": convert.rehisto_state_dict_from_jax({"params_g": new.opt_g.previous_grad,
                                                          "params_d": new.opt_d.previous_grad}),
            "before": case["state"]}
    return case, want


def _write_images(root, n=4):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return root


TRAINER = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
               batch_size=GLOBAL_BATCH, gradient_accumulate_every=1, seed=0,
               calculate_fid_every=2, fid_num_samples=2)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX results and the two ranks' results of every case: the
    trainer case's two gloo ranks on the CPU run while JAX compiles its
    steps, then the step cases' two ranks."""
    tmp = tmp_path_factory.mktemp("dp")
    data = _write_images(tmp / "data")
    trainer = {"kind": "trainer", "data": str(data), "steps": 2,
               "trainer": dict(name="t", results_dir=str(tmp / "r{rank}"),
                               models_dir=str(tmp / "m{rank}"), **TRAINER)}
    env = {"OMP_NUM_THREADS": "1"}

    def spawn(cases, name):
        torch.save(cases, tmp / f"{name}.pt")
        return dp_step.spawn(tmp / f"{name}.pt", tmp / name, RANKS, "gloo", "cpu", env=env)

    with ThreadPoolExecutor(1) as pool:
        trainer_ranks = pool.submit(spawn, [trainer], "trainer")
        names = ("plain", "d_options", "rehisto")
        built = [_histogan_case({}, 32, True, seed=20),
                 _histogan_case(D_OPTIONS, 16, False, seed=40),
                 _rehisto_case()]
        for case, _ in built:  # the step cases write no file
            case["trainer"].update(results_dir=str(tmp / "steps_r"),
                                   models_dir=str(tmp / "steps_m"))
        ranks = spawn([c for c, _ in built], "steps")
        got = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
        got["trainer"] = [r[0] for r in trainer_ranks.result()]
    return dict(tmp=tmp, want=dict(zip(names, (w for _, w in built))), got=got)


def _params_bitwise_equal(per_rank):
    a, b = (r["state"] for r in per_rank)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["plain", "d_options"])
def test_two_ranks_match_the_jax_sharded_step(dp, name):
    check_histogan_ranks(dp["got"][name], dp["want"][name], name == "d_options")


def check_histogan_ranks(got, want, d_options, grad_rtol=None):
    """Two ranks' results of a HistoGAN case against the JAX step's, at the
    tolerances of tests/test_torch_steps.py (the gradients at ``grad_rtol``
    where it is given)."""
    name = "d_options" if d_options else "plain"
    _params_bitwise_equal(got)
    assert all(got[0]["metrics"] == r["metrics"] for r in got)  # one NaN verdict
    metrics = got[0]["metrics"][0]
    assert set(metrics) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(metrics[k] - w) <= LOSS_RTOL * abs(w) + 1e-7, (k, metrics[k], w)
    assert want["metrics"]["gp_loss"] > 0
    assert (want["metrics"]["pl_mean"] > 0) == (name == "plain")
    assert (want["metrics"]["q_loss"] > 0) == (name == "d_options")
    grads = got[0]["grads"]
    assert set(grads) == {k for k in want["grads"]
                          if k.split(".")[0] in ("S", "H", "G", "D") and "quantize_blocks" not in k}
    rtol = grad_rtol or (OPTIONS_GRAD_RTOL if name == "d_options" else GRAD_RTOL)
    for k, g in grads.items():
        scale = want["grads"][k].abs().max().item()
        assert (g - want["grads"][k]).abs().max().item() <= rtol * scale + 1e-12, k
    state = got[0]["state"]
    assert set(state) == set(want["after"])
    off, books = 0, 0
    for k, v in state.items():
        w = want["after"][k]
        if "quantize_blocks" in k:  # the codebook: the global batch's statistics
            books += 1
            assert (v - w).abs().max().item() <= CODEBOOK_RTOL * w.abs().max().item(), k
            continue
        assert (v - w).abs().max().item() <= PARAM_ATOL, k
        off += int(((v - w).abs() > PARAM_CLOSE).sum())
    assert off <= 1e-3 * sum(v.numel() for v in state.values())
    assert books == (3 if name == "d_options" else 0)


def test_two_ranks_match_the_jax_sharded_rehisto_step(dp):
    check_rehisto_ranks(dp["got"]["rehisto"], dp["want"]["rehisto"])


def check_rehisto_ranks(got, want):
    """Two ranks' results of the reHistoGAN case against the JAX step's, at
    the tolerances of tests/test_torch_rehisto_trainer.py."""
    _params_bitwise_equal(got)
    metrics = got[0]["metrics"][0]
    assert set(metrics) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(metrics[k] - w) <= LOSS_RTOL * abs(w) + 1e-7, (k, metrics[k], w)
    assert want["metrics"]["var_loss"] < 0 and want["metrics"]["gp_loss"] > 0
    grads = got[0]["grads"]
    assert set(grads) == set(want["grads"])
    for k, g in grads.items():
        if k.startswith("ED.encoder_blocks.") and k.endswith(("net.0.bias", "net.3.bias")):
            scale = want["grads"][k.replace("bias", "weight")].abs().max().item()
            assert max(g.abs().max().item(), want["grads"][k].abs().max().item()) \
                <= NORMED_BIAS_RTOL * scale, k
            continue
        scale = want["grads"][k].abs().max().item()
        assert (g - want["grads"][k]).abs().max().item() <= RE_GRAD_RTOL * scale + 1e-12, k
    state, off = got[0]["state"], 0
    assert set(state) == set(want["after"])
    for k, v in state.items():
        g, gj = grads[k].double(), want["grads"][k].double()
        allowed = PARAM_CLOSE + LR * (_u(g) - _u(gj)).abs()
        assert bool(((v - want["after"][k]).abs().double() <= allowed).all()), k
        off += int(((v - want["after"][k]).abs() > PARAM_CLOSE).sum())
    assert off <= PARAM_OFF_SHARE * sum(v.numel() for v in state.values())


def test_ranks_draw_the_same_weights_and_stay_equal(dp, tmp_path):
    """No broadcast at init: every rank draws the weights a single process
    draws from the seed; two Trainer.train steps later they are still
    bitwise equal, and every rank read the same metrics."""
    got = dp["got"]["trainer"]
    single = Trainer("s", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", **TRAINER)
    single.init_GAN()
    ref = single.reference_state_dict()
    for r in got:
        assert set(r["initial"]) == set(ref)
        assert all(torch.equal(r["initial"][k], ref[k]) for k in ref)
    _params_bitwise_equal(got)
    assert got[0]["metrics"] == got[1]["metrics"]
    assert all(np.isfinite(v) for m in got[0]["metrics"] for v in m.values())


def test_only_rank_0_writes_files(dp):
    tmp = dp["tmp"]
    for name in ("model_0.pt", ".config.json"):
        assert (tmp / "m0" / "t" / name).is_file()
        assert not (tmp / "m1" / "t" / name).exists()
    for name in ("0-ema.jpg", "metrics.jsonl", "fid_scores.txt"):
        assert (tmp / "r0" / "t" / name).is_file()
        assert not (tmp / "r1" / "t" / name).exists()
    assert (tmp / "r0" / "t" / "fid_scores.txt").read_text().count("\n") == 1  # step 0


def test_a_batch_the_ranks_do_not_divide_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    assert parallel.local_shard_info(4) == (2, 0, 2)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.local_shard_info(3)
    with pytest.raises(ValueError, match="not divisible"):
        Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                **{**TRAINER, "batch_size": 3})


def test_maybe_initialize_distributed_is_a_no_op_without_the_env(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.maybe_initialize_distributed() is False
    assert not parallel.is_distributed()
    assert (parallel.world_size(), parallel.rank(), parallel.is_main()) == (1, 0, True)
    x = torch.arange(6.0)
    assert parallel.local_slice(x) is x and parallel.global_sum(x) is x
    assert parallel.train_device("cuda") == torch.device("cuda")


class _Joined(Exception):
    pass


@pytest.mark.parametrize("module", [cli, rehisto_cli], ids=["histogan", "rehistogan"])
@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_the_cli_picks_the_backend_from_its_device(monkeypatch, tmp_path, module, device,
                                                   backend):
    """Under torchrun on a host with a GPU, ``--device cpu`` joins over gloo
    and pins no GPU; ``--device cuda`` over NCCL on cuda:LOCAL_RANK."""
    env = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pinned = []

    def init_process_group(backend, **kwargs):
        raise _Joined(backend, kwargs["world_size"], kwargs["rank"])

    monkeypatch.setattr(mesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh.torch.cuda, "set_device", pinned.append)
    monkeypatch.setattr(mesh.dist, "init_process_group", init_process_group)
    with pytest.raises(_Joined) as joined:
        module.main(["--results_dir", str(tmp_path / "r"), "--models_dir", str(tmp_path / "m"),
                     "--device", device, "--num_devices", "2"])
    assert joined.value.args == (backend, 2, 1)
    assert pinned == ([1] if backend == "nccl" else [])


def test_num_devices_without_torchrun_raises_and_names_torchrun(tmp_path):
    """More than one device needs torchrun; at one process
    param_sharding='fsdp' is the replicated path (as JAX's FSDP on a
    1-device mesh): a step from the same weights, batch and draws leaves
    the same state bit for bit, and the CLI trains with it. An unknown
    layout raises."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", num_devices=2)
    t = Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", num_devices=1)
    assert t.num_devices == 1
    states = []
    for layout in ("replicated", "fsdp"):
        t = Trainer(layout, str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                    param_sharding=layout, **TRAINER)
        t.init_GAN()
        assert not t.sharded and not any(fsdp.plan(m) for m in t.models().values())
        rng = np.random.default_rng(3)
        h = rng.random((2, 1, GLOBAL_BATCH, 3, 16, 16), dtype=np.float32)
        batch = {"d_images": torch.from_numpy(rng.integers(0, 256, (1, GLOBAL_BATCH, 32, 32, 3),
                                                           dtype=np.uint8)),
                 "d_hists": torch.from_numpy(h[0]), "g_hists": torch.from_numpy(h[1])}
        draws = steps.draw_step(torch.Generator().manual_seed(4), t.cfg, "cpu", True)
        steps.train_step(t.state, batch, draws, t.cfg, True, True, True)
        states.append(t.reference_state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    with pytest.raises(ValueError, match="param_sharding"):
        Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                param_sharding="zero")
    dirs = ["--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
            "--image_size", "32", "--network_capacity", "2", "--new", "True", "--device", "cpu"]
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main([*dirs, "--num_devices", "2"])
    data = _write_images(tmp_path / "data")
    cli.main([*dirs, "--param_sharding", "fsdp", "--data", str(data), "--name", "fs",
              "--hist_bin", "16", "--batch_size", "2", "--gradient_accumulate_every", "1",
              "--num_train_steps", "1"])
    assert (tmp_path / "mod" / "fs" / "model_0.pt").is_file()
    with pytest.raises(SystemExit):
        cli.main([*dirs, "--param_sharding", "zero"])
