"""The port's bf16 storage options against the JAX package's, on the CPU:
stochastic rounding (``ops/rounding.py``), DiffGrad's bf16 state
(``opt_state_dtype='bf16'``) and the bf16 EMA (``ema_dtype='bf16'``)
through the Trainer's schedule, reset, evaluation, checkpoints and
``--export_pt``. The counterparts of ``tests/test_ema.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.ops.rounding import stochastic_round_bf16 as jax_stochastic_round_bf16
from histogan_tpu.optim import diffgrad as jax_diffgrad
from histogan_tpu.train import convert as jax_convert
from histogan_tpu_torch.cli import histogan as cli
from histogan_tpu_torch.ops.rounding import random_bits, stochastic_round_bf16, \
    stochastic_round_list
from histogan_tpu_torch.optim.diffgrad import DiffGrad
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ULP_REL = 2.0 ** -7  # bf16 ulp(x) <= |x| * 2^-7 for normal x
LR = 2e-4


def _sr(x: np.ndarray, seed: int) -> np.ndarray:
    """The port's rounding of ``x`` (float32) with bits from ``seed``."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    return stochastic_round_bf16(t, random_bits(t.shape, torch.Generator().manual_seed(seed),
                                                "cpu")).float().numpy()


# --------------------------------------------------------------- rounding
@pytest.mark.parametrize("case", ["normal", "near_ones", "negative_and_tiny", "overflow_edge"])
def test_sr_bitwise_equal_to_jax_for_the_same_bits(case):
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal((7, 33)),
         "near_ones": 1.0 + rng.random((64,)) * 2.0 ** -7,
         "negative_and_tiny": -rng.random((5, 5)) * 1e-30,
         "overflow_edge": np.array([3.3e38, -3.3e38, 1.9999999, 0.0, -0.0])}[case]
    x = np.asarray(x, np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_stochastic_round_bf16(jnp.asarray(x), key))
    # the bits jax's function draws from its key, handed to the port
    bits = np.array(jax.random.bits(key, x.shape, jnp.uint32)).view(np.int32)
    got = stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_sr_exact_for_bf16_representable():
    vals = np.array([0.0, 1.0, -1.0, 2.5, -0.15625, 384.0], np.float32)
    for s in range(5):
        np.testing.assert_array_equal(_sr(vals, s), vals)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_sr_rejects_non_fp32(dtype):
    with pytest.raises(TypeError):
        stochastic_round_bf16(torch.zeros(3, dtype=dtype), torch.zeros(3, dtype=torch.int32))


def test_sr_lands_on_neighbours_and_is_unbiased():
    # x sits 30% of the way between bf16 neighbours 1.0 and 1.0078125
    lo, hi = 1.0, 1.0 + 2.0 ** -7
    x = np.float32(lo + 0.3 * (hi - lo))
    outs = _sr(np.full(20000, x), 42)
    assert set(np.unique(outs)) == {np.float32(lo), np.float32(hi)}
    assert abs(outs.mean() - float(x)) < 2e-4  # se(mean) ~ 2.5e-5


def test_sr_carry_across_binade():
    # neighbours 1.9921875 and 2.0: the mantissa carry bumps the exponent
    x = np.float32(2.0 - 0.25 * 2.0 ** -7)
    outs = _sr(np.full(4000, x), 7)
    assert set(np.unique(outs)) == {np.float32(1.9921875), np.float32(2.0)}
    assert abs(outs.mean() - float(x)) < 2e-4


def test_sr_negative_unbiased():
    x = np.float32(-(1.0 + 0.7 * 2.0 ** -7))
    assert abs(_sr(np.full(20000, x), 3).mean() - float(x)) < 2e-4


def test_sr_list_draws_each_tensor_anew():
    xs = [torch.full((64,), 1.001), torch.full((64,), 1.001)]
    a, b = stochastic_round_list(xs, torch.Generator().manual_seed(0))
    assert a.dtype == b.dtype == torch.bfloat16
    assert not torch.equal(a, b)


def _ema_loop(n, store):
    e = np.float32(1.0)
    for i in range(n):
        e = store(np.float32(e * 0.995 + 0.005 * 1.3), i)
    return float(e)


def test_bf16_round_to_nearest_ema_stalls():
    """The 0.5 % increment is under half a bf16 ulp at this distance: a
    round-to-nearest store drops it every time."""
    assert _ema_loop(500, lambda x, _: float(torch.tensor(x).to(torch.bfloat16))) == 1.0


def test_bf16_sr_ema_converges():
    gen = torch.Generator().manual_seed(0)
    tail = []

    def sr(x, i):
        t = torch.tensor([x], dtype=torch.float32)
        v = np.float32(stochastic_round_bf16(t, random_bits((1,), gen, "cpu")).float()[0])
        if i >= 2000:
            tail.append(float(v))
        return v

    _ema_loop(4000, sr)
    assert abs(np.mean(tail) - 1.3) < 0.08  # vs the stall at 1.0


# ---------------------------------------------------------------- DiffGrad
def test_diffgrad_bf16_state_matches_jax():
    """Three steps of the same gradients. Parameters within 2 fp32 ulps
    (the update's terms are multiplied in another order); the stored state
    within one bf16 ulp (an fp32 difference can round the other way)."""
    rng = np.random.default_rng(5)
    params = {"b": rng.standard_normal(5).astype(np.float32),
              "w": rng.standard_normal((6, 5)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-4, 1, v.shape))
              .astype(np.float32) for k, v in params.items()} for _ in range(3)]
    tx = jax_diffgrad(LR, 0.5, 0.9, state_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("b", "w")]
    opt = DiffGrad(tp, lr=LR, betas=(0.5, 0.9), state_dtype=torch.bfloat16)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for p, k in zip(tp, ("b", "w")):
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for p, k in zip(tp, ("b", "w")):
        want = np.asarray(jp[k])
        np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=2.5e-7 * np.abs(want).max())
        state = opt.state[p]
        assert state["step"] == 3
        for name in ("exp_avg", "exp_avg_sq", "previous_grad"):
            got = state[name]
            assert got.dtype == torch.bfloat16
            ref = np.asarray(getattr(st, name)[k], np.float32)
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=ULP_REL, atol=0)
        np.testing.assert_array_equal(state["previous_grad"].float().numpy(),
                                      torch.from_numpy(grads[-1][k]).bfloat16().float().numpy())


def test_diffgrad_bf16_state_survives_state_dict():
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(4, 3))
    opt = DiffGrad([p], lr=LR, state_dtype=torch.bfloat16)
    p.grad = torch.randn(4, 3)
    opt.step()
    sd = opt.state_dict()
    assert sd["state"][0]["exp_avg"].dtype == torch.bfloat16
    back = DiffGrad([torch.nn.Parameter(p.detach().clone())], lr=LR, state_dtype=torch.bfloat16)
    back.load_state_dict(sd)  # torch alone would widen it to the parameter's fp32
    for k in ("exp_avg", "exp_avg_sq", "previous_grad"):
        got = back.state[back.param_groups[0]["params"][0]][k]
        assert got.dtype == torch.bfloat16 and torch.equal(got, sd["state"][0][k])
    # an fp32 state loads into a bf16 optimizer rounded to nearest, and a
    # bf16 state into an fp32 one widened
    fp32 = DiffGrad([torch.nn.Parameter(p.detach().clone())], lr=LR)
    fp32.load_state_dict(sd)
    wide = fp32.state[fp32.param_groups[0]["params"][0]]["exp_avg_sq"]
    assert wide.dtype == torch.float32
    narrow = DiffGrad([torch.nn.Parameter(p.detach().clone())], lr=LR,
                      state_dtype=torch.bfloat16)
    narrow.load_state_dict(fp32.state_dict())
    assert narrow.state[narrow.param_groups[0]["params"][0]]["exp_avg_sq"].dtype == torch.bfloat16


# ---------------------------------------------------------------- Trainer
@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return str(root)


def _make_trainer(tmp, tiny_dataset, models=None, **kw):
    t = Trainer("ema", str(tmp / "results"), str(tmp / (models or f"models_{kw.get('ema_dtype')}")),
                image_size=32, network_capacity=4, latent_dim=32, style_depth=2, batch_size=2,
                gradient_accumulate_every=1, hist_bin=16, save_every=1000, seed=0,
                device="cpu", **kw)
    t.init_GAN()
    t.set_data_src(tiny_dataset)
    return t


@pytest.fixture(scope="module")
def trainers(tiny_dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    ts = (_make_trainer(tmp, tiny_dataset, ema_dtype="bf16", opt_state_dtype="bf16"),
          _make_trainer(tmp, tiny_dataset))
    yield ts
    for t in ts:
        t.close()


def _ema(t):
    return [p for k in ("SE", "HE", "GE") for p in getattr(t.state, k).parameters()]


@pytest.mark.parametrize("option", [{"ema_dtype": "fp64"}, {"opt_state_dtype": "bfloat16"},
                                    {"precision": "bf32"}])
def test_dtype_options_validated(tmp_path, option):
    with pytest.raises(ValueError):
        Trainer("x", str(tmp_path), str(tmp_path), device="cpu", **option)


def test_bf16_ema_init_and_on_schedule_step(trainers):
    t, _ = trainers
    assert all(x.dtype == torch.bfloat16 for x in _ema(t))
    t.steps = 20020  # on the EMA schedule, not a reset step
    pre = [x.float().clone() for x in _ema(t)]
    t.train()
    assert np.isfinite(t.d_loss) and np.isfinite(t.g_loss)
    assert all(x.dtype == torch.bfloat16 for x in _ema(t))
    moved = 0
    for e0, p, e in zip(pre, t.state.g_params(), _ema(t)):
        want = e0 * 0.995 + 0.005 * p.detach()  # the exact fp32 EMA
        got = e.float()
        assert bool(((got - want).abs() <= want.abs() * ULP_REL + 1e-6).all())
        moved += int(not torch.equal(got, e0))
    assert moved > 0  # the EMA moved despite the bf16 store


def test_bf16_ema_off_schedule_untouched(trainers):
    t, _ = trainers
    t.steps = 20011
    before = [x.clone() for x in _ema(t)]
    t.train()
    assert all(torch.equal(a, b) for a, b in zip(before, _ema(t)))


def test_bf16_ema_reset_is_cast_of_params(trainers):
    t, _ = trainers
    t.steps = 1002  # the reset window (<= 25000, % 1000 == 2)
    t.train()
    for p, e in zip(t.state.g_params(), _ema(t)):
        assert e.dtype == torch.bfloat16 and torch.equal(e, p.detach().to(torch.bfloat16))


def test_param_stream_unchanged_by_ema_dtype(trainers, tiny_dataset):
    """The rounding bits come from a generator of their own, so the live
    weights after an on-schedule step are bit-identical with ema_dtype
    fp32 and bf16. (The first update after init_GAN reads a zero optimizer
    state, so its bf16 storage does not enter it either.)"""
    t_bf16, t_fp32 = trainers
    for t in (t_bf16, t_fp32):
        t.steps = 20020
        t.gen.manual_seed(123)
        t.init_GAN()
        t.set_data_src(tiny_dataset)
        t.train()
    assert next(t_bf16.state.SE.parameters()).dtype == torch.bfloat16
    assert not all(torch.equal(a.float(), b) for a, b in zip(_ema(t_bf16), _ema(t_fp32)))
    for a, b in zip(t_bf16.state.g_params(), t_fp32.state.g_params()):
        assert torch.equal(a, b)
    for a, b in zip(t_bf16.D.parameters(), t_fp32.D.parameters()):
        assert torch.equal(a, b)


def test_bf16_ema_eval_and_checkpoint_roundtrip(trainers, tiny_dataset, tmp_path):
    t, _ = trainers
    t.init_GAN()  # the fixture's options: bf16 EMA and bf16 optimizer state
    t.set_data_src(tiny_dataset)
    t.steps = 20020
    t.train()
    up = t._ema_params()
    assert all(p.dtype == torch.float32 for m in up.values() for p in m.parameters())
    imgs = t.evaluate(num=7, num_image_tiles=2)
    assert imgs.shape == (4, 32, 32, 3) and np.isfinite(imgs).all()

    t.save(3)
    back = Trainer("ema", str(tmp_path / "r"), str(t.store.dir.parent), image_size=32,
                   network_capacity=4, latent_dim=32, style_depth=2, batch_size=2,
                   gradient_accumulate_every=1, hist_bin=16, seed=0, device="cpu",
                   ema_dtype="bf16", opt_state_dtype="bf16")
    back.load(3)
    for a, b in zip(_ema(back), _ema(t)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for opt, want in ((back.state.opt_g, t.state.opt_g), (back.state.opt_d, t.state.opt_d)):
        for st, ref in zip(opt.state.values(), want.state.values()):
            for k in ("exp_avg", "exp_avg_sq", "previous_grad"):
                assert st[k].dtype == torch.bfloat16 and torch.equal(st[k], ref[k])


def test_fp32_checkpoint_loads_into_bf16_trainer(trainers, tiny_dataset):
    """An fp32 checkpoint resumed with the bf16 options: the EMA and the
    optimizer's state are rounded to nearest, the live weights stay fp32."""
    _, t_fp32 = trainers
    t_fp32.steps = 0
    t_fp32.train()  # fills the optimizer's state
    t_fp32.save(5)
    t = Trainer("ema", str(t_fp32.results_dir), str(t_fp32.store.dir.parent), image_size=32,
                network_capacity=4, latent_dim=32, style_depth=2, batch_size=2,
                gradient_accumulate_every=1, hist_bin=16, seed=0, device="cpu",
                ema_dtype="bf16", opt_state_dtype="bf16")
    t.load(5)
    for a, b in zip(_ema(t), _ema(t_fp32)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    for a, b in zip(t.state.g_params(), t_fp32.state.g_params()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    st = t.state.opt_g.state[next(t.G.parameters())]
    ref = t_fp32.state.opt_g.state[next(t_fp32.G.parameters())]
    assert st["exp_avg"].dtype == torch.bfloat16
    assert torch.equal(st["exp_avg"], ref["exp_avg"].to(torch.bfloat16))


def test_export_pt_from_a_bf16_ema_trainer_converts_back(tmp_path):
    """``--export_pt`` with ``--ema_dtype bf16``: the file is all fp32 (the
    EMA widened) and goes through the JAX package's converter to the same
    values."""
    size, depth = 32, 8  # the CLI's latent width and style depth
    out = tmp_path / "out.pt"
    cli.main(["--new", "True", "--device", "cpu", "--name", "x", "--ema_dtype", "bf16",
              "--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
              "--image_size", str(size), "--network_capacity", "2", "--export_pt", str(out)])
    sd = torch.load(out, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    for k, v in sd.items():  # the EMA's values are bf16 values, the live ones are not all
        if k.split(".")[0] in ("SE", "HE", "GE"):
            assert torch.equal(v, v.to(torch.bfloat16).float()), k
    assert not all(torch.equal(v, v.to(torch.bfloat16).float()) for k, v in sd.items()
                   if k.startswith("G."))
    back = jax_convert.convert_histogan_checkpoint(sd, image_size=size, style_depth=depth)
    back.pop("vq_stats", None)
    again = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, back))
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
