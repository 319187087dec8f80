"""Sharded training state in the port (``param_sharding='fsdp'``,
``parallel/fsdp.py``) on the CPU, against the JAX package's FSDP.

The layout: ``fsdp_spec`` picks, for every parameter of a small HistoGAN
(with and without the discriminator's options) and reHistoGAN, the axis
that JAX's ``fsdp_spec`` picks for the same leaf in its layout, carried
through ``convert``'s transposes (a JAX leaf counting along its sharded
axis must count along the port's).

The steps: two gloo ranks (``tools/dp_step.py``'s ``spawn``, all step
cases in one spawn) take the step-0 step at a global batch of 4 from the
weights, batch and draws of the JAX package's step on ``make_mesh(2)``:
HistoGAN (GP and PL), with the D options, with remat, and reHistoGAN (GP),
held to the JAX step on the replicated mesh at
``tests/test_torch_parallel.py``'s tolerances, and the plain case also to
the JAX step under ``state_shardings`` (its FSDP layout); under bf16 with
bf16 DiffGrad state and EMA, held to the JAX FSDP step at
``tests/test_torch_precision.py``'s gates less JAX's own bf16 error, and
to the port's own bf16 step in one process at those gates with no
allowance. Each case also runs with
``param_sharding='replicated'`` (data parallel): FSDP adds the same sums
in the same order, so its metrics and gradients are DP's bit for bit. One
operation breaks bitwise equality of the parameters on the CPU: DiffGrad's
``torch.sigmoid``, whose vectorized loop and the scalar loop over a
tensor's tail round differently by an ulp, and a shard's tail is not the
full tensor's; the parameters are held to DP's tolerance there, and most
entries are still DP's bit for bit. A bf16 EMA step checks that the
stochastic rounding draws its bits in each parameter's full shape.

Two more ranks train ``Trainer.train`` and ``RecoloringTrainer.train``
for two steps under FSDP (save, evaluate and FID at step 0: no hang, only
rank 0 writes), and load a one-process checkpoint into their shards, in a
spawn of its own that runs while JAX compiles. A checkpoint that the FSDP
ranks saved loads into one process bit for bit.
"""

import copy
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.parallel import fsdp_spec as jax_fsdp_spec
from histogan_tpu.utils.config import HistoGANConfig as JaxConfig
from histogan_tpu_torch import parallel
from histogan_tpu_torch.parallel import fsdp
from histogan_tpu_torch.tools import dp_step
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
from histogan_tpu_torch.train.trainer import Trainer
from test_torch_parallel import (GLOBAL_BATCH, RANKS, TRAINER, _histogan_case, _rehisto_case,
                                 _write_images, check_histogan_ranks, check_rehisto_ranks)
from test_torch_precision import (GRAD_COS_ALL, GRAD_COS_MODULE, GRAD_REL_BF16, LOSS_RTOL,
                                  PARAM_SAME_MIN, _cos)
from test_torch_precision import PARAM_CLOSE as BF16_PARAM_CLOSE
from test_torch_rehisto import _jax_bundle
from test_torch_steps import D_OPTIONS, GRAD_RTOL, PARAM_ATOL, SMALL, _jax_params

torch.set_num_threads(1)

LIVE = ("S", "H", "G", "D")
BF16 = dict(precision="bf16")
BF16_STATE = dict(opt_state_dtype="bf16", ema_dtype="bf16")
# DiffGrad's CPU sigmoid (module docstring) moves an entry by an ulp of
# its update: the share of parameter entries allowed off DP's bit pattern
SIGMOID_OFF_SHARE = 1e-3
# The bf16 step's d_loss and g_loss (D's logits, magnitude 32-64, where
# bf16's spacing is 0.25), port against JAX at a global batch of 4 over 2
# ranks: measured 1.09 (g_loss -35.77 against -36.86: G's phase comes
# after D's bf16 update, whose sign-like first step flips near-zero
# gradients), over tests/test_torch_precision.py's 1.0 at batch 2 in one
# process (measured 0.47 there). JAX's own FSDP and replicated steps agree
# on g_loss here and are 0.125 apart on d_loss. The port's 2 ranks against
# its own bf16 step in one process: 0.53 and 1.22 (each rank's D runs in
# bf16 on 2 images, the one process on 4).
TWO_RANK_LOGIT_LOSS_ATOL = 2.0
# bf16 gradient cosines, port against JAX, under the JAX gradient's own
# cosine to fp32's less this (the test's docstring)
COS_MARGIN = 0.01
# the share of live parameters within fp32 rounding of JAX's, under the
# share where JAX's bf16 step lands on the port's fp32 step less this
SHARE_MARGIN = 0.02
# Gradients against the JAX step under its FSDP layout, per tensor relative
# to its largest entry: test_torch_steps.py's GRAD_RTOL (the port against
# the replicated JAX step: measured 1.1e-4) plus the JAX step's own gap
# between its FSDP and replicated layouts (XLA sums in other orders;
# measured 1.6e-4, G's last noise projection; 2.7e-4 the sum of the two)
JAX_FSDP_GRAD_RTOL = GRAD_RTOL + 2e-4


# ------------------------------------------------ the layout rule
def _marked(tree, n):
    """Each leaf as an array counting 1, 2, ... along the axis that JAX's
    ``fsdp_spec`` shards over ``n`` devices, zeros where it does not shard."""
    def one(x):
        axes = [i for i, a in enumerate(tuple(jax_fsdp_spec(x.shape, n))) if a is not None]
        if not axes:
            return np.zeros(x.shape, np.float32)
        shape = [1] * x.ndim
        shape[axes[0]] = x.shape[axes[0]]
        counts = np.arange(1, x.shape[axes[0]] + 1, dtype=np.float32).reshape(shape)
        return np.broadcast_to(counts, x.shape).copy()

    return jax.tree_util.tree_map(one, tree)


def _varying_axis(t: torch.Tensor):
    axes = [a for a in range(t.dim()) if bool((t.amax(dim=a) != t.amin(dim=a)).any())]
    assert len(axes) <= 1
    return axes[0] if axes else None


@pytest.mark.parametrize("model,n", [("histogan", 2), ("histogan", 4), ("d_options", 2),
                                     ("rehisto", 2), ("rehisto", 4)])
def test_fsdp_spec_matches_jax_on_every_leaf(model, n):
    """The port shards every parameter along the axis JAX shards its leaf
    along (the VQ codebook is a buffer in the port, and stays whole)."""
    if model == "rehisto":
        bundle = _jax_bundle(True, False, seed=1)
        sd = convert.rehisto_state_dict_from_jax(
            {"params_g": _marked(bundle["params_g"], n),
             "params_d": _marked(bundle["params_d"], n)})
    else:
        options = D_OPTIONS if model == "d_options" else {}
        g, d = _jax_params(JaxConfig(**{**SMALL, "image_size": 16}, **options), seed=1)
        marked = _marked(g, n)
        sd = convert.state_dict_from_jax({"params_g": marked, "params_d": _marked(d, n),
                                          "ema": marked})
    sharded = 0
    for k, t in sd.items():
        assert fsdp.fsdp_spec(t.shape, n) == _varying_axis(t), k
        sharded += fsdp.fsdp_spec(t.shape, n) is not None
    assert sharded > 0.8 * len(sd)


def test_fsdp_spec_is_jaxs_rule_through_the_layout():
    """The JAX package's own examples (tests/test_parallel.py:222), in the
    port's layout: HWIO (3, 3, 64, 128) is OIHW (128, 64, 3, 3); a JAX
    (in, out) linear is the port's (out, in)."""
    assert fsdp.fsdp_spec((128, 64, 3, 3), 8) == 0  # HWIO's O
    assert fsdp.fsdp_spec((64, 128), 8) == 1  # (in 128, out 64): the larger in
    assert fsdp.fsdp_spec((64, 64), 8) == 0  # a tie: the trailing out
    assert fsdp.fsdp_spec((3,), 8) is None
    assert fsdp.fsdp_spec((), 8) is None
    assert fsdp.fsdp_spec((64, 4, 4), 8) == 0  # the initial block's C of JAX's (4, 4, C)


def test_one_process_is_the_replicated_path():
    """At world size 1 nothing is sharded and every collective is the
    identity."""
    m = torch.nn.Linear(4, 6)
    before = [p for p in m.parameters()]
    assert fsdp.shard_module_(m) is m and fsdp.plan(m) == {}
    assert list(m.parameters()) == before
    assert fsdp.gather_parameters([m]) == [None]
    x = torch.arange(6.0)
    assert parallel.all_gather(x) is x and parallel.reduce_scatter(x) is x
    grads = [torch.ones(6, 4), torch.ones(6)]
    fsdp.reduce_gradients_(list(m.parameters()), grads)
    assert all(torch.equal(g, torch.ones_like(g)) for g in grads)
    sd = fsdp.unshard_state_dict({"L": m})
    assert set(sd) == {"L.weight", "L.bias"}


# ------------------------------------------------ two ranks
def _with(case, **trainer):
    out = copy.deepcopy(case)
    out["trainer"].update(trainer)
    return out


def _one_process_checkpoint(tmp, data):
    """A one-process (replicated) trainer's checkpoint after one step."""
    t = Trainer("one", str(tmp / "one_r"), str(tmp / "one_m"), device="cpu",
                **{**TRAINER, "calculate_fid_every": None})
    t.init_GAN()
    t.set_data_src(str(data))
    try:
        t.train()
    finally:
        t.close()
    return torch.load(tmp / "one_m" / "one" / "model_0.pt", weights_only=True)


@pytest.fixture(scope="module")
def fs(tmp_path_factory):
    """The JAX FSDP steps' results and the two ranks' results of every
    case: the trainer cases' ranks run while JAX compiles, then every step
    case in one spawn."""
    tmp = tmp_path_factory.mktemp("fs")
    data = _write_images(tmp / "data")
    env = {"OMP_NUM_THREADS": "1"}
    one = _one_process_checkpoint(tmp, data)
    rank_dirs = dict(results_dir=str(tmp / "r{rank}"), models_dir=str(tmp / "m{rank}"))
    trainer_cases = [
        {"kind": "trainer", "data": str(data), "steps": 2,
         "trainer": dict(name="t", param_sharding="fsdp", save_every=1, **rank_dirs, **TRAINER)},
        {"kind": "trainer", "class": "rehisto", "data": str(data), "steps": 2,
         "trainer": dict(name="re", param_sharding="fsdp", save_every=1, image_size=32,
                         network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
                         batch_size=GLOBAL_BATCH, gradient_accumulate_every=1, seed=0,
                         skip_conn_to_GAN=True, **rank_dirs)},
        {"kind": "trainer", "data": str(data), "steps": 0, "load": 0,
         "trainer": dict(name="one", param_sharding="fsdp", results_dir=str(tmp / "l{rank}"),
                         models_dir=str(tmp / "one_m"),
                         **{**TRAINER, "calculate_fid_every": None})}]

    def spawn(cases, name):
        torch.save(cases, tmp / f"{name}.pt")
        return dp_step.spawn(tmp / f"{name}.pt", tmp / name, RANKS, "gloo", "cpu", env=env)

    with ThreadPoolExecutor(1) as pool:
        trainer_ranks = pool.submit(spawn, trainer_cases, "trainers")
        plain = _histogan_case({}, 32, True, seed=20)
        built = {"plain": plain,
                 "d_options": _histogan_case(D_OPTIONS, 16, False, seed=40),
                 "remat": (_with(plain[0], remat=True), plain[1]),
                 "bf16": _histogan_case(BF16, 32, True, seed=50, sharded=True,
                                        tx_options={"state_dtype": jnp.bfloat16}),
                 "rehisto": _rehisto_case(seed=60)}
        jax_fsdp = _histogan_case({}, 32, True, seed=20, sharded=True)[1]
        built["bf16"][0]["trainer"].update(BF16_STATE)
        ema = _with(built["bf16"][0])  # the same input twice, each step moving the EMA
        ema["steps"] = [dict(ema["steps"][0], ema=True) for _ in range(2)]
        cases = {"bf16_in_fp32": _with(built["bf16"][0], precision="fp32", opt_state_dtype=None,
                                       ema_dtype=None, param_sharding="fsdp")}
        for name, (case, _) in {**built, "ema": (ema, None)}.items():
            case["trainer"].update(results_dir=str(tmp / "steps_r"),
                                   models_dir=str(tmp / "steps_m"))
            cases[name] = _with(case, param_sharding="fsdp")
            cases[f"{name}_dp"] = _with(case, param_sharding="replicated")
        ranks = spawn(list(cases.values()), "steps")
        got = {n: [r[i] for r in ranks] for i, n in enumerate(cases)}
        got["bf16_one"] = dp_step.run_cases([cases["bf16_dp"]], "cpu")
        trainers = [[r[i] for r in trainer_ranks.result()] for i in range(len(trainer_cases))]
    return dict(tmp=tmp, one=one, got=got, want={n: w for n, (_, w) in built.items()},
                jax_fsdp=jax_fsdp, trainers=dict(zip(("histogan", "rehisto", "load"), trainers)))


@pytest.mark.parametrize("name", ["plain", "d_options", "remat"])
def test_two_fsdp_ranks_match_the_jax_fsdp_step(fs, name):
    """JAX's FSDP step computes its replicated step's function, so the FSDP
    ranks are held to the JAX step on the replicated 2-device mesh at
    tests/test_torch_parallel.py's tolerances, with no allowance for the
    layout. Remat's JAX reference is the plain step: remat moves no
    value."""
    check_histogan_ranks(fs["got"][name], fs["want"][name], name == "d_options")


def test_two_fsdp_ranks_match_the_jax_step_under_its_fsdp_layout(fs):
    """The plain case against the JAX step run under ``state_shardings``
    on ``make_mesh(2)``: at tests/test_torch_parallel.py's tolerances but
    for the gradients, held to JAX_FSDP_GRAD_RTOL."""
    check_histogan_ranks(fs["got"]["plain"], fs["jax_fsdp"], False, JAX_FSDP_GRAD_RTOL)


def test_two_fsdp_ranks_match_the_jax_fsdp_rehisto_step(fs):
    """As the HistoGAN cases: the reHistoGAN FSDP ranks against the JAX
    step on the replicated 2-device mesh, with no allowance."""
    check_rehisto_ranks(fs["got"]["rehisto"], fs["want"]["rehisto"])


def test_bf16_fsdp_ranks_match_the_jax_bf16_fsdp_step(fs):
    """bf16 compute and bf16 DiffGrad state, at
    tests/test_torch_precision.py's gates (D's logit losses at
    TWO_RANK_LOGIT_LOSS_ATOL): the losses, the gradients' cosines, the share
    of live parameters within fp32 rounding of JAX's. A gradient cosine
    may also fall as far as the JAX step's own bf16 gradient lies from the
    fp32 one (the port's fp32 step on the same case, ``bf16_in_fp32``):
    XLA-CPU sums a bias's gradient in bf16, and here H's JAX gradient has a
    cosine of 0.878 to fp32's, where the port's bf16 one has 0.9997; and
    the share of parameters on JAX's may fall to the share of JAX's on the
    fp32 step's (DiffGrad's first update is sign-like, and H holds 40 % of
    this model's parameters)."""
    got, want = fs["got"]["bf16"], fs["want"]["bf16"]
    assert all(torch.equal(got[0]["state"][k], got[1]["state"][k]) for k in got[0]["state"])
    metrics = got[0]["metrics"][0]
    assert set(metrics) == set(want["metrics"])
    for k in ("d_loss", "g_loss"):
        assert abs(metrics[k] - want["metrics"][k]) <= TWO_RANK_LOGIT_LOSS_ATOL, k
    for k in ("gp_loss", "h_loss", "pl_mean"):
        assert abs(metrics[k] - want["metrics"][k]) <= LOSS_RTOL * abs(want["metrics"][k]), k
    grads = got[0]["grads"]
    fp32 = fs["got"]["bf16_in_fp32"][0]["grads"]

    def gate(keys, cos):
        return min(cos, _cos(_cat(want["grads"], keys), _cat(fp32, keys)) - COS_MARGIN)

    assert _cos(_cat(grads, grads), _cat(want["grads"], grads)) >= gate(list(grads), GRAD_COS_ALL)
    for prefix in LIVE:
        keys = _module_keys(grads, prefix)
        assert _cos(_cat(grads, keys), _cat(want["grads"], keys)) >= gate(keys, GRAD_COS_MODULE), \
            prefix
    floor = _same_share(want["after"], fs["got"]["bf16_in_fp32"][0]["state"]) - SHARE_MARGIN
    assert _same_share(got[0]["state"], want["after"]) >= min(PARAM_SAME_MIN, floor)


def test_bf16_fsdp_ranks_match_one_bf16_process(fs):
    """The 2-rank bf16 FSDP step against the port's own bf16 step in one
    process on the same global batch, weights and draws (bf16 DiffGrad
    state and EMA alike), at tests/test_torch_precision.py's gates with no
    allowance for JAX's bf16 error: the losses (D's logit losses at TWO_RANK_LOGIT_LOSS_ATOL,
    the others at LOSS_RTOL), the gradients' cosines (all tensors, and
    each of S, H, G, D), each tensor's gradient to GRAD_REL_BF16 in norm
    (a gradient summed and not averaged over the ranks is 1.0 off), and
    the share of live parameters within fp32 rounding. A wrong reduction
    of a bf16 gradient across the ranks fails here even where the JAX
    step's own bf16 gradient is far from fp32's."""
    got, want = fs["got"]["bf16"][0], fs["got"]["bf16_one"][0]
    metrics, one = got["metrics"][0], want["metrics"][0]
    assert set(metrics) == set(one)
    for k in ("d_loss", "g_loss"):
        assert abs(metrics[k] - one[k]) <= TWO_RANK_LOGIT_LOSS_ATOL, k
    for k in ("gp_loss", "h_loss", "pl_mean"):
        assert abs(metrics[k] - one[k]) <= LOSS_RTOL * abs(one[k]), k
    grads = got["grads"]
    assert set(grads) == set(want["grads"])
    assert _cos(_cat(grads, grads), _cat(want["grads"], grads)) >= GRAD_COS_ALL
    for prefix in LIVE:
        keys = _module_keys(grads, prefix)
        assert _cos(_cat(grads, keys), _cat(want["grads"], keys)) >= GRAD_COS_MODULE, prefix
    for k, g in grads.items():
        ref = want["grads"][k].double()
        if ref.norm() > 0:
            assert ((g.double() - ref).norm() / ref.norm()).item() <= GRAD_REL_BF16, k
    assert _same_share(got["state"], want["state"]) >= PARAM_SAME_MIN


def _cat(d, keys):
    return torch.cat([d[k].flatten() for k in keys])


def _module_keys(d, prefix):
    return [k for k in d if k.split(".")[0] == prefix]


def _same_share(a, b):
    """The share of the live parameters' entries of ``a`` within fp32
    rounding (the bf16 tests' PARAM_CLOSE) of ``b``'s."""
    keys = [k for k in a if k.split(".")[0] in LIVE]
    same = sum(int(((a[k] - b[k]).abs() <= BF16_PARAM_CLOSE).sum()) for k in keys)
    return same / sum(a[k].numel() for k in keys)


@pytest.mark.parametrize("name", ["plain", "d_options", "remat", "bf16", "rehisto", "ema"])
def test_fsdp_is_data_parallel_bit_for_bit(fs, name):
    """The same case under param_sharding 'fsdp' and 'replicated' on two
    ranks: every metric and the gradients DiffGrad applied bit for bit;
    the parameters after the steps (the EMA too) bit for bit but for
    DiffGrad's CPU sigmoid (module docstring): within DP's PARAM_ATOL, on
    at most SIGMOID_OFF_SHARE of the entries."""
    fsdp_ranks, dp_ranks = fs["got"][name], fs["got"][f"{name}_dp"]
    got, want = fsdp_ranks[0], dp_ranks[0]
    assert got["metrics"] == want["metrics"]
    assert set(got["grads"]) == set(want["grads"])
    assert all(torch.equal(got["grads"][k], want["grads"][k]) for k in want["grads"])
    assert set(got["state"]) == set(want["state"])
    off = total = 0
    for k, w in want["state"].items():
        v = got["state"][k]
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert (v.float() - w.float()).abs().max().item() <= PARAM_ATOL, k
        off += int((v != w).sum())
        total += v.numel()
    assert off <= SIGMOID_OFF_SHARE * total
    for r in fsdp_ranks[1:]:
        assert all(torch.equal(r["state"][k], got["state"][k]) for k in got["state"])


def test_the_state_per_rank_is_under_0_6_of_the_replicated_state(fs):
    for name in ("plain", "bf16", "rehisto"):
        full = fs["got"][f"{name}_dp"][0]["state_bytes"]
        for r in fs["got"][name]:
            assert r["state_bytes"] < 0.6 * full, name


def _slice_of(full: torch.Tensor, local: torch.Tensor, rank: int) -> torch.Tensor:
    if full.shape == local.shape:
        return full
    dim = fsdp.fsdp_spec(full.shape, RANKS)
    assert [a for a in range(full.dim()) if full.shape[a] != local.shape[a]] == [dim]
    k = full.shape[dim] // RANKS
    return full.narrow(dim, rank * k, k)


def test_a_one_process_checkpoint_loads_into_fsdp_ranks_as_their_slices(fs):
    """tests/test_multihost.py::test_two_process_fsdp_checkpoint_roundtrip,
    one way: each rank keeps its slice of every weight and of DiffGrad's
    state, and gathers the whole checkpoint back."""
    one = fs["one"]
    t = Trainer("names", str(fs["tmp"] / "n_r"), str(fs["tmp"] / "n_m"), device="cpu",
                **TRAINER)
    t.init_GAN()
    names = {"opt_g": [f"{p}.{n}" for p in ("S", "H", "G")
                       for n, _ in getattr(t, p).named_parameters()],
             "opt_d": [f"D.{n}" for n, _ in t.D.named_parameters()]}
    shards = 0
    for rank, r in enumerate(fs["trainers"]["load"]):
        assert set(r["local"]) == set(one["GAN"])
        for k, v in r["local"].items():
            assert torch.equal(v, _slice_of(one["GAN"][k], v, rank)), k
            shards += v.shape != one["GAN"][k].shape
        assert all(torch.equal(r["initial"][k], one["GAN"][k]) for k in one["GAN"])
        for opt in ("opt_g", "opt_d"):
            for i, s in r["local_opt"][opt]["state"].items():
                full = one[opt]["state"][i]
                assert s["step"] == full["step"]
                for key in ("exp_avg", "exp_avg_sq", "previous_grad"):
                    assert torch.equal(s[key], _slice_of(full[key], s[key], rank)), \
                        (names[opt][i], key)
    assert shards > 0


def test_a_checkpoint_of_fsdp_ranks_loads_into_one_process(fs, tmp_path):
    """The other way: the FSDP ranks' last checkpoint holds the full state;
    one replicated process loads it bit for bit and trains on from it."""
    ranks = fs["trainers"]["histogan"]
    shutil.copytree(fs["tmp"] / "m0" / "t", tmp_path / "m" / "t")
    t = Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", **TRAINER)
    t.load(1)
    got = t.reference_state_dict()
    assert set(got) == set(ranks[0]["state"])
    assert all(torch.equal(got[k], ranks[0]["state"][k]) for k in got)
    for opt, modules in ((t.state.opt_g, (t.S, t.H, t.G)), (t.state.opt_d, (t.D,))):
        params = [p for m in modules for p in m.parameters()]
        assert all(opt.state[p]["exp_avg"].shape == p.shape for p in params)
    t.set_data_src(str(fs["tmp"] / "data"))
    try:
        assert all(np.isfinite(v) for v in t.train().values())
    finally:
        t.close()


@pytest.mark.parametrize("kind", ["histogan", "rehisto"])
def test_fsdp_trainers_train_and_only_rank_0_writes(fs, kind):
    """Trainer.train / RecoloringTrainer.train for two steps under FSDP
    (both save at each step; HistoGAN evaluates and scores FID at step 0,
    which gather on every rank): the ranks start from the one process's
    weights, read the same metrics and end bitwise equal, and only rank 0
    writes."""
    tmp, ranks = fs["tmp"], fs["trainers"][kind]
    name = "t" if kind == "histogan" else "re"
    kw = dict(TRAINER) if kind == "histogan" else dict(
        image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
        batch_size=GLOBAL_BATCH, gradient_accumulate_every=1, seed=0, skip_conn_to_GAN=True)
    cls = Trainer if kind == "histogan" else RecoloringTrainer
    single = cls("s", str(tmp / f"s_{kind}_r"), str(tmp / f"s_{kind}_m"), device="cpu", **kw)
    single.init_GAN()
    ref = single.reference_state_dict()
    for r in ranks:
        assert all(torch.equal(r["initial"][k], ref[k]) for k in ref)
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ref)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert all(np.isfinite(v) for m in ranks[0]["metrics"] for v in m.values())
    for f in ("model_0.pt", "model_1.pt", ".config.json"):
        assert (tmp / "m0" / name / f).is_file()
        assert not (tmp / "m1" / name / f).exists()
    written = ("0-ema.jpg", "metrics.jsonl", "fid_scores.txt") if kind == "histogan" else (
        "0-generated.jpg", "metrics.jsonl")
    for f in written:
        assert (tmp / "r0" / name / f).is_file()
        assert not (tmp / "r1" / name / f).exists()
