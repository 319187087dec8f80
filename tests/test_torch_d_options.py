"""The discriminator's options in the port against the JAX package, on
the CPU: the linear attention, Residual(Rezero(attn)), the EMA vector
quantizer (forward, commitment loss and codebook update) and the
discriminator with ``attn_layers`` and ``fq_layers`` through the weight
bridge, the round trip of a bundle through ``export_histogan_checkpoint``,
and the bf16 refusal of a VQ layer with a block after it.

Weights are random in the flax modules' parameter trees (``random_params``:
``g`` is live), the codebooks random too. Module outputs are held to
atol 2e-5 (tests/test_convert.py's convention), the codebook after an
update to 2e-5 of its largest entry: both are fp32 sums taken in other
orders. The toy inputs have no row within fp32 rounding of two codes, so
both packages pick the same codes (asserted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.models.attention import ImageLinearAttention as JaxAttention
from histogan_tpu.models.attention import RezeroResidual as JaxRezeroResidual
from histogan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from histogan_tpu.models.vq import VectorQuantize as JaxVectorQuantize
from histogan_tpu.train import convert as jax_convert
from histogan_tpu.train.steps import cast_tree
from histogan_tpu_torch.models.attention import ImageLinearAttention, RezeroResidual
from histogan_tpu_torch.models.discriminator import Discriminator, vq_before_a_block
from histogan_tpu_torch.models.vq import PermuteToFrom, VectorQuantize
from histogan_tpu_torch.train import convert, steps
from histogan_tpu_torch.train.trainer import Trainer
from test_torch_models import random_params

torch.set_num_threads(1)

ATOL = 2e-5
CODEBOOK_RTOL = 2e-5
OPTIONS = dict(fq_layers=(3,), attn_layers=(1, 2))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _attention_state(tree, prefix=""):
    out = {}
    for q in ("to_q", "to_k", "to_v"):
        convert._conv_weight(tree[q], f"{prefix}{q}", out)
    convert._conv(tree["to_out"], f"{prefix}to_out", out)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _codebook(dim, n, seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((dim, n), dtype=np.float32),
            "embed_avg": rng.standard_normal((dim, n), dtype=np.float32),
            "cluster_size": rng.random((n,), dtype=np.float32) * 4}


def _vq_state(stats):
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32)) for k, v in stats.items()}


def test_attention_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4), dtype=np.float32)
    ja = JaxAttention(4)
    params = random_params(ja, 1, jnp.asarray(x))
    want = ja.apply({"params": params}, jnp.asarray(x))
    att = ImageLinearAttention(4)
    att.load_state_dict(_attention_state(params), strict=True)
    np.testing.assert_allclose(_nhwc(att(_nchw(x))), np.asarray(want), atol=ATOL)


def test_rezero_residual_with_random_g_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 8), dtype=np.float32)
    jr = JaxRezeroResidual(8)
    params = random_params(jr, 3, jnp.asarray(x))
    assert abs(float(params["g"][0])) > 1e-3  # a live gate
    want = jr.apply({"params": params}, jnp.asarray(x))
    r = RezeroResidual(8)
    r.load_state_dict({"fn.g": torch.from_numpy(np.asarray(params["g"], np.float32)),
                       **_attention_state(params["attn"], "fn.fn.")}, strict=True)
    np.testing.assert_allclose(_nhwc(r(_nchw(x))), np.asarray(want), atol=ATOL)
    assert RezeroResidual(8).fn.g.item() == 0.0  # g starts at 0


@pytest.mark.parametrize("train", [False, True])
def test_vector_quantize_matches_jax(train):
    dim, n = 8, 16
    x = np.random.default_rng(4).standard_normal((2, 4, 4, dim), dtype=np.float32)
    stats = _codebook(dim, n, 5)
    jq = JaxVectorQuantize(dim, n)
    (want, want_loss), new = jq.apply({"vq_stats": stats}, jnp.asarray(x), train=train,
                                      mutable=["vq_stats"])
    q = VectorQuantize(dim, n)
    q.load_state_dict(_vq_state(stats), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got, loss = q(xt, train_stats=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    # the codes: the rows of the output are codebook columns, the same ones
    codes = got.detach().reshape(-1, dim) @ torch.from_numpy(stats["embed"])
    assert torch.equal(codes.argmax(1), torch.from_numpy(
        np.asarray(want).reshape(-1, dim) @ stats["embed"]).argmax(1))
    for k, v in new["vq_stats"].items():
        v = np.asarray(v)
        np.testing.assert_allclose(getattr(q, k).numpy(), v,
                                   atol=CODEBOOK_RTOL * np.abs(v).max(), err_msg=k)
        assert train or np.array_equal(getattr(q, k).numpy(), stats[k])
    assert q.embed_avg.data_ptr() != q.embed.data_ptr()
    # straight through, plus the commitment loss's 2 (x - q) / N
    (gx,) = torch.autograd.grad(got.sum() + loss, xt)
    jgx = jax.grad(lambda v: jnp.sum(jq.apply({"vq_stats": stats}, v)[0])
                   + jq.apply({"vq_stats": stats}, v)[1])(jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=ATOL)


def test_permute_to_from_reads_rows_in_nhwc_order():
    x = np.random.default_rng(6).standard_normal((2, 4, 4, 8), dtype=np.float32)
    q = VectorQuantize(8, 16)
    wrapped = PermuteToFrom(q)
    out, loss = wrapped(_nchw(x))
    direct, direct_loss = q(torch.from_numpy(x))
    assert torch.equal(_nchw(direct.numpy()), out) and loss.item() == direct_loss.item()


def _jax_d(size=32, cap=2, seed=10, **opts):
    jd = JaxDiscriminator(size, cap, fq_dict_size=16, **opts)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    random_params(jd, seed, jnp.zeros((1, size, size, 3))))
    vq = {f"vq_{n - 1}": jax.tree_util.tree_map(jnp.asarray,
                                                _codebook(cap * 2 ** (n - 1), 16, seed + n))
          for n in opts.get("fq_layers", ())}
    return jd, params, vq


def _port_d(params, vq, size=32, cap=2, **opts):
    sd = {}
    convert.discriminator_state(params, "D", sd, vq)
    d = Discriminator(size, cap, fq_dict_size=16, **opts)
    d.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                      strict=True)
    return d


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_with_attention_and_vq_matches_jax(train):
    x = np.random.default_rng(11).random((2, 32, 32, 3), dtype=np.float32)
    jd, params, vq = _jax_d(**OPTIONS)
    (want, want_q), new = jax.jit(lambda p, v, a: jd.apply(
        {"params": p, "vq_stats": v}, a, train=train, mutable=["vq_stats"]))(
            params, vq, jnp.asarray(x))
    d = _port_d(params, vq, **OPTIONS)
    got, got_q = d(_nchw(x), train_stats=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    assert float(want_q) > 0 and abs(got_q.item() - float(want_q)) <= 1e-5 * float(want_q)
    sd = {}
    convert.discriminator_state(params, "D", sd, jax.device_get(new["vq_stats"]))
    for k, v in d.state_dict().items():
        if "quantize_blocks" in k:
            w = sd[f"D.{k}"]
            np.testing.assert_allclose(v.numpy(), w, atol=CODEBOOK_RTOL * np.abs(w).max(),
                                       err_msg=k)
    # the D gradient of logits and loss, as the D phase takes it
    loss = got.sum() + got_q
    gd = torch.autograd.grad(loss, list(d.parameters()))
    jg = jax.jit(jax.grad(lambda p: (lambda o: jnp.sum(o[0]) + o[1])(
        jd.apply({"params": p, "vq_stats": vq}, jnp.asarray(x)))))(params)
    gsd = {}
    convert.discriminator_state(jg, "D", gsd)
    for (k, _), g in zip(d.named_parameters(), gd):
        w = gsd[f"D.{k}"]
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=k)


def test_bundle_round_trip_through_export(tmp_path):
    """export_histogan_checkpoint's flat dict of a D with attention and VQ
    loads into the port's trainer with strict=True; the port's --export_pt
    writes the same keys and values; model_<k>.pt restores the codebook bit
    for bit."""
    from test_torch_steps import SMALL, _jax_params
    from histogan_tpu.utils.config import HistoGANConfig as JaxConfig

    cfg = JaxConfig(**SMALL, **OPTIONS, fq_dict_size=16)
    params_g, _ = _jax_params(cfg, seed=12)
    _, params_d, vq = _jax_d(cfg.image_size, cfg.network_capacity, seed=13, **OPTIONS)
    bundle = {"params_g": params_g, "params_d": params_d, "ema": params_g, "vq_stats": vq}
    flat = jax_convert.export_histogan_checkpoint(bundle)
    t = Trainer("p", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", seed=0,
                fq_dict_size=16, **SMALL, **OPTIONS)
    t.init_GAN()
    assert t.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()}) == []
    got = t.reference_state_dict()
    assert set(got) == set(flat)
    assert all(np.array_equal(got[k].numpy(), np.asarray(flat[k], np.float32)) for k in flat)
    assert t.export_pt(tmp_path / "out.pt") == len(flat)
    written = torch.load(tmp_path / "out.pt", weights_only=True)
    assert set(written) == set(flat)
    via_bridge = convert.state_dict_from_jax(bundle)
    assert all(torch.equal(via_bridge[k], written[k]) for k in flat)
    t.save(0)
    r = Trainer("p", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", seed=1,
                fq_dict_size=16, **SMALL)  # the architecture comes from .config.json
    r.load(0)
    assert r.cfg.fq_layers == (3,) and r.cfg.attn_layers == (1, 2)
    for k, v in t.state.D.state_dict().items():
        assert torch.equal(r.state.D.state_dict()[k], v), k
    # the codebook is buffers: not in the D optimizer
    assert {id(p) for g in r.state.opt_d.param_groups for p in g["params"]} == {
        id(p) for p in r.state.D.parameters()}
    assert not any("quantize" in n for n, _ in r.state.D.named_parameters())


def test_bf16_refuses_a_vq_layer_before_a_block_as_jax_raises(tmp_path):
    x = np.random.default_rng(14).random((2, 32, 32, 3), dtype=np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    assert vq_before_a_block(32, (1, 4, 5, 9)) == [1, 4]
    # the JAX package: VQ before a block raises in the next convolution
    jd, params, vq = _jax_d(fq_layers=(1,))
    with pytest.raises(TypeError, match="same dtypes"):
        jax.jit(jd.apply)({"params": cast_tree(params, jnp.bfloat16), "vq_stats": vq}, xb)
    # the port: the trainers refuse it with the reason, and so does D itself
    with pytest.raises(ValueError, match="precision='bf16'"):
        Trainer("b", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", image_size=32,
                network_capacity=2, precision="bf16", fq_layers=(1,))
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    with pytest.raises(ValueError, match="fq_layers=5"):
        RecoloringTrainer("b", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                          image_size=32, network_capacity=2, precision="bf16", fq_layers=(4,))
    d = _port_d(params, vq, fq_layers=(1,))
    with pytest.raises(ValueError, match="precision='bf16'"):
        steps.cast_module(d, torch.bfloat16)(_nchw(x).to(torch.bfloat16))

    # VQ at the last block and attention run under bf16 in both: fp32
    # logits and loss after VQ, bf16 logits with attention alone
    for opts, logit_dtype in (({"fq_layers": (5,), "attn_layers": (2,)}, torch.float32),
                              ({"attn_layers": (1,)}, torch.bfloat16)):
        jd, params, vq = _jax_d(**opts)
        want, want_q = jax.jit(jd.apply)(
            {"params": cast_tree(params, jnp.bfloat16), "vq_stats": vq}, xb)
        want32, _ = jax.jit(jd.apply)({"params": params, "vq_stats": vq}, jnp.asarray(x))
        d = _port_d(params, vq, **opts)
        got, got_q = steps.cast_module(d, torch.bfloat16)(_nchw(x).to(torch.bfloat16))
        assert got.dtype == logit_dtype and str(want.dtype) == str(logit_dtype).split(".")[1]
        assert got_q.dtype == (torch.float32 if "fq_layers" in opts else torch.bfloat16)
        assert str(want_q.dtype) == str(got_q.dtype).split(".")[1]
        # each within bf16's rounding of the fp32 logits
        scale = float(np.abs(np.asarray(want32)).max())
        for out in (np.asarray(want, np.float32), got.float().detach().numpy()):
            assert np.abs(out - np.asarray(want32)).max() <= 5e-2 * scale
        Trainer("b", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", image_size=32,
                network_capacity=2, precision="bf16", **opts)


def test_bf16_step_with_the_options_runs(tmp_path):
    """A bf16 GP+PL step with DiffAugment, attention and VQ at the last
    block (the placement JAX runs in bf16): finite losses, the codebook
    fp32 and moved by both phases, fp32 gradients on the fp32 masters."""
    t = Trainer("b", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", image_size=32,
                network_capacity=2, latent_dim=16, style_depth=2, batch_size=2,
                precision="bf16", aug_prob=1.0, aug_types=["color", "translation", "cutout",
                                                           "offset"],
                attn_layers=(1, 2), fq_layers=(5,), fq_dict_size=16, seed=0)
    t.init_GAN()
    rng = np.random.default_rng(15)
    h = rng.random((1, 2, 3, 64, 64), dtype=np.float32)
    h /= h.sum(axis=(2, 3, 4), keepdims=True)
    batch = {"d_images": torch.from_numpy(rng.integers(0, 256, (1, 2, 32, 32, 3), dtype=np.uint8)),
             "d_hists": torch.from_numpy(h), "g_hists": torch.from_numpy(h)}
    book = {k: v.clone() for k, v in t.state.D.named_buffers()}
    draws = steps.draw_step(t.gen, t.cfg, t.device, True, coins=t.coin_gen)
    m = steps.train_step(t.state, batch, draws, t.cfg, apply_gp=True, apply_pl=True)
    assert all(torch.isfinite(v) for v in m.values()) and m["q_loss"].item() > 0
    assert all(v.dtype == torch.float32 and not torch.equal(v, book[k])
               for k, v in t.state.D.named_buffers())
    assert all(p.dtype == torch.float32 for p in t.state.D.parameters())
    assert all(s["previous_grad"].dtype == torch.float32 and
               torch.isfinite(s["previous_grad"]).all() for s in t.state.opt_d.state.values())
