"""The discriminator's options in the port against the benchmark's plain
reference (``benchmark/reference/d_options.py``), on the CPU at a toy
size: the linear attention in Residual(Rezero(.)) forward and backward,
the EMA vector quantizer (output, commitment loss, codebook after an
update), D with ``attn_layers`` and ``fq_layers``, and one full training
step with recorded augmentation draws, by its losses, its first
gradients, its changed leaves and its codebook. The reference imports
neither JAX nor the port (checked in a subprocess).

Weights are seeded, with each Rezero ``g`` live (U(0.5, 1), not the
published 0), so that the attention reaches D's output. Module outputs
and gradients are held to atol 2e-5, the codebook after an update to 2e-5
of its largest entry (``test_torch_d_options.py``'s tolerances): fp32
sums taken in other orders. The step is held as ``test_torch_steps.py``
holds the port's step to the JAX package's: losses 1e-4 relative,
gradients 2e-4 of each tensor's largest entry (the GP's double backward
and the histogram backward add in other orders), post-step parameters
within 1.01 lr everywhere (DiffGrad's first update is lr * sigmoid(|g|) *
sign(g), so a gradient ~0 whose sign rounds differently moves by up to
lr) and within 1e-6 in all but a thousandth of the entries. The
reference takes the port's nearest codes only within the rounding of the
distance; the toy inputs need none beyond it (asserted).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from histogan_tpu_torch.models.attention import RezeroResidual
from histogan_tpu_torch.models.discriminator import Discriminator
from histogan_tpu_torch.models.vq import PermuteToFrom, VectorQuantize
from histogan_tpu_torch.train import steps
from histogan_tpu_torch.train.trainer import Trainer
from histogan_tpu_torch.utils.inits import reset_parameters_

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import d_options  # noqa: E402
from benchmark.reference import steps as ref_steps  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5
CODEBOOK_RTOL = 2e-5
LR = 2e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-4
STEP_CODEBOOK_RTOL = 2e-4  # EMA sums over three forwards, as GRAD_RTOL
PARAM_ATOL = 1.01 * LR
PARAM_CLOSE = 1e-6
OPTIONS = dict(attn_layers=(1, 2), fq_layers=(3,), fq_dict_size=64)
TOY = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_insz=24,
           hist_resizing="interpolation", batch_size=2, seed=0, device="cpu")


def _live_g(module, seed):
    """Each Rezero ``g`` drawn U(0.5, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("fn.g"):
                p.copy_(0.5 + 0.5 * torch.rand(p.shape, generator=gen))
    return module


def _codebook(vq, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        vq.embed.normal_(generator=gen)
        vq.embed_avg.normal_(generator=gen)
        vq.cluster_size.copy_(4 * torch.rand(vq.cluster_size.shape, generator=gen))


def _close(got, want, atol=ATOL):
    assert (got - want).abs().max().item() <= atol, (got - want).abs().max().item()


@pytest.fixture
def record_codes(monkeypatch):
    """The port's nearest codes of each VQ call, in order."""
    codes = []
    inner = VectorQuantize.nearest

    def nearest(dist):
        idx = inner(dist)
        codes.append(idx.clone())
        return idx

    monkeypatch.setattr(VectorQuantize, "nearest", staticmethod(nearest))
    return codes


def test_attention_forward_and_gradients_match_reference():
    port = _live_g(reset_parameters_(RezeroResidual(4), torch.Generator().manual_seed(1)), 2)
    ref = d_options.Residual(d_options.Rezero(d_options.ImageLinearAttention(4)))
    ref.load_state_dict(port.state_dict(), strict=True)
    x = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(3))
    xp, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    yp, yr = port(xp), ref(xr)
    _close(yp, yr)
    w = torch.randn(yp.shape, generator=torch.Generator().manual_seed(4))
    (yp * w).sum().backward()
    (yr * w).sum().backward()
    _close(xp.grad, xr.grad)
    for p, r in zip(port.parameters(), ref.parameters()):
        _close(p.grad, r.grad)


def test_vector_quantizer_matches_reference(record_codes):
    port = PermuteToFrom(VectorQuantize(8, 32))
    _codebook(port.fn, 5)
    ref = d_options.PermuteToFrom(d_options.VectorQuantize(8, 32))
    ref.load_state_dict(port.state_dict(), strict=True)
    ref.fn.pins = record_codes
    x = torch.randn((2, 8, 6, 6), generator=torch.Generator().manual_seed(6)) * 2
    out_p, loss_p = port(x, train_stats=True)
    out_r, loss_r = ref(x)
    assert ref.fn.flipped == 0 and ref.fn.pinned == 0 and record_codes == []
    _close(out_p, out_r)
    assert abs(loss_p.item() - loss_r.item()) <= ATOL * max(1.0, abs(loss_r.item()))
    for k, v in port.state_dict().items():
        want = ref.state_dict()[k]
        _close(v, want, CODEBOOK_RTOL * want.abs().max().item())


def test_discriminator_with_options_matches_reference():
    port = _live_g(reset_parameters_(Discriminator(32, 2, **OPTIONS),
                                     torch.Generator().manual_seed(7)), 8)
    ref = d_options.Discriminator(32, 2, **OPTIONS)
    ref.load_state_dict(port.state_dict(), strict=True)
    x = torch.rand((3, 3, 32, 32), generator=torch.Generator().manual_seed(9))
    logits_p, q_p = port(x, train_stats=True)
    logits_r, q_r = ref(x)
    _close(logits_p, logits_r, ATOL * max(1.0, logits_r.abs().max().item()))
    assert abs(q_p.item() - q_r.item()) <= ATOL * max(1.0, abs(q_r.item()))
    for k, v in port.state_dict().items():
        if "quantize" in k:
            want = ref.state_dict()[k]
            _close(v, want, CODEBOOK_RTOL * want.abs().max().item())


def _reference_cfg(t):
    c = t.cfg
    return {"model": "histogan", "image_size": c.image_size, "network_capacity":
            c.network_capacity, "latent_dim": c.latent_dim, "style_depth": c.style_depth,
            "hist_bin": c.hist_bin, "hist_insz": c.hist_insz, "hist_resizing": c.hist_resizing,
            "hist_sigma": c.hist_sigma, "alpha": c.alpha, "attn_layers": list(c.attn_layers),
            "fq_layers": list(c.fq_layers), "fq_dict_size": c.fq_dict_size}


def _batch(seed, b=2, s=32):
    gen = torch.Generator().manual_seed(seed)

    def hists():
        h = torch.rand((1, b, 3, 64, 64), generator=gen)
        return h / h.sum(dim=(2, 3, 4), keepdim=True)

    return {"d_images": torch.randint(0, 256, (1, b, s, s, 3), generator=gen, dtype=torch.uint8),
            "d_hists": hists(), "g_hists": hists()}


@pytest.mark.parametrize("apply_gp,apply_pl", [(True, True), (False, False)],
                         ids=["gp_pl", "plain"])
def test_train_step_with_recorded_augmentation_matches_reference(tmp_path, record_codes,
                                                                 apply_gp, apply_pl):
    t = Trainer("r", str(tmp_path / "r"), str(tmp_path / "m"), aug_prob=1.0,
                aug_types=("translation", "cutout"), **OPTIONS, **TOY)
    t.init_GAN()
    _live_g(t.state.D, 10)
    flat = {k: v.clone() for k, v in t.reference_state_dict().items()}
    m = d_options.load_flat(d_options.build_modules(_reference_cfg(t), "meta"), flat)
    batch = _batch(11)
    draws = steps.draw_step(torch.Generator().manual_seed(12), t.cfg, "cpu", apply_pl)
    assert all(a.apply for pair in draws.d_aug for a in pair) and draws.g_aug[0].apply
    metrics = steps.train_step(t.state, batch, draws, t.cfg, apply_gp, apply_pl)
    assert len(record_codes) == 3  # fakes, reals, G's fakes

    for q in m["D"].quantizers():
        q.pins = record_codes
    opt_d = ref_steps.DiffGrad(list(m["D"].parameters()), LR)
    opt_g = ref_steps.DiffGrad([p for k in "SHG" for p in m[k].parameters()], LR)
    grads = {}
    want, pl_mean = d_options.histogan_step(m, opt_d, opt_g, batch, dataclasses.asdict(draws),
                                            _reference_cfg(t), apply_gp, apply_pl, False,
                                            torch.zeros(()), grads)
    assert sum(q.flipped for q in m["D"].quantizers()) == 0
    want["pl_mean"] = pl_mean
    assert want["q_loss"] > 0 and (want["gp_loss"] > 0) == apply_gp
    for k, v in want.items():
        got = metrics[k].item()
        assert abs(got - v.item()) <= LOSS_RTOL * abs(v.item()) + 1e-7, (k, got, v.item())

    s = t.state
    got_grads = [s.opt_d.state[p]["previous_grad"] for p in s.D.parameters()]
    got_grads += [s.opt_g.state[p]["previous_grad"] for k in "SHG"
                  for p in getattr(s, k).parameters()]
    for g, w in zip(got_grads, grads["D"] + grads["G"], strict=True):
        assert (g - w).abs().max().item() <= GRAD_RTOL * w.abs().max().item() + 1e-12

    after = t.reference_state_dict()
    ref_after = {f"{p}.{n}": v for p, mod in m.items()
                 for n, v in list(mod.named_parameters()) + list(mod.named_buffers())}
    assert set(after) == set(ref_after)
    off = 0
    for k, v in after.items():
        w = ref_after[k].detach()
        if "quantize_blocks" in k:
            assert not torch.equal(v, flat[k]), k  # all three D calls moved the codebook
            _close(v, w, STEP_CODEBOOK_RTOL * w.abs().max().item())
            continue
        assert (v - w).abs().max().item() <= PARAM_ATOL, k
        off += int(((v - w).abs() > PARAM_CLOSE).sum())
    assert off <= 1e-3 * sum(v.numel() for v in after.values())


def test_reference_loads_neither_jax_nor_the_port():
    code = ("import sys, benchmark.reference.d_options, benchmark.work.flops_dopts; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'histogan_tpu', 'histogan_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
