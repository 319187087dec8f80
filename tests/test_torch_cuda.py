"""The histogram kernels (K1 forward, K2 backward) and the 2x upsample
kernels (U1 forward, U2 backward) on an NVIDIA GPU against their plain
torch versions, and U1 and U2 against aten's.

These tests need a CUDA card and nvcc; elsewhere they skip. They import
no jax, so on a machine with a card and without jax they run without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from histogan_tpu_torch.ops import histogram_cuda, resize
from histogan_tpu_torch.ops.histogram import RGBuvHistBlock, histogram_feature

pytestmark = pytest.mark.cuda

INV_SIGMA2 = 1.0 / (0.02 * 0.02)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from histogan_tpu_torch.utils.platform import setup_runtime

    return setup_runtime("cuda")


def _packed(b, n, seed, dev):
    x = np.random.default_rng(seed).random((b, n, 3), dtype=np.float32)
    return histogram_cuda.pack_pixels(torch.from_numpy(x).to(dev)).contiguous()


def _normalise(h):
    return h / (h.sum(dim=(1, 2, 3), keepdim=True) + histogram_cuda.EPS)


# ragged edges (1, 7, 9, 63, 65 pixels: not whole k-steps of 8 or tiles of
# 64; 150² + 5: not whole chunks), one chunk and many, the longest chunk at
# B = 1 (250²), and the main path's shapes
@pytest.mark.parametrize("b,n", [(1, 1), (1, 7), (1, 9), (1, 63), (1, 65), (3, 1000),
                                 (2, 4096), (2, 150 * 150 + 5), (1, 250 * 250),
                                 (1, 150 * 150), (16, 64 * 64), (8, 250 * 250)])
def test_kernel_matches_plain(dev, b, n):
    packed = _packed(b, n, seed=b * 100003 + n, dev=dev)
    got = histogram_cuda.hist_core(packed, INV_SIGMA2)
    want = histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
    torch.cuda.synchronize()
    assert got.shape == (b, 3, 64, 64)
    assert torch.isfinite(got).all()
    g, w = _normalise(got), _normalise(want)
    err = (g - w).abs().max().item()
    assert err <= 1e-6
    assert err / w.abs().max().item() <= 1e-5
    # un-normalised sums: fp32 accumulated in another order
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_counter_counts_each_launch_once(dev):
    packed = _packed(2, 5000, seed=1, dev=dev)
    before = histogram_cuda.launches
    histogram_cuda.hist_core(packed, INV_SIGMA2)
    histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
    assert histogram_cuda.launches == before + 1


def test_deterministic(dev):
    packed = _packed(4, 22500, seed=2, dev=dev)
    a = histogram_cuda.hist_core(packed, INV_SIGMA2)
    b = histogram_cuda.hist_core(packed, INV_SIGMA2)
    assert torch.equal(a, b)


def test_histogram_feature_on_cuda_goes_through_kernel(dev):
    img = np.random.default_rng(3).random((2, 170, 190, 3), dtype=np.float32)
    before = histogram_cuda.launches
    got = RGBuvHistBlock(insz=150, h=64)(torch.from_numpy(img).to(dev))
    assert histogram_cuda.launches == before + 1
    want = histogram_feature(torch.from_numpy(img))  # plain einsum on the CPU
    assert (got.cpu() - want).abs().max().item() <= 1e-6


def test_other_configs_stay_plain(dev):
    img = torch.from_numpy(np.random.default_rng(4).random((1, 40, 40, 3), dtype=np.float32))
    before = histogram_cuda.launches
    for kw in ({"method": "RBF"}, {"h": 32}, {"green_only": True}, {"space": "lab"}):
        got = histogram_feature(img.to(dev), **kw)
        want = histogram_feature(img, **kw)
        assert (got.cpu() - want).abs().max().item() <= 1e-6
    assert histogram_cuda.launches == before


def _g(b, seed, dev):
    g = 1e-3 * np.random.default_rng(seed).standard_normal((b, 3, 64, 64), dtype=np.float32)
    return torch.from_numpy(g).to(dev)


def _assert_bwd_close(got, want):
    """Each of the 8 columns within 1e-5 of its largest plain entry;
    column 7 exactly 0."""
    assert torch.isfinite(got).all()
    assert torch.equal(got[..., 7], torch.zeros_like(got[..., 7]))
    for c in range(7):
        err = (got[..., c] - want[..., c]).abs().max().item()
        assert err <= 1e-5 * want[..., c].abs().max().item(), c


# ragged edges (N not a multiple of the 16-row step or of the chunk), one
# block and many, and the main path's shapes
@pytest.mark.parametrize("b,n", [(1, 1), (1, 17), (2, 127), (3, 4097), (16, 64 * 64),
                                 (16, 150 * 150), (2, 150 * 150 + 5)])
def test_backward_kernel_matches_plain(dev, b, n):
    packed = _packed(b, n, seed=b * 7 + n, dev=dev)
    g = _g(b, seed=n, dev=dev)
    got = histogram_cuda._launch_bwd(packed, g, INV_SIGMA2)
    want = histogram_cuda.hist_core_bwd_reference(packed, g, INV_SIGMA2)
    torch.cuda.synchronize()
    assert got.shape == (b, n, 8)
    _assert_bwd_close(got, want)


def test_backward_goes_through_the_kernel(dev):
    packed = _packed(2, 5000, seed=5, dev=dev).requires_grad_(True)
    g = _g(2, seed=6, dev=dev)
    before = histogram_cuda.bwd_launches
    histogram_cuda.hist_core(packed, INV_SIGMA2).backward(g)
    assert histogram_cuda.bwd_launches == before + 1
    _assert_bwd_close(packed.grad, histogram_cuda.hist_core_bwd_reference(
        packed.detach(), g, INV_SIGMA2))
    # autograd hands sum()'s gradient over expanded; the wrapper copies it
    packed.grad = None
    histogram_cuda.hist_core(packed, INV_SIGMA2).sum().backward()
    _assert_bwd_close(packed.grad, histogram_cuda.hist_core_bwd_reference(
        packed.detach(), torch.ones(2, 3, 64, 64, device=dev), INV_SIGMA2))


def test_backward_is_deterministic(dev):
    packed = _packed(4, 22500, seed=7, dev=dev)
    g = _g(4, seed=8, dev=dev)
    a = histogram_cuda._launch_bwd(packed, g, INV_SIGMA2)
    b = histogram_cuda._launch_bwd(packed, g, INV_SIGMA2)
    assert torch.equal(a, b)


def test_loss_gradient_card_vs_cpu(dev):
    from histogan_tpu_torch.ops.losses import hellinger_histogram_loss

    rng = np.random.default_rng(9)
    x = rng.random((4, 256, 256, 3), dtype=np.float32) * 1.2 - 0.1
    target = histogram_feature(torch.from_numpy(rng.random((4, 256, 256, 3), dtype=np.float32)),
                               resizing="sampling")
    grads = {}
    for d in ("cpu", dev):
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        loss = hellinger_histogram_loss(
            target.to(d), histogram_feature(torch.relu(xt), resizing="sampling"))
        loss.backward()
        grads[torch.device(d).type] = xt.grad.cpu()
    want = grads["cpu"]
    assert (grads["cuda"] - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_rejects_what_the_kernel_does_not_take(dev):
    packed = _packed(1, 100, seed=6, dev=dev)
    with pytest.raises(TypeError):
        histogram_cuda.hist_core(packed.double(), INV_SIGMA2)
    with pytest.raises(ValueError):
        histogram_cuda.hist_core(packed[:, ::2], INV_SIGMA2)
    with pytest.raises(ValueError):
        histogram_cuda.hist_core(packed[..., :7].contiguous(), INV_SIGMA2)
    misaligned = torch.empty(100 * 8 + 1, device=dev)[1:].view(1, 100, 8)  # 4 bytes off
    misaligned.copy_(packed)
    with pytest.raises(ValueError):  # contiguous, but K1 copies 16 bytes at a time
        histogram_cuda.hist_core(misaligned, INV_SIGMA2)
    g = _g(1, seed=7, dev=dev)
    with pytest.raises(TypeError):
        histogram_cuda._launch_bwd(packed, g.double(), INV_SIGMA2)
    with pytest.raises(ValueError):
        histogram_cuda._launch_bwd(packed, g[:, :2], INV_SIGMA2)
    with pytest.raises(ValueError):
        histogram_cuda._launch_bwd(packed, g.cpu(), INV_SIGMA2)


# ------------------------------------------------------- the 2x upsample, U1 and U2
# G's six x-upsamples at 256 px, capacity 16 (channels, input side), and
# its RGB upsample into 256^2
UPSAMPLE_SHAPES = [(2048, 4), (1024, 8), (512, 16), (256, 32), (128, 64), (64, 128), (3, 128)]


def _ulp_of_largest(t):
    m = t.double().abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - {torch.float32: 23, torch.bfloat16: 7,
                                            torch.float64: 52}[t.dtype])


def _upsample_inputs(b, c, s, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, c, s, s), generator=gen, device=dev).to(dtype)
    g = torch.randn((b, c, 2 * s, 2 * s), generator=gen, device=dev).to(dtype)
    return x, g


def _interpolate(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


# U1 keeps the fmas nvcc makes of aten's expression in aten's kernel, so it
# equals aten's forward bit for bit; its plain version rounds each step
# alone: up to 2 ulps of the largest value apart, in bf16 one rounding of
# those. float64: the oracles that check the port on the card run U1/U2.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("b", [16, 1])
@pytest.mark.parametrize("c,s", UPSAMPLE_SHAPES)
def test_upsample_kernel_matches_aten(dev, c, s, b, dtype):
    x, _ = _upsample_inputs(b, c, s, dtype, seed=c * s + b, dev=dev)
    got = resize.upsample2x_cuda(x)
    want = _interpolate(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    plain = resize.upsample2x_plain(x)
    ulps = 1 if dtype == torch.bfloat16 else 2
    assert (got.double() - plain.double()).abs().max().item() <= ulps * _ulp_of_largest(plain)


# U2 gathers 16 taps in fp32 (fp64 for fp64); aten's backward scatters
# with atomicAdd (in bf16 into bf16, so only fp32 and fp64 are held to it:
# 1e-6 and 1e-14 of the largest). U2 has no atomics: the same bits on every
# run, and its plain version's.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("b", [16, 1])
@pytest.mark.parametrize("c,s", UPSAMPLE_SHAPES)
def test_upsample_backward_kernel_matches_aten(dev, c, s, b, dtype):
    x, g = _upsample_inputs(b, c, s, dtype, seed=c * s + b + 1, dev=dev)
    got = resize.upsample2x_bwd_cuda(g)
    again = resize.upsample2x_bwd_cuda(g)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again)
    assert torch.equal(got, resize.upsample2x_bwd_plain(g))
    if dtype != torch.bfloat16:
        x.requires_grad_(True)
        _interpolate(x).backward(g)
        rtol = 1e-6 if dtype == torch.float32 else 1e-14
        assert (got - x.grad).abs().max().item() <= rtol * x.grad.abs().max().item()


def test_upsample_counts_each_launch_once(dev):
    from torch.profiler import ProfilerActivity, profile

    from histogan_tpu_torch.utils.logging import counters, reset_spans

    x = torch.randn((2, 3, 5, 4), device=dev, requires_grad=True)
    before = (resize.launches, resize.bwd_launches)
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        y = resize.upsample2x(x)
        y.sum().backward()  # an expanded gradient, made contiguous by the wrapper
    assert (resize.launches, resize.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert counters() == {"upsample2x": 1}
    resize.upsample2x(x.detach())  # no profiler: launched, not counted
    assert resize.launches == before[0] + 2 and counters() == {"upsample2x": 1}
    reset_spans()
    x2 = x.detach().clone().requires_grad_(True)
    _interpolate(x2).sum().backward()
    assert torch.allclose(x.grad, x2.grad, rtol=1e-6, atol=0)


def test_upsample_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn((1, 2, 4, 4), device=dev)
    before = (resize.launches, resize.bwd_launches)
    for bad in (x.half(), x.int()):
        with pytest.raises(TypeError):
            resize.upsample2x(bad)
    with pytest.raises(ValueError):
        resize.upsample2x_cuda(x.cpu())
    with pytest.raises(ValueError):
        resize.upsample2x_cuda(x[0])
    g = torch.randn((1, 2, 8, 8), device=dev)
    with pytest.raises(TypeError):
        resize.upsample2x_bwd_cuda(g.half())
    with pytest.raises(ValueError):
        resize.upsample2x_bwd_cuda(g[..., :7])
    with pytest.raises(ValueError):
        resize.upsample2x_bwd_cuda(g.cpu())
    misaligned = torch.empty(2 * 64 + 1, device=dev)[1:].view(1, 2, 8, 8)  # 4 bytes off
    misaligned.copy_(g)
    with pytest.raises(ValueError):  # contiguous, but U2 reads pairs of 8 bytes
        resize.upsample2x_bwd_cuda(misaligned)
    assert (resize.launches, resize.bwd_launches) == before


def test_g_forward_at_256_capacity_16_launches_u1_12_times(dev):
    from histogan_tpu_torch.models.generator import Generator

    torch.manual_seed(0)
    g = Generator(256, 512, 16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    styles = torch.randn((1, g.num_layers - 2, 512), generator=gen, device=dev)
    hists = torch.randn((1, 2, 512), generator=gen, device=dev)
    noise = torch.rand((1, 256, 256, 1), generator=gen, device=dev)
    before = resize.launches
    with torch.no_grad():
        out = g(styles, hists, noise)
    assert out.shape == (1, 3, 256, 256) and torch.isfinite(out).all()
    assert resize.launches - before == 12  # six x upsamples, six RGB ones


# ------------------------------------- remat, data parallel, the debug step, the profiler
# (the gates of chip_smoke.py's RM and DP phases, the JAX package's)
STEP_METRIC_RTOL = 5e-5
STEP_PARAM_REL = 1e-5
TINY = dict(image_size=32, network_capacity=4, latent_dim=32, style_depth=2, hist_bin=64,
            batch_size=2, gradient_accumulate_every=1, seed=0)


def _trainer(tmp_path, **kw):
    from histogan_tpu_torch.train.trainer import Trainer

    t = Trainer("c", str(tmp_path / "r"), str(tmp_path / "m"), device="cuda", **{**TINY, **kw})
    t.init_GAN()
    return t


def _inputs(t, pl=True):
    from histogan_tpu_torch.tools.dp_step import to_device
    from histogan_tpu_torch.train import steps

    rng = np.random.default_rng(0)
    b, s = t.cfg.batch_size, t.cfg.image_size
    h = rng.random((2, 1, b, 3, 64, 64), dtype=np.float32)
    h /= h.sum(axis=(3, 4, 5), keepdims=True)
    batch = {"d_images": torch.from_numpy(rng.integers(0, 256, (1, b, s, s, 3), np.uint8)),
             "d_hists": torch.from_numpy(h[0]), "g_hists": torch.from_numpy(h[1])}
    draws = steps.draw_step(torch.Generator().manual_seed(1), t.cfg, "cpu", pl)
    return to_device(batch, t.device), to_device(draws, t.device)


def _rel(a, b):
    num = sum((a[k].double() - b[k].double()).square().sum().item() for k in b)
    return (num / sum(b[k].double().square().sum().item() for k in b)) ** 0.5


def test_remat_step_on_the_card_matches_and_launches_alike(dev, tmp_path):
    from histogan_tpu_torch.train import steps

    out = {}
    for remat in (False, True):
        t = _trainer(tmp_path / str(remat), remat=remat)
        histogram_cuda.launches = histogram_cuda.bwd_launches = 0
        m = steps.train_step(t.state, *_inputs(t), t.cfg, True, True)
        out[remat] = ({k: v.item() for k, v in m.items()},
                      (histogram_cuda.launches, histogram_cuda.bwd_launches),
                      t.reference_state_dict())
    (m0, c0, p0), (m1, c1, p1) = out[False], out[True]
    assert c0 == c1 == (1, 1)
    assert all(abs(m1[k] - m0[k]) <= STEP_METRIC_RTOL * abs(m0[k]) + 1e-7 for k in m0)
    assert _rel(p1, p0) <= STEP_PARAM_REL


def test_checkify_sees_the_backward_on_the_card(dev, tmp_path):
    from histogan_tpu_torch.train import steps
    from histogan_tpu_torch.utils.debug import checkify_step

    t = _trainer(tmp_path)
    step = checkify_step(steps.train_step)
    step(t.state, *_inputs(t), t.cfg, True, True)
    assert step.checks.ops["convolution_backward"] > 0


def test_profiler_trace_holds_the_kernels(dev, tmp_path):
    import json

    from histogan_tpu_torch.train import steps
    from histogan_tpu_torch.utils.logging import ProfilerHook

    t = _trainer(tmp_path)
    hook = ProfilerHook(tmp_path / "tr", start=0, count=1)
    hook.step(-1)
    steps.train_step(t.state, *_inputs(t), t.cfg, True, True)
    hook.step(0)
    names = [e["name"] for e in json.loads(hook.path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    for kernel in ("hist_partial_kernel", "hist_reduce_kernel", "hist_bwd_kernel"):
        assert any(kernel in n for n in names), kernel


def test_two_gloo_ranks_on_one_card(dev, tmp_path):
    from histogan_tpu_torch.tools import dp_step
    from histogan_tpu_torch.train import steps

    kw = dict(name="dp", results_dir=str(tmp_path / "r"), models_dir=str(tmp_path / "m"),
              **{**TINY, "batch_size": 4})
    t = _trainer(tmp_path / "cfg", batch_size=4)
    batch, draws = _inputs(t)
    case = {"kind": "histogan", "trainer": kw, "state": None,
            "steps": [{"batch": {k: v.cpu() for k, v in batch.items()},
                       "draws": dp_step.to_device(draws, "cpu"), "gp": True, "pl": True}]}
    torch.save([case], tmp_path / "cases.pt")
    two = [r[0] for r in dp_step.spawn(tmp_path / "cases.pt", tmp_path / "out", 2, "gloo",
                                       "cuda:0")]
    one = dp_step.run_cases([case], "cuda")[0]
    assert all(torch.equal(two[0]["state"][k], two[1]["state"][k]) for k in two[0]["state"])
    assert all(abs(two[0]["metrics"][0][k] - w) <= STEP_METRIC_RTOL * abs(w) + 1e-7
               for k, w in one["metrics"][0].items())
    assert _rel(two[0]["state"], one["state"]) <= STEP_PARAM_REL
    assert two[0]["launches"] == {"histogram_fwd": 1, "histogram_bwd": 1}
