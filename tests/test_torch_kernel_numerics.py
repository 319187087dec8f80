"""The arithmetic of the histogram kernels, K1 (forward,
``histogan_tpu_torch/csrc/histogram_fwd.cu``) and K2 (backward,
``csrc/histogram_bwd.cu``), emulated on the CPU.

Both run their products on the tensor cores in split TF32: each operand x
becomes hi + lo, both TF32 (10 mantissa bits), and a . b is taken as
lo.hi + hi.lo + hi.hi with an fp32 sum. K1's product per plane is
(iy ku)^T . kv over the pixels, K2's are kv . g^T and ku . g. Here the
same split, written with integer operations on the fp32 bits, feeds fp32
matmuls, and the result is held against the plain versions
``hist_core_reference`` and ``hist_core_bwd_reference`` with the kernels'
gates: for K1 1e-6 absolute and 1e-5 of max|plain| on the normalised
histogram and 1e-5 of max|plain| un-normalised, for K2 1e-5 of max|plain|
on every column. The split is rounded two ways: to nearest with ties away
from zero, as ``cvt.rna.tf32.f32`` rounds (add 0x1000 to the bits, then
clear the low 13), and by truncation, as the kernels do it (they hand x
over as hi, and the tensor core reads only the top 19 bits). One-pass
TF32 (hi.hi alone) must miss the relative gate: that is why the split is
there. Also the work and bound counts that ``chip_smoke.py`` prints.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from histogan_tpu_torch.ops import histogram_cuda

INV_SIGMA2 = 1.0 / (0.02 * 0.02)
GATE = 1e-5  # chip_smoke.py's KERNEL_TOL_REL: K2 per column, K1 relative
GATE_ABS = 1e-6  # chip_smoke.py's KERNEL_TOL_ABS: K1, normalised histogram
# Pixels of one accumulator run of K1: a warp's 16 k-steps of 8 pixels,
# whose sum is then added in fp32 into its running sum.
FWD_RUN = 128


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """x (fp32) to TF32: "rna" to nearest, ties away from zero; "trunc"
    toward zero."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, rounding: str) -> torch.Tensor:
    a_hi, b_hi = tf32(a, rounding), tf32(b, rounding)
    a_lo, b_lo = tf32(a - a_hi, rounding), tf32(b - b_hi, rounding)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def one_pass_matmul(a: torch.Tensor, b: torch.Tensor, rounding: str) -> torch.Tensor:
    return tf32(a, rounding) @ tf32(b, rounding)


def bwd_emulated(packed, g, matmul):
    """K2's formulas with its products taken by ``matmul``: per plane
    kvg = kv . g^T and kug = iy (ku . g), then the plain epilogue."""
    centers = histogram_cuda._centers()
    iy = packed[..., 6:7]
    cols, diy = [], torch.zeros_like(iy)
    for c in range(3):
        du_arg = packed[..., 2 * c : 2 * c + 1] - centers
        dv_arg = packed[..., 2 * c + 1 : 2 * c + 2] - centers
        ku = 1.0 / (1.0 + torch.square(du_arg) * INV_SIGMA2)
        kv = 1.0 / (1.0 + torch.square(dv_arg) * INV_SIGMA2)
        kvg = matmul(kv, g[:, c].transpose(-1, -2))
        kug = iy * matmul(ku, g[:, c])
        cols.append((iy * kvg * (-2.0 * du_arg * INV_SIGMA2 * torch.square(ku))).sum(-1, True))
        cols.append((kug * (-2.0 * dv_arg * INV_SIGMA2 * torch.square(kv))).sum(-1, True))
        diy = diy + (ku * kvg).sum(-1, keepdim=True)
    return torch.cat(cols + [diy, torch.zeros_like(diy)], dim=-1)


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((b, n, 3), dtype=np.float32))
    g = torch.from_numpy(1e-3 * rng.standard_normal((b, 3, 64, 64), dtype=np.float32))
    return histogram_cuda.pack_pixels(x).contiguous(), g


def _column_errors(got, want):
    """max|got - want| over max|want|, for each of the 7 live columns."""
    return [((got[..., c] - want[..., c]).abs().max() / want[..., c].abs().max()).item()
            for c in range(7)]


def test_tf32_rounding_of_the_bits():
    one_ulp = 2.0 ** -10  # of TF32 at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, 1.0 + one_ulp / 4, -(1.0 + one_ulp / 2),
                      1.0 + 3 * one_ulp / 4, 3.0], dtype=torch.float32)
    assert tf32(x, "rna").tolist() == [1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + one_ulp, 3.0]
    assert tf32(x, "trunc").tolist() == [1.0, 1.0, -1.0, 1.0, 3.0]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(1000, dtype=np.float32))
    for rounding in ("rna", "trunc"):
        assert (tf32(r, rounding).view(torch.int32) & 0x1FFF).eq(0).all()
        assert ((tf32(r, rounding) - r).abs() <= r.abs() * 2.0 ** -10).all()


@pytest.mark.parametrize("rounding", ["rna", "trunc"])
@pytest.mark.parametrize("b,n", [(2, 4097), (1, 17)])
def test_split_tf32_is_within_the_kernel_gate(b, n, rounding):
    packed, g = _inputs(b, n, seed=b * 7 + n)
    want = histogram_cuda.hist_core_bwd_reference(packed, g, INV_SIGMA2)
    got = bwd_emulated(packed, g, lambda x, y: split_matmul(x, y, rounding))
    errs = _column_errors(got, want)
    assert max(errs) <= GATE, errs
    assert torch.equal(got[..., 7], torch.zeros_like(got[..., 7]))


@pytest.mark.parametrize("rounding", ["rna", "trunc"])
@pytest.mark.parametrize("b,n", [(2, 4097), (1, 17)])
def test_one_pass_tf32_misses_the_kernel_gate(b, n, rounding):
    packed, g = _inputs(b, n, seed=b * 7 + n)
    want = histogram_cuda.hist_core_bwd_reference(packed, g, INV_SIGMA2)
    got = bwd_emulated(packed, g, lambda x, y: one_pass_matmul(x, y, rounding))
    errs = _column_errors(got, want)
    assert max(errs) > 10 * GATE, errs


def fwd_emulated(packed, matmul):
    """K1's product with ``matmul``: per plane (iy ku)^T . kv over runs
    of FWD_RUN pixels (the ragged edge padded with zeros: iy = 0), the
    runs' products summed in fp32."""
    b, n, _ = packed.shape
    runs = F.pad(packed, (0, 0, 0, (-n) % FWD_RUN)).reshape(b, -1, FWD_RUN, 8)
    centers = histogram_cuda._centers()
    iy = runs[..., 6:7]
    planes = []
    for c in range(3):
        ku = 1.0 / (1.0 + torch.square(runs[..., 2 * c : 2 * c + 1] - centers) * INV_SIGMA2)
        kv = 1.0 / (1.0 + torch.square(runs[..., 2 * c + 1 : 2 * c + 2] - centers) * INV_SIGMA2)
        planes.append(matmul((iy * ku).transpose(-1, -2), kv).sum(dim=1))
    return torch.stack(planes, dim=1)


def _fwd_errors(got, want):
    """(max|got - want|, that over max|want|) of the normalised
    histograms, and max|got - want| over max|want| un-normalised."""
    g, w = (h / (h.sum(dim=(1, 2, 3), keepdim=True) + histogram_cuda.EPS) for h in (got, want))
    err = (g - w).abs().max().item()
    return err, err / w.abs().max().item(), ((got - want).abs().max() / want.abs().max()).item()


FWD_SHAPES = [(2, 4097), (1, 17), (1, 150 * 150)]


@pytest.mark.parametrize("rounding", ["rna", "trunc"])
@pytest.mark.parametrize("b,n", FWD_SHAPES)
def test_forward_split_tf32_is_within_the_kernel_gate(b, n, rounding):
    packed, _ = _inputs(b, n, seed=b * 11 + n)
    want = histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
    got = fwd_emulated(packed, lambda x, y: split_matmul(x, y, rounding))
    err, rel, raw_rel = _fwd_errors(got, want)
    assert err <= GATE_ABS and rel <= GATE and raw_rel <= GATE, (err, rel, raw_rel)


@pytest.mark.parametrize("rounding", ["rna", "trunc"])
@pytest.mark.parametrize("b,n", FWD_SHAPES)
def test_forward_one_pass_tf32_misses_the_kernel_gate(b, n, rounding):
    packed, _ = _inputs(b, n, seed=b * 11 + n)
    want = histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
    got = fwd_emulated(packed, lambda x, y: one_pass_matmul(x, y, rounding))
    _, rel, _ = _fwd_errors(got, want)
    assert rel > GATE, rel


# Hand-checked at the training loss's shape, 16 images of 64 x 64 pixels:
# 3 planes x 16 x 4096 pixels x 64 bins = 12 582 912 (pixel, plane, bin)
# triples; K2's two products 4 x 64 FLOP each, 3 221 225 472 = 3.22 GFLOP,
# K1's one 1.61 GFLOP; packed 16 x 4096 x 32 bytes = 2 097 152, g or the
# histogram 16 x 3 x 4096 x 4 = 786 432.
@pytest.mark.parametrize("name,work,bound_ms", [
    ("histogram_bwd", {"flop": 3_221_225_472, "elementwise": 26 * 12_582_912,
                       "bytes": 2 * 2_097_152 + 786_432}, 3_221_225_472 / 165e9),
    ("histogram_fwd", {"flop": 1_610_612_736, "elementwise": 11 * 12_582_912,
                       "bytes": 2_097_152 + 786_432}, 1_610_612_736 / 165e9),
])
def test_kernel_work_and_bound_at_the_loss_shape(name, work, bound_ms):
    got = histogram_cuda.kernel_work(name, 16, 64 * 64)
    assert got == work
    ms, by = histogram_cuda.bound_ms(got)
    assert ms == pytest.approx(bound_ms, rel=1e-12)
    assert by == "operations"
    assert round(ms * 1e3, 1) == {"histogram_bwd": 19.5, "histogram_fwd": 9.8}[name]  # us


def test_bound_of_a_single_pixel_is_the_bytes():
    work = histogram_cuda.kernel_work("histogram_bwd", 1, 1)
    ms, by = histogram_cuda.bound_ms(work)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (2 * 32 + 3 * 64 * 64 * 4) / 3.35e12, rel=1e-12)
    with pytest.raises(KeyError):
        histogram_cuda.kernel_work("histogram_other", 1, 1)
