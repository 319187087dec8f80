"""InceptionV3 pool3 feature extractor (the standard FID backbone), the
counterpart of ``histogan_tpu/metrics/inception.py``.

torchvision's ``inception_v3`` truncated at the final average pool (2048-d
"pool3" features), with pytorch-fid's preprocessing: bilinear resize to
299x299 (align_corners=False, no antialias) and normalization to [-1, 1].
Every BatchNorm (eval mode, eps 1e-3) is folded into a per-channel scale
and shift at load time, so the body is conv + affine + relu on
``F.conv2d`` (cuDNN on a GPU; the JAX package runs it as XLA
convolutions, not Pallas), NCHW inside, over OIHW weights.

Weights: a torchvision ``inception_v3`` state dict as .npz or .pt/.pth
(``load_weights_file``; a .pt is read by ``torch.load(weights_only=True)``,
no torchvision needed). Without one, ``random_params(seed)`` builds the
JAX package's deterministic He-initialized network, bit for bit: a
relative quality signal, not comparable with published FID numbers.

The params layout is the JAX module's ({name: {"kernel" HWIO, "scale",
"shift"}}), so one params dict drives both packages.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(eps=0.001)

# ---------------------------------------------------------------- spec
# name -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw))
ConvSpec = Tuple[int, int, Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _build_specs() -> Dict[str, ConvSpec]:
    s: Dict[str, ConvSpec] = {}

    def c(name, cin, cout, k, stride=(1, 1), pad=(0, 0)):
        s[name] = (cin, cout, k, stride, pad)

    # stem
    c("Conv2d_1a_3x3", 3, 32, (3, 3), (2, 2))
    c("Conv2d_2a_3x3", 32, 32, (3, 3))
    c("Conv2d_2b_3x3", 32, 64, (3, 3), pad=(1, 1))
    c("Conv2d_3b_1x1", 64, 80, (1, 1))
    c("Conv2d_4a_3x3", 80, 192, (3, 3))

    def block_a(m, cin, pf):
        c(f"{m}.branch1x1", cin, 64, (1, 1))
        c(f"{m}.branch5x5_1", cin, 48, (1, 1))
        c(f"{m}.branch5x5_2", 48, 64, (5, 5), pad=(2, 2))
        c(f"{m}.branch3x3dbl_1", cin, 64, (1, 1))
        c(f"{m}.branch3x3dbl_2", 64, 96, (3, 3), pad=(1, 1))
        c(f"{m}.branch3x3dbl_3", 96, 96, (3, 3), pad=(1, 1))
        c(f"{m}.branch_pool", cin, pf, (1, 1))
        return 64 + 64 + 96 + pf

    def block_b(m, cin):
        c(f"{m}.branch3x3", cin, 384, (3, 3), (2, 2))
        c(f"{m}.branch3x3dbl_1", cin, 64, (1, 1))
        c(f"{m}.branch3x3dbl_2", 64, 96, (3, 3), pad=(1, 1))
        c(f"{m}.branch3x3dbl_3", 96, 96, (3, 3), (2, 2))
        return 384 + 96 + cin

    def block_c(m, cin, c7):
        c(f"{m}.branch1x1", cin, 192, (1, 1))
        c(f"{m}.branch7x7_1", cin, c7, (1, 1))
        c(f"{m}.branch7x7_2", c7, c7, (1, 7), pad=(0, 3))
        c(f"{m}.branch7x7_3", c7, 192, (7, 1), pad=(3, 0))
        c(f"{m}.branch7x7dbl_1", cin, c7, (1, 1))
        c(f"{m}.branch7x7dbl_2", c7, c7, (7, 1), pad=(3, 0))
        c(f"{m}.branch7x7dbl_3", c7, c7, (1, 7), pad=(0, 3))
        c(f"{m}.branch7x7dbl_4", c7, c7, (7, 1), pad=(3, 0))
        c(f"{m}.branch7x7dbl_5", c7, 192, (1, 7), pad=(0, 3))
        c(f"{m}.branch_pool", cin, 192, (1, 1))
        return 192 * 4

    def block_d(m, cin):
        c(f"{m}.branch3x3_1", cin, 192, (1, 1))
        c(f"{m}.branch3x3_2", 192, 320, (3, 3), (2, 2))
        c(f"{m}.branch7x7x3_1", cin, 192, (1, 1))
        c(f"{m}.branch7x7x3_2", 192, 192, (1, 7), pad=(0, 3))
        c(f"{m}.branch7x7x3_3", 192, 192, (7, 1), pad=(3, 0))
        c(f"{m}.branch7x7x3_4", 192, 192, (3, 3), (2, 2))
        return 320 + 192 + cin

    def block_e(m, cin):
        c(f"{m}.branch1x1", cin, 320, (1, 1))
        c(f"{m}.branch3x3_1", cin, 384, (1, 1))
        c(f"{m}.branch3x3_2a", 384, 384, (1, 3), pad=(0, 1))
        c(f"{m}.branch3x3_2b", 384, 384, (3, 1), pad=(1, 0))
        c(f"{m}.branch3x3dbl_1", cin, 448, (1, 1))
        c(f"{m}.branch3x3dbl_2", 448, 384, (3, 3), pad=(1, 1))
        c(f"{m}.branch3x3dbl_3a", 384, 384, (1, 3), pad=(0, 1))
        c(f"{m}.branch3x3dbl_3b", 384, 384, (3, 1), pad=(1, 0))
        c(f"{m}.branch_pool", cin, 192, (1, 1))
        return 320 + 768 + 768 + 192

    ch = block_a("Mixed_5b", 192, 32)   # 256
    ch = block_a("Mixed_5c", ch, 64)    # 288
    ch = block_a("Mixed_5d", ch, 64)    # 288
    ch = block_b("Mixed_6a", ch)        # 768
    ch = block_c("Mixed_6b", ch, 128)
    ch = block_c("Mixed_6c", ch, 160)
    ch = block_c("Mixed_6d", ch, 160)
    ch = block_c("Mixed_6e", ch, 192)
    ch = block_d("Mixed_7a", ch)        # 1280
    ch = block_e("Mixed_7b", ch)        # 2048
    ch = block_e("Mixed_7c", ch)        # 2048
    assert ch == 2048
    return s


CONV_SPECS: Dict[str, ConvSpec] = _build_specs()
FEATURE_DIM = 2048


# ------------------------------------------------------------- loading
def fold_bn(kernel_oihw: np.ndarray, gamma, beta, mean, var,
            eps: float = BN_EPS) -> Dict[str, np.ndarray]:
    """Conv (no bias) + eval-mode BatchNorm -> HWIO kernel + per-channel
    scale/shift: y = conv(x) * scale + shift."""
    scale = np.asarray(gamma, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps
    )
    shift = np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * scale
    return {
        "kernel": np.transpose(np.asarray(kernel_oihw, np.float32), (2, 3, 1, 0)),
        "scale": scale,
        "shift": shift,
    }


def load_torchvision_state_dict(raw: Mapping[str, np.ndarray]) -> Dict:
    """torchvision inception_v3 state dict (numpy values) -> params.
    AuxLogits/fc keys are ignored (pool3 features don't use them)."""
    params = {}
    for name, (cin, cout, k, _, _) in CONV_SPECS.items():
        w = raw[f"{name}.conv.weight"]
        assert tuple(w.shape) == (cout, cin, k[0], k[1]), (
            f"{name}: expected {(cout, cin, *k)}, got {tuple(w.shape)}"
        )
        params[name] = fold_bn(
            w,
            raw[f"{name}.bn.weight"],
            raw[f"{name}.bn.bias"],
            raw[f"{name}.bn.running_mean"],
            raw[f"{name}.bn.running_var"],
        )
    return params


def load_weights_file(path: str) -> Dict:
    """Load params from a .npz (torchvision key names) or a torch .pt/.pth
    state dict file (``torch.load(weights_only=True)``)."""
    if path.endswith(".npz"):
        raw = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        raw = {k: v.numpy() for k, v in sd.items()}
    return load_torchvision_state_dict(raw)


def random_params(seed: int = 0) -> Dict:
    """Deterministic He-normal random network (the documented fallback
    extractor for environments without the pretrained weights). BN folds
    to identity (scale=1, shift=0)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (cin, cout, k, _, _) in CONV_SPECS.items():
        fan_in = cin * k[0] * k[1]
        kernel = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                            (k[0], k[1], cin, cout)).astype(np.float32)
        params[name] = {
            "kernel": kernel,
            "scale": np.ones((cout,), np.float32),
            "shift": np.zeros((cout,), np.float32),
        }
    return params


# ------------------------------------------------------------- forward
class _Conv(nn.Module):
    """BasicConv2d with its BN folded: relu(conv(x) * scale + shift)."""

    def __init__(self, spec: ConvSpec, p: Mapping[str, np.ndarray]):
        super().__init__()
        _, _, _, self.stride, self.pad = spec
        kernel = np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1))  # HWIO->OIHW
        self.register_buffer("weight", torch.from_numpy(np.ascontiguousarray(kernel)))
        self.register_buffer("scale", torch.from_numpy(np.asarray(p["scale"], np.float32))
                             .reshape(-1, 1, 1))
        self.register_buffer("shift", torch.from_numpy(np.asarray(p["shift"], np.float32))
                             .reshape(-1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, stride=self.stride, padding=self.pad)
        return F.relu(y * self.scale + self.shift)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2)  # VALID


def _avgpool3s1p1(x: torch.Tensor) -> torch.Tensor:
    # count_include_pad: the divisor is 9 at the zero-padded borders too
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=True)


class InceptionPool3(nn.Module):
    """(B, 299, 299, 3) NHWC in [-1, 1] -> (B, 2048) pool3 features."""

    def __init__(self, params: Mapping[str, Mapping[str, np.ndarray]]):
        super().__init__()
        self.convs = nn.ModuleDict({name.replace(".", "_"): _Conv(spec, params[name])
                                    for name, spec in CONV_SPECS.items()})

    def _bc(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.convs[name.replace(".", "_")](x)

    def _block_a(self, m, x):
        b1 = self._bc(f"{m}.branch1x1", x)
        b5 = self._bc(f"{m}.branch5x5_2", self._bc(f"{m}.branch5x5_1", x))
        b3 = self._bc(f"{m}.branch3x3dbl_1", x)
        b3 = self._bc(f"{m}.branch3x3dbl_2", b3)
        b3 = self._bc(f"{m}.branch3x3dbl_3", b3)
        bp = self._bc(f"{m}.branch_pool", _avgpool3s1p1(x))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, m, x):
        b3 = self._bc(f"{m}.branch3x3", x)
        bd = self._bc(f"{m}.branch3x3dbl_1", x)
        bd = self._bc(f"{m}.branch3x3dbl_2", bd)
        bd = self._bc(f"{m}.branch3x3dbl_3", bd)
        return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)

    def _block_c(self, m, x):
        b1 = self._bc(f"{m}.branch1x1", x)
        b7 = self._bc(f"{m}.branch7x7_1", x)
        b7 = self._bc(f"{m}.branch7x7_2", b7)
        b7 = self._bc(f"{m}.branch7x7_3", b7)
        bd = self._bc(f"{m}.branch7x7dbl_1", x)
        for i in (2, 3, 4, 5):
            bd = self._bc(f"{m}.branch7x7dbl_{i}", bd)
        bp = self._bc(f"{m}.branch_pool", _avgpool3s1p1(x))
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, m, x):
        b3 = self._bc(f"{m}.branch3x3_2", self._bc(f"{m}.branch3x3_1", x))
        b7 = self._bc(f"{m}.branch7x7x3_1", x)
        b7 = self._bc(f"{m}.branch7x7x3_2", b7)
        b7 = self._bc(f"{m}.branch7x7x3_3", b7)
        b7 = self._bc(f"{m}.branch7x7x3_4", b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)

    def _block_e(self, m, x):
        b1 = self._bc(f"{m}.branch1x1", x)
        b3 = self._bc(f"{m}.branch3x3_1", x)
        b3 = torch.cat([self._bc(f"{m}.branch3x3_2a", b3), self._bc(f"{m}.branch3x3_2b", b3)],
                       dim=1)
        bd = self._bc(f"{m}.branch3x3dbl_1", x)
        bd = self._bc(f"{m}.branch3x3dbl_2", bd)
        bd = torch.cat([self._bc(f"{m}.branch3x3dbl_3a", bd),
                        self._bc(f"{m}.branch3x3dbl_3b", bd)], dim=1)
        bp = self._bc(f"{m}.branch_pool", _avgpool3s1p1(x))
        return torch.cat([b1, b3, bd, bp], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = self._bc("Conv2d_1a_3x3", x)
        x = self._bc("Conv2d_2a_3x3", x)
        x = self._bc("Conv2d_2b_3x3", x)
        x = _maxpool3s2(x)
        x = self._bc("Conv2d_3b_1x1", x)
        x = self._bc("Conv2d_4a_3x3", x)
        x = _maxpool3s2(x)
        for m in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(m, x)
        x = self._block_b("Mixed_6a", x)
        for m in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(m, x)
        x = self._block_d("Mixed_7a", x)
        x = self._block_e("Mixed_7b", x)
        x = self._block_e("Mixed_7c", x)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1x1


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """pytorch-fid preprocessing: NHWC [0, 1] -> bilinear resize to size x
    size (align_corners=False, no antialias) -> [-1, 1], NHWC."""
    images = images.float()
    if images.shape[1] != size or images.shape[2] != size:
        images = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                               align_corners=False, antialias=False).permute(0, 2, 3, 1)
    return images * 2.0 - 1.0


def make_extractor(params, device="cuda", resize: bool = True):
    """Callable (B, H, W, 3) in [0, 1] (numpy or tensor) -> numpy (B, 2048),
    computed on ``device`` in fp32 (the port's runtime keeps TF32 off)."""
    net = InceptionPool3(params).to(device).eval()

    @torch.inference_mode()
    def extract(images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                            dtype=torch.float32).to(device)
        return net(preprocess(x) if resize else x).cpu().numpy()

    return extract
