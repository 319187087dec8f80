"""VGG16 perceptual loss (reference utils/vggloss.py:5-51), the
counterpart of ``histogan_tpu/ops/vgg.py``.

Feature blocks are torchvision VGG16 ``features`` slices [:4], [4:9],
[9:16], [16:23] (conv+relu stacks up to relu1_2 / relu2_2 / relu3_3 /
relu4_3), ImageNet normalization, bilinear resize to 224, L1 over
feature maps; optional Gram-matrix style terms. The convolutions are
cuDNN's on a GPU: the JAX package leaves them to XLA, with no Pallas
kernel.

Weights: nothing is downloaded, so pretrained weights must be provided
as a file, a torchvision ``vgg16`` state_dict (.pth) or an .npz with the
same keys. Set ``VGG16_WEIGHTS`` or pass ``weights_path``. Without
weights the loss is unavailable and callers should run with
vgg_loss_weight=0. ``random_vgg16_state`` gives seeded weights at the
real shapes, for timing and tests.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16.features conv layer indices per block slice
_BLOCK_CONVS = [
    [0, 2],            # features[:4]   conv1_1, conv1_2
    [5, 7],            # features[4:9]  conv2_1, conv2_2
    [10, 12, 14],      # features[9:16] conv3_*
    [17, 19, 21],      # features[16:23] conv4_*
]
_POOL_AFTER_BLOCK = [True, True, True, False]  # maxpool at 4, 9, 16; none before 23

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


# torchvision vgg16 'features' conv (index, in_channels, out_channels)
# up to relu4_3 — the slice the perceptual loss consumes
_VGG16_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
]


def random_vgg16_state(seed: int = 0) -> dict:
    """Random He-init weights in torchvision's vgg16 ``features``
    state-dict layout, at the REAL shapes (numpy, the JAX package's draws
    bit for bit). For timing and tests where no pretrained file exists:
    the work per step is the same for random and pretrained values."""
    rng = np.random.RandomState(seed)
    out = {}
    for idx, cin, cout in _VGG16_CONVS:
        out[f"features.{idx}.weight"] = (
            rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (cin * 9))
        ).astype(np.float32)
        out[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
    return out


def load_vgg16_weights(weights_path: Optional[str] = None
                       ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Load {conv_idx: (weight OIHW, bias)} from a .pth state_dict or .npz,
    fp32 on the CPU. torchvision's OIHW layout is the port's own, so
    nothing is transposed."""
    path = weights_path or os.environ.get("VGG16_WEIGHTS")
    if not path or not os.path.exists(path or ""):
        raise FileNotFoundError(
            "VGG16 weights not found. Download torchvision's vgg16 state "
            "dict on a machine with network access and point VGG16_WEIGHTS "
            "at the .pth/.npz file."
        )
    if path.endswith(".npz"):
        with np.load(path) as data:
            raw = {k: torch.from_numpy(data[k]) for k in data.files}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for block in _BLOCK_CONVS:
        for idx in block:
            out[idx] = (raw[f"features.{idx}.weight"].float().contiguous(),
                        raw[f"features.{idx}.bias"].float().contiguous())
    return out


class VGGPerceptualLoss(nn.Module):
    """(input, target) -> scalar; images NHWC in [0,1], as the JAX loss
    takes them (NCHW inside). The weights are buffers: they move with
    ``.to(device)`` and take no gradient."""

    def __init__(self, weights_path: Optional[str] = None, resize: bool = True):
        super().__init__()
        self.resize = resize
        for idx, (w, b) in load_vgg16_weights(weights_path).items():
            self.register_buffer(f"weight{idx}", w)
            self.register_buffer(f"bias{idx}", b)
        self.register_buffer("mean", torch.from_numpy(_MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.from_numpy(_STD).view(1, 3, 1, 1))

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for bi, block in enumerate(_BLOCK_CONVS):
            for idx in block:
                x = F.relu(F.conv2d(x, getattr(self, f"weight{idx}"),
                                    getattr(self, f"bias{idx}"), padding=1))
            feats.append(x)
            if _POOL_AFTER_BLOCK[bi]:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [0, 1] -> normalised NCHW, resized to 224 (half-pixel
        bilinear without antialiasing, as ``jax.image.resize(...,
        antialias=False)``, also when it scales down)."""
        x = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        if self.resize:
            x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False,
                              antialias=False)
        return x

    def forward(self, input_img: torch.Tensor, target_img: torch.Tensor,
                feature_layers: Sequence[int] = (0, 1, 2, 3),
                style_layers: Sequence[int] = ()) -> torch.Tensor:
        fx = self._features(self._prep(input_img))
        fy = self._features(self._prep(target_img))
        loss = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            if i in feature_layers:
                loss += torch.mean(torch.abs(a - b))
            if i in style_layers:
                am = a.reshape(a.shape[0], a.shape[1], -1)
                bm = b.reshape(b.shape[0], b.shape[1], -1)
                ga = am @ am.transpose(1, 2)
                gb = bm @ bm.transpose(1, 2)
                loss += torch.mean(torch.square(ga - gb))
        return loss
