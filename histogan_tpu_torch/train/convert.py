"""The weight bridge into the port.

The port's modules hold their parameters under the reference's
state-dict names and shapes (histoGAN/histoGAN.py:634-715): Linear
(out, in), Conv2DMod OIHW, ``initial_block`` (C, 4, 4). So

- a reference-layout ``.pt`` (the published checkpoints, and the file the
  JAX package's ``--export_pt`` writes) loads with
  ``load_state_dict(strict=True)`` on each prefix: ``load_reference_pt``;
- the JAX package's parameter trees (nested dicts of arrays, NHWC/HWIO)
  become that layout through ``state_dict_from_jax``, which re-states
  ``histogan_tpu/train/convert.py``'s ``export_*`` without importing it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# state-dict prefixes the sampler loads; D.* waits for the discriminator
SAMPLER_PREFIXES = ("S", "H", "G", "SE", "HE", "GE")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _count(tree: Mapping, fmt: str) -> int:
    n = 0
    while fmt.format(n) in tree:
        n += 1
    return n


def _linear(tree: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(tree["kernel"]).T)
    out[f"{prefix}.bias"] = _np(tree["bias"])


def _conv2dmod(tree: Mapping, prefix: str, out: Dict) -> None:
    # HWIO -> OIHW
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(_np(tree["weight"]), (3, 2, 0, 1)))


def style_vectorizer_state(tree: Mapping, prefix: str, out: Dict) -> None:
    for i in range(_count(tree, "fc{}")):
        _linear(tree[f"fc{i}"], f"{prefix}.net.{2 * i}", out)


def hist_vectorizer_state(tree: Mapping, prefix: str, out: Dict) -> None:
    for i in range(_count(tree, "fc{}")):
        _linear(tree[f"fc{i}"], f"{prefix}.fcs.{2 * i}", out)


def generator_block_state(tree: Mapping, prefix: str, out: Dict) -> None:
    for name in ("to_style1", "to_style2", "to_noise1", "to_noise2"):
        _linear(tree[name], f"{prefix}.{name}", out)
    _conv2dmod(tree["conv1"], f"{prefix}.conv1", out)
    _conv2dmod(tree["conv2"], f"{prefix}.conv2", out)
    _linear(tree["to_rgb"]["to_style"], f"{prefix}.to_rgb.to_style", out)
    _conv2dmod(tree["to_rgb"]["conv"], f"{prefix}.to_rgb.conv", out)


def generator_state(tree: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.initial_block"] = np.ascontiguousarray(
        np.transpose(_np(tree["initial_block"]), (2, 0, 1)))
    for i in range(_count(tree, "blocks_{}")):
        generator_block_state(tree[f"blocks_{i}"], f"{prefix}.blocks.{i}", out)


def state_dict_from_jax(bundle: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter bundle {'params_g': {'S','H','G'}, 'ema': {...}} ->
    the reference-layout state dict for the S/H/G/SE/HE/GE prefixes.
    ``params_d`` is not converted: the discriminator is not ported yet."""
    out: Dict[str, np.ndarray] = {}
    for tree, (s, h, g) in ((bundle["params_g"], ("S", "H", "G")),
                            (bundle["ema"], ("SE", "HE", "GE"))):
        style_vectorizer_state(tree["S"], s, out)
        hist_vectorizer_state(tree["H"], h, out)
        generator_state(tree["G"], g, out)
    return {k: torch.tensor(v) for k, v in out.items()}


def load_reference_pt(path) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pt`` (flat ``GAN.state_dict()``) as CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def split_by_prefix(sd: Mapping[str, torch.Tensor]):
    """-> ({prefix: sub-state-dict} for SAMPLER_PREFIXES, sorted keys of
    every other prefix)."""
    parts = {p: {} for p in SAMPLER_PREFIXES}
    others = []
    for key, value in sd.items():
        prefix, _, rest = key.partition(".")
        if prefix in parts:
            parts[prefix][rest] = value
        else:
            others.append(key)
    return parts, sorted(others)
