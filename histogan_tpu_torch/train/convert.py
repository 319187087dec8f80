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

reHistoGAN's checkpoints hold the prefixes ED, H, G and D
(rehistoGAN.py:637-718; no EMA): ``rehisto_state_dict_from_jax`` is the
bridge for them, and ``detect_rehistogan_variant`` reads the two
architecture flags that the reference does not persist from the keys.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

# the reference state dict's prefixes (histoGAN/histoGAN.py:634-715)
PREFIXES = ("S", "H", "G", "D", "SE", "HE", "GE")
# reHistoGAN's (rehistoGAN.py:637-718)
REHISTO_PREFIXES = ("ED", "H", "G", "D")


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


def _conv_weight(tree: Mapping, prefix: str, out: Dict) -> None:
    """A conv without bias, HWIO -> OIHW."""
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(_np(tree["kernel"]), (3, 2, 0, 1)))


def _conv(tree: Mapping, prefix: str, out: Dict) -> None:
    _conv_weight(tree, prefix, out)
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


def discriminator_state(tree: Mapping, prefix: str, out: Dict,
                        vq_stats: Optional[Mapping] = None) -> None:
    """The JAX package's ``export_discriminator`` (convert.py:386-408):
    ``net0``/``net1``/``down`` become ``net.0``/``net.2``/``downsample``;
    ``attn_{i}_{j}`` becomes ``attn_blocks.{i}.{j}.fn.g`` and
    ``.fn.fn.to_{q,k,v,out}``; the ``vq_stats`` collection's ``vq_{i}``
    becomes ``quantize_blocks.{i}.fn.{embed,embed_avg,cluster_size}``; and
    ``to_logit``'s input axis is reordered from the JAX flatten (2, 2, C)
    to the reference's NCHW flatten (C, 2, 2). A key it does not know
    raises."""
    n = _count(tree, "blocks_{}")
    known = {f"blocks_{i}" for i in range(n)} | {"to_logit"} | {
        f"attn_{i}_{j}" for i in range(n) for j in (0, 1)}
    vq_stats = vq_stats or {}
    unknown = sorted(set(tree) - known) + sorted(set(vq_stats) - {f"vq_{i}" for i in range(n)})
    if unknown:
        raise ValueError(f"the discriminator bridge does not know {unknown}")
    for i in range(n):
        blk = tree[f"blocks_{i}"]
        b = f"{prefix}.blocks.{i}"
        _conv(blk["conv_res"], f"{b}.conv_res", out)
        _conv(blk["net0"], f"{b}.net.0", out)
        _conv(blk["net1"], f"{b}.net.2", out)
        if "down" in blk:
            _conv(blk["down"], f"{b}.downsample", out)
        for j in (0, 1):
            if f"attn_{i}_{j}" not in tree:
                continue
            a = tree[f"attn_{i}_{j}"]
            ap = f"{prefix}.attn_blocks.{i}.{j}.fn"
            out[f"{ap}.g"] = _np(a["g"])
            for q in ("to_q", "to_k", "to_v"):
                _conv_weight(a["attn"][q], f"{ap}.fn.{q}", out)
            _conv(a["attn"]["to_out"], f"{ap}.fn.to_out", out)
        if f"vq_{i}" in vq_stats:
            qp = f"{prefix}.quantize_blocks.{i}.fn"
            for suffix in ("embed", "embed_avg", "cluster_size"):
                out[f"{qp}.{suffix}"] = _np(vq_stats[f"vq_{i}"][suffix])
    w = _np(tree["to_logit"]["kernel"]).T  # (1, 2*2*C), NHWC order
    c = w.shape[1] // 4
    out[f"{prefix}.to_logit.weight"] = np.ascontiguousarray(
        w.reshape(1, 2, 2, c).transpose(0, 3, 1, 2).reshape(1, -1))
    out[f"{prefix}.to_logit.bias"] = _np(tree["to_logit"]["bias"])


def state_dict_from_jax(bundle: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter bundle {'params_g': {'S','H','G'}, 'params_d',
    'ema': {...}[, 'vq_stats']} -> the reference-layout state dict (every
    prefix of PREFIXES), as ``export_histogan_checkpoint`` writes it."""
    out: Dict[str, np.ndarray] = {}
    for tree, (s, h, g) in ((bundle["params_g"], ("S", "H", "G")),
                            (bundle["ema"], ("SE", "HE", "GE"))):
        style_vectorizer_state(tree["S"], s, out)
        hist_vectorizer_state(tree["H"], h, out)
        generator_state(tree["G"], g, out)
    discriminator_state(bundle["params_d"], "D", out, bundle.get("vq_stats"))
    return {k: torch.tensor(v) for k, v in out.items()}


def encoder_block_state(tree: Mapping, prefix: str, out: Dict) -> None:
    """``net0``/``net1``/``down`` become ``net.0``/``net.3``/``downsample``
    (the InstanceNorms and LeakyReLUs between hold no parameters)."""
    _conv(tree["conv_res"], f"{prefix}.conv_res", out)
    _conv(tree["net0"], f"{prefix}.net.0", out)
    _conv(tree["net1"], f"{prefix}.net.3", out)
    _conv(tree["down"], f"{prefix}.downsample", out)


def decoder_block_state(tree: Mapping, prefix: str, out: Dict) -> None:
    for name in ("block1", "block2", "conv_out_latent"):
        _conv(tree[name], f"{prefix}.{name}.0", out)
    _conv(tree["conv_res"], f"{prefix}.conv_res", out)
    _conv(tree["conv_out_rgb"], f"{prefix}.conv_out_rgb", out)
    if "to_latent" in tree:
        _linear(tree["to_latent"], f"{prefix}.to_latent", out)
        _conv2dmod(tree["conv_latent"], f"{prefix}.conv_latent", out)


def encoder_decoder_state(tree: Mapping, prefix: str, out: Dict) -> None:
    _conv(tree["mapping"], f"{prefix}.mapping", out)
    _conv(tree["decoder_mapping"], f"{prefix}.decoder_mapping", out)
    for i in range(_count(tree, "encoder_{}")):
        encoder_block_state(tree[f"encoder_{i}"], f"{prefix}.encoder_blocks.{i}", out)
    for i in range(_count(tree, "decoder_{}")):
        decoder_block_state(tree[f"decoder_{i}"], f"{prefix}.decoder_blocks.{i}", out)
    if "hist_projection" in tree:
        hist_vectorizer_state(tree["hist_projection"], f"{prefix}.hist_projection", out)
    for name in ("to_latent_1", "to_latent_2"):
        if name in tree:
            _linear(tree[name], f"{prefix}.{name}", out)
    for name in ("conv_latent_1", "conv_latent_2"):
        if name in tree:
            _conv2dmod(tree[name], f"{prefix}.{name}", out)


def rehisto_state_dict_from_jax(bundle: Mapping) -> Dict[str, torch.Tensor]:
    """JAX recoloring bundle {'params_g': {'ED', 'H', 'G'}, 'params_d'[,
    'vq_stats']} ->
    the reference-layout state dict (ED, H, G, D), as
    ``export_rehistogan_checkpoint`` writes it."""
    out: Dict[str, np.ndarray] = {}
    g = bundle["params_g"]
    encoder_decoder_state(g["ED"], "ED", out)
    hist_vectorizer_state(g["H"], "H", out)
    for i in range(_count(g["G"], "blocks_{}")):
        generator_block_state(g["G"][f"blocks_{i}"], f"G.blocks.{i}", out)
    discriminator_state(bundle["params_d"], "D", out, bundle.get("vq_stats"))
    return {k: torch.tensor(v) for k, v in out.items()}


def detect_rehistogan_variant(sd: Mapping) -> Dict[str, bool]:
    """skip_conn_to_GAN / internal_hist from a recoloring state dict's keys
    (the reference persists neither in .config.json)."""
    return {"skip_conn_to_GAN": "ED.conv_latent_1.weight" in sd,
            "internal_hist": "ED.decoder_blocks.0.to_latent.weight" in sd}


def load_reference_pt(path) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pt`` (flat ``GAN.state_dict()``) as CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def split_by_prefix(sd: Mapping[str, torch.Tensor], prefixes=PREFIXES):
    """-> ({prefix: sub-state-dict} for ``prefixes``, sorted keys of every
    other prefix)."""
    parts = {p: {} for p in prefixes}
    others = []
    for key, value in sd.items():
        prefix, _, rest = key.partition(".")
        if prefix in parts:
            parts[prefix][rest] = value
        else:
            others.append(key)
    return parts, sorted(others)
