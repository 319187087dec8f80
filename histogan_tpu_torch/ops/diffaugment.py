"""DiffAugment for NCHW tensors, the counterpart of
``histogan_tpu/ops/diffaugment.py`` (the reference's utils/diff_augment.py
and AugWrapper, histoGAN/histoGAN.py:312-331).

Every function takes its random values as tensors, as the train step
takes its other draws (``train/steps.py``): per-sample factors for color,
per-sample integer offsets for translation, cutout and offset, drawn by
:func:`draw_aug` with the JAX package's distributions (the parity tests
rebuild JAX's own from its keys). The batch-level gate and flip of
:func:`aug_wrapper` are host booleans (:class:`AugDraws`), drawn on a
host generator, so that a D call costs no device-to-host sync; a batch
that the gate passes by is not touched.

The JAX package's quirks are kept: saturation's mean over the channels;
translation's clamped gather into a 1-px zero pad, the H offset drawn
from [-sh, sh] and the W offset from [-sw, sw]; cutout's centre on
[0, h + (1 - ch % 2)) and its clipped box; offset's swapped names
(``value_h`` rolls W, ``value_v`` rolls H); the flip when u >= 0.5; the
whole batch augmented when u < prob. The wrapper holds no parameters.
Traced (``utils/logging.py``), each ``aug_wrapper`` call is span ``d.aug``
(host time only).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from histogan_tpu_torch.utils.logging import span


def _per_sample(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return f.to(x.dtype).reshape(-1, 1, 1, 1)


def rand_brightness(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``u``: (B,) U[0, 1); adds u - 0.5."""
    return x + (_per_sample(u, x) - 0.5)


def rand_saturation(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Scales each pixel's distance to its mean over the channels by 2u."""
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * (_per_sample(u, x) * 2.0) + mean


def rand_contrast(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Scales each image's distance to its mean by u + 0.5."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (_per_sample(u, x) + 0.5) + mean


def rand_translation(x: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Shift by (tx, ty) (B,) integer pixels on H and W, zero fill: the
    clamped gather of the padded image (diff_augment.py:33-50)."""
    b, c, h, w = x.shape
    rows = torch.clamp(torch.arange(h, device=x.device)[None, :] + tx[:, None] + 1, 0, h + 1)
    cols = torch.clamp(torch.arange(w, device=x.device)[None, :] + ty[:, None] + 1, 0, w + 1)
    x_pad = torch.nn.functional.pad(x, (1, 1, 1, 1))
    x_pad = torch.gather(x_pad, 2, rows[:, None, :, None].expand(b, c, h, w + 2))
    return torch.gather(x_pad, 3, cols[:, None, None, :].expand(b, c, h, w))


def _scaled(n: int, ratio: float) -> int:
    return int(n * ratio + 0.5)


def rand_cutout(x: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                ratio: float = 0.5) -> torch.Tensor:
    """Zero a (ch, cw) box centred at (ox, oy) (B,), clipped to the image
    (diff_augment.py:79-98), as a coordinate-range mask."""
    _, _, h, w = x.shape
    ch, cw = _scaled(h, ratio), _scaled(w, ratio)
    ii = torch.arange(h, device=x.device)[None, :]
    jj = torch.arange(w, device=x.device)[None, :]
    lo_x = torch.clamp(ox - ch // 2, 0, h - 1)[:, None]
    hi_x = torch.clamp(ox - ch // 2 + ch - 1, 0, h - 1)[:, None]
    lo_y = torch.clamp(oy - cw // 2, 0, w - 1)[:, None]
    hi_y = torch.clamp(oy - cw // 2 + cw - 1, 0, w - 1)[:, None]
    cut = ((ii >= lo_x) & (ii <= hi_x))[:, :, None] & ((jj >= lo_y) & (jj <= hi_y))[:, None, :]
    return x * (~cut)[:, None].to(x.dtype)


def _roll(x: torch.Tensor, shift: torch.Tensor, dim: int) -> torch.Tensor:
    """A per-sample ``torch.roll`` by ``shift`` (B,) along ``dim`` (2 or 3)."""
    b, c, h, w = x.shape
    n = x.shape[dim]
    src = torch.remainder(torch.arange(n, device=x.device)[None, :] - shift[:, None], n)
    view = (b, 1, n, 1) if dim == 2 else (b, 1, 1, n)
    return torch.gather(x, dim, src.reshape(view).expand(b, c, h, w))


def rand_offset(x: torch.Tensor, value_h: torch.Tensor, value_v: torch.Tensor) -> torch.Tensor:
    """Circular roll by ``value_h`` (B,) along W, then ``value_v`` along H
    (diff_augment.py:52-71: the reference's names are swapped)."""
    return _roll(_roll(x, value_h, 3), value_v, 2)


rand_offset_h = rand_offset
rand_offset_v = rand_offset


def offset_ranges(h: int, w: int, ratio_h: float, ratio_v: float):
    """(max_h, max_v): the offsets are 2 * randint(0, max + 1) - max, and 0
    where max is 0 (diff_augment.py:52-71 on NCHW dims)."""
    return int(h * ratio_h), int(w * ratio_v)


# {type: [(function, draw kind, its arguments)]}; a draw kind names what
# draw_aug makes for it
AUGMENT_FNS = {
    "color": [(rand_brightness, "uniform", ()), (rand_saturation, "uniform", ()),
              (rand_contrast, "uniform", ())],
    "offset": [(rand_offset, "offset", (1.0, 1.0))],
    "offset_h": [(rand_offset_h, "offset", (1.0, 0.0))],
    "offset_v": [(rand_offset_v, "offset", (0.0, 1.0))],
    "translation": [(rand_translation, "translation", (0.125,))],
    "cutout": [(rand_cutout, "cutout", (0.5,))],
}


def augment_fns(types: Sequence[str]):
    """The functions of ``types``, in the order ``diff_augment`` runs them."""
    return [fn for p in types for fn in AUGMENT_FNS[p]]


@dataclasses.dataclass
class AugDraws:
    """One AugWrapper call's draws. ``apply``: the gate (u < prob);
    ``flip``: the horizontal flip (u >= 0.5); ``values``: per function of
    ``augment_fns(types)``, the list of its (B,) tensors; ``types``: the
    augmentation types, in order."""

    apply: bool
    flip: bool
    values: List[List[torch.Tensor]]
    types: Sequence[str]


def diff_augment(x: torch.Tensor, types: Sequence[str], values) -> torch.Tensor:
    for (fn, _, _), v in zip(augment_fns(types), values, strict=True):
        x = fn(x, *v)
    return x


def random_hflip(x: torch.Tensor, flip: bool) -> torch.Tensor:
    """The whole batch flipped along W when ``flip``."""
    return torch.flip(x, dims=(3,)) if flip else x


def aug_wrapper(images: torch.Tensor, draws: AugDraws) -> torch.Tensor:
    """AugWrapper (histoGAN/histoGAN.py:318-331): when the gate is on, the
    flip and DiffAugment on the whole batch, else the images as they are."""
    with span("d.aug"):
        if not draws.apply:
            return images
        return diff_augment(random_hflip(images, draws.flip), draws.types, draws.values)


def draw_aug(gen: torch.Generator, coins: torch.Generator, batch: int, h: int, w: int,
             prob: float, types: Sequence[str], device) -> AugDraws:
    """An AugDraws with the JAX package's distributions: the two coins
    from ``coins`` (a CPU generator: no sync), the per-sample values from
    ``gen`` on ``device``."""
    apply_u, flip_u = torch.rand((2,), generator=coins).tolist()
    values = []
    for _, kind, args in augment_fns(types):
        if kind == "uniform":
            values.append([torch.rand((batch,), generator=gen, device=device)])
        elif kind == "translation":
            sh, sw = _scaled(h, args[0]), _scaled(w, args[0])
            values.append([torch.randint(-sh, sh + 1, (batch,), generator=gen, device=device),
                           torch.randint(-sw, sw + 1, (batch,), generator=gen, device=device)])
        elif kind == "cutout":
            ch, cw = _scaled(h, args[0]), _scaled(w, args[0])
            values.append([
                torch.randint(0, h + (1 - ch % 2), (batch,), generator=gen, device=device),
                torch.randint(0, w + (1 - cw % 2), (batch,), generator=gen, device=device)])
        else:
            vals = []
            for m in offset_ranges(h, w, *args):
                r = torch.randint(0, m + 1, (batch,), generator=gen, device=device)
                vals.append(r * 2 - m if m > 0 else torch.zeros_like(r))
            values.append(vals)
    return AugDraws(apply=apply_u < prob, flip=flip_u >= 0.5, values=values, types=tuple(types))
