"""The model FLOP of one training step with D's options, counted as
``flops.py`` counts the other units: ``reference/d_options.py``'s step on
the ``meta`` device under ``flops.py``'s dispatch-mode count, which adds
``flop_registry``'s count of every convolution and matrix product once as
it runs. Beside the plain step's it counts the attention's 1x1 convs and
its two batched contractions (forward, backward and, on GP steps, the
double backward through them), and each VQ call's two products: the
distance's ``flatten @ embed`` and the codebook update's sums
``flatten.T @ onehot``. DiffAugment moves pixels and computes no
product, so the count takes no augmentation; nor does it count the
softmaxes, the argmax or the EMA's elementwise work."""

from __future__ import annotations

import functools
import json

import torch

from benchmark.reference import d_options
from benchmark.work.flops import _Count, _gen_draws, _meta, _NoStep


def _unit(cfg, traffic, kind):
    m = d_options.build_modules(cfg, "meta")
    s, h = cfg["image_size"], cfg["hist_bin"]
    a, b = traffic["gradient_accumulate_every"], traffic["batch_size"]
    batch = {"d_images": _meta(a, b, s, s, 3, dtype=torch.uint8),
             "d_hists": _meta(a, b, 3, h, h), "g_hists": _meta(a, b, 3, h, h)}
    draws = {"d": [_gen_draws(b, cfg) for _ in range(a)],
             "g": [_gen_draws(b, cfg) for _ in range(a)],
             "pl": [_meta(b, m["G"].num_layers - 2, cfg["latent_dim"]) for _ in range(a)]}
    return lambda: d_options.histogan_step(m, _NoStep(), _NoStep(), batch, draws, cfg,
                                           "gp" in kind, "pl" in kind, False, _meta())


@functools.lru_cache(maxsize=None)
def _cached(cfg_json: str, traffic_json: str, kind: str) -> int:
    with _Count() as c:
        _unit(json.loads(cfg_json), json.loads(traffic_json), kind)()
    return c.total


def unit_flop(cfg: dict, traffic: dict, kind: str = "") -> int:
    """Model FLOP of one training step of ``kind`` ('', 'gp', 'pl' or
    'gppl') with the configuration's D options."""
    return _cached(json.dumps(cfg, sort_keys=True), json.dumps(traffic, sort_keys=True), kind)
