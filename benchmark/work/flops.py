"""The model FLOP of one unit of work (a training step of a given kind, a
recolor request, a sampling request), counted from the configuration and
the traffic alone: the benchmark's reference runs the unit on the ``meta``
device under ``torch.utils.flop_counter.FlopCounterMode``, which counts
every convolution and matrix product (the histogram's einsums included)
once as it runs: forward, backward, and the gradient penalty's double
backward. Elementwise work, resampling and the optimizer are not model
FLOP. The reference recomputes nothing, so remat is never counted."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from benchmark.reference import histogram, models, steps


class _NoStep:
    def step(self, grads):
        pass


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _gen_draws(b, cfg):
    s = cfg["image_size"]
    return {"z1": _meta(b, cfg["latent_dim"]), "z2": _meta(b, cfg["latent_dim"]),
            "cutoff": _meta(dtype=torch.int64), "noise": _meta(b, s, s, 1)}


class _Count(TorchDispatchMode):
    """Adds up ``flop_registry``'s count of every operator that runs."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out


def _count(fn) -> int:
    with _Count() as c:
        fn()
    return c.total


def _unit(cfg, traffic, kind):
    m = models.build_modules(cfg, "meta")
    s, h = cfg["image_size"], cfg["hist_bin"]
    if traffic["driver"] == "train":
        a, b = traffic["gradient_accumulate_every"], traffic["batch_size"]
        batch = {"d_images": _meta(a, b, s, s, 3, dtype=torch.uint8),
                 "g_images": _meta(a, b, s, s, 3, dtype=torch.uint8),
                 "d_hists": _meta(a, b, 3, h, h), "g_hists": _meta(a, b, 3, h, h)}
        gp, pl = "gp" in kind, "pl" in kind
        if cfg["model"] == "histogan":
            nl = m["G"].num_layers
            draws = {"d": [_gen_draws(b, cfg) for _ in range(a)],
                     "g": [_gen_draws(b, cfg) for _ in range(a)],
                     "pl": [_meta(b, nl - 2, cfg["latent_dim"]) for _ in range(a)]}
            return lambda: steps.histogan_step(m, _NoStep(), _NoStep(), batch, draws, cfg, gp,
                                               pl, False, _meta())
        draws = {"d": [_meta(b, s, s, 1) for _ in range(a)],
                 "g": [_meta(b, s, s, 1) for _ in range(a)]}
        return lambda: steps.rehistogan_step(m, _NoStep(), _NoStep(), batch, draws, cfg, gp)
    target = _meta(1, s, s, 3)
    if traffic["driver"] == "recolor":
        def recolor():
            with torch.no_grad():
                hist = histogram.hist_of(target, cfg)
                steps.recolor(m, _meta(1, 3, s, s), hist, _meta(1, s, s, 1))
        return recolor
    if traffic["driver"] == "sample":
        n = traffic["num_image_tiles"] ** 2

        def sample():
            with torch.no_grad():
                hist = histogram.hist_of(target, cfg)
                rows = hist.expand(traffic["num_image_tiles"], -1, -1, -1)
                steps.sample_truncated(m, rows, _meta(n, cfg["latent_dim"]), _meta(n, s, s, 1),
                                       _meta(1, cfg["latent_dim"]), cfg["trunc_psi"],
                                       traffic["batch_size"])
        return sample
    raise ValueError(f"no FLOP count for driver {traffic['driver']!r}")


@functools.lru_cache(maxsize=None)
def _cached(cfg_json: str, traffic_json: str, kind: str) -> int:
    return _count(_unit(json.loads(cfg_json), json.loads(traffic_json), kind))


def unit_flop(cfg: dict, traffic: dict, kind: str = "") -> int:
    """Model FLOP of one unit: a training step of ``kind`` ('', 'gp', 'pl'
    or 'gppl'), or one request."""
    return _cached(json.dumps(cfg, sort_keys=True), json.dumps(traffic, sort_keys=True), kind)
