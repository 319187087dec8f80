"""The native BGU fit's time, with the stencil product's sizes known at
compile time (the RGB fit: 4 coefficients, 3 output channels) and with
the runtime-sized loop alone, beside scipy's direct solve.

    python -m histogan_tpu_torch.tools.bgu_fit_timing [--repeats 5]

Runs on the host's CPU (g++, no card). The fit is the recolor's: a
synthetic 384x512 photo, its 256x256 downscale, an affine recolor of that
downscale, grid 16x16x8. Prints the sorted seconds of each backend, the
solver's iterations and how far each native grid lies from scipy's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from histogan_tpu_torch import native
from histogan_tpu_torch.post import bgu, bgu_native
from histogan_tpu_torch.post.imresize import imresize


def photo_fit(h: int = 384, w: int = 512, size: int = 256, seed: int = 21):
    """BGU.m's fit at the size the recolor gives it: (photo, input, edge,
    output), a synthetic photo, its ``size``-square downscale and an
    affine recolor of that (grid 16x16x8)."""
    rng = np.random.default_rng(seed)
    photo = np.kron(rng.random((h // 32, w // 32, 3)), np.ones((32, 32, 1)))
    photo = np.clip(photo + 0.1 * np.sin(np.arange(w) / 17.0)[None, :, None]
                    + rng.normal(0, 0.03, (h, w, 3)), 0, 1)
    ds_in = imresize(photo, output_shape=(size, size))
    m = np.array([[0.7, 0.1, 0.0], [0.0, 0.8, 0.1], [0.2, 0.0, 0.6]])
    ds_out = np.clip(ds_in @ m.T + np.array([0.05, 0.0, 0.1]), 0, 1)
    return photo, ds_in, bgu.rgb2luminance(ds_in), ds_out


def _timed(fn, repeats: int):
    secs, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
    return sorted(secs), out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    fit = photo_fit()[1:]
    secs, g_scipy = _timed(lambda: bgu.bgu_fit(*fit), args.repeats)
    print(f"scipy direct solve: {' '.join(f'{s:.3f}' for s in secs)} s")
    flags = native.FLAGS
    try:
        for label, extra in (("compile-time sizes", ()),
                             ("runtime sizes", ("-DBGU_RUNTIME_SIZES",))):
            native.FLAGS, native._lib = flags + extra, None
            native.load_library()  # built before the timed fits
            secs, (gamma, report) = _timed(
                lambda: bgu_native.bgu_fit_native_report(*fit), args.repeats)
            off = np.abs(gamma - g_scipy).max() / np.abs(g_scipy).max()
            print(f"native, {label}: {' '.join(f'{s:.3f}' for s in secs)} s, iterations "
                  f"{report.iters}, grid {off:.2e} of its largest entry off scipy's")
    finally:
        native.FLAGS, native._lib = flags, None


if __name__ == "__main__":
    main()
