"""One image's RGB-uv histogram (insz 150, ``interpolation`` resize) ->
``<output_dir>/<name>.npy`` with shape (1, 3, h, h): the counterpart of
``histogan_tpu/cli/create_hist_sample.py`` (reference
create_hist_sample.py:25-44), plus ``--device``. On a GPU the histogram
goes through the histogram kernel.

    histogan-create-hist-sample-torch --image target.jpg
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Create a target histogram.")
    parser.add_argument("--image", required=True)
    parser.add_argument("--output_dir", default="./histograms/")
    parser.add_argument("--hist_bin", type=int, default=64)
    parser.add_argument("--hist_insz", type=int, default=150)
    parser.add_argument("--hist_method", default="inverse-quadratic")
    parser.add_argument("--hist_resizing", default="interpolation")
    parser.add_argument("--hist_sigma", type=float, default=0.02)
    parser.add_argument("--device", default="cuda",
                        help="torch device for the histogram (default cuda)")
    args = parser.parse_args(argv)

    from histogan_tpu_torch.cli.histogan import image_hist
    from histogan_tpu_torch.data.dataset import load_rgb
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
    from histogan_tpu_torch.utils.platform import setup_runtime

    device = setup_runtime(args.device)
    block = RGBuvHistBlock(insz=args.hist_insz, h=args.hist_bin, resizing=args.hist_resizing,
                           method=args.hist_method, sigma=args.hist_sigma)
    hist = image_hist(load_rgb(args.image), block, device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{Path(args.image).stem}.npy"
    np.save(out, hist)
    print(f"saved histogram {hist.shape} to {out}")
    return out


if __name__ == "__main__":
    main()
