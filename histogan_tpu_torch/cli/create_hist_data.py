"""Build the recoloring sampling pool: the RGB-uv histogram (insz 250,
``sampling`` resize) of every image under ``--input_dir``, stacked and
saved as ``histograms.npy`` with shape (N, 1, 3, h, h): the counterpart
of ``histogan_tpu/cli/create_hist_data.py`` (reference
create_hist_data.py:33-55), plus ``--device``. On a GPU each histogram
goes through the histogram kernel.

    histogan-create-hist-data-torch --input_dir ./histogram_data/
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Create histogram pool data.")
    parser.add_argument("--input_dir", default="./histogram_data/")
    parser.add_argument("--output", default=None,
                        help="default: <input_dir>/histograms.npy")
    parser.add_argument("--hist_bin", type=int, default=64)
    parser.add_argument("--hist_insz", type=int, default=250)
    parser.add_argument("--hist_method", default="inverse-quadratic")
    parser.add_argument("--hist_resizing", default="sampling")
    parser.add_argument("--hist_sigma", type=float, default=0.02)
    parser.add_argument("--device", default="cuda",
                        help="torch device for the histograms (default cuda)")
    args = parser.parse_args(argv)

    from histogan_tpu_torch.cli.histogan import image_hist
    from histogan_tpu_torch.data.dataset import list_images, load_rgb
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
    from histogan_tpu_torch.utils.platform import setup_runtime

    device = setup_runtime(args.device)
    block = RGBuvHistBlock(insz=args.hist_insz, h=args.hist_bin, resizing=args.hist_resizing,
                           method=args.hist_method, sigma=args.hist_sigma)
    paths = list_images(args.input_dir)
    if not paths:
        raise FileNotFoundError(f"no images under {args.input_dir}")
    out = np.stack([image_hist(load_rgb(p), block, device) for p in paths])  # (N, 1, 3, h, h)
    out_path = Path(args.output or (Path(args.input_dir) / "histograms.npy"))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, out)
    print(f"saved {out.shape} histogram pool to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
