"""CLI: GAN inversion by optimizing per-block post-projection style
vectors directly (reference projection_to_latent.py), on a GPU or the CPU.

    histogan-projection-to-latent-torch --name m --input_image in.jpg
"""

from __future__ import annotations

from histogan_tpu_torch.cli.projection_common import build_parser, run

# reference projection_to_latent.py:632-659 defaults
REFERENCE_DEFAULTS = dict(num_train_steps=2000)


def main(argv=None):
    args = build_parser("./results_projection_to_latent",
                        defaults=REFERENCE_DEFAULTS).parse_args(argv)
    run(args, mode="latent")


if __name__ == "__main__":
    main()
