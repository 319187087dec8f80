"""CLI: GAN inversion by optimizing input z-space style vectors
(reference projection_gaussian.py), on a GPU or the CPU.

    histogan-projection-gaussian-torch --name m --input_image in.jpg
    histogan-projection-gaussian-torch --name m --input_image in.jpg \
        --generate True --target_hist t.jpg
"""

from __future__ import annotations

from histogan_tpu_torch.cli.projection_common import build_parser, run

# reference projection_gaussian.py:587-614 defaults (they differ from
# projection_to_latent.py's — save_every 2 vs 100, style_reg_weight
# 10.0 vs 0.0)
REFERENCE_DEFAULTS = dict(save_every=2, style_reg_weight=10.0)


def main(argv=None):
    args = build_parser("./results_projection_gaussian",
                        defaults=REFERENCE_DEFAULTS).parse_args(argv)
    run(args, mode="gaussian")


if __name__ == "__main__":
    main()
