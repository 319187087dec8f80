"""The program's U1 launches (its counter ``upsample2x``, one a launch of
the 2x upsample kernel) per image of the profiled steps or requests: a
count, which repeats exactly for the same step kinds, and 0 where the
program recorded spans but launched no U1 (aten's upsample). None where the
program records no spans. Read as ``upsample2x_per_img.<cell's kind>``."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import counters, span_table
    except ImportError:  # a program without counters
        return None
    if not span_table() or not view.images:
        return None
    return counters().get("upsample2x", 0) / view.images
