"""D's attention blocks run per image of the profiled steps: the
program's counter ``attn`` (one a ``RezeroResidual`` forward) over the
profiled images, a count that repeats exactly for the same step kinds.
With attention at two layers (two blocks each) and three D calls a step
(fakes, reals, G's fakes; the GP's shares the reals' forward) it is
3 x 4 / batch: 0.75 at batch 16. None where the program records no spans
or no attention."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import counters, span_table
    except ImportError:  # a program without counters
        return None
    n = counters().get("attn", 0)
    if not span_table() or not n or not view.images:
        return None
    return n / view.images
