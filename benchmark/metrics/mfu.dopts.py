"""``mfu.py`` for a training cell with D's options: the model FLOP of the
profiled steps (``work/flops_dopts.py``: each step by its kind, the
attention and the VQ's products included) over the profiled wall time,
as a share of the configuration's precision's peak (``work/peaks.py``,
NVIDIA H100 SXM at 700 W)."""

from benchmark.work import flops_dopts, peaks


def read(view, ctx):
    total = sum(flops_dopts.unit_flop(ctx.cfg, ctx.traffic, kind) for kind in view.units)
    return 100.0 * total / view.window_s / peaks.PRECISION_PEAK[ctx.cfg["precision"]]
