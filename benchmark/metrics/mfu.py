"""The model FLOP of the profiled units (``work/flops.py``: each training
step by its kind, or each request) over the profiled wall time, as a
share of the peak of the configuration's precision (``work/peaks.py``,
NVIDIA H100 SXM at 700 W). Read as ``mfu.<cell's kind>``."""

from benchmark.work import flops, peaks


def read(view, ctx):
    total = sum(flops.unit_flop(ctx.cfg, ctx.traffic, kind) for kind in view.units)
    return 100.0 * total / view.window_s / peaks.PRECISION_PEAK[ctx.cfg["precision"]]
