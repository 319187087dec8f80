"""The histogram operation's backward-pass share of its roofline
(``work/histogram.py``'s ``roofline_share``) over every call in the
profile; None when the profile holds none."""

from benchmark.work.histogram import roofline_share


def read(view, ctx):
    return roofline_share("bwd", view.hist["bwd"], ctx.cfg["hist_bin"])
