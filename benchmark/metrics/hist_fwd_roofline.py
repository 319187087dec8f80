"""The histogram operation's forward-pass share of its roofline
(``work/histogram.py``'s ``roofline_share``) over every call in the
profile; None when the profile holds none."""

from benchmark.work.histogram import roofline_share


def read(view, ctx):
    return roofline_share("fwd", view.hist["fwd"], ctx.cfg["hist_bin"])
