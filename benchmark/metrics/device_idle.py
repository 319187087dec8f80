"""The share of the profiled window in which no kernel, copy or set ran on
the device: 1 minus the union of their intervals over the window."""


def read(view, ctx):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
