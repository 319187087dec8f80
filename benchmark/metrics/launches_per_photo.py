"""Kernels launched on the device in the profiled requests, per photo
recolored (one a request): a count, which repeats exactly."""


def read(view, ctx):
    return view.launches / view.images
