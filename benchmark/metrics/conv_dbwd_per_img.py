"""The double backwards through D's convolutions per image of the profiled
steps: the program's counter ``conv_dbwd`` (one a gradient penalty's
second-order pass through one convolution of D, ``ops/conv2d.py``) over
the profiled images, a count that repeats exactly for the same step kinds.
Over two GP cycles of 4 steps at batch 16 it is 2 x D's convolutions / 128:
0.484375 for HistoGAN's 31 at 256 px, 0.734375 with the attention's 16 at
layers 1-2. 0 where the program records spans but no such pass (aten's own
double backward). None where the program records no spans. Read as
``conv_dbwd_per_img.<cell's kind>``."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import counters, span_table
    except ImportError:  # a program without counters
        return None
    if not span_table() or not view.images:
        return None
    return counters().get("conv_dbwd", 0) / view.images
