"""The program's calls to ``readback()`` (its counter ``syncs``) per photo
recolored in the profiled requests: a count, which repeats exactly, and 0
where the program recorded spans but no readback. A read that bypasses
``readback()`` is not counted. None where the program records no spans."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import counters, span_table
    except ImportError:  # a program without counters
        return None
    if not span_table() or not view.images:
        return None
    return counters().get("syncs", 0) / view.images
