"""The data source's host ms a step: the program's ``data.*`` spans (the
batch taken, the next one staged) over the profiled steps (``train.step``
spans). None where the program records no such spans."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    steps = sum(s.name == "train.step" for s in table)
    ms = [s.host_ms for s in table if s.name.startswith("data.")]
    if not steps or not ms:
        return None
    return sum(ms) / steps
