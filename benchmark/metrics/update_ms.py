"""The optimizer's stream ms a step: the program's ``step.update`` spans
(the gradients' reduction and DiffGrad's update, once in each phase) over
the profiled steps (``train.step`` spans). None where the program records
no such spans, or no stream times (on the CPU)."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    steps = sum(s.name == "train.step" for s in table)
    ms = [s.stream_ms for s in table if s.name == "step.update"]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
