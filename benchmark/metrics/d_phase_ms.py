"""The D phase's stream ms (the program's span ``step.d_phase`` and its
CUDA events), the mean over the profiled steps without a gradient penalty
(no ``step.gp`` span in the step). None where the program records no such
spans, or no stream times (on the CPU)."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gp = {s.unit for s in table if s.name == "step.gp"}
    ms = [s.stream_ms for s in table if s.name == "step.d_phase" and s.unit not in gp]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
