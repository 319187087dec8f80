"""The gradient penalty's stream ms, its double backward included: the
mean stream ms of the D phase (span ``step.d_phase``) over the profiled
steps with a ``step.gp`` span, less that over the steps without one. None
where either kind of step, the spans or their stream times are missing."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gp = {s.unit for s in table if s.name == "step.gp"}
    phases = [s for s in table if s.name == "step.d_phase"]
    on = [s.stream_ms for s in phases if s.unit in gp]
    off = [s.stream_ms for s in phases if s.unit not in gp]
    if not on or not off or None in on + off:
        return None
    return sum(on) / len(on) - sum(off) / len(off)
