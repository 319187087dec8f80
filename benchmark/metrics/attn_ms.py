"""D's linear attention's stream ms a profiled step: the program's spans
``d.attn`` (one a ``RezeroResidual`` forward, with its CUDA events),
summed over the profiled steps and divided by their number. Forward only:
the GP's create-graph forward is inside a span, every backward outside
one. None where the program records no such spans, or no stream times
(on the CPU)."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    ms = [s.stream_ms for s in span_table() if s.name == "d.attn"]
    if not ms or None in ms or not view.units:
        return None
    return sum(ms) / len(view.units)
