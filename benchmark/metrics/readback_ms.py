"""The stream ms a profiled request spent copying its samples to the
host: the program's ``sync.images`` spans and their CUDA events, the
copy's own device time once the samples are made. None where the program
records no such spans, or no stream times (on the CPU)."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    ms = [s.stream_ms for s in span_table() if s.name == "sync.images"]
    if not ms or None in ms or not view.units:
        return None
    return sum(ms) / len(view.units)
