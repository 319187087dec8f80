"""D's vector quantization's stream ms a profiled step: the program's
spans ``d.vq`` (one a ``PermuteToFrom`` call, the nearest codes, the
codebook's update and the commitment loss, with its CUDA events), summed
over the profiled steps and divided by their number; the backward runs
outside them. None where the program records no such spans, or no stream
times (on the CPU)."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    ms = [s.stream_ms for s in span_table() if s.name == "d.vq"]
    if not ms or None in ms or not view.units:
        return None
    return sum(ms) / len(view.units)
