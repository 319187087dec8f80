"""The program's chunks of samples copied to the host as they are made
(its counter ``readback_chunks``, one a chunk) per image of the profiled
requests: a count, which repeats exactly (one over the chunk size), and 0
where the program records spans but reads its samples back whole (the CPU,
or a program without the chunked copy). None where the program records no
spans. Read as ``readback_chunks_per_img.<cell's kind>``."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import counters, span_table
    except ImportError:  # a program without counters
        return None
    if not span_table() or not view.images:
        return None
    return counters().get("readback_chunks", 0) / view.images
