"""The host's ms a unit of work (a profiled step or request) blocked in
the program's readbacks to the host: its ``sync.*`` spans, 0 where the
program recorded spans but no readback. Read as ``sync_ms.<cell's
kind>``; None where the program records no spans."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    if not table or not view.units:
        return None
    return sum(s.host_ms for s in table if s.name.startswith("sync.")) / len(view.units)
