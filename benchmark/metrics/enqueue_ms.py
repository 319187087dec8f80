"""The host's ms a profiled request spent in the program and not blocked
on a readback: the host ms of the program's top-level spans
(``hist.target`` and ``recolor``), less that of the ``sync.*`` spans
inside them. Read as ``enqueue_ms.<cell's kind>`` in a serving cell, where
the host sets the pace; in a device-bound cell the host waits on a full
launch queue, and this would read the device's pace. None where the
program records no spans."""


def read(view, ctx):
    try:
        from histogan_tpu_torch.utils.logging import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    tops = [s for s in table if s.parent is None and not s.name.startswith("sync.")]
    syncs = [s for s in table if s.name.startswith("sync.") and s.parent is not None]
    if not tops or not view.units:
        return None
    return (sum(s.host_ms for s in tops) - sum(s.host_ms for s in syncs)) / len(view.units)
