"""Training metrics log, the counterpart of ``histogan_tpu/utils/logging.py``.

The reference's only telemetry is a print every 50 steps and sample grids
(histoGAN/histoGAN.py:1093-1105). Here: a JSONL log with the step time
and images per second as well, a torch.profiler trace of chosen steps
(``ProfilerHook``), and the program's spans and counters.

Spans and counters (``span``, ``readback``, ``count``) record only while a
torch.profiler is recording, whoever started it; otherwise a span is one
check and a shared no-op object, so an untraced run records nothing. A
recorded span is a ``record_function`` (so it lies in the profiler's
Chrome trace, beside the kernels it launched) and a row of the span table:
its name, its parent, its unit of work, its host interval
(``time.perf_counter_ns``) and, for a span opened with ``stream=True``
once CUDA is in use, a pair of CUDA events recorded on the current stream
at entry and exit, whose elapsed time is the span's stream time (the
device time from the end of the work queued before it to the end of its
own). Only the spans whose stream time is read take events, so that the
traced window pays for no others. ``span_table`` and ``counters`` read
them; ``reset_spans`` clears both.
"""

from __future__ import annotations

import json
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

from histogan_tpu_torch import parallel


class MetricsLogger:
    """Appends one JSON object every ``every`` steps to <dir>/<name>/metrics.jsonl
    (on a data-parallel rank other than 0, nothing)."""

    def __init__(self, log_dir, name: str, every: int = 50,
                 imgs_per_step: Optional[int] = None):
        self.path = Path(log_dir) / name / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.every = every
        self.imgs_per_step = imgs_per_step
        self._last_time: Optional[float] = None
        self._last_step: Optional[int] = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        now = time.perf_counter()
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._last_time is not None and step > self._last_step:
            dt = (now - self._last_time) / (step - self._last_step)
            row["step_time_s"] = round(dt, 5)
            if self.imgs_per_step:
                row["imgs_per_sec"] = round(self.imgs_per_step / dt, 2)
        self._last_time = now
        self._last_step = step
        if parallel.is_main() and step % self.every == 0:
            with self.path.open("a") as f:
                f.write(json.dumps(row) + "\n")


class ProfilerHook:
    """A torch.profiler trace (CPU, and CUDA where there is a GPU) of steps
    [start, start + count), written as a Chrome trace
    ``<trace_dir>/steps_<start>-<start + count - 1>[.rank<r>].json`` (the
    counterpart of the JAX package's jax.profiler hook).

    ``step(n)`` is called once after step n has run: the trace starts
    when the next step is ``start``, after a device sync (so that it does
    not open on the queued tail of the step before) and with the span
    table cleared, and stops (after a device sync) once step
    start + count - 1 has run, the span table then holding the traced
    steps. ``close`` writes a trace that is still open."""

    def __init__(self, trace_dir, start: int, count: int = 5):
        self.trace_dir = Path(trace_dir)
        self.start, self.stop = int(start), int(start) + int(count)
        self.path: Optional[Path] = None  # the trace, once written
        self._prof = None

    def step(self, step: int) -> None:
        if self._prof is None and self.path is None and step + 1 == self.start:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            reset_spans()
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and step + 1 >= self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        suffix = f".rank{parallel.rank()}" if parallel.world_size() > 1 else ""
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        path = self.trace_dir / f"steps_{self.start}-{self.stop - 1}{suffix}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof, self.path = None, path


# -------------------------------------------------------------------- spans
_profiling = torch._C._autograd._profiler_enabled  # is a torch.profiler recording?


class _Record:
    """A row of the span table while it is being written."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "events")

    def __init__(self, name: str, parent: Optional[int], unit: int):
        self.name, self.parent, self.unit = name, parent, unit
        self.start_ns = self.end_ns = 0
        self.events = None


class Span(NamedTuple):
    """A recorded span: ``parent`` is the index of the enclosing span in
    the table (None at the top), ``unit`` the unit of work it belongs to
    (the trainer's step, or a fresh negative number for each top-level
    call without one); ``host_ms`` None while the span is open,
    ``stream_ms`` None where no CUDA events were recorded (a span without
    ``stream``, or no CUDA)."""

    name: str
    parent: Optional[int]
    unit: int
    start_ns: int
    end_ns: int
    host_ms: Optional[float]
    stream_ms: Optional[float]


class _SpanTable:
    """The recorded spans, the counters and the stack of open spans. One
    stack for the process: the autograd engine runs a CUDA backward on a
    thread of its own while the caller waits, and its spans nest under the
    caller's."""

    def __init__(self):
        self.rows: List[_Record] = []
        self.counters: Counter = Counter()
        self.open: List[int] = []
        self.calls = 0  # the units of spans opened at the top without one

    def enter(self, name: str, unit: Optional[int]) -> _Record:
        parent = self.open[-1] if self.open else None
        if unit is None:
            if parent is None:
                self.calls += 1
                unit = -self.calls
            else:
                unit = self.rows[parent].unit
        row = _Record(name, parent, unit)
        self.open.append(len(self.rows))
        self.rows.append(row)
        return row

    def leave(self, row: _Record) -> None:
        if self.open and self.rows[self.open[-1]] is row:
            self.open.pop()


_TABLE = _SpanTable()


class _Off:
    """The span of an untraced run."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A recorded span: a ``record_function`` and a row of the table."""

    __slots__ = ("name", "unit", "stream", "row", "scope")

    def __init__(self, name: str, unit: Optional[int], stream: bool):
        self.name, self.unit, self.stream = name, unit, stream

    def __enter__(self):
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        self.row = row = _TABLE.enter(self.name, self.unit)
        if self.stream and torch.cuda.is_initialized():
            row.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            row.events[0].record()
        row.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        row = self.row
        row.end_ns = time.perf_counter_ns()
        if row.events is not None:
            row.events[1].record()
        _TABLE.leave(row)
        self.scope.__exit__(*exc)
        return False


def span(name: str, unit: Optional[int] = None, stream: bool = False):
    """A context manager that records span ``name`` while a torch.profiler
    is recording; otherwise a shared no-op. ``unit`` names the unit of work
    (the trainer passes its step); a span without one takes its parent's,
    or at the top a fresh negative number. ``stream`` records its CUDA
    events."""
    if not _profiling():
        return _OFF
    return _On(name, unit, stream)


def readback(name: str, tensor: torch.Tensor, stream: bool = False) -> torch.Tensor:
    """``tensor.cpu()``, the program's device-to-host read: while a
    profiler records, inside span ``sync.<name>`` (with its CUDA events if
    ``stream``) and counted as one of counter ``syncs``."""
    if not _profiling():
        return tensor.cpu()
    with _On("sync." + name, None, stream):
        count("syncs")
        return tensor.cpu()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _profiling():
        _TABLE.counters[name] += n


def span_table() -> List[Span]:
    """The spans recorded since the last ``reset_spans``, in the order
    they were entered, with their host and stream ms (this waits for the
    device to reach each span's end); a span still open has neither."""
    out = []
    for r in _TABLE.rows:
        host = stream = None
        if r.end_ns:
            host = (r.end_ns - r.start_ns) * 1e-6
            if r.events is not None:
                r.events[1].synchronize()
                stream = r.events[0].elapsed_time(r.events[1])
        out.append(Span(r.name, r.parent, r.unit, r.start_ns, r.end_ns, host, stream))
    return out


def counters() -> Dict[str, int]:
    """The counters since the last ``reset_spans``."""
    return dict(_TABLE.counters)


def reset_spans() -> None:
    """Clear the span table and the counters (spans still open are
    dropped from the table)."""
    _TABLE.__init__()
