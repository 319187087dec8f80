"""Training metrics log, the counterpart of ``histogan_tpu/utils/logging.py``.

The reference's only telemetry is a print every 50 steps and sample grids
(histoGAN/histoGAN.py:1093-1105). Here: a JSONL log with the step time
and images per second as well, and a torch.profiler trace of chosen
steps (``ProfilerHook``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

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

    ``step(n)`` is called once after step n has been dispatched, where the
    JAX trainer calls its hook: the trace starts when the next step is
    ``start``, and stops (after a device sync) once step start + count - 1
    has run. ``close`` writes a trace that is still open."""

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
