"""Training metrics log, the counterpart of ``histogan_tpu/utils/logging.py``.

The reference's only telemetry is a print every 50 steps and sample grids
(histoGAN/histoGAN.py:1093-1105). Here: a JSONL log with the step time
and images per second as well.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    """Appends one JSON object every ``every`` steps to <dir>/<name>/metrics.jsonl."""

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
        if step % self.every == 0:
            with self.path.open("a") as f:
                f.write(json.dumps(row) + "\n")
