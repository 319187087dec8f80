"""The traced run's profile: ``torch.profiler`` (CPU and CUDA activities)
started and stopped by the benchmark around a whole number of units of
work, exported as a Chrome trace and reduced here to what the per-layer
metrics read: the window, the device's busy time (the union of kernel,
copy and set intervals), the kernels, and the histogram operation's calls
with the device time of the kernels each launched."""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
HIST_TAG = "bench.hist_core"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels ops/histogram_cuda.py launches, by name: the attribution used
# when the profiler's op tree does not tie a kernel to its op
HIST_KERNELS = {"fwd": ("hist_partial_kernel", "hist_reduce_kernel"), "bwd": ("hist_bwd_kernel",)}


@contextlib.contextmanager
def hist_shape_spans():
    """Label every call of the program's histogram contraction with its
    (B, N) in the profile, from the benchmark's side of the call."""
    from histogan_tpu_torch.ops import histogram_cuda

    inner = histogram_cuda.hist_core

    def labelled(packed, inv_sigma2):
        with torch.profiler.record_function(f"{HIST_TAG} {packed.shape[0]} {packed.shape[1]}"):
            return inner(packed, inv_sigma2)

    histogram_cuda.hist_core = labelled
    try:
        yield
    finally:
        histogram_cuda.hist_core = inner


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profile:
    """Start with ``start()`` after a synchronise, stop with ``stop(path)``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self._window = None
        self._spans = None

    def start(self):
        _sync()
        self._spans = hist_shape_spans()
        self._spans.__enter__()
        self.prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self, path: Path) -> Path:
        _sync()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self._spans.__exit__(None, None, None)
        self.prof.export_chrome_trace(str(path))
        return path


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class TraceView:
    """The reduced profile. Times in seconds."""

    def __init__(self, path: Path, units: list, images: int):
        events = json.loads(Path(path).read_text())["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the profile holds no window annotation")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.window_s = (w1 - w0) * 1e-6
        self.units, self.images = units, images
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self.launches = len(self.kernels)
        self._gaps = self._idle_gaps(busy, w0, w1, xs)
        self._device_ops = self._top_ops(dev)
        self.hist, self.hist_method = self._hist_calls(xs)

    @staticmethod
    def _top_ops(dev) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for e in dev:
            total[e["name"]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:10]]

    @staticmethod
    def _idle_gaps(busy, w0, w1, xs) -> List[list]:
        """The ten longest spans of the window with nothing on the device,
        each named by the innermost host event that covers its middle."""
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda ab: ab[0] - ab[1])[:10]
        host = [e for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                                  "python_function")
                and e.get("name") != WINDOW]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            covering = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = min(covering, key=lambda e: e["dur"])["name"] if covering else "host (no op)"
            out.append([name, (b - a) * 1e-6])
        return out

    @staticmethod
    def _hist_calls(xs):
        """{'fwd'|'bwd': [(B, N, device seconds), ...]} and the method that
        tied the kernels to the calls: 'op tree' (each kernel's launching op
        lies inside the histogram autograd op's forward or backward) or
        'kernel names' (HIST_KERNELS)."""
        ops = [e for e in xs if e.get("cat") == "cpu_op"]
        tags = sorted((e for e in xs if e.get("cat") == "user_annotation"
                       and e["name"].startswith(HIST_TAG)), key=lambda e: e["ts"])
        fwd = [e for e in ops if e["name"] == "_HistCore"]
        bwd = [e for e in ops if e["name"] == "_HistCoreBackward"]

        def shape_of(e) -> Optional[Tuple[int, int]]:
            for t in tags:
                if t["ts"] <= e["ts"] and e["ts"] + e["dur"] <= t["ts"] + t["dur"]:
                    _, b, n = t["name"].split()
                    return int(b), int(n)
            return None

        fwd_shape = {}
        for e in fwd:
            seq = e.get("args", {}).get("Sequence number")
            fwd_shape[seq] = shape_of(e)
        shapes = {s for s in fwd_shape.values() if s is not None}
        only = next(iter(shapes)) if len(shapes) == 1 else None

        by_ext = {}
        for e in ops:
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                by_ext[ext] = e
        kernels = [e for e in xs if e.get("cat") == "kernel"]

        def attribute(calls):
            starts = sorted((c["ts"], i) for i, c in enumerate(calls))
            keys = [s for s, _ in starts]
            time = [0.0] * len(calls)
            for k in kernels:
                op = by_ext.get(k.get("args", {}).get("External id"))
                if op is None:
                    continue
                j = bisect.bisect_right(keys, op["ts"]) - 1
                if j < 0:
                    continue
                c = calls[starts[j][1]]
                if c.get("tid") == op.get("tid") and op["ts"] + op["dur"] <= c["ts"] + c["dur"]:
                    time[starts[j][1]] += k["dur"] * 1e-6
            return time

        out = {"fwd": [], "bwd": []}
        f_time, b_time = attribute(fwd), attribute(bwd)
        if fwd and sum(f_time) > 0 and (not bwd or sum(b_time) > 0):
            for e, t in zip(fwd, f_time):
                out["fwd"].append((*(shape_of(e) or only or (0, 0)), t))
            for e, t in zip(bwd, b_time):
                seq = e.get("args", {}).get("Sequence number")
                out["bwd"].append((*(fwd_shape.get(seq) or only or (0, 0)), t))
            return out, "op tree"
        # by kernel names: one call per launch of the first kernel of a call
        for d, names in HIST_KERNELS.items():
            ks = [k for k in kernels if any(n in k["name"] for n in names)]
            calls = [k for k in ks if names[0] in k["name"]]
            total = sum(k["dur"] for k in ks) * 1e-6
            for k in calls:
                out[d].append((*(only or (0, 0)), total / len(calls)))
        return out, "kernel names"

    def breakdown(self) -> dict:
        return {"device_ops": self._device_ops, "idle_gaps": self._gaps}
