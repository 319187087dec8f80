"""The benchmark of histogan_tpu_torch on one H100.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in the repository's BENCHMARK.json.
Its configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (a data file that names the general driver in
``drivers/`` that runs it and the end-to-end metric it reports), the
limits of its comparison with the plain reference ``limits/<cell>.json``,
and each per-layer metric ``metrics/<metric>.py`` or its family's
``metrics/<family>.py``: all found by name, so that a later cell, mix or
metric is new files and entries alone.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error. The run exits non-zero and prints
no result without a CUDA device, or if JAX, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.monotonic()  # the process's start, before the heavy imports

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "histogan_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``read(view, ctx)`` of
    ``metrics/<name>.py``, or where there is none, of the family's file,
    named by the part of ``name`` before its first dot (``mfu.train`` and
    ``mfu.sample`` share ``metrics/mfu.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find_cell(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, cfg


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device=None,
             t0: float = T0, fault=None, controls=()) -> dict:
    """Run one cell and return its result (without printing it). ``device``
    None takes the GPU and refuses to run without one."""
    from benchmark import harness

    harness.env_dirs()
    import torch

    cell, cfg_entry = find_cell(bench, name)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{name} needs {cell['chips']} CUDA device(s); "
                             f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    driver_path = HERE / "drivers" / f"{traffic['driver']}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_driver_{traffic['driver']}",
                                                  driver_path)
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    with tempfile.TemporaryDirectory(prefix="histogan_bench_") as work:
        ctx = harness.Ctx(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), device=torch.device(device),
                          t0=t0, workdir=Path(work), limits=harness.load_limits(name),
                          fault=fault, controls=tuple(controls))
        out = driver.run(ctx)
    if ctx.device.type == "cuda":
        harness.say(f"card: {harness.power_limit()}")
    if trace:
        view = out.pop("view")
        wanted = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        metrics = {}
        for m in wanted:
            value = load_metric(m["name"])(view, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        out["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        out["breakdown"] = view.breakdown()
        harness.say(f"trace: {view.launches} kernels, histogram attributed by {view.hist_method}")
    else:
        wanted = {m["name"]: m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])}
        out["metrics"] = {k: {"value": v, "unit": wanted[k]["unit"]}
                          for k, v in out["metrics"].items() if k in wanted}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        import histogan_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 3
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    checks = out.pop("checks")
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
