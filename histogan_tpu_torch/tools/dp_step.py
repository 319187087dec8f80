"""Run saved training cases on every rank of a data-parallel process group
and write each rank's results: the check that N ranks compute what one
process computes on the global batch.

    python -m histogan_tpu_torch.tools.dp_step CASES.pt OUT_DIR [--backend gloo] [--device cpu]

under ``torchrun --nproc_per_node N`` (or ``spawn``, which starts the N
processes with torchrun's variables itself). ``CASES.pt`` is a list of
cases, each a dict:

- ``{"kind": "histogan" | "rehisto", "trainer": kwargs, "state": a
  reference-layout state dict or None (the seed's weights), "steps":
  [{"batch", "draws", "gp", "pl"}]}``: the global batch's batch and draws
  of each step; every rank builds the trainer, loads the state, and runs
  ``train_step`` on its slices (``steps.local_draws``,
  ``rehisto_steps.local_draws``). The results hold the gradients that
  DiffGrad applied at step ``"grads_step"`` (default the last; None:
  none).
- ``{"kind": "trainer", "trainer": kwargs, "data": folder, "steps": n}``:
  ``Trainer.train`` n times on the folder, as a user runs it; a string
  kwarg may name the rank as ``{rank}``.

A reHistoGAN case also holds ``"hyper"``: the step's alpha, beta, gamma.

Each rank writes ``OUT_DIR/rank<r>.pt``: per case the metrics of each step,
the state dict after them, the weights right after ``init_GAN``
(``initial``, trainer cases), the gradients that DiffGrad applied,
and for step cases each step's milliseconds (host clock, after a device
sync) and the histogram kernels' launches (``ops/histogram_cuda.py``'s
counts; 0 on the CPU, which runs their plain versions).
``run_cases`` runs the same cases in one process (the reference).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from histogan_tpu_torch import parallel


def to_device(x, device):
    """``x`` (tensors inside dicts, lists, tuples and dataclasses) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


def _applied_grads(state, prefixes) -> dict:
    """{reference name: the gradient DiffGrad last applied} (on the CPU)."""
    out = {}
    for p in prefixes:
        opt = state.opt_d if p == "D" else state.opt_g
        for n, w in getattr(state, p).named_parameters():
            out[f"{p}.{n}"] = opt.state[w]["previous_grad"].detach().cpu()
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cpu_state(t) -> dict:
    return {k: v.detach().cpu().clone() for k, v in t.reference_state_dict().items()}


def _run_steps(case: dict, device) -> dict:
    from histogan_tpu_torch.train import rehisto_steps, steps
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    from histogan_tpu_torch.train.trainer import Trainer

    from histogan_tpu_torch.ops import histogram_cuda

    rehisto = case["kind"] == "rehisto"
    t = (RecoloringTrainer if rehisto else Trainer)(device=device, **case["trainer"])
    t.init_GAN()
    if case.get("state") is not None:
        t.load_state_dict(case["state"])
    histogram_cuda.launches = histogram_cuda.bwd_launches = 0
    prefixes = ("ED", "H", "G", "D") if rehisto else ("S", "H", "G", "D")
    grads_step = case.get("grads_step", len(case["steps"]) - 1)
    metrics, ms, grads = [], [], None
    for s in case["steps"]:
        batch = {k: parallel.local_slice(v, dim=1).to(t.device) for k, v in s["batch"].items()}
        draws = to_device(copy.deepcopy(s["draws"]), t.device)
        _sync(t.device)
        t0 = time.perf_counter()
        if rehisto:
            m = rehisto_steps.train_step(t.state, batch, rehisto_steps.local_draws(draws), t.cfg,
                                         s["gp"], **case["hyper"])
        else:
            m = steps.train_step(t.state, batch, steps.local_draws(draws), t.cfg, s["gp"],
                                 s["pl"])
        _sync(t.device)
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: v.item() for k, v in m.items()})
        if len(metrics) - 1 == grads_step:
            grads = _applied_grads(t.state, prefixes)
    out = {"metrics": metrics, "state": _cpu_state(t), "ms": ms,
           "launches": {"histogram_fwd": histogram_cuda.launches,
                        "histogram_bwd": histogram_cuda.bwd_launches}}
    if grads is not None:
        out["grads"] = grads
    return out


def _run_trainer(case: dict, device) -> dict:
    from histogan_tpu_torch.train.trainer import Trainer

    kwargs = {k: v.format(rank=parallel.rank()) if isinstance(v, str) else v
              for k, v in case["trainer"].items()}
    t = Trainer(device=device, **kwargs)
    t.init_GAN()
    initial = _cpu_state(t)
    t.set_data_src(case["data"])
    try:
        metrics = [t.train() for _ in range(case["steps"])]
    finally:
        t.close()
    return {"metrics": metrics, "state": _cpu_state(t), "initial": initial,
            "grads": _applied_grads(t.state, ("S", "H", "G", "D"))}


def run_cases(cases: List[dict], device) -> List[dict]:
    """Each case's results on this rank (or in this one process)."""
    return [_run_trainer(c, device) if c["kind"] == "trainer" else _run_steps(c, device)
            for c in cases]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(cases_path, out_dir, nproc: int, backend: str, device: str,
          timeout: float = 600.0, env: Optional[dict] = None) -> List[dict]:
    """Run this tool on ``nproc`` ranks (processes started here with
    torchrun's variables, on one host); returns each rank's results.
    Raises if a rank fails or the run outlasts ``timeout`` seconds, after
    stopping every rank."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = str(Path(__file__).resolve().parents[2])  # the checkout, for -m from anywhere
    path = os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))
    base = {**os.environ, "PYTHONPATH": path, **(env or {}), "WORLD_SIZE": str(nproc),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    procs, logs = [], [out_dir / f"rank{r}.log" for r in range(nproc)]
    for r in range(nproc):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "histogan_tpu_torch.tools.dp_step", str(cases_path),
                 str(out_dir), "--backend", backend, "--device", device],
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:  # a rank that fails leaves the others waiting in a collective: stop them all
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"data-parallel ranks {failed} failed or were stopped "
                           f"(timeout {timeout} s):\n"
                           + "\n".join(f"--- rank {r}\n{logs[r].read_text()[-4000:]}"
                                       for r in failed))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(nproc)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("cases")
    parser.add_argument("out_dir")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: NCCL "
                        "for a CUDA --device, gloo for cpu)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not parallel.maybe_initialize_distributed(args.backend, args.device):
        raise SystemExit("dp_step runs under torchrun (or spawn): no process group in the env")
    try:
        cases = torch.load(args.cases, weights_only=False)
        results = run_cases(cases, args.device)
        torch.save(results, Path(args.out_dir) / f"rank{parallel.rank()}.pt")
        parallel.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
