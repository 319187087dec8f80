"""Run saved training cases on every rank of a data-parallel process group
and write each rank's results: the check that N ranks compute what one
process computes on the global batch.

    python -m histogan_tpu_torch.tools.dp_step CASES.pt OUT_DIR [--backend gloo] [--device cpu]

under ``torchrun --nproc_per_node N`` (or ``spawn``, which starts the N
processes with torchrun's variables itself). ``CASES.pt`` is a list of
cases, each a dict:

- ``{"kind": "histogan" | "rehisto", "trainer": kwargs, "state": a
  reference-layout state dict or None (the seed's weights), "steps":
  [{"batch", "draws", "gp", "pl"[, "ema"]}]}``: the global batch's batch
  and draws of each step (and whether it moves the EMA); every rank
  builds the trainer, loads the state, and runs ``train_step`` on its
  slices (``steps.local_draws``,
  ``rehisto_steps.local_draws``). The results hold the gradients that
  DiffGrad applied at step ``"grads_step"`` (default the last; None:
  none). ``"trainer"`` may hold ``param_sharding="fsdp"``: the state is
  then sharded over the ranks, and the state dict and the gradients are
  gathered. ``"keep"``: the module prefixes whose state the results
  hold (default all); with ``"digest": True`` they hold each state
  tensor's sha256 in place of the tensor.
- ``{"kind": "trainer", "trainer": kwargs, "data": folder, "steps": n}``:
  ``Trainer.train`` n times on the folder, as a user runs it; a string
  kwarg may name the rank as ``{rank}``; ``"class": "rehisto"`` trains
  the ``RecoloringTrainer`` instead; ``"load": k`` first loads checkpoint
  k, and the results then hold what the rank keeps of it (``local``: each
  module's state dict, ``local_opt``: the optimizers', shards under FSDP);
- ``{"kind": "source", "data": (n, size, hist_bin, seed), "batch_size",
  "accum", "batches": k, "budget": bytes, "flag", "options": {...}}``: a
  device dataset over ``synthetic_data(*data)`` through ``make_source``
  with that per-device budget (``"sharded"`` where the cache fits only
  the ranks' budgets together), k batches of it.

A reHistoGAN case also holds ``"hyper"``: the step's alpha, beta, gamma.

Each rank writes ``OUT_DIR/rank<r>.pt``: per case the metrics of each step,
the state dict after them, the weights right after ``init_GAN``
(``initial``, trainer cases), the gradients that DiffGrad applied,
the bytes of training state the rank holds (``state_bytes``), and for
step cases the histogram kernels' launches (``ops/histogram_cuda.py``'s
counts; 0 on the CPU, which runs their plain versions). A source case
writes the placement, the rows and bytes the rank holds and its batches
(on the CPU).
``run_cases`` runs the same cases in one process (the reference).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import hashlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
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
    """{reference name: the gradient DiffGrad last applied} (on the CPU,
    gathered where the state is sharded)."""
    out = {}
    for opt, group in ((state.opt_g, [p for p in prefixes if p != "D"]), (state.opt_d, ["D"])):
        modules = [getattr(state, p) for p in group]
        sd = parallel.full_optimizer_state_dict(opt, modules)["state"]
        names = [f"{p}.{n}" for p, m in zip(group, modules) for n, _ in m.named_parameters()]
        for i, name in enumerate(names):
            out[name] = sd[i]["previous_grad"].detach().cpu()
    return out


def state_bytes(t) -> int:
    """The bytes of training state the trainer ``t`` holds on this rank."""
    s = t.state
    return parallel.sharded_bytes_per_rank(list(s.modules().values()), [s.opt_g, s.opt_d])


@functools.lru_cache(maxsize=1)
def synthetic_data(n: int, size: int, hist_bin: int, seed: int):
    """A (n, size, size, 3) uint8 cache and a (n, 3, hist_bin, hist_bin)
    fp32 pool of histograms, from ``seed``; read-only, as the last call's
    are kept for the next."""
    rng = np.random.default_rng(seed)
    cache = np.frombuffer(bytearray(rng.bytes(n * size * size * 3)), np.uint8).reshape(
        n, size, size, 3)
    pool = rng.random((n, 3, hist_bin, hist_bin), dtype=np.float32)
    pool /= pool.sum(axis=(1, 2, 3), keepdims=True)
    for x in (cache, pool):
        x.setflags(write=False)
    return cache, pool


def _cpu_state(t, keep=None) -> dict:
    """The reference state dict on the CPU, only the prefixes of ``keep``
    (all for None)."""
    return {k: v.detach().cpu().clone() for k, v in t.reference_state_dict().items()
            if keep is None or k.split(".")[0] in keep}


def _digest(t) -> dict:
    """{name: sha256 of the tensor's bytes} of the reference state dict."""
    return {k: hashlib.sha256(v.detach().cpu().reshape(-1).view(torch.uint8).numpy()).hexdigest()
            for k, v in t.reference_state_dict().items()}


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
    metrics, grads = [], None
    for s in case["steps"]:
        batch = {k: parallel.local_slice(v, dim=1).to(t.device) for k, v in s["batch"].items()}
        draws = to_device(copy.deepcopy(s["draws"]), t.device)
        if rehisto:
            m = rehisto_steps.train_step(t.state, batch, rehisto_steps.local_draws(draws),
                                         t.cfg, s["gp"], **case["hyper"])
        else:
            m = steps.train_step(t.state, batch, steps.local_draws(draws), t.cfg, s["gp"],
                                 s["pl"], s.get("ema", False))
        metrics.append({k: v.item() for k, v in m.items()})
        if len(metrics) - 1 == grads_step:
            grads = _applied_grads(t.state, prefixes)
    state = _digest(t) if case.get("digest") else _cpu_state(t, case.get("keep"))
    out = {"metrics": metrics, "state": state, "state_bytes": state_bytes(t),
           "launches": {"histogram_fwd": histogram_cuda.launches,
                        "histogram_bwd": histogram_cuda.bwd_launches}}
    if grads is not None:
        out["grads"] = grads
    return out


def _run_trainer(case: dict, device) -> dict:
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    from histogan_tpu_torch.train.trainer import Trainer

    rehisto = case.get("class") == "rehisto"
    kwargs = {k: v.format(rank=parallel.rank()) if isinstance(v, str) else v
              for k, v in case["trainer"].items()}
    t = (RecoloringTrainer if rehisto else Trainer)(device=device, **kwargs)
    t.init_GAN()
    out = {}
    if case.get("load") is not None:
        t.load(case["load"])
        s = t.state
        out["local"] = {f"{p}.{k}": v.detach().cpu().clone() for p, m in s.modules().items()
                        for k, v in m.state_dict().items()}
        out["local_opt"] = to_device(copy.deepcopy({"opt_g": s.opt_g.state_dict(),
                                                    "opt_d": s.opt_d.state_dict()}), "cpu")
    out["initial"] = _cpu_state(t)
    out["metrics"] = []
    if case["steps"]:
        t.set_data_src(case["data"])
        try:
            out["metrics"] = [t.train() for _ in range(case["steps"])]
        finally:
            t.close()
    prefixes = ("ED", "H", "G", "D") if rehisto else ("S", "H", "G", "D")
    return {**out, "state": _cpu_state(t), "grads": _applied_grads(t.state, prefixes),
            "state_bytes": state_bytes(t)}


def _run_source(case: dict, device) -> dict:
    import types

    from histogan_tpu_torch.data import device_source

    cache, pool = synthetic_data(*case["data"])
    opts = dict(case.get("options", {}))
    aug = opts.pop("aug_prob", 0.0)
    ds = types.SimpleNamespace(_cache=cache, aug_prob=aug)
    src = device_source.make_source(case.get("flag", True), ds, types.SimpleNamespace(pool=pool),
                                    case["batch_size"], case["accum"], seed=case.get("seed", 3),
                                    device=device, budget=case["budget"], **opts)
    del cache, pool
    batches = [{k: v.cpu().clone() for k, v in next(src).items()}
               for _ in range(case["batches"])]
    return {"shard_cache": src.shard_cache, "rows": src.rows, "batches": batches,
            "bytes": src._images.numel() + src._pool.numel() * src._pool.element_size()}


def run_cases(cases: List[dict], device) -> List[dict]:
    """Each case's results on this rank (or in this one process)."""
    run = {"trainer": _run_trainer, "source": _run_source}
    return [run.get(c["kind"], _run_steps)(c, device) for c in cases]


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
