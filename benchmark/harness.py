"""What every driver shares: the streams drawn from ``--seed``, the
synthetic photos, the weights, the device's description, the limits of a
cell's comparison and the checks printed beside them."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models
from benchmark.trace import Profile, TraceView

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

# the streams drawn from one seed, each its own
STREAMS = {"weights": 1, "photos": 2, "targets": 3, "order": 4, "requests": 5, "check": 6}


@dataclasses.dataclass
class Ctx:
    """One run: the cell, its configuration and traffic (the parsed data
    files), the seed, the window's length, the trace flag, the device,
    the process's start on the monotonic clock and a scratch directory."""

    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    workdir: Path
    limits: dict
    fault: Optional[str] = None  # a fault planted in the program (tests of the check)
    controls: tuple = ()  # the control ('tf32') and faults read beside the check


def stream_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed of ``stream`` (and item ``index``) derived from the
    run's seed, which may exceed 32 bits."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), STREAMS[stream], int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream, index))


def make_photos(n: int, size: int, seed: int, stream: str, device) -> np.ndarray:
    """``n`` photo-like (size, size, 3) uint8 images: a smooth random
    colour field around a random mean colour, with grain, so that each
    image's histogram is concentrated as a photo's is. Made on ``device``
    in a few large calls."""
    g = generator(seed, stream, device)
    mean = 0.15 + 0.7 * torch.rand((n, 3, 1, 1), generator=g, device=device)
    spread = 0.05 + 0.25 * torch.rand((n, 1, 1, 1), generator=g, device=device)
    coarse = torch.randn((n, 3, 6, 6), generator=g, device=device)
    field = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
    grain = torch.randn((n, 3, size, size), generator=g, device=device)
    img = (mean + spread * field + 0.02 * grain).clamp(0.0, 1.0)
    return (img * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def write_jpegs(images: np.ndarray, folder: Path) -> list:
    """Each image as ``folder/<index>.jpg`` (quality 95); returns the paths."""
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    paths = [folder / f"{i:05d}.jpg" for i in range(len(images))]

    def write(i):
        Image.fromarray(images[i]).save(paths[i], quality=95)

    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(write, range(len(images))))
    return paths


def read_jpeg(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGB"))


def parameter_table(cfg) -> list:
    """(key, shape) of every tensor of the configuration's state dict, in
    the modules' order."""
    mods = models.build_modules(cfg, "meta")
    return [(f"{p}.{n}", tuple(t.shape)) for p, m in mods.items() for n, t in m.named_parameters()]


EMA_OF = {"SE": "S", "HE": "H", "GE": "G"}


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict the program and the reference both start from, made
    on ``device`` from the seed in two draws: the published initialisation
    (every weight N(0, 2 / fan_in), every bias U(+-1/sqrt(fan_in)), the
    generator's constant input N(0, 1), the noise projections 0) and the
    EMA modules equal to the live ones, as after a reset."""
    table = parameter_table(cfg)
    shapes = dict(table)
    normal = [(k, s) for k, s in table if k.split(".")[0] not in EMA_OF and len(s) >= 2
              and ".to_noise" not in k]
    uniform = [(k, s) for k, s in table if k.split(".")[0] not in EMA_OF and len(s) == 1
               and ".to_noise" not in k]
    g = generator(seed, "weights", device)
    flat_n = torch.randn(sum(math.prod(s) for _, s in normal), generator=g, device=device)
    flat_u = torch.rand(sum(math.prod(s) for _, s in uniform), generator=g, device=device)
    out, off = {}, 0
    for k, s in normal:
        n = math.prod(s)
        std = 1.0 if k.endswith("initial_block") else math.sqrt(2.0 / math.prod(s[1:]))
        out[k] = (flat_n[off:off + n] * std).view(s)
        off += n
    off = 0
    for k, s in uniform:
        n = math.prod(s)
        fan_in = math.prod(shapes[k[: -len("bias")] + "weight"][1:])
        out[k] = ((flat_u[off:off + n] * 2.0 - 1.0) / math.sqrt(fan_in)).view(s)
        off += n
    for k, s in table:
        if ".to_noise" in k:
            out[k] = torch.zeros(s, device=device)
    for k, s in table:
        prefix, _, rest = k.partition(".")
        if prefix in EMA_OF:
            out[k] = out[f"{EMA_OF[prefix]}.{rest}"].clone()
    return {k: out[k] for k, _ in table}


def device_info(device) -> dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def load_limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {'value', 'limit'}} of each number that has a limit: the
    compared ones. A number is within its limit when it is finite and at
    most the limit. The others are readings, printed and not judged."""
    for k, v in values.items():
        if k not in limits:
            say(f"reading {k} {float(v)!r} (not compared)")
    return {k: {"value": float(values[k]), "limit": float(lim)} for k, lim in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def serve(ctx, request, images_per_request: int, checked: int, profiled: int):
    """The closed loop of one client: ``request(i)`` for i = 0, 1, ... until
    ``--seconds`` have passed; traced, the ``profiled`` requests that start
    once a third of the window has passed are profiled. Returns (each
    request's seconds, the window's seconds, {i: answer} of ``checked``
    requests drawn from the seed as a reservoir sample, the TraceView or
    None)."""
    keep = np.random.default_rng(stream_seed(ctx.seed, "check"))
    kept, lat, view, prof, first = {}, [], None, None, 0
    start = time.monotonic()
    while time.monotonic() - start < ctx.seconds or (ctx.trace and view is None):
        i = len(lat)
        if ctx.trace and prof is None and view is None \
                and time.monotonic() - start >= ctx.seconds / 3:
            prof, first = Profile(), i
            prof.start()
        t = time.monotonic()
        answer = request(i)
        lat.append(time.monotonic() - t)
        if len(kept) < checked:
            kept[i] = answer
        else:
            j = int(keep.integers(0, i + 1))
            if j < checked:
                kept.pop(sorted(kept)[j])
                kept[i] = answer
        if prof is not None and i + 1 - first == profiled:
            view = TraceView(prof.stop(ctx.workdir / "trace.json"), [""] * profiled,
                             profiled * images_per_request)
            prof = None
    return lat, time.monotonic() - start, kept, view


def free_device_memory():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def quantile(values, q: float) -> float:
    """The ``q`` quantile, linear between order statistics (numpy's
    default)."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def env_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
