"""Smoke run of the PyTorch port (histogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
  2. build: compiles the histogram kernel from histogan_tpu_torch/csrc;
  3. kernel: the kernel against its plain torch version at the shapes the
     paths give it, fp32 with TF32 off, timed with CUDA events;
  4. slice: HistoGAN sampling at 256 px, capacity 16, latent 512, style
     depth 8, batch 16: weights from seed 0 written as a reference-layout
     .pt and loaded back, one 384x512 target image, 8 x 8 tiles = 64
     samples through the CLI's per-target function;
  5. reference: two of those samples recomputed on the CPU with the same
     weights, latents and noise.
Then one JSON line with the kernels, and last the result line. Any failed
check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_TOL_ABS = 1e-6  # normalised histogram, max |kernel - plain|
KERNEL_TOL_REL = 1e-5  # the same over max |plain|
# Card vs CPU at full width: 14 modulated convs of up to 2048 x 9 terms
# summed in other orders (cuDNN vs the CPU's algorithms), fp32 throughout.
SLICE_TOL = 1e-3
SHAPES = [(1, 150 * 150), (16, 64 * 64), (8, 250 * 250)]  # (B, N) of packed
INV_SIGMA2 = 1.0 / (0.02 * 0.02)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def normalise(h: torch.Tensor) -> torch.Tensor:
    return h / (h.sum(dim=(1, 2, 3), keepdim=True) + 1e-6)


def main() -> int:
    # ---- 1. device
    if not torch.cuda.is_available():
        print("device: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from histogan_tpu_torch.cli.histogan import sample_target, tile_double
    from histogan_tpu_torch.ops import histogram_cuda
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock, resize_if_needed
    from histogan_tpu_torch.train.trainer import Trainer
    from histogan_tpu_torch.utils.platform import setup_runtime

    dev = setup_runtime("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = histogram_cuda.build()
    histogram_cuda._library()
    print(f"build: {lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib} "
          f"in {time.perf_counter() - t0:.2f} s")
    log = lib.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas {line.strip()}")

    # ---- 3. kernel against plain
    max_err = 0.0
    shape_rows = []
    for b, n in SHAPES:
        x = np.random.default_rng(b * 7919 + n).random((b, n, 3), dtype=np.float32)
        packed = histogram_cuda.pack_pixels(torch.from_numpy(x).to(dev)).contiguous()
        got = histogram_cuda.hist_core(packed, INV_SIGMA2)
        want = histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
        torch.cuda.synchronize()
        g, w = normalise(got), normalise(want)
        err = (g - w).abs().max().item()
        rel = err / w.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"kernel output finite at B={b} N={n}")
        check(err <= KERNEL_TOL_ABS, f"max|kernel-plain| {err:.3e} <= {KERNEL_TOL_ABS} at B={b} N={n}")
        check(rel <= KERNEL_TOL_REL, f"relative {rel:.3e} <= {KERNEL_TOL_REL} at B={b} N={n}")
        max_err = max(max_err, err)
        reps = 50
        p1 = time_ms(lambda: histogram_cuda.hist_core_reference(packed, INV_SIGMA2), reps)
        k1 = time_ms(lambda: histogram_cuda.hist_core(packed, INV_SIGMA2), reps)
        k2 = time_ms(lambda: histogram_cuda.hist_core(packed, INV_SIGMA2), reps)
        p2 = time_ms(lambda: histogram_cuda.hist_core_reference(packed, INV_SIGMA2), reps)
        chunk, n_chunks = histogram_cuda.split_pixels(
            b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        row = {"B": b, "N": n, "max_abs_err": err, "rel_err": rel, "ms": min(k1, k2),
               "plain_ms": min(p1, p2), "chunks": n_chunks, "chunk": chunk}
        shape_rows.append(row)
        print(f"kernel: B={b} N={n} max|d|={err:.3e} rel={rel:.3e} "
              f"kernel {k1:.4f}/{k2:.4f} ms plain {p1:.4f}/{p2:.4f} ms "
              f"({n_chunks} chunks of {chunk} px)")

    # ---- 4. the slice at the flagship width
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    cfg = dict(image_size=256, network_capacity=16, latent_dim=512, style_depth=8,
               batch_size=16, hist_resizing="interpolation", hist_insz=150,
               hist_bin=64, trunc_psi=0.75, seed=0)
    t0 = time.perf_counter()
    src = Trainer("chip_smoke", work / "results", work / "models", device="cpu", **cfg)
    src.init_GAN()
    pt = work / "weights.pt"
    torch.save(src.reference_state_dict(), pt)
    model = Trainer("chip_smoke", work / "results", work / "models", device="cuda", **cfg)
    model.init_GAN()
    skipped = model.load_pt(pt)
    check(skipped == [], f"every key of the written .pt loads (skipped {skipped[:4]})")
    n_params = sum(p.numel() for m in model.models().values() for p in m.parameters())
    print(f"slice: weights seed 0, {n_params} parameters (S/H/G + EMA), "
          f".pt {pt.stat().st_size} bytes written and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    img = np.random.default_rng(1).random((384, 512, 3), dtype=np.float32)
    hist_block = RGBuvHistBlock(insz=150, h=64, resizing="interpolation",
                                method="inverse-quadratic", sigma=0.02)
    tiles = 8
    sample_target(model, hist_block, image=img, num_image_tiles=tiles)  # warm-up, resolves av
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    histogram_cuda.launches = 0
    t0 = time.perf_counter()
    out = sample_target(model, hist_block, image=img, num_image_tiles=tiles)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = histogram_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    check(out.shape == (tiles * tiles, 256, 256, 3), f"output shape {out.shape}")
    check(bool(np.isfinite(out).all()), "output finite")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output in [0, 1]")
    check(float(out.std()) > 0.0, "output not constant")
    check(launches >= 1, f"histogram kernel launched on the path ({launches})")

    x = torch.from_numpy(img[None]).to(dev)
    with torch.inference_mode():
        hist_path = hist_block(x)
        packed = histogram_cuda.pack_pixels(
            resize_if_needed(x.clamp(0, 1), 150, 64, "interpolation").reshape(1, -1, 3))
        hist_plain = normalise(histogram_cuda.hist_core_reference(packed, INV_SIGMA2))
    herr = (hist_path - hist_plain).abs().max().item()
    check(herr <= KERNEL_TOL_ABS, f"target histogram max|kernel-plain| {herr:.3e} <= {KERNEL_TOL_ABS}")
    rate = tiles * tiles / dt
    print(f"slice: {tiles * tiles} samples 256x256 in {dt:.4f} s = {rate:.2f} imgs/s "
          f"(fp32, {tiles * tiles // cfg['batch_size']} G chunks of {cfg['batch_size']}; "
          f"histogram kernel launches {launches}; target hist max|d| {herr:.3e}; "
          f"peak {peak} bytes) on {smi}")

    # ---- 5. two samples against the CPU with the same weights and inputs
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 512), dtype=np.float32)
    noise = rng.random((2, 256, 256, 1), dtype=np.float32)
    h2 = tile_double(hist_plain.cpu().numpy(), 2)
    src.av = model.av.cpu()
    imgs = {}
    for t in (model, src):
        with torch.inference_mode():
            imgs[t.device.type] = t.generate_truncated(
                t._ema_params(), torch.from_numpy(h2).to(t.device),
                torch.from_numpy(z).to(t.device), torch.from_numpy(noise).to(t.device),
                trunc_psi=cfg["trunc_psi"]).cpu().numpy()
    serr = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
    check(serr <= SLICE_TOL, f"card vs CPU samples max|d| {serr:.3e} <= {SLICE_TOL}")
    print(f"reference: 2 samples, card vs CPU max|d| {serr:.3e} (tolerance {SLICE_TOL})")
    shutil.rmtree(work, ignore_errors=True)

    main_shape = shape_rows[0]
    print(json.dumps({"kernels": [{
        "name": "histogram_fwd", "route": "cuda",
        "source": "histogan_tpu_torch/csrc/histogram_fwd.cu",
        "replaces": "histogan_tpu/ops/histogram_pallas.py:39",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "shapes": shape_rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
