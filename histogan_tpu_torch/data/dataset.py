"""Data pipeline: image folder, histogram pool and prefetching loader,
the counterpart of ``histogan_tpu/data/dataset.py`` (reference Dataset,
histoGAN/histoGAN.py:253-307).

The reference opens three images and runs the histogram block twice for
every training example. Here the histogram of every dataset image is
computed once, in batches on the training device, into a host pool; a
step's target histograms are two pool lookups and a lerp, the same
distribution as the reference's ``hist_interpolation(hist1, hist2)`` with
``ratio ~ U[0,1)`` (histoGAN/histoGAN.py:179-181). Images are decoded
once into a uint8 cache and fed by a background thread. PIL and cv2 are
imported only where a file is decoded or resized.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

EXTS = ["jpg", "png"]  # histoGAN/histoGAN.py:52


def list_images(folder: str) -> List[Path]:
    paths = [p for ext in EXTS for p in Path(folder).glob(f"**/*.{ext}")]
    return sorted(paths)


def load_rgb(path, transparent: bool = False) -> np.ndarray:
    """Decode to float32 [0,1] HWC; greyscale expanded, RGBA handled like
    the reference transforms (histoGAN/histoGAN.py:227-244)."""
    from PIL import Image

    img = Image.open(path)
    mode = "RGBA" if transparent else "RGB"
    if img.mode != mode:
        img = img.convert(mode)
    return np.asarray(img, dtype=np.float32) / 255.0


def _resize_pil(arr: np.ndarray, size_hw) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
    img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


class ImageFolderDataset:
    """Training image source with the reference's transform chain:
    resize-to-minimum, shorter-side resize, random-resized-crop with prob
    ``aug_prob`` else center-crop (histoGAN/histoGAN.py:271-281).

    Decoded-image cache: with ``cache_dir`` set, the deterministic
    (non-augmented, center-crop) transform of every image is decoded ONCE
    into a memory-mapped uint8 ``.npy`` alongside the histogram pool;
    per-step feeding then costs an mmap read instead of a JPEG decode and
    two PIL resizes. Lossless: the decode path's output is exactly
    uint8/255 (it round-trips through PIL uint8). Augmented draws (prob
    ``aug_prob``) still decode: the random crop needs the pre-crop
    pixels."""

    # skip building the decoded cache past this size (a 70k-image 1024px
    # folder would otherwise write ~220 GB before training starts)
    CACHE_BUDGET_BYTES = 8 << 30

    def __init__(self, folder: str, image_size: int = 256,
                 transparent: bool = False, aug_prob: float = 0.0,
                 cache_dir: Optional[str] = None):
        self.paths = list_images(folder)
        if not self.paths:
            raise FileNotFoundError(f"no {EXTS} images under {folder}")
        self.image_size = image_size
        self.transparent = transparent
        self.aug_prob = aug_prob
        self._cache: Optional[np.ndarray] = None
        if cache_dir is not None:
            c = 4 if transparent else 3
            est = len(self.paths) * image_size * image_size * c
            if est <= self.CACHE_BUDGET_BYTES:
                self._cache = self._build_or_load_cache(cache_dir)
            else:
                print(f"decoded-image cache skipped: {est >> 20} MiB "
                      f"exceeds the {self.CACHE_BUDGET_BYTES >> 20} MiB budget "
                      f"(streaming decode instead)")

    def __len__(self) -> int:
        return len(self.paths)

    def _cache_file(self, cache_dir: str) -> Path:
        import hashlib

        def line(p):
            st = Path(p).stat()  # one stat per file (big folders, NFS)
            return f"{p}:{st.st_mtime_ns}:{st.st_size}"

        ident = "\n".join(line(p) for p in self.paths)
        cfg = f"{self.image_size}:{self.transparent}"
        key = hashlib.sha256((ident + cfg).encode()).hexdigest()[:24]
        return Path(cache_dir) / f"img_cache_{key}.npy"

    def _build_or_load_cache(self, cache_dir: str) -> np.ndarray:
        import os

        path = self._cache_file(cache_dir)
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            # pid-unique tmp: two processes sharing a models dir must not
            # truncate each other's half-written cache (atomic replace
            # still publishes exactly one complete file)
            tmp = path.with_suffix(f".tmp{os.getpid()}.npy")
            c = 4 if self.transparent else 3
            size = self.image_size
            arr = np.lib.format.open_memmap(
                tmp, mode="w+", dtype=np.uint8,
                shape=(len(self.paths), size, size, c),
            )
            for i in range(len(self.paths)):
                img = self._decode(i, use_aug=False, rng=None)
                arr[i] = np.round(img * 255.0).astype(np.uint8)
            arr.flush()
            del arr
            tmp.replace(path)  # atomic
        return np.load(path, mmap_mode="r")

    def get_image_u8(self, index: int, rng: np.random.Generator) -> np.ndarray:
        """One training image as uint8 HWC: a cache hit returns the raw
        cache row, a decode is rounded back to uint8 (lossless: every
        decode path is PIL-uint8-derived). One rng draw per item whichever
        path it takes, as the reference's RandomApply draws
        (histoGAN/histoGAN.py:278-281)."""
        use_aug = (rng.random() < self.aug_prob) if rng is not None else False
        if self._cache is not None and not use_aug:
            return np.asarray(self._cache[index])
        return np.rint(
            self._decode(index, use_aug, rng) * 255.0).astype(np.uint8)

    def _decode(self, index: int, use_aug: bool,
                rng: Optional[np.random.Generator]) -> np.ndarray:
        size = self.image_size
        arr = load_rgb(self.paths[index], self.transparent)
        h, w = arr.shape[:2]
        if max(h, w) < size:  # resize_to_minimum_size (histoGAN.py:247-250)
            scale = size / min(h, w)
            arr = _resize_pil(arr, (round(h * scale), round(w * scale)))
            h, w = arr.shape[:2]
        # transforms.Resize(size): shorter side -> size
        if min(h, w) != size:
            scale = size / min(h, w)
            arr = _resize_pil(arr, (max(size, round(h * scale)), max(size, round(w * scale))))
            h, w = arr.shape[:2]
        if use_aug:
            # RandomResizedCrop(scale=(0.5,1.0), ratio=(0.98,1.02))
            area = h * w
            for _ in range(10):
                target_area = area * rng.uniform(0.5, 1.0)
                ar = np.exp(rng.uniform(np.log(0.98), np.log(1.02)))
                cw = int(round(np.sqrt(target_area * ar)))
                ch = int(round(np.sqrt(target_area / ar)))
                if 0 < cw <= w and 0 < ch <= h:
                    i = rng.integers(0, h - ch + 1)
                    j = rng.integers(0, w - cw + 1)
                    return _resize_pil(arr[i : i + ch, j : j + cw], (size, size))
            return self._center_crop(arr, size)
        return self._center_crop(arr, size)

    @staticmethod
    def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
        h, w = arr.shape[:2]
        i = max(0, (h - size) // 2)
        j = max(0, (w - size) // 2)
        return arr[i : i + size, j : j + size]


class HistogramPool:
    """Per-image RGB-uv histograms for the whole dataset, computed once.

    The reference's resize-for-histogram happens on the FULL image before
    the hist block (RGBuvHistBlock.py:77-95); the same rule runs on the
    host (cv2 / index sampling), then batches of ``batch`` images go
    through ``histogram_feature`` on ``device`` (on a GPU, the histogram
    kernel).
    """

    BATCH = 16  # images per histogram_feature call

    def __init__(self, paths: Sequence, hist_insz: int = 150, hist_bin: int = 64,
                 hist_method: str = "inverse-quadratic",
                 hist_resizing: str = "sampling", hist_sigma: float = 0.02,
                 transparent: bool = False, cache_dir: Optional[str] = None,
                 device="cpu"):
        import torch

        from histogan_tpu_torch.ops.histogram import histogram_feature

        self.paths = list(paths)
        self.h = hist_bin
        n = len(self.paths)
        self.pool = np.zeros((n, 3, hist_bin, hist_bin), np.float32)

        # disk cache keyed on file identities + histogram config
        cache_file = None
        if cache_dir is not None:
            import hashlib

            def line(p):
                st = Path(p).stat()
                return f"{p}:{st.st_mtime_ns}:{st.st_size}"

            ident = "\n".join(line(p) for p in self.paths)
            cfg = f"{hist_insz}:{hist_bin}:{hist_method}:{hist_resizing}:{hist_sigma}:{transparent}"
            key = hashlib.sha256((ident + cfg).encode()).hexdigest()[:24]
            cache_file = Path(cache_dir) / f"hist_pool_{key}.npy"
            if cache_file.exists():
                self.pool = np.load(cache_file)
                return

        def host_resize(arr: np.ndarray) -> np.ndarray:
            hh, ww = arr.shape[:2]
            if hh <= hist_insz and ww <= hist_insz:
                return arr
            if hist_resizing == "sampling":
                rows = np.linspace(0, hh, hist_bin, endpoint=False).astype(np.int64)
                cols = np.linspace(0, ww, hist_bin, endpoint=False).astype(np.int64)
                return arr[rows][:, cols]
            import cv2

            return cv2.resize(arr, (hist_insz, hist_insz), interpolation=cv2.INTER_LINEAR)

        # group by post-resize shape so each batch stacks
        groups: Dict[tuple, List[int]] = {}
        resized: Dict[int, np.ndarray] = {}
        for i, p in enumerate(self.paths):
            arr = host_resize(load_rgb(p, transparent)[..., :3])
            resized[i] = arr
            groups.setdefault(arr.shape, []).append(i)

        for shape, idxs in groups.items():
            for s in range(0, len(idxs), self.BATCH):
                chunk = idxs[s : s + self.BATCH]
                x = torch.from_numpy(np.stack([resized[i] for i in chunk])).to(device)
                with torch.inference_mode():
                    hists = histogram_feature(
                        x, h=hist_bin, insz=max(hist_insz, max(shape[:2])),
                        resizing=hist_resizing, method=hist_method, sigma=hist_sigma,
                    )
                self.pool[chunk] = hists.cpu().numpy()

        if cache_file is not None:
            import os

            cache_file.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache_file.with_suffix(f".tmp{os.getpid()}.npy")
            np.save(tmp, self.pool)
            tmp.replace(cache_file)  # atomic

    def __len__(self) -> int:
        return len(self.paths)

    def self_hist(self, indices) -> np.ndarray:
        return self.pool[np.asarray(indices)]

    def sample_interpolated(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """r*h_a + (1-r)*h_b over uniformly random image pairs
        (histoGAN/histoGAN.py:296-302, 179-181)."""
        idx = rng.integers(0, len(self.paths), size=(2, n))
        r = rng.random((n, 1, 1, 1), dtype=np.float32)
        return r * self.pool[idx[0]] + (1.0 - r) * self.pool[idx[1]]


class TrainLoader:
    """Background-thread prefetching loader yielding per-step batches:

    {'d_images': (A,B,S,S,C) uint8, 'd_hists': (A,B,3,h,h), 'g_hists': (A,B,3,h,h)}

    The D phase consumes images and target histograms, the G phase only
    target histograms (the reference draws full batches for G and ignores
    the images, histoGAN/histoGAN.py:936-940; their decode is skipped).
    Images travel as uint8 and are dequantised on the device
    (``steps.dequantize_images``), four times fewer bytes to the device.

    reHistoGAN's options (``histogan_tpu/data/dataset.py`` TrainLoader):
    ``include_g_images`` gives G's batches images of their own
    ('g_images', drawn after the D half), and ``self_hist`` takes each
    image's own histogram as its target in place of a pool interpolation
    (the recoloring trainer's ``sampling=False``). With both off the
    batches and the draws are the HistoGAN trainer's.
    """

    def __init__(self, dataset: ImageFolderDataset, pool: HistogramPool,
                 batch_size: int, accum: int, seed: int = 0, prefetch: int = 2,
                 self_hist: bool = False, include_g_images: bool = False):
        self.dataset = dataset
        self.pool = pool
        self.batch_size = batch_size
        self.accum = accum
        self.self_hist = self_hist
        self.include_g_images = include_g_images
        self._rng = np.random.default_rng(seed)
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self) -> Dict[str, np.ndarray]:
        a, b = self.accum, self.batch_size
        rng = self._rng

        def images_and_hists():
            idx = rng.integers(0, len(self.dataset), size=a * b)
            imgs = np.stack([self.dataset.get_image_u8(int(i), rng) for i in idx])
            return imgs.reshape(a, b, *imgs.shape[1:]), hists(idx)

        def hists(idx):
            h = (self.pool.self_hist(idx) if self.self_hist
                 else self.pool.sample_interpolated(rng, a * b))
            return h.reshape(a, b, *self.pool.pool.shape[1:])

        batch = dict(zip(("d_images", "d_hists"), images_and_hists()))
        if self.include_g_images:
            batch["g_images"], batch["g_hists"] = images_and_hists()
        else:
            batch["g_hists"] = self.pool.sample_interpolated(rng, a * b).reshape(
                a, b, *self.pool.pool.shape[1:])
        return batch

    def _worker(self):
        while not self._stop.is_set():
            batch = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def close(self):
        self._stop.set()
