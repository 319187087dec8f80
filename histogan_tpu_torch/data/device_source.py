"""Device-resident dataset, the counterpart of
``histogan_tpu/data/device_source.py``: the decoded uint8 image cache and
the histogram pool live in device memory, and each step's batch is a set
of gathers on the device from one int32 and one fp32 upload of the step's
draws (a few hundred bytes) instead of a stream of images from the host.

The sampling distribution is the streaming ``TrainLoader``'s: uniform
image draws, target histograms ``r*pool[i] + (1-r)*pool[j]`` with ``r ~
U[0,1)`` (histoGAN/histoGAN.py:296-302, 179-181), or each image's own
histogram for reHistoGAN's ``hist_sampling=False``. The draws come from
the JAX module's rng stream in its order, so one seed gives the JAX
package's batches. The streaming loader draws one ``rng.random()`` per
image even at ``aug_prob`` 0 (``ImageFolderDataset.get_image_u8``) and
this source does not, so the two loaders give one distribution from two
streams, as in the JAX package. Images stay uint8 on the device; the step
dequantizes them (``train/steps.dequantize_images``).

Dataset augmentation: the reference's RandomResizedCrop (scale 0.5-1.0,
ratio 0.98-1.02, prob ``dataset_aug_prob``; histoGAN/histoGAN.py:276-278)
needs the pre-crop image, which only the host has, so ``"auto"`` streams
then. An explicit ``device_dataset=True`` runs the crop on the device
from the cached center square: the boxes are drawn on the host by the
reference's algorithm (``sample_crop_boxes``) and the resize is a batched
separable bilinear (``crop_resize_u8``) within 1 uint8 level of PIL's
crop and resize. For a non-square source the crop window is then limited
to the cached center square, a slightly narrower content distribution.

Placement: ``device_dataset_mode`` returns ``None`` (stream),
``"replicated"`` (every rank of a data-parallel run holds the whole
cache) or ``"sharded"``: the budget is per device, so "auto" replicates a
cache that fits one device's budget and shards one that fits the world's,
as the JAX module does. Every rank draws the global batch's indices from
the same seed and keeps its slice (``shard``), as the JAX trainer's
source draws the global batch on every process; the streaming loader on
rank r is seeded seed + r and loads the local batch. Sharded
(``shard_cache``), rank r holds rows [r * m, (r + 1) * m) of the cache and
of the pool, m = ceil(n / ranks), zero-padded; the rows of a batch reach
the rank that needs them in one reduce-scatter of owner-masked rows (exact:
one rank owns each row), and the pool mix and the crop then run on the
local rows, so the batches are the replicated source's bit for bit.

The streaming path's batches reach the device through ``take_batch`` and
``stage_next_batch``: on a GPU the loader's thread hands out pinned
tensors and the next batch's copy goes on a side stream right after the
step is dispatched. Each pinned tensor is a fresh block of PyTorch's
pinned-memory cache, which does not hand a block out again before the
copy that reads it has completed, so no buffer is rewritten in flight.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from histogan_tpu_torch import parallel
from histogan_tpu_torch.utils.logging import span

# The JAX package's budget for "auto" (images + pool), kept so that "auto"
# makes the same decision for the same folder.
DEVICE_DATASET_BUDGET = 2 << 30


def normalise_flag(flag):
    """True, False or "auto" from the trainer's flag; the strings
    "true"/"false"/"auto" (any case, also "1"/"0"/"yes"/"no") are read as
    such and any other string raises (``bool("false")`` is True)."""
    if isinstance(flag, str):
        norm = flag.strip().lower()
        if norm in ("true", "1", "yes"):
            return True
        if norm in ("false", "0", "no"):
            return False
        if norm == "auto":
            return "auto"
        raise ValueError(f"device_dataset={flag!r}: expected True/False/'auto' "
                         "(or the strings 'true'/'false'/'auto')")
    return flag


def should_use_device_dataset(flag, dataset, pool, dataset_aug_prob: float = 0.0,
                              world_size: int = 1, budget: Optional[int] = None) -> bool:
    """Resolve the trainers' ``device_dataset`` flag ("auto" | True | False).

    "auto" holds the data on the device when the decoded uint8 cache
    exists, no per-item augmentation needs the host's decode
    (``dataset_aug_prob`` 0) and images + pool fit ``world_size`` times
    the per-device ``budget`` (default ``DEVICE_DATASET_BUDGET``; the JAX
    module's ``_budget_scale``). An explicit True also takes
    ``dataset_aug_prob`` > 0 (the crop then runs on the device); True with
    no cache or over the budget raises."""
    flag = normalise_flag(flag)
    if flag is False:
        return False
    total = DEVICE_DATASET_BUDGET if budget is None else budget
    total *= world_size
    cache = getattr(dataset, "_cache", None)
    fits = cache is not None and cache.nbytes + pool.pool.nbytes <= total
    if flag == "auto":
        return fits and dataset_aug_prob == 0.0
    if flag is True and not fits:
        raise ValueError("device_dataset=True but the dataset is not eligible (needs a "
                         f"decoded cache and <= {total >> 20} MiB of images + pool across "
                         f"the {world_size} device(s))")
    return bool(flag)


def device_dataset_mode(flag, dataset, pool, dataset_aug_prob: float = 0.0,
                        world_size: Optional[int] = None,
                        budget: Optional[int] = None) -> Optional[str]:
    """The cache's placement: ``None`` (stream from the host),
    ``"replicated"`` (the whole cache on each rank's device, when it fits
    one device's budget) or ``"sharded"`` (1/``world_size`` of the rows on
    each, when it fits only the world's), as the JAX module's
    ``device_dataset_mode`` on a mesh of ``world_size`` devices (default
    the process group's)."""
    world_size = parallel.world_size() if world_size is None else world_size
    if not should_use_device_dataset(flag, dataset, pool, dataset_aug_prob, world_size, budget):
        return None
    fits_one = dataset._cache.nbytes + pool.pool.nbytes <= (
        DEVICE_DATASET_BUDGET if budget is None else budget)
    return "replicated" if fits_one else "sharded"


def sample_crop_boxes(rng: np.random.Generator, n: int, size: int,
                      aug_prob: float) -> np.ndarray:
    """RandomResizedCrop parameter draws on the host, the reference's
    algorithm (torchvision's get_params as ``ImageFolderDataset._decode``
    has it: scale U(0.5, 1.0) of the area, log-uniform ratio in (0.98,
    1.02), 10 attempts, center fallback) on the cached (size, size)
    square. Returns (n, 4) float32 rows (y0, x0, ch, cw); an item not
    augmented (prob 1 - aug_prob, one ``rng.random()`` per item as
    RandomApply draws) gets the identity box."""
    boxes = np.empty((n, 4), np.float32)
    boxes[:, :2] = 0.0
    boxes[:, 2:] = size
    area = float(size * size)
    for k in range(n):
        if rng.random() >= aug_prob:
            continue
        for _ in range(10):
            target_area = area * rng.uniform(0.5, 1.0)
            ar = np.exp(rng.uniform(np.log(0.98), np.log(1.02)))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if 0 < cw <= size and 0 < ch <= size:
                i = rng.integers(0, size - ch + 1)
                j = rng.integers(0, size - cw + 1)
                boxes[k] = (i, j, ch, cw)
                break
        # all 10 attempts out of bounds: the identity (the center crop of
        # the already square cache)
    return boxes


def crop_resize_u8(images: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Crop each (S, S, C) uint8 image of ``images`` (B, S, S, C) to its box
    (y0, x0, ch, cw) of ``boxes`` (B, 4) and resize it back to (S, S) by
    bilinear interpolation with half-pixel centers, sampling clamped at the
    crop's edges (PIL's crop and resize to within 1 level; the identity
    box passes the image through exactly). The JAX function's fp32
    arithmetic: p = start + (i + 0.5) * extent / S - 0.5, clipped to the
    box; floor; two gathers; a lerp per axis; then rint (half to even) and
    a clip to uint8."""
    b, size = images.shape[0], images.shape[1]
    f = images.float()
    boxes = boxes.to(f.device, torch.float32)
    i = torch.arange(size, dtype=torch.float32, device=f.device)

    def axis_interp(f, start, extent, axis):
        start, extent = start[:, None], extent[:, None]
        p = start + (i + 0.5) * extent / size - 0.5
        p = torch.minimum(torch.maximum(p, start), start + extent - 1.0)
        lo = torch.floor(p)
        w = p - lo
        lo_i = lo.long().clamp(0, size - 1)
        hi_i = (lo_i + 1).clamp(0, size - 1)
        shape = [b, 1, 1, 1]
        shape[axis] = size

        def take(idx):
            return torch.gather(f, axis, idx.reshape(shape).expand_as(f))

        w = w.reshape(shape)
        return take(lo_i) * (1.0 - w) + take(hi_i) * w

    f = axis_interp(f, boxes[:, 0], boxes[:, 2], 1)
    f = axis_interp(f, boxes[:, 1], boxes[:, 3], 2)
    # the host's augmented decode round-trips through PIL uint8
    return torch.clamp(torch.round(f), 0.0, 255.0).to(torch.uint8)


def make_source(flag, dataset, pool, batch_size: int, accum: int, seed: int,
                num_workers: Optional[int] = None, self_hist: bool = False,
                include_g_images: bool = False, device="cuda", budget: Optional[int] = None):
    """The trainers' batch source for ``dataset`` and ``pool``: a
    ``DeviceDataSource`` where ``device_dataset_mode`` places the cache on
    the device (with the dataset's ``aug_prob``, which only an explicit
    True lets through; sharded over the ranks where it says so), else the
    streaming ``TrainLoader``, whose batches are pinned for a GPU.
    ``batch_size`` is the global batch: the device source draws it from
    ``seed`` and gathers this rank's slice, the streaming loader on rank r
    loads the local batch from seed + r. ``budget``: the per-device budget
    (default ``DEVICE_DATASET_BUDGET``)."""
    from histogan_tpu_torch.data.dataset import TrainLoader

    device = torch.device(device)
    local, shard, shards = parallel.local_shard_info(batch_size)
    mode = device_dataset_mode(flag, dataset, pool, dataset.aug_prob, budget=budget)
    if mode:
        return DeviceDataSource(dataset._cache, pool.pool, batch_size, accum, seed=seed,
                                self_hist=self_hist, include_g_images=include_g_images,
                                aug_prob=dataset.aug_prob, device=device, shard=(shard, shards),
                                shard_cache=mode == "sharded")
    return TrainLoader(dataset, pool, local, accum, seed=seed + shard,
                       prefetch=max(2, num_workers or 0), self_hist=self_hist,
                       include_g_images=include_g_images, pin_memory=device.type == "cuda")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(device, non_blocking=True) for k, v in batch.items()}


class StagedBatch:
    """A streaming batch whose copy to the device was enqueued on a side
    stream; ``take`` makes the current stream wait for it."""

    def __init__(self, batch: Dict[str, torch.Tensor], stream):
        self.batch, self.stream = batch, stream

    def take(self) -> Dict[str, torch.Tensor]:
        current = torch.cuda.current_stream(self.stream.device)
        current.wait_stream(self.stream)
        for v in self.batch.values():
            v.record_stream(current)  # its memory is in use on this stream now
        return self.batch


def take_batch(loader, staged: Optional[StagedBatch], device) -> Dict[str, torch.Tensor]:
    """The step's batch on ``device``: a ``DeviceDataSource``'s gathers, a
    staged batch (``stage_next_batch``), or the loader's next batch copied
    now (the first step, and every step on the CPU)."""
    with span("data.take"):
        if isinstance(loader, DeviceDataSource):
            return next(loader)
        if staged is not None:
            return staged.take()
        return _to_device(next(loader), device)


def stage_next_batch(loader, device) -> Optional[StagedBatch]:
    """Enqueue the next streaming batch's copy to a GPU on a side stream
    (call it right after the step is dispatched, so the copy overlaps the
    step); None for a ``DeviceDataSource`` and on the CPU."""
    device = torch.device(device)
    if isinstance(loader, DeviceDataSource) or device.type != "cuda":
        return None
    with span("data.stage"):
        host = next(loader)
        stream = torch.cuda.Stream(device)  # from PyTorch's pool of streams
        with torch.cuda.stream(stream):
            return StagedBatch(_to_device(host, device), stream)


class DeviceDataSource:
    """Iterator of batches gathered on ``device``, with the TrainLoader's
    contract: {'d_images' (A, B, S, S, C) uint8, 'd_hists'/'g_hists' (A, B,
    3, h, h) fp32, optional 'g_images'}.

    ``images`` is the dataset's decoded uint8 cache (N, S, S, C), ``pool``
    the (N, 3, h, h) fp32 histogram pool; both go to the device once.
    ``self_hist`` takes each image's own histogram as its target,
    ``include_g_images`` gives the G phase images of its own (reHistoGAN),
    and ``aug_prob`` > 0 crops on the device (module docstring). With
    ``shard`` (index, count) the draws are the global ``batch_size``'s and
    the batches hold slice ``index`` of ``count`` along the batch axis.
    With ``shard_cache`` as well, this rank holds only its ``rows`` rows of
    the cache and the pool, and the rest reach it by a collective: every
    rank of the process group draws every batch.
    """

    def __init__(self, images: np.ndarray, pool: np.ndarray, batch_size: int, accum: int,
                 seed: int = 0, self_hist: bool = False, include_g_images: bool = False,
                 aug_prob: float = 0.0, device="cuda", shard: Tuple[int, int] = (0, 1),
                 shard_cache: bool = False):
        if images.dtype != np.uint8:
            raise ValueError(f"expects the decoded uint8 cache, got {images.dtype}")
        if batch_size % shard[1]:
            raise ValueError(f"global batch {batch_size} is not divisible by {shard[1]} shards")
        self.n = images.shape[0]
        self.batch_size, self.accum = batch_size, accum
        self.shard = shard
        self.local_batch = batch_size // shard[1]
        self.self_hist, self.include_g_images = self_hist, include_g_images
        self.aug_prob = float(aug_prob)
        self.device = torch.device(device)
        if self.aug_prob > 0.0:
            print("DeviceDataSource: device-side dataset augmentation "
                  f"(dataset_aug_prob={self.aug_prob:g}) crops the cached center square — "
                  "for non-square sources this narrows the crop distribution vs the "
                  "reference's host path (device_dataset='auto' keeps the faithful host "
                  "crop).", flush=True)
        self.image_size = int(images.shape[1])
        self._rng = np.random.default_rng(seed)
        self.shard_cache = bool(shard_cache) and shard[1] > 1
        self.rows, self._first = self.n, 0
        if self.shard_cache:  # rows [first, first + rows), zero-padded past the end
            self.rows = -(-self.n // shard[1])
            self._first = shard[0] * self.rows
            images, pool = (self._own_rows(x) for x in (images, pool))
        # writable copies where the cache is a read-only memory map
        self._images = torch.from_numpy(np.require(images, requirements=["C", "W"])).to(
            self.device)
        self._pool = torch.from_numpy(np.require(pool, np.float32, ["C", "W"])).to(self.device)

        # the packed uploads' layout, in the draws' order
        n_items = accum * batch_size
        self._int_layout, self._float_layout = [], []
        self._int_layout.append(("d_idx", n_items))
        if not self_hist:
            self._int_layout.append(("d_pair", 2 * n_items))
            self._float_layout.append(("d_r", n_items))
        if include_g_images:
            self._int_layout.append(("g_idx", n_items))
            if not self_hist:
                self._int_layout.append(("g_pair", 2 * n_items))
                self._float_layout.append(("g_r", n_items))
        else:
            self._int_layout.append(("g_pair", 2 * n_items))
            self._float_layout.append(("g_r", n_items))
        if self.aug_prob > 0.0:
            self._float_layout.append(("d_crop", 4 * n_items))
            if include_g_images:
                self._float_layout.append(("g_crop", 4 * n_items))

    def _own_rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's ``rows`` rows of ``x``, zero-padded past its end."""
        out = np.zeros((self.rows, *x.shape[1:]), x.dtype)
        mine = x[self._first:self._first + self.rows]
        out[:len(mine)] = mine
        return out

    def _draws(self) -> Dict[str, np.ndarray]:
        """The step's index, ratio and crop draws on the host, in the JAX
        module's rng order (the crop draws last)."""
        n_items = self.accum * self.batch_size
        rng = self._rng
        d = {"d_idx": rng.integers(0, self.n, size=n_items)}
        if not self.self_hist:
            d["d_pair"] = rng.integers(0, self.n, size=(2, n_items))
            d["d_r"] = rng.random((n_items,), dtype=np.float32)
        if self.include_g_images:
            d["g_idx"] = rng.integers(0, self.n, size=n_items)
            if not self.self_hist:
                d["g_pair"] = rng.integers(0, self.n, size=(2, n_items))
                d["g_r"] = rng.random((n_items,), dtype=np.float32)
        else:
            d["g_pair"] = rng.integers(0, self.n, size=(2, n_items))
            d["g_r"] = rng.random((n_items,), dtype=np.float32)
        if self.aug_prob > 0.0:
            d["d_crop"] = sample_crop_boxes(rng, n_items, self.image_size, self.aug_prob)
            if self.include_g_images:
                d["g_crop"] = sample_crop_boxes(rng, n_items, self.image_size, self.aug_prob)
        return d

    def _unpack(self, ints: torch.Tensor, floats: torch.Tensor) -> Dict[str, torch.Tensor]:
        n_items = self.accum * self.batch_size
        d, off = {}, 0
        for k, size in self._int_layout:
            v = ints[off:off + size].long()  # gathers index in int64
            d[k] = v.reshape(2, n_items) if k.endswith("pair") else v
            off += size
        off = 0
        for k, size in self._float_layout:
            v = floats[off:off + size]
            d[k] = v.reshape(n_items, 4) if k.endswith("crop") else v
            off += size
        return d

    def _local(self, draws: Dict[str, torch.Tensor], index: int) -> Dict[str, torch.Tensor]:
        """Each draw's items of shard ``index``'s slice of every micro-batch."""
        if self.shard[1] == 1:
            return draws
        lo, hi, a, b = index * self.local_batch, (index + 1) * self.local_batch, \
            self.accum, self.batch_size
        out = {}
        for k, v in draws.items():
            if k.endswith("pair"):  # (2, items)
                out[k] = v.reshape(2, a, b)[:, :, lo:hi].reshape(2, -1)
            else:  # (items, ...)
                out[k] = v.reshape(a, b, *v.shape[1:])[:, lo:hi].reshape(-1, *v.shape[1:])
        return out

    def _lookups(self) -> List[Tuple[str, str, Optional[int]]]:
        """(table, draw, row of a pair draw) of each gather of a batch, in
        the order ``_assemble`` takes them."""
        def hists(part):
            return ([("pool", f"{part}_idx", None)] if self.self_hist
                    else [("pool", f"{part}_pair", 0), ("pool", f"{part}_pair", 1)])

        out = [("images", "d_idx", None), *hists("d")]
        if self.include_g_images:
            return out + [("images", "g_idx", None), *hists("g")]
        # the images-less G phase interpolates even in self_hist mode
        # (TrainLoader._make_batch's branches)
        return out + [("pool", "g_pair", 0), ("pool", "g_pair", 1)]

    def _table(self, name: str) -> torch.Tensor:
        return self._images if name == "images" else self._pool

    @staticmethod
    def _index(draws, key: str, row: Optional[int]) -> torch.Tensor:
        return draws[key] if row is None else draws[key][row]

    def _exchange(self, draws: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The rows of each lookup for this rank's slice of the batch, from
        the sharded tables: per destination rank, the rows this rank owns
        of that rank's items and zeros for the others, as bytes, in one
        reduce-scatter (sum). One rank owns each row, so the sum is exact."""
        lookups, count = self._lookups(), self.shard[1]
        per_rank, shapes = [], []
        for q in range(count):
            part, chunks = self._local(draws, q), []
            for table, key, row in lookups:
                idx = self._index(part, key, row) - self._first
                own = (idx >= 0) & (idx < self.rows)
                t = self._table(table)
                rows = t.index_select(0, idx.clamp(0, self.rows - 1))
                rows = torch.where(own.view(-1, *[1] * (t.dim() - 1)), rows, rows.new_zeros(()))
                chunks.append(rows.reshape(-1).view(torch.uint8))
                if q == 0:
                    shapes.append((rows.shape, rows.dtype))
            per_rank.append(torch.cat(chunks))
        mine = parallel.reduce_scatter(torch.cat(per_rank))
        sizes = [math.prod(shape) * torch.empty((), dtype=dtype).element_size()
                 for shape, dtype in shapes]
        return [b.view(dtype).view(shape)
                for b, (shape, dtype) in zip(mine.split(sizes), shapes)]

    def _assemble(self, draws: Dict[str, torch.Tensor], rows) -> Dict[str, torch.Tensor]:
        """The batch from the local draws and the lookups' rows, in order."""
        rows = iter(rows)
        a, b = self.accum, self.local_batch

        def images(crop):
            x = next(rows)
            if crop is not None:
                x = crop_resize_u8(x, crop)
            return x.reshape(a, b, *x.shape[1:])

        def hists(part):
            if self.self_hist and part == "d" or self.self_hist and self.include_g_images:
                h = next(rows)
            else:
                r = draws[f"{part}_r"][:, None, None, None]
                h = r * next(rows) + (1.0 - r) * next(rows)
            return h.reshape(a, b, *h.shape[1:])

        batch = {"d_images": images(draws.get("d_crop")), "d_hists": hists("d")}
        if self.include_g_images:
            batch["g_images"] = images(draws.get("g_crop"))
        batch["g_hists"] = hists("g")
        return batch

    def __next__(self) -> Dict[str, torch.Tensor]:
        d = self._draws()
        ints = np.concatenate([np.ravel(d[k]) for k, _ in self._int_layout]).astype(np.int32)
        floats = (np.concatenate([np.ravel(d[k]) for k, _ in self._float_layout])
                  .astype(np.float32) if self._float_layout else np.zeros((0,), np.float32))
        # two small copies from pageable memory: CUDA stages them at
        # once, so the arrays may go; the host does not wait for the device
        draws = self._unpack(torch.from_numpy(ints).to(self.device, non_blocking=True),
                             torch.from_numpy(floats).to(self.device, non_blocking=True))
        local = self._local(draws, self.shard[0])
        if self.shard_cache:
            rows = self._exchange(draws)
        else:
            rows = [self._table(t).index_select(0, self._index(local, k, r))
                    for t, k, r in self._lookups()]
        return self._assemble(local, rows)

    def __iter__(self):
        return self

    def close(self) -> None:  # the TrainLoader's API
        pass
