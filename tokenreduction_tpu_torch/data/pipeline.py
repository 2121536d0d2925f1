"""Transform composition + a threaded prefetching loader feeding numpy
batches to the device (replaces torch DataLoader workers,
reference train.py:273-311).

The port's copy of ``tokenreduction_tpu/data/pipeline.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue
import threading
from typing import Callable, Iterable

import numpy as np
from PIL import Image

from tokenreduction_tpu_torch.data import transforms as T

# fork-inherited worker state for the process pool (set right before the
# pool is created; workers read it after fork, so closures/datasets never
# need to pickle)
_FORK_STATE = None


def _fork_make_batch(task):
    loader = _FORK_STATE
    seed, epoch, idxs, positions = task
    return loader._make_batch(np.asarray(idxs), positions,
                              seed=seed, epoch=epoch)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    input_size: int = 224
    color_jitter: float = 0.3
    aa: str = "rand-m9-mstd0.5-inc1"
    train_interpolation: str = "bicubic"
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    crop_pct: float = 0.875
    three_augment: bool = False  # DeiT-III: replaces RandAugment
    src_crop: bool = False  # simple random crop (reference --src)


def make_transform(dataset_name: str, is_train: bool,
                   cfg: TransformConfig) -> Callable:
    """(PIL, np.random.Generator) -> normalized float32 HWC.

    Composition parity (reference datasets.py):
    - imagenet train: RRC + hflip + RandAugment (color jitter only when AA
      is disabled, matching timm transforms_imagenet_train) + RandomErasing
    - nabirds train: same minus auto-augment (datasets.py:84-96)
    - coco/nuswide train: fixed square resize + CutoutPIL + RandAugment
      (ASL recipe, datasets.py:40-71); eval = plain square resize
    - multiclass eval: resize shorter side + center crop (crop_pct)
    """
    name = dataset_name.lower()
    asl_style = name in ("coco", "nuswide", "synthetic_multilabel")
    use_aa = cfg.aa if name not in ("nabirds",) else ""
    # full --aa grammar (rand-*/augmix-*/AutoAugment policies); unknown
    # strings raise here, at loader construction, not mid-epoch
    aa_fn = T.make_aa_transform(use_aa, cfg.input_size)

    def train_fn(img, rng):
        if asl_style:
            img = T.resize_square(img, cfg.input_size,
                                  cfg.train_interpolation)
            img = T.cutout_pil(img, rng, 0.5)
            if aa_fn is not None:
                img = aa_fn(img, rng)
            arr = T.normalize(T.to_float_array(img))
            return arr
        if cfg.src_crop:
            img = T.resize_square(img, int(cfg.input_size * 1.14),
                                  cfg.train_interpolation)
            W, H = img.size
            left = int(rng.integers(0, W - cfg.input_size + 1))
            top = int(rng.integers(0, H - cfg.input_size + 1))
            img = img.crop((left, top, left + cfg.input_size,
                            top + cfg.input_size))
        else:
            img = T.random_resized_crop(
                img, rng, cfg.input_size,
                interpolation=cfg.train_interpolation)
        img = T.maybe_hflip(img, rng)
        if cfg.three_augment:
            img = T.three_augment(img, rng)
            if cfg.color_jitter:
                img = T.color_jitter(img, rng, cfg.color_jitter)
        elif aa_fn is not None:
            img = aa_fn(img, rng)
        elif cfg.color_jitter:
            img = T.color_jitter(img, rng, cfg.color_jitter)
        arr = T.normalize(T.to_float_array(img))
        arr = T.random_erasing(arr, rng, cfg.reprob, cfg.remode, cfg.recount)
        return arr

    def eval_fn(img, rng):
        if asl_style:
            img = T.resize_square(img, cfg.input_size,
                                  cfg.train_interpolation)
        else:
            img = T.resize_center_crop(img, cfg.input_size, cfg.crop_pct,
                                       cfg.train_interpolation)
        return T.normalize(T.to_float_array(img))

    return train_fn if is_train else eval_fn


def make_raw_transform(size: int | None = None):
    """uint8 passthrough for device-side augmentation (data/device_aug.py):
    the loader only collates (optionally square-resizing) cached uint8
    images; crop/RandAugment/normalize/erasing run on-chip. Accepts
    ndarray input directly (Loader uses dataset.load_array when present,
    skipping the PIL round-trip)."""

    def fn(img, rng):
        if isinstance(img, np.ndarray):
            if size is None or img.shape[:2] == (size, size):
                return img
            img = Image.fromarray(img, "RGB")
        if size is not None and img.size != (size, size):
            img = T.resize_square(img, size)
        return np.asarray(img, np.uint8)

    fn.accepts_array = True
    fn.raw_size = size  # Loader whole-batch fast-path size gate
    return fn


class Loader:
    """Index sampler -> decoded/transformed/batched numpy.

    num_workers=0 (default): a background thread keeps `prefetch` batches
    ready -- PIL decode/resize release the GIL, so one thread overlaps
    host preprocessing with device compute on a 1-core host.

    num_workers>0: a fork-context process pool builds batches in parallel
    (the torch DataLoader equivalent, reference train.py:294-311).
    Batches are bitwise-identical to the in-process path because every
    sample's augmentation RNG is seeded by (seed, epoch, position, index)
    -- never by worker identity (tests/test_pipeline_e2e.py). Decode
    throughput scales with cores; this 1-core dev box stays at ~50 img/s
    at 224px either way, see data/cache.py for the pre-decoded path."""

    def __init__(self, dataset, sampler: Iterable[int], batch_size: int,
                 transform: Callable, drop_last: bool = False,
                 seed: int = 0, prefetch: int = 2,
                 pad_partial: bool = False, num_workers: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.transform = transform
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.pad_partial = pad_partial
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idxs, positions, seed=None, epoch=None):
        seed = self.seed if seed is None else seed
        epoch = self.epoch if epoch is None else epoch
        if self._batch_fast_path():
            return self._make_batch_fast(idxs)
        load = self.dataset.load
        if (getattr(self.transform, "accepts_array", False)
                and hasattr(self.dataset, "load_array")):
            load = self.dataset.load_array
        images, labels = [], []
        for idx, pos in zip(idxs, positions):
            rng = np.random.default_rng(
                (seed, epoch, pos, idx))
            img, label = load(idx)
            images.append(self.transform(img, rng))
            labels.append(label)
        pad_to = self.batch_size if self.pad_partial else len(images)
        valid = len(images)
        while len(images) < pad_to:
            images.append(images[-1])
            labels.append(labels[-1])
        image = np.stack(images)
        if image.dtype != np.uint8:  # uint8 = device-side augmentation path
            image = image.astype(np.float32)
        label0 = labels[0]
        if np.isscalar(label0) or isinstance(label0, (int, np.integer)):
            label = np.asarray(labels, dtype=np.int32)
        else:
            label = np.stack(labels).astype(np.float32)
        return {"image": image, "label": label,
                "index": np.asarray(idxs.tolist() + [-1] * (pad_to - valid),
                                    dtype=np.int32)
                if pad_to != valid else np.asarray(idxs, dtype=np.int32),
                "valid": valid}

    def _batch_fast_path(self) -> bool:
        """Raw uint8 collate of an already-square cache needs no per-image
        transform or RNG: the whole batch is ONE fancy-index off the mmap
        (dataset.load_batch). Gated on the raw transform being a size-
        matched passthrough so the bytes are identical to the slow loop."""
        tf = self.transform
        if not (getattr(tf, "accepts_array", False)
                and hasattr(self.dataset, "load_batch")):
            return False
        raw_size = getattr(tf, "raw_size", 0)  # 0 = not a raw transform
        return raw_size is None or raw_size == getattr(
            self.dataset, "size", None)

    def _make_batch_fast(self, idxs):
        image, label = self.dataset.load_batch(idxs)
        valid = len(image)
        pad_to = self.batch_size if self.pad_partial else valid
        if pad_to != valid:
            image = np.concatenate(
                [image, np.repeat(image[-1:], pad_to - valid, axis=0)])
            label = np.concatenate(
                [label, np.repeat(label[-1:], pad_to - valid, axis=0)])
        label = label.astype(
            np.int32 if np.issubdtype(label.dtype, np.integer)
            else np.float32, copy=False)
        index = np.asarray(list(idxs) + [-1] * (pad_to - valid),
                           dtype=np.int32)
        return {"image": image, "label": label, "index": index,
                "valid": valid}

    def __iter__(self):
        if self.num_workers > 0:
            yield from self._iter_procs()
            return
        yield from self._iter_thread()

    def _iter_procs(self):
        global _FORK_STATE
        idxs = np.asarray(list(iter(self.sampler)), dtype=np.int64)
        nb = len(self)
        tasks = []
        for b in range(nb):
            lo = b * self.batch_size
            hi = min(lo + self.batch_size, len(idxs))
            tasks.append((self.seed, self.epoch, idxs[lo:hi].tolist(),
                          tuple(range(lo, hi))))
        _FORK_STATE = self
        ctx = mp.get_context("fork")
        pool = ctx.Pool(self.num_workers)
        try:
            # imap preserves task order -> identical batch stream
            for batch in pool.imap(_fork_make_batch, tasks, chunksize=1):
                yield batch
        finally:
            pool.terminate()
            pool.join()
            _FORK_STATE = None

    def _iter_thread(self):
        idxs = np.asarray(list(iter(self.sampler)), dtype=np.int64)
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    lo = b * self.batch_size
                    hi = min(lo + self.batch_size, len(idxs))
                    q.put(self._make_batch(
                        idxs[lo:hi], range(lo, hi)))
                q.put(None)
            except BaseException as e:  # surface worker errors
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
