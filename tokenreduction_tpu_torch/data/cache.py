"""Pre-decoded image cache: decode + resize once, train many times.

JPEG decode at 224px costs ~20 ms/image/core; on low-core hosts that
starves the chip (the reference sidesteps this with 10 DataLoader
processes, train.py:294-311). `build_decoded_cache` writes one uint8
memory-mapped array of shorter-side-resized images plus labels; a
`DecodedCacheDataset` then serves PIL views straight off the mmap, so
epoch-time host work is only the (cheap) augmentation pipeline.

Cache layout in `out_dir`:
  images.npy   uint8 [n, S, S, 3] (S = cache_size, square-resized)
  labels.npy   int32 [n] or float32 [n, ...] (multilabel)
  names.json   per-index image names (viz JSON keys)
  meta.json    {n, size, multilabel}

The port's copy of ``tokenreduction_tpu/data/cache.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


def build_decoded_cache(dataset, out_dir: str, cache_size: int = 256,
                        log_every: int = 0):
    """Decode every sample of `dataset` into out_dir. Resizes to a
    cache_size x cache_size square (bicubic) -- downstream RandomResizedCrop
    / center-crop operate on the cached square."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    images = np.lib.format.open_memmap(
        os.path.join(out_dir, "images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, cache_size, cache_size, 3))
    labels = None
    names = []
    for i in range(n):
        img, label = dataset.load(i)
        img = img.resize((cache_size, cache_size), Image.BICUBIC)
        images[i] = np.asarray(img, np.uint8)
        if labels is None:
            if np.isscalar(label) or isinstance(label, (int, np.integer)):
                labels = np.zeros((n,), np.int32)
            else:
                labels = np.zeros((n,) + np.shape(label), np.float32)
        labels[i] = label
        names.append(str(dataset.image_name(i)))
        if log_every and (i + 1) % log_every == 0:
            print(f"cached {i + 1}/{n}")
    images.flush()
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump(names, f)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": n, "size": cache_size,
                   "multilabel": bool(getattr(dataset, "multilabel",
                                              False)),
                   "num_classes": int(getattr(dataset, "num_classes", 0))},
                  f)
    return out_dir


class DecodedCacheDataset:
    """Serves PIL images from a build_decoded_cache directory. Same
    protocol as the other datasets (load/image_name/num_classes)."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            meta = json.load(f)
        self.images = np.load(os.path.join(cache_dir, "images.npy"),
                              mmap_mode="r")
        self.labels = np.load(os.path.join(cache_dir, "labels.npy"))
        with open(os.path.join(cache_dir, "names.json")) as f:
            self.names = json.load(f)
        self.multilabel = meta["multilabel"]
        self.num_classes = meta["num_classes"]
        self.size = meta["size"]

    def __len__(self):
        return len(self.images)

    def load(self, idx):
        img = Image.fromarray(np.asarray(self.images[idx]), "RGB")
        label = self.labels[idx]
        if self.labels.dtype == np.int32:
            label = int(label)
        return img, label

    def load_array(self, idx):
        """uint8 HWC + label without the PIL round-trip (raw-transform
        fast path for device-side augmentation)."""
        label = self.labels[idx]
        if self.labels.dtype == np.int32:
            label = int(label)
        return np.asarray(self.images[idx]), label

    def load_batch(self, idxs):
        """Whole-batch uint8 [K,S,S,3] + labels [K,...] in one C-level
        fancy-index off the mmap -- bitwise-identical bytes to stacking
        per-index `load_array` results, without the per-image Python
        loop (the raw-collate host feed is the real-data eval bottleneck:
        the chip evaluates ~4x faster than the per-image loop collates)."""
        idxs = np.asarray(idxs)
        return (np.asarray(self.images[idxs]),
                np.asarray(self.labels[idxs]))

    def image_name(self, idx):
        return self.names[idx]
