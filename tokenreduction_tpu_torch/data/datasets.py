"""Datasets: ImageNet (folder layout), NABirds, COCO-2014 multi-label,
NUS-WIDE, plus a synthetic dataset for tests/benchmarks.

Replaces reference datasets.py:19-38 + dataloaders/*; torchvision- and
pycocotools-free (plain json/pandas/PIL).

Each dataset exposes:
  __len__, load(idx) -> (PIL.Image, label), image_name(idx), num_classes,
  multilabel (bool)

The port's copy of ``tokenreduction_tpu/data/datasets.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np
from PIL import Image

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG")


class ImageFolderDataset:
    """ImageNet-style root/<split>/<class>/<img>; classes sorted by name
    (torchvision ImageFolder convention, used via torchvision.ImageNet in
    reference datasets.py:23)."""

    multilabel = False

    def __init__(self, root: str, split: str):
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            # torchvision ImageNet uses 'val'; accept both
            alt = {"val": "validation", "validation": "val"}.get(split)
            if alt and os.path.isdir(os.path.join(root, alt)):
                base = os.path.join(root, alt)
            else:
                raise FileNotFoundError(base)
        classes = sorted(
            d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(base, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.endswith(IMG_EXTS):
                    self.samples.append(
                        (os.path.join(cdir, fn), self.class_to_idx[c]))
        self.num_classes = len(classes)

    def __len__(self):
        return len(self.samples)

    def load(self, idx):
        path, label = self.samples[idx]
        return Image.open(path).convert("RGB"), label

    def image_name(self, idx):
        return os.path.basename(self.samples[idx][0])


class NABirdsDataset:
    """NABirds txt-file joins (reference dataloaders/nabirds.py:48-66)."""

    multilabel = False

    def __init__(self, root: str, train: bool):
        import pandas as pd

        image_paths = pd.read_csv(
            os.path.join(root, "images.txt"), sep=" ",
            names=["img_id", "filepath"])
        labels = pd.read_csv(
            os.path.join(root, "image_class_labels.txt"), sep=" ",
            names=["img_id", "target"])
        split = pd.read_csv(
            os.path.join(root, "train_test_split.txt"), sep=" ",
            names=["img_id", "is_training_img"])
        # continuous remap (reference nabirds.py:84-86)
        label_set = sorted(set(labels["target"]))
        self.label_map = {k: i for i, k in enumerate(label_set)}
        data = image_paths.merge(labels, on="img_id")
        data = data.merge(split, on="img_id")
        want = 1 if train else 0
        self.data = data[data.is_training_img == want].reset_index(drop=True)
        self.root = root
        self.num_classes = len(self.label_map)

    def __len__(self):
        return len(self.data)

    def load(self, idx):
        row = self.data.iloc[idx]
        path = os.path.join(self.root, "images", row.filepath)
        return Image.open(path).convert("RGB"), self.label_map[row.target]

    def image_name(self, idx):
        return self.data.iloc[idx].img_id


class CocoMultiLabelDataset:
    """COCO-2014 multi-label with (3, 80) size-binned multi-hot targets
    (areas < 32^2 / < 96^2 / rest -- reference dataloaders/coco.py:32-40),
    collapsed by max() at loss/eval time. Plain-json COCO parsing:
    image ids appear in first-annotation order like pycocotools imgToAnns.
    """

    multilabel = True

    def __init__(self, root: str, train: bool):
        split = "train2014" if train else "val2014"
        self.data_path = os.path.join(root, split)
        ann_file = os.path.join(
            root, "annotations", f"instances_{split}.json")
        with open(ann_file) as f:
            ann = json.load(f)
        self.cat2cat = {}
        for cat in ann["categories"]:
            self.cat2cat[cat["id"]] = len(self.cat2cat)
        img_to_anns = {}
        for a in ann["annotations"]:
            img_to_anns.setdefault(a["image_id"], []).append(a)
        self.ids = list(img_to_anns.keys())
        self.img_to_anns = img_to_anns
        self.file_names = {im["id"]: im["file_name"] for im in ann["images"]}
        self.num_classes = 80

    def __len__(self):
        return len(self.ids)

    def load(self, idx):
        img_id = self.ids[idx]
        target = np.zeros((3, 80), dtype=np.float32)
        for obj in self.img_to_anns[img_id]:
            c = self.cat2cat[obj["category_id"]]
            if obj["area"] < 32 * 32:
                target[0, c] = 1
            elif obj["area"] < 96 * 96:
                target[1, c] = 1
            else:
                target[2, c] = 1
        path = os.path.join(self.data_path, self.file_names[img_id])
        return Image.open(path).convert("RGB"), target

    def image_name(self, idx):
        return self.ids[idx]


class NUSWideDataset:
    """CSV-driven multi-hot (reference dataloaders/nus_wide.py:24-50)."""

    multilabel = True

    def __init__(self, root: str, train: bool):
        import pandas as pd

        df = pd.read_csv(os.path.join(root, "nus_wid_data.csv"))
        split = "train" if train else "val"

        def str_to_list(text):
            return [i.strip("[]'\"\n ") for i in text.split(",")]

        all_labels = sorted({
            lab for item in df["label"] for lab in str_to_list(item)
        })
        label_map = {n: i for i, n in enumerate(all_labels)}
        self.num_classes = len(all_labels)
        self.itemlist = []
        for _, row in df.iterrows():
            if row.iloc[2] != split:
                continue
            vec = np.zeros(self.num_classes, dtype=np.float32)
            for lab in str_to_list(row.iloc[1]):
                vec[label_map[lab]] = 1.0
            self.itemlist.append((os.path.join(root, row.iloc[0]), vec))

    def __len__(self):
        return len(self.itemlist)

    def load(self, idx):
        path, vec = self.itemlist[idx]
        return Image.open(path).convert("RGB"), vec

    def image_name(self, idx):
        return os.path.splitext(os.path.basename(self.itemlist[idx][0]))[0]


class SyntheticDataset:
    """Deterministic random images; CPU-runnable stand-in for tests and the
    BASELINE config-1 val-subset path when no real data is mounted."""

    def __init__(self, n: int = 64, num_classes: int = 1000,
                 img_size: int = 224, multilabel: bool = False, seed: int = 0):
        self.n = n
        self.num_classes = num_classes
        self.img_size = img_size
        self.multilabel = multilabel
        self.seed = seed

    def __len__(self):
        return self.n

    def load(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        arr = rng.integers(0, 256, (self.img_size, self.img_size, 3),
                           dtype=np.uint8)
        img = Image.fromarray(arr, "RGB")
        if self.multilabel:
            label = (rng.random(self.num_classes) < 0.05).astype(np.float32)
        else:
            label = int(rng.integers(0, self.num_classes))
        return img, label

    def image_name(self, idx):
        return f"synthetic_{idx:08d}.JPEG"


def build_dataset(root: str, name: str, split: str, *,
                  num_classes: int = 1000, img_size: int = 224,
                  synthetic_n: int = 64):
    """(dataset, num_classes) dispatch (reference datasets.py:19-38)."""
    name = name.lower()
    train = split.lower() == "train"
    if name == "imagenet":
        ds = ImageFolderDataset(root, "train" if train else "val")
        return ds, 1000
    if name == "nabirds":
        ds = NABirdsDataset(root, train)
        return ds, ds.num_classes
    if name == "coco":
        ds = CocoMultiLabelDataset(root, train)
        return ds, 80
    if name == "nuswide":
        ds = NUSWideDataset(root, train)
        return ds, ds.num_classes
    if name == "cached":
        from tokenreduction_tpu_torch.data.cache import DecodedCacheDataset

        sub = os.path.join(root, split)
        ds = DecodedCacheDataset(sub if os.path.isdir(sub) else root)
        return ds, ds.num_classes
    if name == "synthetic":
        ds = SyntheticDataset(n=synthetic_n, num_classes=num_classes,
                              img_size=img_size)
        return ds, num_classes
    if name == "synthetic_multilabel":
        ds = SyntheticDataset(n=synthetic_n, num_classes=num_classes,
                              img_size=img_size, multilabel=True)
        return ds, num_classes
    raise ValueError(f"unknown dataset {name}")
