"""The input pipeline's rates: the counterpart of ``tools/bench_input.py``.

``--host``: the decoded cache's build rate and the host Loader's rates
(one worker thread) through the port's ``data/``: the host PIL
augmentation (RandomResizedCrop, RandAugment, erasing) against the raw
uint8 collate that feeds the augmentation on the card.

``--device``: ``data/device_aug.py``'s augmentation of a B = 256 batch
of 256-px uint8 squares to 224 px on the card, ms a batch by CUDA events around
batches issued back to back (PyTorch ops, no kernel of the port).

    python -m tokenreduction_tpu_torch.tools.bench_input --host --device

``--device`` runs on the card unless ``--device-name cpu`` is given.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.tools import _measure as M


def bench_host(n: int = 512, cache_size: int = 256, input_size: int = 224,
               batch: int = 64):
    """Print the cache build's and the Loader's img/s on the host."""
    from tokenreduction_tpu_torch.data.cache import (
        DecodedCacheDataset,
        build_decoded_cache,
    )
    from tokenreduction_tpu_torch.data.datasets import build_dataset
    from tokenreduction_tpu_torch.data.pipeline import (
        Loader,
        TransformConfig,
        make_raw_transform,
        make_transform,
    )
    from tokenreduction_tpu_torch.data.sampler import ShardedSampler

    ds, _ = build_dataset("", "synthetic", "train", num_classes=10,
                          img_size=cache_size, synthetic_n=n)
    tmp = tempfile.mkdtemp(prefix="cachebench")
    try:
        t0 = time.perf_counter()
        build_decoded_cache(ds, tmp, cache_size=cache_size)
        print(f"cache build: {n / (time.perf_counter() - t0):.0f} img/s "
              "(host clock)", flush=True)
        cds = DecodedCacheDataset(tmp)
        tcfg = TransformConfig(input_size=input_size)
        for name, tf in (
                ("host PIL aug (RRC+RA+erase)",
                 make_transform("imagenet", True, tcfg)),
                ("raw uint8 collate (device-aug feed)",
                 make_raw_transform(cache_size))):
            loader = Loader(cds, ShardedSampler(len(cds), 1, 0), batch, tf,
                            drop_last=True)
            it = iter(loader)
            next(it)  # warm
            t0 = time.perf_counter()
            cnt = 0
            for b in it:
                cnt += b["image"].shape[0]
            dt = time.perf_counter() - t0
            print(f"{name}: {cnt / dt:.0f} img/s (batch {batch}, {cnt} "
                  "images, host clock)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_device(device, batch: int = 256, size: int = 224, src: int = 256,
                 iters: int = 10):
    """Print the augmentation's ms a batch on ``device``."""
    from tokenreduction_tpu_torch.data.device_aug import (
        DeviceAugConfig,
        make_device_augment,
    )

    aug = make_device_augment(DeviceAugConfig(input_size=size))
    gen = torch.Generator(device=device).manual_seed(0)
    u8 = torch.randint(0, 256, (batch, src, src, 3), generator=gen,
                       device=device, dtype=torch.uint8)
    ms = M.timeit(lambda: aug(u8, gen), device, iters, reps=3)
    print(f"device aug: {ms:.2f} ms a b{batch} batch ({M.clock(device)}; "
          f"{batch / ms * 1e3:.0f} img/s if aug-bound)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="The input pipeline's rates: "
                                 "the host Loader and the augmentation on "
                                 "the card.")
    ap.add_argument("--host", action="store_true",
                    help="the decoded cache and the host Loader")
    ap.add_argument("--device", action="store_true",
                    help="the augmentation on the card")
    ap.add_argument("--device-name", default=None,
                    help="torch device of --device; the card unless 'cpu' "
                         "is given")
    ap.add_argument("--n", type=int, default=512,
                    help="synthetic images of --host")
    ap.add_argument("--host-batch", type=int, default=64,
                    help="images a Loader batch of --host")
    ap.add_argument("--batch", type=int, default=256,
                    help="images a batch of --device")
    ap.add_argument("--iters", type=int, default=10,
                    help="batches a timed run of --device")
    ap.add_argument("--src", type=int, default=256,
                    help="the uint8 squares' size of --device")
    ap.add_argument("--input-size", type=int, default=224,
                    help="the augmented images' size of --device")
    args = ap.parse_args(argv)
    if args.host:
        bench_host(n=args.n, batch=args.host_batch)
    if args.device:
        bench_device(resolve_device(args.device_name), batch=args.batch,
                     size=args.input_size, src=args.src, iters=args.iters)


if __name__ == "__main__":
    main()
