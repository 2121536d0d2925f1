"""Host-sharded index sampling.

TPU-native replacement for torch DistributedSampler / RASampler
(reference samplers.py:7-63): pure-numpy epoch-seeded index streams; in
multi-host training each host takes its rank's stride so the global batch
is sharded across hosts before device placement.

The port's copy of ``tokenreduction_tpu/data/sampler.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import math

import numpy as np


class ShardedSampler:
    """DistributedSampler equivalent: per-epoch seeded shuffle, padded to a
    multiple of world size, strided by rank."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(n / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(self.n)
        else:
            indices = np.arange(self.n)
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        return iter(indices[self.rank:self.total_size:self.num_replicas]
                    .tolist())


class RASampler(ShardedSampler):
    """Repeated augmentation: each sample appears `num_repeats` times per
    epoch, distributed so different replicas see different augmentations of
    the same image; epoch length truncated to
    floor(n // 256 * 256 / world) (reference samplers.py:31-57)."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, num_repeats: int = 3, seed: int = 0):
        super().__init__(n, num_replicas, rank, shuffle, seed)
        if num_repeats < 1:
            raise ValueError("num_repeats should be greater than 0")
        self.num_repeats = num_repeats
        self.num_samples = int(
            math.ceil(n * num_repeats / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.num_selected_samples = int(
            math.floor(n // 256 * 256 / num_replicas))

    def __len__(self):
        return self.num_selected_samples

    def __iter__(self):
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(self.n)
        else:
            indices = np.arange(self.n)
        indices = np.repeat(indices, self.num_repeats)
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        assert len(indices) == self.total_size
        sel = indices[self.rank:self.total_size:self.num_replicas]
        return iter(sel[: self.num_selected_samples].tolist())


class DistributedEvalSampler(ShardedSampler):
    """Sequential eval shard (reference train.py:284-290 dist_eval path:
    padding may duplicate a few tail samples)."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0):
        super().__init__(n, num_replicas, rank, shuffle=False)
