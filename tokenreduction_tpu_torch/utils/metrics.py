"""Host-side metrics: mAP (reference utils.py:242-278) and running meters
(reference utils.py:18-159, minus the NCCL sync -- device metric reduction
happens inside the jitted steps via sharding/psum instead).

The port's copy of ``tokenreduction_tpu/utils/metrics.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np


def average_precision(output: np.ndarray, target: np.ndarray) -> float:
    """AP for one class (reference utils.py:242-259)."""
    epsilon = 1e-8
    indices = output.argsort()[::-1]
    total_count_ = np.cumsum(np.ones((len(output), 1)))
    target_ = target[indices]
    ind = target_ == 1
    pos_count_ = np.cumsum(ind)
    total = pos_count_[-1]
    pos_count_[np.logical_not(ind)] = 0
    pp = pos_count_ / total_count_
    precision_at_i_ = np.sum(pp)
    precision_at_i = precision_at_i_ / (total + epsilon)
    return precision_at_i


def mAP(targs: np.ndarray, preds: np.ndarray) -> float:
    """Mean average precision over classes, in percent
    (reference utils.py:262-278)."""
    if np.size(preds) == 0:
        return 0.0
    ap = np.zeros((preds.shape[1]))
    for k in range(preds.shape[1]):
        scores = preds[:, k]
        targets = targs[:, k]
        ap[k] = average_precision(scores, targets)
    return 100.0 * ap.mean()


class SmoothedValue:
    """Windowed + global average meter (reference utils.py:18-77)."""

    def __init__(self, window_size=20, fmt="{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value, count=self.count,
        )


class MetricLogger:
    """stdout progress logging (reference utils.py:80-159)."""

    def __init__(self, delimiter="  "):
        self.meters = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable, print_freq, header=""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                msg = f"{header} [{i}" + (f"/{n}]" if n else "]")
                print(f"{msg}  {self}  time: {iter_time}")
            i += 1
            end = time.time()
        total = time.time() - start
        print(f"{header} Total time: {total:.1f}s "
              f"({total / max(i, 1):.4f} s/it)")


class JSONLLogger:
    """log.txt JSON-lines sink (reference train.py:711-713), plus an
    optional wandb passthrough when wandb is importable and enabled."""

    def __init__(self, path=None, use_wandb=False, wandb_kwargs=None):
        self.path = path
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self.wandb = wandb
            except Exception as e:  # wandb optional, never load-bearing
                print(f"wandb disabled: {e}")

    def log(self, stats: dict, step=None):
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(stats) + "\n")
        if self.wandb is not None:
            self.wandb.log(stats, step=step)
