"""Static heuristic pruning patterns (reference models/heuristic.py:157-222).

A JAX-free copy of ``tokenreduction_tpu/ops/heuristic.py``, which is pure
numpy but is reached only through the JAX package's ``__init__``, which
loads Flax. The two copies must stay identical below this docstring
(``tests/test_torch_package.py`` checks it), the odd-P grid quirk
included.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _distance_grid(num_patches: int, pattern: str) -> Tuple[np.ndarray, int]:
    P = int(num_patches ** 0.5)
    # torch.linspace(-P//2, P//2, P) with meshgrid(indexing="ij").
    # NB python parses -P//2 as (-P)//2: for odd P the grid is
    # ASYMMETRIC (e.g. P=15 -> linspace(-8, 7, 15)); replicate exactly
    xs = np.linspace((-P) // 2, P // 2, P)
    x, y = np.meshgrid(xs, xs, indexing="ij")
    p = pattern.lower()
    if p == "l1":
        z = np.abs(x) + np.abs(y)
    elif p == "l2":
        z = np.sqrt(x * x + y * y)
    elif p == "linf":
        z = np.maximum(np.abs(x), np.abs(y))
    else:
        raise ValueError(f"unknown heuristic pattern {pattern}")
    return z, P


def contiguous_thresholds(
    num_patches: int,
    pattern: str,
    min_radius: float,
    start_stage: int,
    end_stage: int,
    depth: int,
):
    """Radius thresholds shrinking linearly across [start, end] stages
    (reference heuristic.py:157-179). Returns (z [P,P], thresholds [depth],
    reduction_loc list)."""
    z, P = _distance_grid(num_patches, pattern)
    if min_radius is None or min_radius <= 0:
        min_radius = float(z[P // 2, P // 2])
    steps = end_stage - start_stage + 3
    thr = np.linspace(z[0, 0], min_radius, steps)
    thr = np.concatenate(
        [np.full(max(start_stage - 1, 0), z[0, 0]), thr]
    )
    thr = np.concatenate(
        [thr, np.full(max(depth - end_stage - 1, 0), thr[-1])]
    )
    loc = list(range(start_stage, end_stage + 1))
    return z, thr, loc


def subset_thresholds(
    num_patches: int,
    pattern: str,
    num_tokens: Sequence[int],
    reduction_loc: Sequence[int],
    depth: int,
):
    """not_contiguous mode: per-stage thresholds fitted to target token
    counts (reference heuristic.py:182-222). Returns (z, thresholds [depth])."""
    z, _ = _distance_grid(num_patches, pattern)
    unique = np.unique(z)
    within = [int(np.sum(z <= u)) for u in unique]

    closest = []
    for target in num_tokens:
        best, best_thr = np.inf, None
        for u, w in zip(unique, within):
            if abs(target - w) < best:
                best, best_thr = abs(target - w), float(u)
        closest.append(best_thr)
    closest = [float(unique[-1])] + closest

    thresholds: List[float] = []
    counter = 0
    for idx in range(depth):
        if idx in reduction_loc:
            counter += 1
        thresholds.append(closest[counter])
    return z, np.asarray(thresholds)


def masks_per_block(z: np.ndarray, thresholds, reduction_loc,
                    depth: int, num_prefix: int = 1):
    """Boolean [N_tokens] attention mask active from each reduction block on.

    Tokens are never physically removed (reference heuristic.py:245-259);
    returns {block_idx: mask} plus kept patch indices for viz.
    """
    P = z.shape[0]
    flat = z.reshape(P * P)
    out = {}
    kept = {}
    for idx in reduction_loc:
        thr = thresholds[idx]
        thr_v = float(np.asarray(thr).reshape(-1)[0])
        m = flat <= thr_v
        kept[idx] = np.nonzero(m)[0]
        out[idx] = np.concatenate([np.ones(num_prefix, dtype=bool), m])
    return out, kept
