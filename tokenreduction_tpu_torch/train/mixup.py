"""Mixup/CutMix with label smoothing (counterpart of
``tokenreduction_tpu/train/mixup.py``; timm semantics, as wired in
reference train.py:313-319).

The parameters are drawn on the host, from a ``numpy.random.Generator``
(``draw_mixup``): whether the batch (or each element) is mixed, mixup or
cutmix, lambda and the cut box. ``mix`` then applies them to the batch as
plain tensor ops on its device, with no host synchronisation: the batch
mode's box and lambda are host numbers, the per-element modes' are copied
to the device. timm's ``Mixup`` draws its parameters on the host as well;
JAX draws them from ``jax.random`` inside its step, so the draws differ
from JAX's, but given the same draws ``mix`` makes JAX's images and soft
targets. Images are NCHW here (JAX's NHWC): the box covers rows and
columns of every channel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000
    mode: str = "batch"  # batch | pair | elem (timm Mixup modes)
    # timm cutmix ratio bounds (reference train.py:134 --cutmix-minmax):
    # when set, the cut box side is drawn uniformly in
    # [H*min, H*max) x [W*min, W*max) and placed fully inside the image
    # (timm rand_bbox_minmax), with lambda taken from the exact box area;
    # timm forces cutmix_alpha = 1.0 in this mode.
    cutmix_minmax: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in ("batch", "pair", "elem"):
            raise ValueError(f"unknown mixup mode {self.mode!r}; "
                             "expected batch, pair, or elem")
        if self.cutmix_minmax is not None:
            mm = tuple(float(v) for v in self.cutmix_minmax)
            if len(mm) != 2:
                raise ValueError("cutmix_minmax expects exactly two "
                                 f"floats, got {self.cutmix_minmax!r}")
            object.__setattr__(self, "cutmix_minmax", mm)
            # timm Mixup.__init__: "force cutmix alpha == 1.0 when minmax
            # active to mimic original paper"
            object.__setattr__(self, "cutmix_alpha", 1.0)

    @property
    def enabled(self) -> bool:
        return (self.mixup_alpha > 0 or self.cutmix_alpha > 0
                or self.cutmix_minmax is not None)


@dataclasses.dataclass
class MixupDraw:
    """One batch's parameters, as JAX draws them (``mixup.py:93-128``
    there): per element in the pair and elem modes ([B] arrays, the
    boxes [B, 4]), one for the batch in batch mode (shape [1]). ``box`` is
    (y1, y2, x1, x2), rows then columns, ends excluded."""

    apply: np.ndarray  # bool: mixed at all
    use_cutmix: np.ndarray  # bool: cutmix, else mixup
    lam_mix: np.ndarray  # mixup's lambda
    box: np.ndarray  # int [n, 4]


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _rand_bbox(rng, H, W, lam):
    """timm rand_bbox: cut ratio sqrt(1-lam), uniform centre, clipped."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(H * ratio), int(W * ratio)
    cy, cx = int(rng.integers(0, H)), int(rng.integers(0, W))
    return (int(np.clip(cy - cut_h // 2, 0, H)),
            int(np.clip(cy + cut_h // 2, 0, H)),
            int(np.clip(cx - cut_w // 2, 0, W)),
            int(np.clip(cx + cut_w // 2, 0, W)))


def _rand_bbox_minmax(rng, H, W, minmax):
    """timm rand_bbox_minmax: sides uniform in [dim*min, dim*max), the box
    placed fully inside the image (never clipped)."""
    lo, hi = minmax
    cut_h = int(rng.integers(int(H * lo), int(H * hi)))
    cut_w = int(rng.integers(int(W * lo), int(W * hi)))
    y1 = int(rng.integers(0, H - cut_h))
    x1 = int(rng.integers(0, W - cut_w))
    return y1, y1 + cut_h, x1, x1 + cut_w


def draw_mixup(rng: np.random.Generator, B: int, H: int, W: int,
               cfg: MixupConfig) -> MixupDraw:
    """The parameters of one batch of B images of H x W, from ``rng``:
    one set in batch mode, one per element in the pair and elem modes
    (pair mode's symmetry is applied by ``mix``)."""
    n = 1 if cfg.mode == "batch" else B
    apply = rng.random(n) < cfg.prob
    if cfg.mixup_alpha <= 0:
        use_cutmix = np.ones(n, bool)
    else:
        use_cutmix = (rng.random(n) < cfg.switch_prob) & \
            (cfg.cutmix_alpha > 0)
    a_m, a_c = cfg.mixup_alpha or 1.0, cfg.cutmix_alpha or 1.0
    lam_mix = rng.beta(a_m, a_m, n).astype(np.float32)
    lam_cut = rng.beta(a_c, a_c, n).astype(np.float32)
    if cfg.cutmix_minmax is not None:
        box = [_rand_bbox_minmax(rng, H, W, cfg.cutmix_minmax)
               for _ in range(n)]
    else:
        box = [_rand_bbox(rng, H, W, lam) for lam in lam_cut]
    return MixupDraw(apply, use_cutmix, lam_mix,
                     np.asarray(box, np.int64).reshape(n, 4))


def _paired(draw: MixupDraw) -> MixupDraw:
    """timm's pair mode: element j = B-1-i takes i's draws for i in the
    first half; with an odd B the middle element pairs with itself and is
    never mixed."""
    B = len(draw.apply)
    idx = np.arange(B)
    first = idx < (B - 1 - idx)

    def sym(v):
        return np.where(first.reshape((B,) + (1,) * (v.ndim - 1)), v,
                        v[::-1])

    return MixupDraw(sym(draw.apply) & (idx != B - 1 - idx),
                     sym(draw.use_cutmix), sym(draw.lam_mix), sym(draw.box))


def mix(images: torch.Tensor, labels: torch.Tensor, cfg: MixupConfig,
        draw: Optional[MixupDraw]):
    """(mixed images, soft targets [B, num_classes]) of NCHW ``images``
    and int ``labels`` [B] under ``draw``: each image mixed with its
    mirror (element B-1-i), the targets likewise with the smoothed one-hot
    labels; an element that is not applied keeps its image and its
    smoothed one-hot target."""
    y1h = one_hot_smooth(labels, cfg.num_classes, cfg.label_smoothing)
    if not cfg.enabled:
        return images, y1h
    if cfg.mode == "pair":
        draw = _paired(draw)
    H, W = images.shape[-2:]
    flipped = images.flip(0)
    y2h = y1h.flip(0)
    area = (draw.box[:, 1] - draw.box[:, 0]) * (draw.box[:, 3] -
                                                draw.box[:, 2])
    lam_cut = (np.float32(1.0) - area / np.float32(H * W)).astype(np.float32)
    lam = np.where(draw.use_cutmix, lam_cut, draw.lam_mix)
    lam = np.where(draw.apply, lam, np.float32(1.0)).astype(np.float32)
    if cfg.mode == "batch":
        if not draw.apply[0]:
            return images, y1h
        lam0 = float(lam[0])
        if draw.use_cutmix[0]:
            y1, y2, x1, x2 = (int(v) for v in draw.box[0])
            mixed = images.clone()
            mixed[..., y1:y2, x1:x2] = flipped[..., y1:y2, x1:x2]
        else:
            mixed = images * lam0 + flipped * float(np.float32(1.0) - lam[0])
        return mixed, y1h * lam0 + y2h * float(np.float32(1.0) - lam[0])

    def dev(a, dtype):
        return torch.from_numpy(np.array(a)).to(
            images.device, dtype, non_blocking=True)

    lam_t = dev(lam, torch.float32)
    box = dev(draw.box, torch.int64)
    ys = torch.arange(H, device=images.device).view(1, 1, H, 1)
    xs = torch.arange(W, device=images.device).view(1, 1, 1, W)

    def edge(i):
        return box[:, i].view(-1, 1, 1, 1)

    in_box = (ys >= edge(0)) & (ys < edge(1)) & (xs >= edge(2)) & \
        (xs < edge(3))
    lam_mix = dev(draw.lam_mix, images.dtype).view(-1, 1, 1, 1)
    mixed_m = images * lam_mix + flipped * (1.0 - lam_mix)
    mixed_c = torch.where(in_box, flipped, images)
    cut = dev(draw.use_cutmix, torch.bool).view(-1, 1, 1, 1)
    on = dev(draw.apply, torch.bool).view(-1, 1, 1, 1)
    mixed = torch.where(on, torch.where(cut, mixed_c, mixed_m), images)
    lam2 = lam_t[:, None]
    return mixed, y1h * lam2 + y2h * (1.0 - lam2)


def make_mixup_fn(cfg: MixupConfig, seed: int) -> Callable:
    """``mixup_fn(images, labels) -> (images, soft targets)``: each call
    draws its batch's parameters from a ``numpy.random.Generator`` seeded
    from ``seed`` (``draw_mixup``) and applies them on the images' device
    (``mix``)."""
    rng = np.random.default_rng(seed)

    def mixup_fn(images, labels):
        B, _, H, W = images.shape
        return mix(images, labels, cfg, draw_mixup(rng, B, H, W, cfg))

    return mixup_fn


def multilabel_passthrough(images, labels):
    """The multilabel recipe's ``mixup_fn`` (JAX train/loop.py:545-552):
    no mixing; 3-D labels [B, k, C] become their max over k."""
    return images, (labels.amax(dim=1) if labels.ndim == 3 else labels)
