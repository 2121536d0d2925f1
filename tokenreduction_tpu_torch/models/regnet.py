"""RegNetY (inference only), the DeiT distillation teacher.

Counterpart of ``tokenreduction_tpu/models/regnet.py``: the pycls RegNetY
("Designing Network Design Spaces": bottleneck ratio 1, grouped 3x3 conv,
squeeze-excitation of ratio 0.25 of each block's input width), which the
reference builds with ``--teacher-model regnety_160`` (reference
train.py:178, 455-478). Module names follow timm's RegNet layout
(``stem.conv``, ``stem.bn``, ``s{i}.b{j}.{conv1, conv2, se.fc1, se.fc2,
conv3, downsample}``, ``head.fc``), so a timm checkpoint loads with
``load_state_dict`` once its ``num_batches_tracked`` entries are dropped,
and ``models/convert.py`` maps the Flax tree onto these names.

Inference only: each BatchNorm is frozen, ``(x - running_mean) /
sqrt(running_var + eps) * weight + bias`` with eps 1e-5, its four vectors
buffers that take no gradient. The convolutions pad symmetrically by
``(k - 1) // 2`` and run through ``F.conv2d`` (cuDNN on the card), as XLA
computes them in JAX. Images enter as NCHW; the forward moves them to
channels-last memory (NHWC, the layout the JAX model computes in), and
the weights are kept channels-last too: in NCHW memory cuDNN's fp32
kernels transpose around each convolution (on the H100 its transposes
took 48.2% of a distilled DeiT-S step's device time, chip_smoke.py
phase 5). Weights are made on the CPU
from an explicit ``torch.Generator`` (seed 0 when none is given) with the
Flax defaults (LeCun truncated normal kernels, zero biases, identity
BatchNorms), then the model moves to ``device``: the card unless the
caller passes ``device="cpu"``.

RegNetY-160 (16 GF): stem 32, depths (2, 4, 11, 1), widths (224, 448,
1232, 3024), group width 112.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tokenreduction_tpu_torch.core.device import resolve_device

# scale that gives a normal truncated at 2 std the requested std (Flax's
# variance_scaling "truncated_normal")
_TRUNC_STD_FIX = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class RegNetConfig:
    depths: Tuple[int, ...] = (2, 4, 11, 1)
    widths: Tuple[int, ...] = (224, 448, 1232, 3024)
    group_width: int = 112
    stem_width: int = 32
    se_ratio: float = 0.25
    num_classes: int = 1000
    img_size: int = 224
    bn_eps: float = 1e-5
    method: str = "regnety"  # registry/bookkeeping tag


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm over NCHW: x * inv + (bias - running_mean * inv)
    with inv = weight / sqrt(running_var + eps), the JAX formula."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class ConvBn(nn.Module):
    """conv (no bias, symmetric padding) -> frozen BN (-> relu), named
    conv and bn like timm's ConvNormAct."""

    def __init__(self, w_in: int, w_out: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True, eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv2d(w_in, w_out, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm2d(w_out, eps)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class SqueezeExcite(nn.Module):
    """Global mean pool -> fc1 1x1 -> relu -> fc2 1x1 -> sigmoid gate."""

    def __init__(self, features: int, rd_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(features, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, features, 1)

    def forward(self, x):
        s = F.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class Bottleneck(nn.Module):
    """RegNetY bottleneck (ratio 1): 1x1 -> grouped 3x3 (stride) -> SE ->
    1x1, the residual through a 1x1 strided downsample where the stride or
    the width changes, then relu."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float, eps: float = 1e-5):
        super().__init__()
        groups = max(w_out // group_width, 1)
        self.downsample = None
        if stride != 1 or w_in != w_out:
            self.downsample = ConvBn(w_in, w_out, 1, stride, act=False,
                                     eps=eps)
        self.conv1 = ConvBn(w_in, w_out, 1, eps=eps)
        self.conv2 = ConvBn(w_out, w_out, 3, stride, groups=groups, eps=eps)
        self.se = SqueezeExcite(w_out, int(round(w_in * se_ratio)))
        self.conv3 = ConvBn(w_out, w_out, 1, act=False, eps=eps)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = self.conv3(self.se(self.conv2(self.conv1(x))))
        return F.relu(shortcut + y)


class ClassifierHead(nn.Module):
    def __init__(self, w_in: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(w_in, num_classes)

    def forward(self, x):
        return self.fc(x.mean((2, 3)))


class RegNet(nn.Module):
    """RegNetY classifier: forward(x NCHW) -> logits."""

    def __init__(self, cfg: RegNetConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = self.cfg = cfg
        self.stem = ConvBn(3, c.stem_width, 3, 2, eps=c.bn_eps)
        w_in = c.stem_width
        self.stages = []
        for si, (depth, w_out) in enumerate(zip(c.depths, c.widths)):
            stage = nn.Module()
            for bi in range(depth):
                stage.add_module(f"b{bi + 1}", Bottleneck(
                    w_in, w_out, 2 if bi == 0 else 1, c.group_width,
                    c.se_ratio, c.bn_eps))
                w_in = w_out
            self.add_module(f"s{si + 1}", stage)
            self.stages.append(stage)
        self.head = ClassifierHead(w_in, c.num_classes)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))
        self.eval()
        self.to(resolve_device(device), memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = m.weight[0].numel() ** -0.5 / _TRUNC_STD_FIX
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x):
        x = self.stem(x.contiguous(memory_format=torch.channels_last))
        for stage in self.stages:
            for blk in stage.children():
                x = blk(x)
        return self.head(x)
