"""Dense DeiT backbone (timm VisionTransformer equivalent) and its viz
variant. Counterpart of ``tokenreduction_tpu/models/deit.py:26-133``.

Images enter as NCHW. Weights are made on the CPU from an explicit
``torch.Generator`` (seed 0 when none is given), so a seed gives the same
weights on every device, with the Flax package's initialisers: truncated
normal (std 0.02, cut at 2 std) for every Linear weight and for the CLS,
dist and position embeddings, LeCun truncated normal for the patch conv,
zero biases, unit LayerNorm scales. The model then moves to ``device``:
the card unless the caller passes ``device="cpu"``.

In training the forward takes ``generator=``, the generator of the
stochastic-depth and dropout masks, on the device of the model. With
``cfg.viz_mode`` every block is built with ``force_plain`` (JAX's
``force_xla=c.viz_mode``, ``models/deit.py:76`` there): extraction runs
the plain composition on every device and launches no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from tokenreduction_tpu_torch.core.config import ViTConfig, drop_path_rates
from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.core.layers import Block, Dropout, PatchEmbed

# scale that gives a normal truncated at 2 std the requested std (Flax's
# variance_scaling "truncated_normal")
_TRUNC_STD_FIX = 0.87962566103423978


def _trunc_normal(t: torch.Tensor, std: float, generator: torch.Generator):
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class ViTBase(nn.Module):
    """Shared embedding / blocks / norm / head scaffolding for every model
    family."""

    def __init__(self, cfg: ViTConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = self.cfg = cfg
        D = c.embed_dim
        self.patch_embed = PatchEmbed(c.patch_size, c.in_chans, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        if c.distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.num_patches + c.num_prefix_tokens, D))
        self.pos_drop = Dropout(c.drop_rate)
        dpr = drop_path_rates(c)
        self.blocks = nn.ModuleList(self.make_block(i, dpr[i])
                                    for i in range(c.depth))
        self.norm = nn.LayerNorm(D, eps=c.layer_norm_eps)
        if c.num_classes > 0:
            self.head = nn.Linear(D, c.num_classes)
            if c.distilled:
                self.head_dist = nn.Linear(D, c.num_classes)
        self.make_modules()
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def make_modules(self):
        """A family's own modules and buffers beside the backbone, made
        before the weights are initialised and moved to the device (none
        here)."""

    def make_block(self, i: int, drop_path: float) -> nn.Module:
        """Block i of the backbone (a family with its own blocks overrides
        this), pinned to the plain composition in viz mode."""
        c = self.cfg
        return Block(c.embed_dim, c.num_heads, mlp_ratio=c.mlp_ratio,
                     qkv_bias=c.qkv_bias, drop=c.drop_rate,
                     attn_drop=c.attn_drop_rate, drop_path=drop_path,
                     layer_norm_eps=c.layer_norm_eps,
                     force_plain=c.viz_mode)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _trunc_normal(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                _trunc_normal(m.weight, fan_in ** -0.5 / _TRUNC_STD_FIX,
                              generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name in ("cls_token", "dist_token", "pos_embed"):
            if hasattr(self, name):
                _trunc_normal(getattr(self, name), 0.02, generator)

    def embed(self, x, generator: torch.Generator | None = None):
        """Patchify + prepend prefix tokens + positional embedding, then
        dropout (its masks from ``generator``)."""
        x = self.patch_embed(x)
        B = x.shape[0]
        prefix = [self.cls_token.expand(B, -1, -1)]
        if self.cfg.distilled:
            prefix.append(self.dist_token.expand(B, -1, -1))
        return self.pos_drop(torch.cat(prefix + [x], dim=1) + self.pos_embed,
                             generator)

    def classify(self, x):
        """Final norm -> head (DeiT dist-token averaging at eval)."""
        c = self.cfg
        x = self.norm(x)
        if c.num_classes <= 0:
            return x[:, 0]
        logits = self.head(x[:, 0])
        if c.distilled:
            logits_dist = self.head_dist(x[:, 1])
            if self.training:
                return logits, logits_dist
            return (logits + logits_dist) / 2
        return logits


class VisionTransformer(ViTBase):
    """Dense DeiT; with ``capture_features`` and ``cfg.viz_mode`` it also
    returns per-block features (the ``deit_*_local_viz`` registry
    entries, reference deit_viz.py)."""

    def __init__(self, cfg: ViTConfig, *, capture_features: bool = False,
                 **kwargs):
        super().__init__(cfg, **kwargs)
        self.capture_features = capture_features

    def forward(self, x, generator: torch.Generator | None = None):
        c = self.cfg
        capture = c.viz_mode and self.capture_features
        x = self.embed(x, generator)
        features = {}
        for i, blk in enumerate(self.blocks):
            x, _ = blk(x, generator=generator)
            if capture:
                features[i] = x
        out = self.classify(x)
        if capture and not self.training:
            return out, {"Features": features}
        return out
