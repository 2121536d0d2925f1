"""Model configuration and reduction-schedule computation.

A JAX-free copy of ``tokenreduction_tpu/core/config.py``: importing the
JAX package runs its Flax registry, and this package never imports JAX.
The two copies must stay identical below this docstring
(``tests/test_torch_package.py`` checks it).

The reference threads a full argparse namespace into every model
constructor (reference train.py:330).  Here the model-relevant subset is an
explicit frozen dataclass so that configs are hashable and serializable
into checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static configuration of a (possibly token-reducing) DeiT backbone."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    distilled: bool = False  # DeiT distillation token

    # --- token reduction ---
    # which method this backbone runs; "" = dense
    method: str = ""
    # block indices at which reduction happens (reference --reduction_loc)
    reduction_loc: Tuple[int, ...] = ()
    # reference --keep_rate; semantics differ per family (fraction kept for
    # pruning, cluster/token count for merging, max sample count for ATS)
    keep_rate: Tuple[float, ...] = ()

    # --- method-specific knobs (reference train.py:205-236) ---
    k_neighbors: int = 5  # dpcknn
    cluster_iters: int = 3  # kmedoids / sinkhorn
    equal_weight: bool = False  # dpcknn / kmedoids
    sinkhorn_eps: float = 1.0  # sinkhorn
    heuristic_pattern: str = "l1"  # heuristic: l1 | l2 | linf
    min_radius: float = 1.0  # heuristic
    not_contiguous: bool = False  # heuristic
    ats_eps: float = 1e-6  # ats significance normalizer

    # eval-time capture of per-stage reduction decisions/features
    viz_mode: bool = False

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


def expand_keep_rate(cfg: ViTConfig) -> Tuple[float, ...]:
    """Geometric expansion of a single keep_rate across stages.

    Mirrors the per-model expansion in the reference (e.g.
    models/topk.py:141-142): keep_rate [r] with L reduction locations becomes
    [r^1, r^2, ..., r^L].
    """
    kr = tuple(cfg.keep_rate)
    loc = tuple(cfg.reduction_loc)
    if len(kr) == 1 and len(loc) > 1:
        kr = tuple(kr[0] ** (i + 1) for i in range(len(loc)))
    if len(kr) != len(loc):
        raise ValueError(
            f"Mismatch between reduction_loc ({loc}) and keep_rate ({kr})"
        )
    return kr


def reduction_schedule(cfg: ViTConfig) -> Tuple[int, ...]:
    """Per-stage integer target (kept tokens / clusters / samples).

    Pruning family (topk, evit, dyvit): int(keep_rate * num_patches)
      (reference models/topk.py:56 -- note the reference hardcodes 196 via
       ``init_n = 14*14`` at models/topk.py:40; we use num_patches so
       non-224 inputs behave sensibly; identical at 224).
    Merge/cluster family (tome, sit, sinkhorn, patchmerger, dpcknn,
      kmedoids): int(num_patches * r^(i+1)) (e.g. models/sit.py:80-81).
    ATS: int(num_patches * r^(i+1)) + 1 (models/ats.py:204-205).
    If keep_rate is given as an explicit per-stage list with values > 1 the
    values are taken as absolute counts (merging family semantics,
    reference README.md:27).
    """
    kr = tuple(cfg.keep_rate)
    loc = tuple(cfg.reduction_loc)
    n = cfg.num_patches
    fam_prune = cfg.method in ("topk", "evit", "dyvit")
    fam_ats = cfg.method == "ats"

    if len(kr) == 1 and len(loc) > 1:
        r = kr[0]
        if fam_prune:
            return tuple(int(r ** (i + 1) * n) for i in range(len(loc)))
        if fam_ats:
            return tuple(int(r ** (i + 1) * n) + 1 for i in range(len(loc)))
        return tuple(int(n * r ** (i + 1)) for i in range(len(loc)))

    if len(kr) != len(loc):
        raise ValueError(
            f"Mismatch between reduction_loc ({loc}) and keep_rate ({kr})"
        )
    out = []
    for v in kr:
        if v > 1:  # absolute count
            out.append(int(v))
        elif fam_prune or fam_ats:
            out.append(int(v * n) + (1 if fam_ats else 0))
        else:
            out.append(int(n * v))
    return tuple(out)


def drop_path_rates(cfg: ViTConfig) -> Tuple[float, ...]:
    """Stochastic-depth decay rule: linspace(0, drop_path_rate, depth)."""
    d = cfg.depth
    if d == 1:
        return (0.0,)
    return tuple(cfg.drop_path_rate * i / (d - 1) for i in range(d))


# Registry of per-size backbone dims (reference models_act.py factories:
# tiny=192d/3h, small=384d/6h, base=768d/12h, all patch16/224/depth12).
SIZE_PRESETS = {
    "tiny": dict(embed_dim=192, num_heads=3),
    "small": dict(embed_dim=384, num_heads=6),
    "base": dict(embed_dim=768, num_heads=12),
}
