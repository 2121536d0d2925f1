"""Model registry: reference-compatible names -> (module, config).

Counterpart of ``tokenreduction_tpu/models/registry.py``, with all of its
names: ``deit_{tiny,small,base}_patch16_224_local(_viz)``,
``{topk,evit,tome,sit,patchmerger,sinkhorn,dpcknn,kmedoids,ats,heuristic,
dyvit}_{tiny,small,base}_patch16_224``, the DyViT teachers
``dyvit_{tiny,small,base}_patch16_224_teacher`` (the dense ViT returning
its CLS logits and post-norm patch tokens) and the convnet teacher
``regnety_160``. The per-method flags are ViTConfig fields:
``k_neighbors``, ``cluster_iters``, ``equal_weight``, ``sinkhorn_eps`` and
the others; ``dyvit_distillation`` is taken by every ViT name and used by
DyViT alone, as the JAX registry does.
"""

from __future__ import annotations

import torch
from torch import nn

from tokenreduction_tpu_torch.core.config import SIZE_PRESETS, ViTConfig
from tokenreduction_tpu_torch.models.deit import (
    VisionTransformer,
    VisionTransformerTeacher,
)
from tokenreduction_tpu_torch.models.regnet import RegNet, RegNetConfig
from tokenreduction_tpu_torch.reduction.ats import ATSVisionTransformer
from tokenreduction_tpu_torch.reduction.cluster import (
    DPCKNNVisionTransformer,
    KMedoidsVisionTransformer,
    PatchMergerVisionTransformer,
    SinkhornVisionTransformer,
    SiTVisionTransformer,
)
from tokenreduction_tpu_torch.reduction.dyvit import DynamicVisionTransformer
from tokenreduction_tpu_torch.reduction.evit import EViTVisionTransformer
from tokenreduction_tpu_torch.reduction.heuristic import (
    HeuristicVisionTransformer,
)
from tokenreduction_tpu_torch.reduction.tome import ToMeVisionTransformer
from tokenreduction_tpu_torch.reduction.topk import TopKVisionTransformer

_CLASSES = {"": VisionTransformer, "topk": TopKVisionTransformer,
            "evit": EViTVisionTransformer, "tome": ToMeVisionTransformer,
            "sit": SiTVisionTransformer,
            "patchmerger": PatchMergerVisionTransformer,
            "sinkhorn": SinkhornVisionTransformer,
            "dpcknn": DPCKNNVisionTransformer,
            "kmedoids": KMedoidsVisionTransformer,
            "ats": ATSVisionTransformer,
            "heuristic": HeuristicVisionTransformer,
            "dyvit": DynamicVisionTransformer}

_REGISTRY = {}  # ViT name -> (method key, size, module class, module kwargs)
for _size in SIZE_PRESETS:
    _REGISTRY[f"deit_{_size}_patch16_224_local"] = (
        "", _size, VisionTransformer, {})
    _REGISTRY[f"deit_{_size}_patch16_224_local_viz"] = (
        "", _size, VisionTransformer, {"capture_features": True})
    _REGISTRY[f"dyvit_{_size}_patch16_224_teacher"] = (
        "", _size, VisionTransformerTeacher, {})
    for _m, _cls in _CLASSES.items():
        if _m:
            _REGISTRY[f"{_m}_{_size}_patch16_224"] = (_m, _size, _cls, {})

# convnet teachers: name -> RegNetConfig preset (JAX registry.py:75-103)
_REGNETS = {"regnety_160": dict(depths=(2, 4, 11, 1),
                                widths=(224, 448, 1232, 3024),
                                group_width=112)}
# ViT options that a convnet teacher refuses
_VIT_ONLY = {"embed_dim", "depth", "num_heads", "patch_size", "reduction_loc",
             "keep_rate"}


def list_models():
    return sorted([*_REGISTRY, *_REGNETS])


def _create_regnet(name, num_classes, img_size, device, generator,
                   overrides):
    bad = set(overrides) & _VIT_ONLY
    if bad:
        raise ValueError(f"{name} is a convnet teacher; ViT options "
                         f"{sorted(bad)} do not apply")
    for key in ("depths", "widths"):
        if key in overrides:
            overrides[key] = tuple(overrides[key])
    cfg = RegNetConfig(**{**_REGNETS[name], "num_classes": num_classes,
                          "img_size": img_size, **overrides})
    return RegNet(cfg, device=device, generator=generator), cfg


def create_model(name: str, *, num_classes: int = 1000, img_size: int = 224,
                 device=None, generator: torch.Generator | None = None,
                 dyvit_distillation: bool = False,
                 **kwargs) -> tuple[nn.Module, ViTConfig | RegNetConfig]:
    """Build (module, cfg) with weights from ``generator`` on ``device``:
    the card unless the caller passes ``device="cpu"``; without a CUDA
    device and with no device given it raises. For a ViT name kwargs are
    ViTConfig fields: reduction_loc, keep_rate, viz_mode, drop_rate,
    drop_path_rate, distilled, and the width overrides; DyViT also takes
    ``dyvit_distillation`` (its training forward then returns the
    distillation tuple). ``regnety_160`` takes RegNetConfig overrides
    (depths, widths, group_width, stem_width) and refuses ViT options."""
    if name in _REGNETS:
        return _create_regnet(name, num_classes, img_size, device, generator,
                              kwargs)
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {list_models()}")
    method, size, cls, mod_kw = _REGISTRY[name]
    for key in ("reduction_loc", "keep_rate"):
        if kwargs.get(key) is not None:
            kwargs[key] = tuple(kwargs[key])
    cfg = ViTConfig(**{**SIZE_PRESETS[size], "img_size": img_size,
                       "num_classes": num_classes, "method": method,
                       **kwargs})
    if cls is DynamicVisionTransformer:
        mod_kw = {**mod_kw, "dyvit_distillation": dyvit_distillation}
    module = cls(cfg, device=device, generator=generator, **mod_kw)
    return module, cfg


def model_for_config(cfg: ViTConfig, *, device=None, **mod_kw) -> nn.Module:
    """Rebuild the module class for a (checkpoint-stored) config, on
    ``device`` as ``create_model`` places it."""
    if cfg.method not in _CLASSES:
        raise NotImplementedError(
            f"method {cfg.method!r} is not a method of the port")
    return _CLASSES[cfg.method](cfg, device=device, **mod_kw)
