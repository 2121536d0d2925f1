"""Model registry: reference-compatible names -> (module, config).

Counterpart of ``tokenreduction_tpu/models/registry.py``, with the names
ported so far: ``deit_{tiny,small,base}_patch16_224_local(_viz)`` and
``{topk,tome,ats,heuristic,dyvit}_{tiny,small,base}_patch16_224``
(DyViT in eval only: its training raises). Every other name of the JAX
registry, ``dyvit_*_teacher`` included, raises ``NotImplementedError``
until its method is ported.
"""

from __future__ import annotations

import torch
from torch import nn

from tokenreduction_tpu_torch.core.config import SIZE_PRESETS, ViTConfig
from tokenreduction_tpu_torch.models.deit import VisionTransformer
from tokenreduction_tpu_torch.reduction.ats import ATSVisionTransformer
from tokenreduction_tpu_torch.reduction.dyvit import DynamicVisionTransformer
from tokenreduction_tpu_torch.reduction.heuristic import (
    HeuristicVisionTransformer,
)
from tokenreduction_tpu_torch.reduction.tome import ToMeVisionTransformer
from tokenreduction_tpu_torch.reduction.topk import TopKVisionTransformer

_CLASSES = {"": VisionTransformer, "topk": TopKVisionTransformer,
            "tome": ToMeVisionTransformer, "ats": ATSVisionTransformer,
            "heuristic": HeuristicVisionTransformer,
            "dyvit": DynamicVisionTransformer}

# methods of the JAX registry that wait for their slice of the port
_NOT_PORTED = ("evit", "sit", "patchmerger", "sinkhorn", "dpcknn",
               "kmedoids")

_REGISTRY = {}  # name -> (method key, size, module kwargs)
_REFERENCE_ONLY = {"regnety_160"}
for _size in SIZE_PRESETS:
    _REGISTRY[f"deit_{_size}_patch16_224_local"] = ("", _size, {})
    _REGISTRY[f"deit_{_size}_patch16_224_local_viz"] = (
        "", _size, {"capture_features": True})
    _REGISTRY[f"topk_{_size}_patch16_224"] = ("topk", _size, {})
    _REGISTRY[f"tome_{_size}_patch16_224"] = ("tome", _size, {})
    for _m in ("ats", "heuristic", "dyvit"):
        _REGISTRY[f"{_m}_{_size}_patch16_224"] = (_m, _size, {})
    _REFERENCE_ONLY.add(f"dyvit_{_size}_patch16_224_teacher")
    _REFERENCE_ONLY.update(f"{m}_{_size}_patch16_224" for m in _NOT_PORTED)


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, *, num_classes: int = 1000, img_size: int = 224,
                 device=None, generator: torch.Generator | None = None,
                 **kwargs) -> tuple[nn.Module, ViTConfig]:
    """Build (module, cfg) with weights from ``generator`` on ``device``:
    the card unless the caller passes ``device="cpu"``; without a CUDA
    device and with no device given it raises. kwargs are ViTConfig
    fields: reduction_loc, keep_rate, viz_mode, drop_rate,
    drop_path_rate, distilled, and the width overrides."""
    if name in _REFERENCE_ONLY:
        raise NotImplementedError(
            f"{name!r} is not ported to PyTorch yet (ROADMAP Queue 1 item 6)")
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {list_models()}")
    method, size, mod_kw = _REGISTRY[name]
    for key in ("reduction_loc", "keep_rate"):
        if kwargs.get(key) is not None:
            kwargs[key] = tuple(kwargs[key])
    cfg = ViTConfig(**{**SIZE_PRESETS[size], "img_size": img_size,
                       "num_classes": num_classes, "method": method,
                       **kwargs})
    module = _CLASSES[method](cfg, device=device, generator=generator,
                              **mod_kw)
    return module, cfg


def model_for_config(cfg: ViTConfig, *, device=None, **mod_kw) -> nn.Module:
    """Rebuild the module class for a (checkpoint-stored) config, on
    ``device`` as ``create_model`` places it."""
    if cfg.method not in _CLASSES:
        raise NotImplementedError(
            f"method {cfg.method!r} is not ported to PyTorch yet (ROADMAP "
            "Queue 1 item 6)")
    return _CLASSES[cfg.method](cfg, device=device, **mod_kw)
