"""Weight bridge: Flax param tree -> torch state dict.

The inverse of ``tokenreduction_tpu/models/convert.py:63
convert_torch_state_dict``: Dense kernels [in, out] -> nn.Linear weights
[out, in], the patch conv HWIO -> OIHW, LayerNorm ``scale`` -> ``weight``;
``cls_token``, ``dist_token`` and ``pos_embed`` pass through. DyViT's
score predictors map from ``score_predictor_{i}/{in_ln, in_fc, out_fc1,
out_fc2, out_fc3}`` to ``score_predictor.{i}.<name>.{weight, bias}``
(the port's own names; no loader of the reference's ``in_conv`` /
``out_conv`` checkpoint names exists on either side). The cluster
family's modules map from ``cluster_layers_{k}/<name>/{kernel, scale,
bias}`` to ``cluster_layers.{k}.<name>.{weight, bias}`` (Dense kernels
transposed; the LayerNorms ``weight_ln`` and ``norm``), and their raw
params ``queries``, ``v`` and ``scale`` to ``cluster_layers.{k}.<leaf>``.
The DyViT teacher's names are the dense ViT's. RegNet's tree
(``models/regnet.py`` there: ``stem``, ``s{i}_b{j}``, ``head_fc``) maps to
timm's names (``stem``, ``s{i}.b{j}``, ``head.fc``): conv kernels [kh, kw,
cin / groups, cout] -> [cout, cin / groups, kh, kw], the frozen
BatchNorms' ``scale``, ``bias``, ``mean``, ``var`` -> ``weight``,
``bias``, ``running_mean``, ``running_var``, the head's Dense kernel
transposed. It works on
any nested mapping of array-likes (numpy arrays in the tests) and imports
no JAX. ``torch_names_from_flax`` maps any tree shaped like the params
(gradients, optimizer labels, EMA params) to the port's parameter names
leaf by leaf, leaves untouched.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


# the cluster layers' LayerNorms; their other submodules are Dense
_CLUSTER_NORMS = ("weight_ln", "norm")
# RegNet: a block's Flax name, and the frozen BatchNorm's leaves
_REGNET_BLOCK = re.compile(r"s\d+_b\d+")
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _regnet_name(path: tuple[str, ...]):
    """(timm name, transform) of a RegNet leaf, None for another path."""
    top, leaf = path[0], path[-1]
    if top == "head_fc" and len(path) == 2:
        return f"head.fc.{'weight' if leaf == 'kernel' else 'bias'}", \
            "linear" if leaf == "kernel" else None
    if top == "stem" or _REGNET_BLOCK.fullmatch(top):
        prefix = ".".join(top.split("_") + list(path[1:-2]))
        if path[-2] == "bn":
            return f"{prefix}.bn.{_BN_LEAVES[leaf]}", None
        if leaf == "kernel":
            return f"{prefix}.{path[-2]}.weight", "conv"
        return f"{prefix}.{path[-2]}.bias", None
    return None


def flax_path_to_torch_name(path: tuple[str, ...]):
    """(flax path) -> (timm name, transform) with transform "linear"
    (transpose), "conv" (HWIO -> OIHW) or None. None for unknown paths."""
    regnet = _regnet_name(path)
    if regnet is not None:
        return regnet
    top, leaf = path[0], path[-1]
    if top in ("cls_token", "pos_embed", "dist_token") and len(path) == 1:
        return top, None
    weight = leaf in ("kernel", "scale")
    suffix = "weight" if weight else "bias"
    if top == "patch_embed" and path[1:2] == ("proj",):
        return f"patch_embed.proj.{suffix}", "conv" if weight else None
    if top.startswith("blocks_") and len(path) >= 3:
        i = top[len("blocks_"):]
        if path[1] in ("norm1", "norm2"):
            return f"blocks.{i}.{path[1]}.{suffix}", None
        if path[1] in ("attn", "mlp") and len(path) == 4:
            return (f"blocks.{i}.{path[1]}.{path[2]}.{suffix}",
                    "linear" if weight else None)
        return None
    if top.startswith("cluster_layers_") and len(path) in (2, 3):
        k = top[len("cluster_layers_"):]
        if len(path) == 2:  # raw params: queries, v, SiT's scale
            return f"cluster_layers.{k}.{leaf}", None
        linear = weight and path[1] not in _CLUSTER_NORMS
        return (f"cluster_layers.{k}.{path[1]}.{suffix}",
                "linear" if linear else None)
    if top.startswith("score_predictor_") and len(path) == 3:
        i = top[len("score_predictor_"):]
        linear = weight and path[1] != "in_ln"
        return (f"score_predictor.{i}.{path[1]}.{suffix}",
                "linear" if linear else None)
    if top == "norm":
        return f"norm.{suffix}", None
    if top in ("head", "head_dist"):
        return f"{top}.{suffix}", "linear" if weight else None
    return None


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _mapped_leaves(tree: Mapping):
    """((timm name, transform), leaf) for each leaf of a Flax tree; raises
    KeyError on a leaf with no timm counterpart."""
    for path, value in _leaves(tree):
        mapped = flax_path_to_torch_name(path)
        if mapped is None:
            raise KeyError(f"no torch name for flax param {'/'.join(path)}")
        yield mapped, value


def torch_names_from_flax(tree: Mapping) -> dict:
    """A tree shaped like the Flax params -> {timm name: leaf}, leaves
    as they are (no transpose)."""
    return {name: value for (name, _), value in _mapped_leaves(tree)}


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested Flax params {name: array} -> {timm name: torch.Tensor}.
    Raises KeyError on a leaf with no timm counterpart."""
    out = {}
    for (name, kind), value in _mapped_leaves(params):
        arr = np.asarray(value)
        if kind == "linear":
            arr = arr.T
        elif kind == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    return out
