"""Weight bridge: Flax param tree -> torch state dict.

The inverse of ``tokenreduction_tpu/models/convert.py:63
convert_torch_state_dict``: Dense kernels [in, out] -> nn.Linear weights
[out, in], the patch conv HWIO -> OIHW, LayerNorm ``scale`` -> ``weight``;
``cls_token``, ``dist_token`` and ``pos_embed`` pass through. It works on
any nested mapping of array-likes (numpy arrays in the tests) and imports
no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def flax_path_to_torch_name(path: tuple[str, ...]):
    """(flax path) -> (timm name, transform) with transform "linear"
    (transpose), "conv" (HWIO -> OIHW) or None. None for unknown paths."""
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


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested Flax params {name: array} -> {timm name: torch.Tensor}.
    Raises KeyError on a leaf with no timm counterpart."""
    out = {}
    for path, value in _leaves(params):
        mapped = flax_path_to_torch_name(path)
        if mapped is None:
            raise KeyError(f"no torch name for flax param {'/'.join(path)}")
        name, kind = mapped
        arr = np.asarray(value)
        if kind == "linear":
            arr = arr.T
        elif kind == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    return out
