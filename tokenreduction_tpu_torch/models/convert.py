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

The ``.pth`` route (``--finetune``, ``--teacher-path``) is the
counterpart of JAX ``models/convert.py:63-215``:
``load_torch_checkpoint`` reads the state dict (under ``"model"`` or
``"state_dict"`` when the file wraps it), ``convert_torch_state_dict`` and
``convert_regnet_state_dict`` keep the names the JAX converters map (timm's
names, which are the port's own, so no name changes) and list the others
as skipped, ``merge_pretrained`` copies every entry whose name and shape
match into a model's state dict (strict=False) with the report the CLIs
print, and ``resize_pos_embed`` interpolates position embeddings to
another grid (PIL bicubic per channel, as JAX does). Downloads
(``--pretrained``, an ``http`` teacher path) are refused:
``refuse_download``.

The ``.npz`` route (``--finetune x.npz``) is the port's copy of JAX
``models/convert.py:212-300``: ``load_jax_npz_state`` reads a Google
Brain Flax ViT checkpoint, ``convert_jax_npz`` builds the Flax param
subtree from it (per-head q/k/v re-fused into one qkv kernel, the output
projection flattened; hybrid and other non-ViT files refused), and
``state_dict_from_flax`` takes that tree to the port's names.
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


# timm ViT names the JAX converter maps (convert.py:22-60 there); the
# others (pre_logits, ...) are skipped
_VIT_TOP = ("cls_token", "pos_embed", "dist_token")
_VIT_BLOCK = re.compile(
    r"blocks\.\d+\.(norm[12]\.(weight|bias)|"
    r"(attn\.(qkv|proj)|mlp\.(fc1|fc2))\.(weight|bias))")
_REGNET_NAME = re.compile(
    r"(stem\.(conv\.weight|bn\.(weight|bias|running_mean|running_var))"
    r"|head\.fc\.(weight|bias)"
    r"|s\d+\.b\d+\.((conv[123]|downsample)\.(conv\.weight|"
    r"bn\.(weight|bias|running_mean|running_var))"
    r"|se\.fc[12]\.(weight|bias)))")


def _vit_name_known(name: str) -> bool:
    return (name in _VIT_TOP or _VIT_BLOCK.fullmatch(name) is not None
            or re.fullmatch(r"patch_embed\.proj\.(weight|bias)|norm\.(weight|"
                            r"bias)|(head|head_dist)\.(weight|bias)", name)
            is not None)


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth`` file's state dict {name: CPU tensor}: the file's
    ``"model"`` or ``"state_dict"`` entry when it wraps one (a DeiT
    release, a training checkpoint), else the file itself."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def convert_torch_state_dict(state: Mapping) -> tuple[dict, list]:
    """(the entries of a timm ViT state dict that the port loads, the
    skipped names). timm's names are the port's, so nothing is renamed or
    transposed."""
    keep = {k: v for k, v in state.items() if _vit_name_known(k)}
    return keep, [k for k in state if k not in keep]


def convert_regnet_state_dict(state: Mapping) -> tuple[dict, list]:
    """The same for a timm RegNet state dict (the released regnety_160
    teacher): ``num_batches_tracked`` and unknown names are skipped."""
    keep = {k: v for k, v in state.items()
            if _REGNET_NAME.fullmatch(k) is not None}
    return keep, [k for k in state if k not in keep]


def merge_pretrained(state: Mapping[str, torch.Tensor], pretrained: Mapping,
                     strict: bool = False) -> tuple[dict, dict]:
    """strict=False merge (reference models_act.py:96): each entry of a
    model's ``state`` whose name is in ``pretrained`` with the same shape
    takes its value (in the entry's dtype and device), the rest keeps its
    own. Returns (merged state, report {"loaded", "shape_mismatch",
    "missing_in_ckpt"}: lists of names)."""
    report = {"loaded": [], "shape_mismatch": [], "missing_in_ckpt": []}
    merged = {}
    for name, value in state.items():
        src = pretrained.get(name)
        if src is None:
            report["missing_in_ckpt"].append(name)
        elif tuple(src.shape) != tuple(value.shape):
            report["shape_mismatch"].append(name)
        else:
            merged[name] = torch.as_tensor(np.asarray(src)).to(
                dtype=value.dtype, device=value.device)
            report["loaded"].append(name)
            continue
        merged[name] = value
    if strict and (report["shape_mismatch"] or report["missing_in_ckpt"]):
        raise ValueError(f"strict load failed: {report}")
    return merged, report


def resize_pos_embed(pos_embed, new_tokens: int,
                     num_prefix: int = 1) -> np.ndarray:
    """Bicubic grid interpolation of position embeddings [1, prefix + n,
    D] to ``new_tokens`` grid tokens (reference train.py:336-370), channel
    by channel through PIL, as JAX's resize_pos_embed."""
    from PIL import Image

    pe = np.asarray(pos_embed)
    prefix = pe[:, :num_prefix]
    grid = pe[0, num_prefix:]
    old_n = grid.shape[0]
    if old_n == new_tokens:
        return pe
    old_s = int(round(old_n ** 0.5))
    new_s = int(round(new_tokens ** 0.5))
    d = grid.shape[-1]
    out = np.zeros((new_s * new_s, d), dtype=np.float32)
    img = grid.reshape(old_s, old_s, d).astype(np.float32)
    for c in range(d):
        ch = Image.fromarray(img[..., c], mode="F")
        ch = ch.resize((new_s, new_s), Image.BICUBIC)
        out[:, c] = np.asarray(ch, dtype=np.float32).reshape(-1)
    return np.concatenate([prefix, out[None]], axis=1).astype(pe.dtype)


def refuse_download(flag: str, local: str):
    """Neither the port's users' machines nor its test machines are assumed
    to reach the network: a flag that would download weights raises."""
    raise ValueError(
        f"{flag} downloads weights, which the port does not do: download "
        f"the .pth yourself and pass it as a local {local} file instead")


def _set(tree: dict, path: tuple, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_jax_npz_state(path: str) -> dict:
    """A Google Brain Flax ViT ``.npz`` checkpoint as {name: numpy}."""
    with np.load(path) as w:
        return {k: np.asarray(w[k]) for k in w.files}


def convert_jax_npz(state: Mapping) -> tuple[dict, list]:
    """(the Flax param subtree of a Brain-Flax ViT ``.npz`` mapping, the
    skipped names), as JAX's ``convert_jax_npz``: the reference's
    timm-inherited loader (deit_viz.py:252-327 ``_load_weights``) for the
    plain ViT. The layouts are Flax's already (conv kernels HWIO, Dense
    kernels [in, out]); the per-head q/k/v kernels [D, H, hd] are re-fused
    into one [D, 3D] qkv kernel and ``out/kernel`` [H, hd, D] flattens to
    the [D, D] proj kernel. Raises ValueError on a file with no
    ``Transformer/encoderblock_*`` (hybrid backbones are not
    supported)."""
    prefix = "opt/target/" if "opt/target/embedding/kernel" in state else ""

    def squash(a: np.ndarray) -> np.ndarray:
        # 1x1x1xN "conv" biases in some Brain checkpoints (deit_viz.py:257)
        if a.ndim == 4 and a.shape[0] == a.shape[1] == a.shape[2] == 1:
            return a.reshape(-1)
        return a

    used = set()

    def get(name: str) -> np.ndarray:
        used.add(prefix + name)
        return squash(np.asarray(state[prefix + name]))

    def has(name: str) -> bool:
        return prefix + name in state

    tree: dict = {}
    _set(tree, ("patch_embed", "proj", "kernel"), get("embedding/kernel"))
    _set(tree, ("patch_embed", "proj", "bias"), get("embedding/bias"))
    _set(tree, ("cls_token",), get("cls"))
    _set(tree, ("pos_embed",),
         get("Transformer/posembed_input/pos_embedding"))
    _set(tree, ("norm", "scale"), get("Transformer/encoder_norm/scale"))
    _set(tree, ("norm", "bias"), get("Transformer/encoder_norm/bias"))
    if has("head/kernel"):
        # a head of another class count is dropped by merge_pretrained's
        # shape check (deit_viz.py:310-312)
        _set(tree, ("head", "kernel"), get("head/kernel"))
        _set(tree, ("head", "bias"), get("head/bias"))

    i = 0
    while has(f"Transformer/encoderblock_{i}/LayerNorm_0/scale"):
        bp = f"Transformer/encoderblock_{i}/"
        mha = bp + "MultiHeadDotProductAttention_1/"
        base = (f"blocks_{i}",)
        for ln, ours in (("LayerNorm_0", "norm1"), ("LayerNorm_2", "norm2")):
            _set(tree, base + (ours, "scale"), get(f"{bp}{ln}/scale"))
            _set(tree, base + (ours, "bias"), get(f"{bp}{ln}/bias"))
        d = state[prefix + f"{mha}query/kernel"].shape[0]
        _set(tree, base + ("attn", "qkv", "kernel"), np.concatenate(
            [get(f"{mha}{n}/kernel").reshape(d, -1)
             for n in ("query", "key", "value")], axis=1))
        _set(tree, base + ("attn", "qkv", "bias"), np.concatenate(
            [get(f"{mha}{n}/bias").reshape(-1)
             for n in ("query", "key", "value")]))
        _set(tree, base + ("attn", "proj", "kernel"),
             get(f"{mha}out/kernel").reshape(-1, d))
        _set(tree, base + ("attn", "proj", "bias"), get(f"{mha}out/bias"))
        for r, fc in ((0, "fc1"), (1, "fc2")):
            _set(tree, base + ("mlp", fc, "kernel"),
                 get(f"{bp}MlpBlock_3/Dense_{r}/kernel"))
            _set(tree, base + ("mlp", fc, "bias"),
                 get(f"{bp}MlpBlock_3/Dense_{r}/bias"))
        i += 1
    if i == 0:
        raise ValueError(
            "no Transformer/encoderblock_* entries — not a Brain-Flax ViT "
            "checkpoint (hybrid-backbone .npz files are not supported)")
    return tree, sorted(set(state) - used)
