"""Host-side image transforms (numpy + PIL), replacing the torchvision/timm
transform stack (reference datasets.py:40-143, aug_factory.py:5-24).

Every transform takes (PIL.Image | np.ndarray, np.random.Generator) so the
pipeline is explicitly seeded -- no hidden global RNG.

The port's copy of ``tokenreduction_tpu/data/transforms.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

IMAGENET_DEFAULT_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_DEFAULT_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_INTERP = {
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "nearest": Image.NEAREST,
    "lanczos": Image.LANCZOS,
}


def interp(name: str):
    return _INTERP.get(name, Image.BICUBIC)


def to_float_array(img: Image.Image) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1]."""
    return np.asarray(img, dtype=np.float32) / 255.0


def normalize(arr: np.ndarray) -> np.ndarray:
    return (arr - IMAGENET_DEFAULT_MEAN) / IMAGENET_DEFAULT_STD


# --------------------------------------------------------------------------
# geometric
# --------------------------------------------------------------------------
def random_resized_crop(
    img: Image.Image,
    rng: np.random.Generator,
    size: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    interpolation: str = "bicubic",
) -> Image.Image:
    """torchvision RandomResizedCrop semantics."""
    W, H = img.size
    area = H * W
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            i = int(rng.integers(0, H - h + 1))
            j = int(rng.integers(0, W - w + 1))
            return img.resize((size, size), interp(interpolation),
                              box=(j, i, j + w, i + h))
    # fallback: center crop
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    i, j = (H - h) // 2, (W - w) // 2
    return img.resize((size, size), interp(interpolation),
                      box=(j, i, j + w, i + h))


def resize_center_crop(img: Image.Image, size: int, crop_pct: float = 0.875,
                       interpolation: str = "bicubic") -> Image.Image:
    """timm eval transform: resize shorter side to size/crop_pct, center
    crop to size."""
    scale_size = int(math.floor(size / crop_pct))
    W, H = img.size
    if W <= H:
        nw, nh = scale_size, int(round(scale_size * H / W))
    else:
        nh, nw = scale_size, int(round(scale_size * W / H))
    img = img.resize((nw, nh), interp(interpolation))
    left = (nw - size) // 2
    top = (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def resize_square(img: Image.Image, size: int,
                  interpolation: str = "bicubic") -> Image.Image:
    """ASL-style fixed Resize((size, size)) (reference datasets.py:64,75)."""
    return img.resize((size, size), interp(interpolation))


def maybe_hflip(img: Image.Image, rng, prob: float = 0.5) -> Image.Image:
    if rng.random() < prob:
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


# --------------------------------------------------------------------------
# color jitter
# --------------------------------------------------------------------------
def color_jitter(img: Image.Image, rng, factor: float) -> Image.Image:
    """brightness/contrast/saturation jitter by +-factor, random order."""
    if factor <= 0:
        return img
    ops = [ImageEnhance.Brightness, ImageEnhance.Contrast,
           ImageEnhance.Color]
    order = rng.permutation(len(ops))
    for k in order:
        f = float(rng.uniform(max(0.0, 1 - factor), 1 + factor))
        img = ops[k](img).enhance(f)
    return img


# --------------------------------------------------------------------------
# RandAugment / AutoAugment / AugMix
#
# The reference passes --aa verbatim into timm
# create_transform(auto_augment=...) (reference datasets.py:84-110,
# train.py:100 default 'rand-m9-mstd0.5-inc1'), so the full grammar is
# part of the CLI contract: 'rand-*' (RandAugment), 'augmix-*' (AugMix),
# and the named AutoAugment policies 'original[r]' / 'v0[r]'. Op names
# and level maps below follow timm auto_augment.py; anything outside the
# grammar raises ValueError (a silent no-op would train with the wrong
# recipe).
# --------------------------------------------------------------------------
_MAX_LEVEL = 10.0
_FILL = tuple(int(min(255, round(255 * m))) for m in IMAGENET_DEFAULT_MEAN)


def _rotate(img, mag, rng):
    deg = mag / _MAX_LEVEL * 30.0
    if rng.random() < 0.5:
        deg = -deg
    return img.rotate(deg, resample=Image.BICUBIC, fillcolor=_FILL)


def _shear(img, mag, rng, axis):
    v = mag / _MAX_LEVEL * 0.3
    if rng.random() < 0.5:
        v = -v
    mat = (1, v, 0, 0, 1, 0) if axis == "x" else (1, 0, 0, v, 1, 0)
    return img.transform(img.size, Image.AFFINE, mat,
                         resample=Image.BICUBIC, fillcolor=_FILL)


def _translate(img, mag, rng, axis, const):
    v = mag / _MAX_LEVEL * const
    if rng.random() < 0.5:
        v = -v
    mat = (1, 0, v, 0, 1, 0) if axis == "x" else (1, 0, 0, 0, 1, v)
    return img.transform(img.size, Image.AFFINE, mat,
                         resample=Image.BICUBIC, fillcolor=_FILL)


def _enhance_inc(cls):
    """'Increasing' enhance variants: strength grows away from the
    identity factor 1.0 in a random direction (timm
    _enhance_increasing_level_to_arg)."""

    def f(img, mag, rng):
        v = mag / _MAX_LEVEL * 0.9
        if rng.random() < 0.5:
            v = -v
        return cls(img).enhance(max(0.1, 1.0 + v))

    return f


def _enhance_fixed(cls):
    """Plain enhance variants (AutoAugment policies / non-inc
    RandAugment): factor in [0.1, 1.9] monotone in magnitude, never
    negated (timm _enhance_level_to_arg)."""

    def f(img, mag, rng):
        return cls(img).enhance(mag / _MAX_LEVEL * 1.8 + 0.1)

    return f


def _posterize_bits(img, bits: int):
    # PIL accepts bits=0 (all-black) which timm's level maps can produce
    # at magnitude 10; keep that quirk rather than clamping it away.
    if bits >= 8:
        return img
    return ImageOps.posterize(img, max(0, min(8, int(bits))))


def _posterize_plain(img, mag, rng):
    # timm 'Posterize' (TF EfficientNet map): bits 0..4, severity
    # DECREASES with magnitude (used by non-inc RandAugment and policy v0)
    return _posterize_bits(img, int(mag / _MAX_LEVEL * 4))


def _posterize_original(img, mag, rng):
    # AutoAugment-paper map ('original' policy): bits 4..8, severity
    # decreases with magnitude
    return _posterize_bits(img, int(mag / _MAX_LEVEL * 4) + 4)


def _posterize_increasing(img, mag, rng):
    # timm 'PosterizeIncreasing': bits 4..0, severity increases with
    # magnitude (the inc1 / 'r'-policy variant)
    return _posterize_bits(img, 4 - int(mag / _MAX_LEVEL * 4))


def _solarize_increasing(img, mag, rng):
    # timm 'SolarizeIncreasing': threshold 256..0; 256 (mag 0) is the
    # identity (PIL inverts pixels >= threshold)
    thresh = 256 - int(mag / _MAX_LEVEL * 256)
    return ImageOps.solarize(img, max(0, thresh))


def _solarize_plain(img, mag, rng):
    # timm 'Solarize': threshold 0..256, severity DECREASES with
    # magnitude (mag 10 is the identity)
    return ImageOps.solarize(img, min(256, int(mag / _MAX_LEVEL * 256)))


def _solarize_add(img, mag, rng):
    add = int(mag / _MAX_LEVEL * 110)
    arr = np.asarray(img).astype(np.int32)
    arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


def _autocontrast(img, mag, rng):
    return ImageOps.autocontrast(img)


def _equalize(img, mag, rng):
    return ImageOps.equalize(img)


def _invert(img, mag, rng):
    return ImageOps.invert(img)


def _op_table(translate_const: int):
    """name -> fn(img, mag, rng). Names and level maps follow timm
    auto_augment.py (the backend of reference datasets.py:84-110).
    TranslateX/Y use the absolute translate_const the factory derives as
    int(img_size * 0.45) -- identical to timm's TranslateXRel at
    translate_pct=0.45 on the square post-crop images this pipeline
    feeds."""
    return {
        "AutoContrast": _autocontrast,
        "Equalize": _equalize,
        "Invert": _invert,
        "Rotate": _rotate,
        "Posterize": _posterize_plain,
        "PosterizeIncreasing": _posterize_increasing,
        "PosterizeOriginal": _posterize_original,
        "Solarize": _solarize_plain,
        "SolarizeIncreasing": _solarize_increasing,
        "SolarizeAdd": _solarize_add,
        "Color": _enhance_fixed(ImageEnhance.Color),
        "ColorIncreasing": _enhance_inc(ImageEnhance.Color),
        "Contrast": _enhance_fixed(ImageEnhance.Contrast),
        "ContrastIncreasing": _enhance_inc(ImageEnhance.Contrast),
        "Brightness": _enhance_fixed(ImageEnhance.Brightness),
        "BrightnessIncreasing": _enhance_inc(ImageEnhance.Brightness),
        "Sharpness": _enhance_fixed(ImageEnhance.Sharpness),
        "SharpnessIncreasing": _enhance_inc(ImageEnhance.Sharpness),
        "ShearX": lambda i, m, r: _shear(i, m, r, "x"),
        "ShearY": lambda i, m, r: _shear(i, m, r, "y"),
        "TranslateX":
            lambda i, m, r: _translate(i, m, r, "x", translate_const),
        "TranslateY":
            lambda i, m, r: _translate(i, m, r, "y", translate_const),
    }


# timm _RAND_TRANSFORMS / _RAND_INCREASING_TRANSFORMS op sets (the
# device-side table data/device_aug.py::_ra_op_table mirrors these by
# position -- keep the order in sync)
_RAND_NAMES_PLAIN = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
)
_RAND_NAMES_INC = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateX", "TranslateY",
)


def rand_augment_ops(translate_const: int, inc: bool = True):
    table = _op_table(translate_const)
    names = _RAND_NAMES_INC if inc else _RAND_NAMES_PLAIN
    return [(n, table[n]) for n in names]


def parse_rand_augment(config: str):
    """Parse timm's 'rand-m9-mstd0.5-inc1' grammar ->
    (num_ops, magnitude, mstd, inc, prob).

    Follows timm rand_augment_transform token-for-token: m (magnitude,
    default 10), n (ops per image, default 2), mstd (magnitude noise;
    >100 means uniform-in-[0, m], returned as inf), inc (op set; timm
    evaluates bool("0") so ANY inc token -- including inc0 -- selects the
    increasing set: replicated, documented quirk), p (per-op apply
    probability, default 0.5 as in timm rand_augment_ops). 'w' choice-
    weight sets and any unknown token raise ValueError instead of
    silently changing the recipe."""
    num_ops, magnitude, mstd, inc, prob = 2, 10.0, 0.0, False, 0.5
    for part in config.split("-")[1:]:
        if part.startswith("mstd"):
            mstd = float(part[4:])
            if mstd > 100:
                mstd = float("inf")
        elif part.startswith("mmax"):
            if float(part[4:]) != _MAX_LEVEL:
                raise ValueError(
                    f"rand-augment mmax != {_MAX_LEVEL:g} not supported "
                    f"(got {part!r})")
        elif part.startswith("inc"):
            inc = bool(part[3:])  # timm quirk: 'inc0' == 'inc1'
        elif part.startswith("m"):
            magnitude = float(part[1:])
        elif part.startswith("n"):
            num_ops = int(part[1:])
        elif part.startswith("p"):
            prob = float(part[1:])
        else:
            raise ValueError(
                f"unsupported rand-augment token {part!r} in {config!r} "
                "(supported: m, n, mstd, mmax, inc, p)")
    return num_ops, magnitude, mstd, inc, prob


def _draw_magnitude(rng, magnitude: float, mstd: float) -> float:
    if mstd > 0:
        if math.isinf(mstd):
            magnitude = float(rng.uniform(0.0, magnitude))
        else:
            magnitude = float(rng.normal(magnitude, mstd))
    return max(0.0, min(_MAX_LEVEL, magnitude))


def rand_augment(img: Image.Image, rng, config: str,
                 img_size: int) -> Image.Image:
    if not config:
        return img
    if not config.startswith("rand"):
        raise ValueError(
            f"rand_augment got non-rand config {config!r}; use "
            "make_aa_transform for the full --aa grammar")
    num_ops, magnitude, mstd, inc, prob = parse_rand_augment(config)
    ops = rand_augment_ops(translate_const=int(img_size * 0.45), inc=inc)
    for _ in range(num_ops):
        name, fn = ops[int(rng.integers(0, len(ops)))]
        if prob < 1.0 and rng.random() > prob:
            continue
        img = fn(img, _draw_magnitude(rng, magnitude, mstd), rng)
    return img


# AutoAugment ImageNet policies, (op, prob, magnitude) pairs
# (timm auto_augment_policy_v0 / _original; 'r' variants swap the
# posterize op for PosterizeIncreasing as timm's do).
_AA_POLICY_V0 = (
    (("Equalize", 0.8, 1), ("ShearY", 0.8, 4)),
    (("Color", 0.4, 9), ("Equalize", 0.6, 3)),
    (("Color", 0.4, 1), ("Rotate", 0.6, 8)),
    (("Solarize", 0.8, 3), ("Equalize", 0.4, 7)),
    (("Solarize", 0.4, 2), ("Solarize", 0.6, 2)),
    (("Color", 0.2, 0), ("Equalize", 0.8, 8)),
    (("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)),
    (("ShearX", 0.2, 9), ("Rotate", 0.6, 8)),
    (("Color", 0.6, 1), ("Equalize", 1.0, 2)),
    (("Invert", 0.4, 9), ("Rotate", 0.6, 0)),
    (("Equalize", 1.0, 9), ("ShearY", 0.6, 3)),
    (("Color", 0.4, 7), ("Equalize", 0.6, 0)),
    (("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)),
    (("Solarize", 0.6, 8), ("Color", 0.6, 9)),
    (("Solarize", 0.2, 4), ("Rotate", 0.8, 9)),
    (("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)),
    (("ShearX", 0.0, 0), ("Solarize", 0.8, 4)),
    (("ShearY", 0.8, 0), ("Color", 0.6, 4)),
    (("Color", 1.0, 0), ("Rotate", 0.6, 2)),
    (("Equalize", 0.8, 4), ("Equalize", 0.0, 8)),
    (("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)),
    (("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)),
    (("Posterize", 0.8, 2), ("Solarize", 0.6, 10)),
    (("Solarize", 0.6, 8), ("Equalize", 0.6, 1)),
    (("Color", 0.8, 6), ("Rotate", 0.4, 5)),
)
_AA_POLICY_ORIGINAL = (
    (("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
)


def auto_augment_policy(name: str):
    """timm auto_augment_policy: 'original', 'originalr', 'v0', 'v0r'."""
    def swap(policy, old, new):
        return tuple(
            tuple((new if op == old else op, p, m) for op, p, m in sub)
            for sub in policy)

    if name == "v0":
        return _AA_POLICY_V0
    if name == "v0r":
        return swap(_AA_POLICY_V0, "Posterize", "PosterizeIncreasing")
    if name == "original":
        return _AA_POLICY_ORIGINAL
    if name == "originalr":
        return swap(_AA_POLICY_ORIGINAL, "PosterizeOriginal",
                    "PosterizeIncreasing")
    raise ValueError(
        f"unknown AutoAugment policy {name!r} "
        "(supported: original, originalr, v0, v0r)")


def auto_augment(img: Image.Image, rng, policy, mstd: float,
                 img_size: int) -> Image.Image:
    """Apply one randomly chosen sub-policy (timm AutoAugment.__call__)."""
    table = _op_table(int(img_size * 0.45))
    sub = policy[int(rng.integers(0, len(policy)))]
    for name, prob, mag in sub:
        if prob < 1.0 and rng.random() > prob:
            continue
        img = table[name](img, _draw_magnitude(rng, float(mag), mstd), rng)
    return img


# timm _AUGMIX_TRANSFORMS (translate const comes from translate_pct=0.3,
# set by the transform factory for augmix only)
_AUGMIX_NAMES = (
    "AutoContrast", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing", "Equalize", "Rotate",
    "PosterizeIncreasing", "SolarizeIncreasing", "ShearX", "ShearY",
    "TranslateX", "TranslateY",
)


def parse_augmix(config: str):
    """'augmix-m3-w3-d-1-a1-mstd...' -> (magnitude, width, depth, alpha,
    mstd). Defaults follow timm augment_and_mix_transform, including the
    magnitude_std default of inf (uniform magnitude sampling). The 'b1'
    blended-mode approximation is rejected rather than silently ignored."""
    magnitude, width, depth, alpha = 3.0, 3, -1, 1.0
    mstd = float("inf")
    for part in config.split("-")[1:]:
        if part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("m"):
            magnitude = float(part[1:])
        elif part.startswith("w"):
            width = int(part[1:])
        elif part.startswith("d"):
            depth = int(part[1:])
        elif part.startswith("a"):
            alpha = float(part[1:])
        elif part.startswith("b"):
            raise ValueError(
                "augmix blended mode ('b' token) is not supported")
        else:
            raise ValueError(
                f"unsupported augmix token {part!r} in {config!r}")
    return magnitude, width, depth, alpha, mstd


def augmix(img: Image.Image, rng, config: str,
           img_size: int) -> Image.Image:
    """AugMix (Hendrycks et al. 2020) as timm AugMixAugment._apply_basic:
    `width` op chains of depth 1-3, Dirichlet(alpha)-weighted pixel mix,
    then Beta(alpha, alpha) blend with the original image."""
    magnitude, width, depth, alpha, mstd = parse_augmix(config)
    table = _op_table(int(img_size * 0.3))
    ws = rng.dirichlet([alpha] * width).astype(np.float32)
    m = float(rng.beta(alpha, alpha))
    mixed = np.zeros((img.size[1], img.size[0], len(img.getbands())),
                     np.float32)
    for w in ws:
        d = depth if depth > 0 else int(rng.integers(1, 4))
        img_aug = img
        for _ in range(d):
            name = _AUGMIX_NAMES[int(rng.integers(0, len(_AUGMIX_NAMES)))]
            img_aug = table[name](
                img_aug, _draw_magnitude(rng, magnitude, mstd), rng)
        mixed += w * np.asarray(img_aug, np.float32)
    mixed = Image.fromarray(np.clip(mixed, 0, 255).astype(np.uint8))
    return Image.blend(img, mixed, m)


def make_aa_transform(config: str, img_size: int):
    """--aa dispatcher mirroring timm create_transform's auto_augment
    branch (reference datasets.py:84-110): 'rand-*' -> RandAugment,
    'augmix-*' -> AugMix, otherwise a named AutoAugment policy with an
    optional '-mstd' suffix. Returns None for an empty config, else a
    callable (img, rng) -> img; unknown grammar raises ValueError at
    construction time."""
    if not config:
        return None
    if config.startswith("rand"):
        parse_rand_augment(config)  # validate tokens eagerly
        return lambda img, rng: rand_augment(img, rng, config, img_size)
    if config.startswith("augmix"):
        parse_augmix(config)
        return lambda img, rng: augmix(img, rng, config, img_size)
    parts = config.split("-")
    policy = auto_augment_policy(parts[0])
    mstd = 0.0
    for part in parts[1:]:
        if part.startswith("mstd"):
            mstd = float(part[4:])
        else:
            raise ValueError(
                f"unsupported AutoAugment token {part!r} in {config!r} "
                "(only '-mstd' is accepted after a policy name)")
    return lambda img, rng: auto_augment(img, rng, policy, mstd, img_size)


# --------------------------------------------------------------------------
# erasing / cutout
# --------------------------------------------------------------------------
def random_erasing(arr: np.ndarray, rng, prob: float = 0.25,
                   mode: str = "pixel", count: int = 1,
                   area: Tuple[float, float] = (0.02, 1 / 3),
                   ratio: float = 0.3) -> np.ndarray:
    """timm RandomErasing on the normalized HWC array."""
    if prob <= 0 or rng.random() >= prob:
        return arr
    H, W, C = arr.shape
    arr = arr.copy()
    for _ in range(count):
        for _ in range(10):
            a = rng.uniform(area[0], area[1]) * H * W / count
            log_r = (math.log(ratio), math.log(1 / ratio))
            r = math.exp(rng.uniform(*log_r))
            h = int(round(math.sqrt(a * r)))
            w = int(round(math.sqrt(a / r)))
            if h < H and w < W:
                top = int(rng.integers(0, H - h + 1))
                left = int(rng.integers(0, W - w + 1))
                if mode == "pixel":
                    arr[top:top + h, left:left + w] = rng.normal(
                        size=(h, w, C)).astype(np.float32)
                else:
                    arr[top:top + h, left:left + w] = 0.0
                break
    return arr


def cutout_pil(img: Image.Image, rng, cutout_factor: float = 0.5) -> Image.Image:
    """ASL CutoutPIL (reference aug_factory.py:5-24): one random-color box
    with side ~ factor * image side."""
    from PIL import ImageDraw

    draw = ImageDraw.Draw(img)
    W, H = img.size
    h = int(cutout_factor * H + 0.5)
    w = int(cutout_factor * W + 0.5)
    y = int(rng.integers(0, H))
    x = int(rng.integers(0, W))
    y0, y1 = max(0, y - h // 2), min(H, y + h // 2)
    x0, x1 = max(0, x - w // 2), min(W, x + w // 2)
    color = tuple(int(v) for v in rng.integers(0, 256, 3))
    draw.rectangle((x0, y0, x1, y1), fill=color)
    return img


def three_augment(img: Image.Image, rng) -> Image.Image:
    """DeiT-III ThreeAugment (reference --ThreeAugment flag): one of
    grayscale / solarize / gaussian blur per image."""
    from PIL import ImageFilter

    choice = int(rng.integers(0, 3))
    if choice == 0:
        return img.convert("L").convert("RGB")
    if choice == 1:
        return ImageOps.solarize(img, 128)
    return img.filter(ImageFilter.GaussianBlur(
        radius=float(rng.uniform(0.1, 2.0))))
