"""Augmentation on the card: the ImageNet train transform as batched
PyTorch over uint8 inputs (counterpart of
``tokenreduction_tpu/data/device_aug.py``).

The host only copies pre-decoded uint8 squares (``data/cache.py``,
``data/pipeline.py::make_raw_transform``) into batches; RandomResizedCrop,
hflip, RandAugment (rand-m9-mstd0.5-inc1), normalisation and
RandomErasing run on the card inside the train step, ahead of mixup. The
aug takes a uint8 batch [B, S, S, 3] on the card and returns normalised
fp32 NCHW [B, 3, size, size] on the same device.

Semantics are the JAX module's, with the deviations from PIL that it
documents:

- geometric resampling is bilinear (not bicubic), PIL's pixel-centre
  convention, the mean-grey fill ``FILL``;
- RandomResizedCrop draws its 10 candidate boxes at once and takes the
  first valid one (the same acceptance rule);
- the colour and enhance ops run in continuous [0, 255] (PIL quantises to
  uint8 between ops); the histogram ops (equalize, autocontrast,
  posterize, solarize) first round to integer bins, then apply PIL's
  exact integer LUTs;
- the RandAugment op index is drawn once per group of ``ra_group_size``
  images, and the rotate and shear ops of a group share its first
  image's sign and magnitude (JAX ``_rand_augment_batch``,
  ``_RA_GROUP_OPS``).

Each draw is separate from the transform it drives: every op is a plain
function of the images and explicit parameters (a box, a flip, a
magnitude, a sign, an erase box), and ``make_device_augment``'s ``aug``
draws those parameters from the ``torch.Generator`` it is given, on the
images' device, in bulk. Nothing reads a value back to the host. JAX draws
per image from split keys, which the port cannot reproduce: the
transforms agree at equal parameters, and the draws agree in
distribution. On the card the 15 RandAugment ops are each computed for
the whole batch and selected per group (a per-group branch would need the
op index on the host); the crop, the resize and the geometric ops are
batched matmuls with JAX's interpolation matrices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from tokenreduction_tpu_torch.parallel.mesh import (
    draw_rows,
    global_count,
    microbatch_rows,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MAX_LEVEL = 10.0
# round(255 * mean) per channel, as transforms.py's _FILL
FILL = (124.0, 116.0, 104.0)


@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    input_size: int = 224
    recipe: str = "imagenet"  # "imagenet": RRC+hflip+RA+erase;
    # "asl" (COCO/NUS-WIDE multilabel): square resize + CutoutPIL + RA
    aa: str = "rand-m9-mstd0.5-inc1"  # "" disables (NABirds)
    color_jitter: float = 0.0  # only when aa is disabled, as the host
    # recipe (pipeline.py train_fn)
    ra_group_size: int = 16  # images sharing one RA op draw
    hflip: float = 0.5
    reprob: float = 0.25
    recount: int = 1
    scale: tuple = (0.08, 1.0)
    ratio: tuple = (3 / 4, 4 / 3)
    crop_pct: float = 0.875  # eval only


def _col(v, x):
    """Per-image values [B] as [B, 1, 1, 1] in x's dtype."""
    return torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(
        -1, 1, 1, 1)


def _fill(x):
    return torch.tensor(FILL, dtype=x.dtype, device=x.device)


# --------------------------------------------------------------------------
# crop and resize: two interpolation matmuls per image
# --------------------------------------------------------------------------
def interp_matrix(out_size: int, in_size: int, start, length):
    """[B, out_size, in_size] PIL-bilinear rows resampling the source
    interval [start, start + length) (each [B]) to out_size pixels: the
    triangle filter's support scaled by the downscale ratio, each row
    renormalised (JAX ``_interp_matrix``)."""
    start = torch.as_tensor(start, dtype=torch.float32)
    length = torch.as_tensor(length, dtype=torch.float32,
                             device=start.device)
    scale = (length / out_size)[:, None, None]
    fscale = torch.clamp(scale, min=1.0)
    xo = torch.arange(out_size, dtype=torch.float32,
                      device=start.device) + 0.5
    center = start[:, None, None] + xo[None, :, None] * scale
    cols = torch.arange(in_size, dtype=torch.float32,
                        device=start.device) + 0.5
    d = (cols[None, None, :] - center) / fscale
    w = torch.clamp(1.0 - d.abs(), min=0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def crop_resize(imgs, top, left, h, w, out_size: int):
    """imgs [B, S, S, 3] float -> [B, out, out, 3]: each image's
    (top, left, h, w) box (each [B]) resized (JAX ``_crop_resize``)."""
    S = imgs.shape[1]
    ry = interp_matrix(out_size, S, top, h)    # [B, out, S]
    rx = interp_matrix(out_size, S, left, w)   # [B, out, S]
    t = torch.einsum("bos,bswc->bowc", ry, imgs)
    return torch.einsum("bpw,bowc->bopc", rx, t)


def rrc_boxes(gen, B: int, in_size: int, scale, ratio, device):
    """RandomResizedCrop's boxes (torchvision semantics, JAX ``_rrc_box``):
    10 tries an image drawn at once, the first valid one taken, else the
    whole image. Returns (top, left, h, w), each fp32 [B]."""
    H = W = in_size
    area = float(H * W)
    u = draw_rows(torch.rand, (B, 22), generator=gen, device=device)
    ta = area * (scale[0] + (scale[1] - scale[0]) * u[:, :10])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[:, 10:20])
    return rrc_from_draws(ta, aspect, u[:, 20], u[:, 21], in_size)


def rrc_from_draws(ta, aspect, u_i, u_j, in_size: int):
    """The RandomResizedCrop box from its draws: target areas ta and
    aspects [B, 10], the uniforms u_i and u_j [B] of the top-left corner."""
    H = W = float(in_size)
    w = torch.round(torch.sqrt(ta * aspect))
    h = torch.round(torch.sqrt(ta / aspect))
    valid = (w > 0) & (w <= W) & (h > 0) & (h <= H)
    idx = valid.to(torch.int32).argmax(1, keepdim=True)
    any_valid = valid.any(1)
    w = torch.where(any_valid, w.gather(1, idx)[:, 0], W)
    h = torch.where(any_valid, h.gather(1, idx)[:, 0], H)
    top = torch.where(any_valid, torch.floor(u_i * (H - h + 1.0)),
                      torch.floor((H - h) / 2))
    left = torch.where(any_valid, torch.floor(u_j * (W - w + 1.0)),
                       torch.floor((W - w) / 2))
    return top, left, h, w


def hflip(imgs, flip):
    """Images [B, H, W, 3] mirrored where flip [B] (bool) holds."""
    return torch.where(flip[:, None, None, None], imgs.flip(2), imgs)


# --------------------------------------------------------------------------
# geometric warps as interpolation matmuls (JAX _shift_matrix, _apply_x/y)
# --------------------------------------------------------------------------
def shift_matrix(n: int, offset):
    """[..., n_out, n_in] 2-tap bilinear sampling matrices for
    xin_centre = xout_centre + offset (PIL's AFFINE pixel-centre
    convention); ``offset`` [...] (a row's or an image's shift).
    Out-of-canvas taps weigh 0; the callers add the fill times
    1 - the row sum."""
    off = torch.as_tensor(offset, dtype=torch.float32)
    idx = torch.arange(n, dtype=torch.float32, device=off.device)
    d = (idx[None, :] - idx[:, None]) - off[..., None, None]
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _fill_rest(out, cov):
    return out + (1.0 - cov) * _fill(out)


def resample_x(imgs, m):
    """Each image [B, H, W, 3] resampled along x by its m [B, W, W]."""
    return _fill_rest(torch.einsum("bxu,byuc->byxc", m, imgs),
                      m.sum(-1)[:, None, :, None])


def resample_y(imgs, m):
    """Each image [B, H, W, 3] resampled along y by its m [B, H, H]."""
    return _fill_rest(torch.einsum("byv,bvxc->byxc", m, imgs),
                      m.sum(-1)[:, :, None, None])


def resample_x_rows(imgs5, m):
    """Groups [G, gs, H, W, 3] resampled along x, a matrix a row of each
    group: m [G, H, W, W]."""
    return _fill_rest(torch.einsum("gyxu,gsyuc->gsyxc", m, imgs5),
                      m.sum(-1)[:, None, :, :, None])


def resample_y_cols(imgs5, m):
    """Groups [G, gs, H, W, 3] resampled along y, a matrix a column of
    each group: m [G, W, H, H]."""
    return _fill_rest(torch.einsum("gxyv,gsvxc->gsyxc", m, imgs5),
                      m.sum(-1).transpose(1, 2)[:, None, :, :, None])


def translate(imgs, v, axis: str):
    """Each image [B, H, W, 3] shifted by its v [B] pixels along axis."""
    v = v.to(torch.float32)
    if axis == "x":
        return resample_x(imgs, shift_matrix(imgs.shape[2], v))
    return resample_y(imgs, shift_matrix(imgs.shape[1], v))


def _offsets(v, n: int, centre: float = 0.0):
    return v[:, None] * (torch.arange(n, dtype=torch.float32,
                                      device=v.device) + 0.5 - centre)


def shear(imgs5, v, axis: str):
    """Groups of images [G, gs, H, W, 3], each group sheared by its v [G]
    (PIL matrix (1, v, 0, ...) along x, its transpose along y)."""
    H, W = imgs5.shape[2], imgs5.shape[3]
    v = v.to(torch.float32)
    if axis == "x":
        return resample_x_rows(imgs5, shift_matrix(W, _offsets(v, H)))
    return resample_y_cols(imgs5, shift_matrix(H, _offsets(v, W)))


def rotate(imgs5, deg):
    """Groups of images [G, gs, H, W, 3], each group rotated by its deg [G]
    about the centre: three shear passes (Paeth), each an interpolation
    matmul (JAX ``_rotate_group``)."""
    a = -deg.to(torch.float32) * (math.pi / 180.0)
    H, W = imgs5.shape[2], imgs5.shape[3]
    mx = shift_matrix(W, _offsets(torch.tan(a / 2.0), H, H / 2.0))
    my = shift_matrix(H, _offsets(-torch.sin(a), W, W / 2.0))
    imgs5 = resample_x_rows(imgs5, mx)
    imgs5 = resample_y_cols(imgs5, my)
    return resample_x_rows(imgs5, mx)


# --------------------------------------------------------------------------
# colour, enhance and histogram ops; images [B, H, W, 3] in 0..255
# --------------------------------------------------------------------------
def to_bins(imgs):
    return torch.clamp(torch.round(imgs), 0, 255).to(torch.int64)


def autocontrast(imgs):
    """PIL ImageOps.autocontrast, cutoff 0: each channel stretched by the
    integer-truncated LUT; a constant channel stays as it is."""
    x = to_bins(imgs)
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    out = torch.clamp(torch.div((x - lo) * 255, torch.clamp(hi - lo, min=1),
                                rounding_mode="floor"), 0, 255)
    return torch.where(hi <= lo, imgs, out.to(imgs.dtype))


def equalize(imgs):
    """PIL ImageOps.equalize's integer LUT a channel:
    step = (n_pixels - count(max value)) // 255,
    lut[i] = (step // 2 + sum_{j<i} hist[j]) // step."""
    B, H, W, C = imgs.shape
    x = to_bins(imgs).permute(0, 3, 1, 2).reshape(B, C, H * W)
    hist = torch.zeros(B, C, 256, dtype=torch.int64, device=imgs.device)
    hist.scatter_add_(2, x, torch.ones_like(x))
    nz = hist > 0
    maxval = 255 - nz.flip(-1).to(torch.int32).argmax(-1, keepdim=True)
    step = torch.div(H * W - hist.gather(2, maxval.long()), 255,
                     rounding_mode="floor")
    csum = torch.cumsum(hist, -1) - hist
    lut = torch.clamp(torch.div(torch.div(step, 2, rounding_mode="floor")
                                + csum, torch.clamp(step, min=1),
                                rounding_mode="floor"), 0, 255)
    ident = (nz.sum(-1, keepdim=True) <= 1) | (step == 0)
    lut = torch.where(ident, torch.arange(256, device=imgs.device), lut)
    out = lut.gather(2, x).reshape(B, C, H, W).permute(0, 2, 3, 1)
    return out.to(imgs.dtype)


def invert(imgs):
    return 255.0 - imgs


def posterize(imgs, bits):
    """PIL posterize keeping the top bits [B] (int) of each pixel; 0 bits
    blacks the image, as PIL's does."""
    shift = torch.clamp(8 - bits, 0, 8)
    q = _col(torch.exp2(shift.to(torch.float32)), imgs)
    x = to_bins(imgs).to(imgs.dtype)
    return torch.floor(x / q) * q


def solarize(imgs, thresh):
    """PIL solarize: pixels >= thresh [B] inverted (256 = identity)."""
    x = to_bins(imgs).to(imgs.dtype)
    return torch.where(x < _col(thresh, imgs), x, 255.0 - x)


def solarize_add(imgs, add):
    x = to_bins(imgs).to(imgs.dtype)
    return torch.where(x < 128.0, torch.clamp(x + _col(add, imgs), 0, 255),
                       x)


def gray(imgs):
    """PIL "L": ITU-R 601-2 luma, [B, H, W]."""
    return (imgs[..., 0] * 299.0 + imgs[..., 1] * 587.0
            + imgs[..., 2] * 114.0) / 1000.0


def blend(degenerate, imgs, factor):
    return torch.clamp(degenerate + _col(factor, imgs) * (imgs - degenerate),
                       0.0, 255.0)


def color(imgs, factor):
    """PIL ImageEnhance.Color with factor [B]."""
    return blend(gray(imgs)[..., None], imgs, factor)


def contrast(imgs, factor):
    """PIL ImageEnhance.Contrast: the degenerate image is solid grey at
    int(mean(L) + 0.5), the mean summed in fp64 so that no device's
    summation order moves it across a rounding edge."""
    mean = torch.floor(gray(to_bins(imgs).to(imgs.dtype)).mean(
        dim=(1, 2), dtype=torch.float64) + 0.5).to(imgs.dtype)
    return blend(_col(mean, imgs), imgs, factor)


def brightness(imgs, factor):
    return blend(torch.zeros((), dtype=imgs.dtype, device=imgs.device),
                 imgs, factor)


def sharpness_degenerate(imgs):
    """PIL's SMOOTH kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 on the
    interior; the 1-pixel border stays as it is."""
    p = imgs
    s = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
         + p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] * 5.0 + p[:, 1:-1, 2:]
         + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]) / 13.0
    out = p.clone()
    out[:, 1:-1, 1:-1] = torch.clamp(s, 0.0, 255.0)
    return out


def sharpness(imgs, factor):
    return blend(sharpness_degenerate(imgs), imgs, factor)


# --------------------------------------------------------------------------
# RandAugment: each op takes (images, magnitudes [B], signs [B] of +-1,
# group size) in JAX _ra_op_table's order; the group ops read each group's
# first magnitude and sign
# --------------------------------------------------------------------------
def _level(mags, scale):
    return mags / MAX_LEVEL * scale


def _enhance_factor(mags, signs):
    # timm's increasing variant: 1 +- mag / 10 * 0.9
    return 1.0 + signs * _level(mags, 0.9)


def _enhance_factor_plain(mags):
    # timm's plain variant: [0.1, 1.9], never negated
    return _level(mags, 1.8) + 0.1


def _grouped(op, level: float):
    """An op of groups [G, gs, H, W, 3] at each group's first sign and
    magnitude, on images [B, H, W, 3]."""
    def run(imgs, mags, signs, gs):
        B = imgs.shape[0]
        out = op(imgs.reshape((B // gs, gs) + imgs.shape[1:]),
                 signs[::gs] * _level(mags[::gs], level))
        return out.reshape(imgs.shape)
    return run


def _shear_x(imgs5, v):
    return shear(imgs5, v, "x")


def _shear_y(imgs5, v):
    return shear(imgs5, v, "y")


def _translate_op(axis, frac=0.45):
    def op(imgs, mags, signs, gs):
        size = imgs.shape[2] if axis == "x" else imgs.shape[1]
        return translate(imgs, signs * _level(mags, int(size * frac)), axis)
    return op


def _posterize_inc(imgs, mags, signs, gs):
    # timm PosterizeIncreasing: bits 4..0
    return posterize(imgs, 4 - torch.floor(_level(mags, 4)).to(torch.int64))


def _posterize_plain(imgs, mags, signs, gs):
    return posterize(imgs, torch.floor(_level(mags, 4)).to(torch.int64))


def _solarize_inc(imgs, mags, signs, gs):
    # timm SolarizeIncreasing: truncate the level before subtracting
    return solarize(imgs, torch.clamp(
        256.0 - torch.floor(_level(mags, 256.0)), 0, 256))


def _solarize_plain(imgs, mags, signs, gs):
    return solarize(imgs, torch.clamp(torch.floor(_level(mags, 256.0)),
                                      0, 256))


def _solarize_add(imgs, mags, signs, gs):
    return solarize_add(imgs, torch.floor(_level(mags, 110.0)))


def _enhance(fn, inc: bool):
    def op(imgs, mags, signs, gs):
        f = _enhance_factor(mags, signs) if inc else \
            _enhance_factor_plain(mags)
        return fn(imgs, f)
    return op


def _plain_op(fn):
    return lambda imgs, mags, signs, gs: fn(imgs)


def ra_op_table(inc: bool):
    """The 15 ops by position, as JAX ``_ra_op_table`` (inc: timm's
    increasing level maps, else the plain ones)."""
    return (
        _plain_op(autocontrast), _plain_op(equalize), _plain_op(invert),
        _grouped(rotate, 30.0),
        _posterize_inc if inc else _posterize_plain,
        _solarize_inc if inc else _solarize_plain, _solarize_add,
        _enhance(color, inc), _enhance(contrast, inc),
        _enhance(brightness, inc), _enhance(sharpness, inc),
        _grouped(_shear_x, 0.3), _grouped(_shear_y, 0.3),
        _translate_op("x"), _translate_op("y"),
    )


def group_size(B: int, ra_group_size: int) -> int:
    """The largest divisor of B that is at most ra_group_size."""
    gs = max(1, min(ra_group_size, B))
    while B % gs:
        gs -= 1
    return gs


def rand_augment_apply(imgs, ops, op_idx, mags, signs, apply, gs: int):
    """One RandAugment round at explicit parameters: op_idx [B // gs] (one
    op a group), mags [B], signs [B] (+-1), apply [B] (bool: the
    per-image gate, None for always). Every op runs on the whole batch and
    each group keeps its own."""
    sel = op_idx.repeat_interleave(gs)[:, None, None, None]
    out = imgs
    for i, op in enumerate(ops):
        out = torch.where(sel == i, op(imgs, mags, signs, gs), out)
    if apply is not None:
        out = torch.where(apply[:, None, None, None], out, imgs)
    return out


def rand_augment(imgs, gen, num_ops: int, magnitude: float, mstd: float,
                 ra_group_size: int, inc: bool = True, prob: float = 0.5):
    """RandAugment over [B, H, W, 3] (JAX ``_rand_augment_batch``): per
    round, the op index drawn once a group, the magnitude (mstd noise, or
    uniform in [0, magnitude] when mstd is inf), the sign and the
    prob gate per image."""
    B = imgs.shape[0]
    gs = group_size(global_count(B), ra_group_size)
    if microbatch_rows(B) % gs:
        raise ValueError(
            f"RandAugment's groups of {gs} images straddle the ranks' "
            f"microbatches of {microbatch_rows(B)}: pick a batch size that "
            "--ra_group_size divides")
    ops = ra_op_table(inc)
    dev = imgs.device
    for _ in range(num_ops):
        op_idx = draw_rows(torch.randint, 0, len(ops), (B // gs,),
                           generator=gen, device=dev)
        u = draw_rows(torch.rand, (B, 3), generator=gen, device=dev)
        if math.isinf(mstd):
            mags = magnitude * u[:, 0]
        else:
            mags = torch.full((B,), magnitude, dtype=torch.float32,
                              device=dev)
            if mstd > 0:
                mags = mags + mstd * draw_rows(torch.randn, (B,),
                                               generator=gen, device=dev)
        mags = torch.clamp(mags, 0.0, MAX_LEVEL)
        signs = torch.where(u[:, 1] < 0.5, -1.0, 1.0)
        apply = u[:, 2] < prob if prob < 1.0 else None
        imgs = rand_augment_apply(imgs, ops, op_idx, mags, signs, apply, gs)
    return imgs


# --------------------------------------------------------------------------
# RandomErasing, CutoutPIL, colour jitter, normalisation
# --------------------------------------------------------------------------
def erase_boxes(gen, B: int, H: int, W: int, prob: float, count: int,
                device, area=(0.02, 1 / 3), ratio: float = 0.3):
    """RandomErasing's boxes (timm, JAX ``_random_erasing``): count boxes
    an image, 10 tries each, the first valid kept, all of an image's gated
    by one draw < prob. Returns [(top, left, h, w, ok)] a box, each [B]."""
    gate = draw_rows(torch.rand, (B,), generator=gen, device=device) < prob
    boxes = []
    for _ in range(count):
        u = draw_rows(torch.rand, (B, 22), generator=gen, device=device)
        a = (area[0] + (area[1] - area[0]) * u[:, :10]) * H * W / count
        lo, hi = math.log(ratio), math.log(1 / ratio)
        r = torch.exp(lo + (hi - lo) * u[:, 10:20])
        h = torch.round(torch.sqrt(a * r))
        w = torch.round(torch.sqrt(a / r))
        valid = (h < H) & (w < W)
        idx = valid.to(torch.int32).argmax(1, keepdim=True)
        h = h.gather(1, idx)[:, 0]
        w = w.gather(1, idx)[:, 0]
        top = torch.floor(u[:, 20] * (H - h + 1.0))
        left = torch.floor(u[:, 21] * (W - w + 1.0))
        boxes.append((top, left, h, w, valid.any(1) & gate))
    return boxes


def box_mask(H: int, W: int, top, left, h, w, ok, device):
    """[B, H, W, 1] bool: pixels inside each image's box where ok."""
    ys = torch.arange(H, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, None, :]
    box = ((ys >= top[:, None, None]) & (ys < (top + h)[:, None, None])
           & (xs >= left[:, None, None]) & (xs < (left + w)[:, None, None])
           & ok[:, None, None])
    return box[..., None]


def random_erasing(arr, gen, prob: float, count: int):
    """RandomErasing in timm's pixel mode on the normalised images
    [B, H, W, 3]: each box filled with standard normal noise."""
    if prob <= 0:
        return arr
    B, H, W, C = arr.shape
    for top, left, h, w, ok in erase_boxes(gen, B, H, W, prob, count,
                                           arr.device):
        noise = draw_rows(torch.randn, arr.shape, generator=gen,
                          device=arr.device, dtype=arr.dtype)
        arr = torch.where(box_mask(H, W, top, left, h, w, ok, arr.device),
                          noise, arr)
    return arr


def cutout(imgs, y, x, rgb, factor: float = 0.5):
    """ASL CutoutPIL (transforms.py:279): one box of colour rgb [B, 3]
    with sides factor * the image's, centred at pixel (y, x) (each [B]),
    clipped."""
    B, H, W, _ = imgs.shape
    h, w = int(factor * H + 0.5), int(factor * W + 0.5)
    ys = torch.arange(H, device=imgs.device)[None, :, None]
    xs = torch.arange(W, device=imgs.device)[None, None, :]
    y, x = y[:, None, None], x[:, None, None]
    box = ((ys >= y - h // 2) & (ys < y + h // 2)
           & (xs >= x - w // 2) & (xs < x + w // 2))
    return torch.where(box[..., None], rgb[:, None, None, :].to(imgs.dtype),
                       imgs)


def color_jitter_apply(imgs, order, factors):
    """transforms.py::color_jitter in continuous 0..255: brightness (0),
    contrast (1) and saturation (2) in each image's order [B, 3] by its
    factors [B, 3]."""
    for i in range(3):
        idx = order[:, i][:, None, None, None]
        f = factors[:, i]
        imgs = torch.where(idx == 0, brightness(imgs, f),
                           torch.where(idx == 1, contrast(imgs, f),
                                       color(imgs, f)))
    return imgs


def parse_ra(config: str):
    """'rand-m9-mstd0.5-inc1' -> (num_ops, magnitude, mstd, inc, prob),
    through the host parser (``transforms.py::parse_rand_augment``) so that
    the two recipes cannot drift; '' disables. Other --aa grammars exist
    on the host path only and raise."""
    if not config:
        return 0, 0.0, 0.0, False, 0.5
    if not config.startswith("rand"):
        raise ValueError(
            f"device-side augmentation supports the 'rand-*' --aa grammar "
            f"only (got {config!r}); drop --device_aug to run AutoAugment/"
            "augmix policies on the host pipeline")
    from tokenreduction_tpu_torch.data.transforms import parse_rand_augment

    return parse_rand_augment(config)


def normalize_01(imgs_255):
    mean = torch.tensor(IMAGENET_MEAN, dtype=imgs_255.dtype,
                        device=imgs_255.device)
    std = torch.tensor(IMAGENET_STD, dtype=imgs_255.dtype,
                       device=imgs_255.device)
    return ((imgs_255 / 255.0) - mean) / std


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def make_device_augment(cfg: DeviceAugConfig):
    """``aug(batch_u8, generator)``: uint8 [B, S, S, 3] on a device ->
    normalised fp32 [B, 3, size, size] on it, every draw from
    ``generator`` (on the same device)."""
    num_ops, magnitude, mstd, inc, ra_prob = parse_ra(cfg.aa)
    size = cfg.input_size
    asl = cfg.recipe == "asl"

    def aug(batch_u8, generator: Optional[torch.Generator]):
        if generator is None:
            raise ValueError("the device augmentation draws from an "
                             "explicit torch.Generator: pass generator=")
        dev = batch_u8.device
        B, S = batch_u8.shape[0], batch_u8.shape[1]
        imgs = batch_u8.to(torch.float32)
        if asl:  # fixed square resize + CutoutPIL
            zero = torch.zeros(B, device=dev)
            full = torch.full((B,), float(S), device=dev)
            imgs = crop_resize(imgs, zero, zero, full, full, size)
            yx = draw_rows(torch.randint, 0, size, (B, 2),
                           generator=generator, device=dev)
            rgb = draw_rows(torch.randint, 0, 256, (B, 3),
                            generator=generator, device=dev)
            imgs = cutout(imgs, yx[:, 0], yx[:, 1], rgb)
        else:
            top, left, h, w = rrc_boxes(generator, B, S, cfg.scale,
                                        cfg.ratio, dev)
            imgs = crop_resize(imgs, top, left, h, w, size)
            if cfg.hflip > 0:
                flip = draw_rows(torch.rand, (B,), generator=generator,
                                 device=dev) < cfg.hflip
                imgs = hflip(imgs, flip)
        if num_ops > 0:
            imgs = rand_augment(imgs, generator, num_ops, magnitude, mstd,
                                cfg.ra_group_size, inc=inc, prob=ra_prob)
        elif not asl and cfg.color_jitter > 0:
            order = draw_rows(torch.rand, (B, 3), generator=generator,
                              device=dev).argsort(1)
            lo = max(0.0, 1.0 - cfg.color_jitter)
            factors = lo + (1.0 + cfg.color_jitter - lo) * draw_rows(
                torch.rand, (B, 3), generator=generator, device=dev)
            imgs = color_jitter_apply(imgs, order, factors)
        arr = normalize_01(imgs)
        if not asl:
            arr = random_erasing(arr, generator, cfg.reprob, cfg.recount)
        return _nchw(arr)

    return aug


def make_device_eval_transform(cfg: DeviceAugConfig):
    """``tf(batch_u8)``: the eval transform from cached squares (JAX
    ``make_device_eval_transform``): resize to floor(size / crop_pct),
    centre crop, normalise, as fp32 NCHW; the ASL recipe a plain square
    resize. Draws nothing."""
    size = cfg.input_size
    scale_size = (size if cfg.recipe == "asl"
                  else int(math.floor(size / cfg.crop_pct)))

    def tf(batch_u8):
        B, S = batch_u8.shape[0], batch_u8.shape[1]
        dev = batch_u8.device
        zero = torch.zeros(B, device=dev)
        full = torch.full((B,), float(S), device=dev)
        imgs = crop_resize(batch_u8.to(torch.float32), zero, zero, full,
                           full, scale_size)
        off = (scale_size - size) // 2
        imgs = imgs[:, off:off + size, off:off + size]
        return _nchw(normalize_01(imgs))

    return tf
