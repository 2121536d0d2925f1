"""The port's augmentation on the card (data/device_aug.py) against the JAX
package's, on the CPU.

Every op of the port is a plain function of the images and explicit
parameters; JAX's draw them from keys. So each JAX function runs on its
key, and the port's function takes the values that JAX drew from that key
(the same ``jax.random`` calls, made here): signs from JAX's ``_rand_sign``,
boxes, flips, op indices, magnitudes, gates and noise. Bounds: the LUT ops
(autocontrast, equalize, invert, posterize, solarize, solarize-add) and
the box geometry exactly; the crop and resize, the eval transform, the
enhance ops, colour jitter and the geometric ops (rotate, shear, translate)
within 1e-4 of 255 (the same interpolation matrices, fp32 sums in other
orders). The whole pipeline from a seed: shapes, dtype, range and
determinism. The port's own draws against JAX's in distribution:
RandomResizedCrop's boxes, the op picks and the magnitudes, by scipy's
two-sample KS test over 4096 draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tokenreduction_tpu.data import device_aug as J
from tokenreduction_tpu_torch.data import device_aug as P
from torch_threads import one_torch_thread  # noqa: F401

B, S, SIZE = 6, 40, 32
LEVELS = 1e-4 * 255  # the float ops' bound, in levels of 0..255


@pytest.fixture(scope="module")
def u8():
    return np.random.default_rng(0).integers(0, 256, (B, S, S, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def imgs():
    """Images in 0..255 at the crop's output size, with flat and skewed
    channels for the histogram ops' edge cases."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    x[0, ..., 1] = 77.0  # constant channel: autocontrast's identity
    x[1] = np.clip(rng.normal(30, 4, (SIZE, SIZE, 3)), 0, 255)  # skewed
    return x


def keys(seed, n=B):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def signs_of(ks):
    return np.array([float(J._rand_sign(k, 1.0)) for k in ks], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def group_ref(op, x, mags, ks):
    return np.asarray(jax.jit(op)(jnp.asarray(x), jnp.asarray(mags), ks))


def image_ref(op, x, mags, ks):
    return np.asarray(jax.jit(jax.vmap(op))(jnp.asarray(x),
                                            jnp.asarray(mags), ks))


LUT = (0, 1, 2, 4, 5, 6)
ENHANCE = (7, 8, 9, 10)
GEOMETRIC = (3, 11, 12, 13, 14)


@pytest.mark.parametrize("inc", [True, False])
@pytest.mark.parametrize("i", LUT + ENHANCE + GEOMETRIC)
def test_ra_op_matches_jax(imgs, inc, i):
    """Each RandAugment op of both tables at per-image magnitudes (and
    10, the posterize-to-zero edge): the LUT ops equal, the others within
    1e-4 of 255. The group ops (rotate, shears) take the group's first
    sign and magnitude on both sides."""
    ks = keys(10 + i)
    mags = np.random.default_rng(i).uniform(0, 10, B).astype(np.float32)
    mags[-1] = 10.0
    if i in J._RA_GROUP_OPS:
        want = group_ref(J._RA_GROUP_OPS[i], imgs, mags, ks)
        gs = B
    else:
        want = image_ref(J._ra_op_table(inc)[i], imgs, mags, ks)
        gs = 1
    got = P.ra_op_table(inc)[i](t(imgs), t(mags), t(signs_of(ks)),
                                gs).numpy()
    if i in LUT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=LEVELS)


def test_crop_resize_and_flip_match_jax(u8):
    """The crop and resize of each image's box (whole image, downscales,
    an upscale) and the mirror."""
    x = u8.astype(np.float32)
    top = np.array([0, 3, 5, 1, 12, 7], np.float32)
    left = np.array([0, 9, 2, 4, 12, 0], np.float32)
    h = np.array([40, 20, 13, 30, 16, 33], np.float32)
    w = np.array([40, 25, 13, 36, 16, 11], np.float32)
    crop = jax.jit(J._crop_resize, static_argnums=5)
    want = np.stack([np.asarray(crop(jnp.asarray(x[i]), top[i], left[i],
                                     h[i], w[i], SIZE)) for i in range(B)])
    got = P.crop_resize(t(x), t(top), t(left), t(h), t(w), SIZE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVELS)
    flip = torch.tensor([True, False, True, False, False, True])
    flipped = P.hflip(got, flip).numpy()
    for i in range(B):
        ref = want[i][:, ::-1] if flip[i] else want[i]
        np.testing.assert_allclose(flipped[i], ref, rtol=0, atol=LEVELS)


@pytest.mark.parametrize("recipe", ["imagenet", "asl"])
def test_eval_transform_matches_jax(u8, recipe):
    """Resize to floor(size / crop_pct) and centre crop (ASL: a square
    resize), normalised: within 1e-4 of 255 before the normalisation."""
    want = np.asarray(J.make_device_eval_transform(J.DeviceAugConfig(
        input_size=SIZE, recipe=recipe))(jnp.asarray(u8)))
    got = P.make_device_eval_transform(P.DeviceAugConfig(
        input_size=SIZE, recipe=recipe))(t(u8))
    assert got.shape == (B, 3, SIZE, SIZE) and got.dtype == torch.float32
    atol = LEVELS / 255 / min(P.IMAGENET_STD)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=atol)


def rrc_draws(key, in_size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """The values JAX's _rrc_box draws from key."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ta = float(in_size * in_size) * jax.random.uniform(
        k1, (10,), minval=scale[0], maxval=scale[1])
    aspect = jnp.exp(jax.random.uniform(
        k2, (10,), minval=math.log(ratio[0]), maxval=math.log(ratio[1])))
    return (np.asarray(ta), np.asarray(aspect),
            float(jax.random.uniform(k3, ())), float(jax.random.uniform(
                k4, ())))


@pytest.mark.parametrize("scale", [(0.08, 1.0), (1.5, 2.0)])
def test_rrc_box_matches_jax_at_its_draws(scale):
    """The first valid of the 10 tries, and the centred whole image when
    none is valid (scale above 1)."""
    ks = keys(3, 64)
    draws = [rrc_draws(k, S, scale) for k in ks]
    got = P.rrc_from_draws(
        torch.tensor(np.stack([d[0] for d in draws])),
        torch.tensor(np.stack([d[1] for d in draws])),
        torch.tensor([d[2] for d in draws], dtype=torch.float32),
        torch.tensor([d[3] for d in draws], dtype=torch.float32), S)
    box = jax.jit(lambda k: J._rrc_box(k, S, scale, (3 / 4, 4 / 3)))
    want = np.array([[float(v) for v in box(k)] for k in ks])
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want)
    if scale[0] > 1:
        assert (want[:, 2:] == S).all()


def test_random_erasing_matches_jax_at_its_draws():
    """timm's pixel mode, two boxes an image, gated: JAX's boxes and noise
    put through the port's box geometry give JAX's output."""
    arr = np.random.default_rng(4).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)
    count, prob = 2, 0.7
    ks = keys(5)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, k: J._random_erasing(a, k, prob, count)))(
            jnp.asarray(arr), ks))
    got = torch.from_numpy(arr.copy())
    H = W = SIZE
    for b, key in enumerate(ks):
        key, k_gate = jax.random.split(key)
        gate = float(jax.random.uniform(k_gate, ())) < prob
        for _ in range(count):
            key, k_a, k_r, k_t, k_l, k_n = jax.random.split(key, 6)
            a = jax.random.uniform(k_a, (10,), minval=0.02,
                                   maxval=1 / 3) * H * W / count
            r = jnp.exp(jax.random.uniform(
                k_r, (10,), minval=math.log(0.3), maxval=math.log(1 / 0.3)))
            h, w = jnp.round(jnp.sqrt(a * r)), jnp.round(jnp.sqrt(a / r))
            valid = np.asarray((h < H) & (w < W))
            j = int(valid.argmax())
            hj, wj = float(h[j]), float(w[j])
            top = math.floor(float(jax.random.uniform(k_t, ())) * (H - hj + 1))
            left = math.floor(float(jax.random.uniform(k_l, ())) *
                              (W - wj + 1))
            mask = P.box_mask(H, W, torch.tensor([float(top)]),
                              torch.tensor([float(left)]),
                              torch.tensor([hj]), torch.tensor([wj]),
                              torch.tensor([bool(valid.any()) and gate]),
                              "cpu")[0]
            noise = t(jax.random.normal(k_n, (H, W, 3)))
            got[b] = torch.where(mask, noise, got[b])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != arr).any()


def test_cutout_matches_jax_at_its_draws(imgs):
    ks = keys(6)
    want = np.asarray(jax.jit(jax.vmap(J._cutout))(jnp.asarray(imgs), ks))
    yx, rgb = [], []
    for k in ks:
        ky, kx, kc = jax.random.split(k, 3)
        yx.append([int(jax.random.randint(ky, (), 0, SIZE)),
                   int(jax.random.randint(kx, (), 0, SIZE))])
        rgb.append(np.asarray(jax.random.randint(kc, (3,), 0, 256)))
    yx = torch.tensor(yx)
    got = P.cutout(t(imgs), yx[:, 0], yx[:, 1], t(np.stack(rgb)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_color_jitter_matches_jax_at_its_draws(imgs):
    ks = keys(7)
    f = 0.4
    want = np.asarray(jax.jit(jax.vmap(
        lambda im, k: J._color_jitter_one(im, k, f)))(jnp.asarray(imgs), ks))
    order, factors = [], []
    for k in ks:
        kp, kf = jax.random.split(k)
        order.append(np.asarray(jax.random.permutation(kp, 3)))
        factors.append(np.asarray(jax.random.uniform(
            kf, (3,), minval=1 - f, maxval=1 + f)))
    got = P.color_jitter_apply(t(imgs), t(np.stack(order)),
                               t(np.stack(factors)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVELS)


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-m7-n3-mstd101"])
def test_rand_augment_rounds_match_jax_at_its_draws(aa):
    """JAX's whole _rand_augment_batch (groups of 4, each round's op a
    group, per-image magnitude, sign and gate) against the port's rounds
    at the same draws: within 1e-4 of 255, except that a histogram op
    after a float op rounds to integer bins, so a value within 1e-4 of a
    half level may land one level apart (at most 0.1% of the values)."""
    n_img, gs = 16, 4
    x = np.random.default_rng(8).uniform(
        0, 255, (n_img, SIZE, SIZE, 3)).astype(np.float32)
    num_ops, magnitude, mstd, inc, prob = J.parse_ra(aa)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda im, k: J._rand_augment_batch(
        im, k, num_ops, magnitude, mstd, gs, inc=inc, prob=prob))(
            jnp.asarray(x), key))
    rounds = []
    for k in jax.random.split(key, n_img // gs):
        per_group = []
        for _ in range(num_ops):
            k, k_op, k_mag, k_in, k_ap = jax.random.split(k, 5)
            op = int(jax.random.randint(k_op, (), 0, 15))
            if math.isinf(mstd):
                mags = magnitude * jax.random.uniform(k_mag, (gs,))
            else:
                mags = magnitude + mstd * jax.random.normal(k_mag, (gs,))
            mags = np.clip(np.asarray(mags, np.float32), 0.0, 10.0)
            signs = signs_of(jax.random.split(k_in, gs))
            apply = np.asarray(jax.random.bernoulli(k_ap, prob, (gs,)))
            per_group.append((op, mags, signs, apply))
        rounds.append(per_group)
    got = t(x)
    ops = P.ra_op_table(inc)
    for r in range(num_ops):
        got = P.rand_augment_apply(
            got, ops, torch.tensor([g[r][0] for g in rounds]),
            t(np.concatenate([g[r][1] for g in rounds])),
            t(np.concatenate([g[r][2] for g in rounds])),
            t(np.concatenate([g[r][3] for g in rounds])), gs)
    err = np.abs(got.numpy() - want)
    assert err.max() <= 1.0 + LEVELS and (err > LEVELS).mean() <= 1e-3
    assert np.abs(want - x).max() > 1  # some op did something


@pytest.mark.parametrize("cfg", [
    dict(), dict(recipe="asl"), dict(aa="", color_jitter=0.4),
    dict(aa="rand-m9-mstd101-inc1", reprob=0.0)], ids=str)
def test_pipeline_from_a_seed(u8, cfg):
    """The whole ``make_device_augment``: NCHW fp32 of the crop size,
    finite, two runs from one seed bitwise equal and another seed
    different; without erasing every value within the normalised range of
    0..255."""
    aug = P.make_device_augment(P.DeviceAugConfig(input_size=SIZE, **cfg))
    x = t(u8)
    a = aug(x, torch.Generator().manual_seed(0))
    b = aug(x, torch.Generator().manual_seed(0))
    c = aug(x, torch.Generator().manual_seed(1))
    assert a.shape == (B, 3, SIZE, SIZE) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a, c)
    if cfg.get("reprob", 0.25) == 0.0 or cfg.get("recipe") == "asl":
        mean = torch.tensor(P.IMAGENET_MEAN)[:, None, None]
        std = torch.tensor(P.IMAGENET_STD)[:, None, None]
        levels = (a * std + mean) * 255
        assert levels.min() >= -1e-3 and levels.max() <= 255 + 1e-3
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        aug(x, None)


def test_non_rand_policy_raises():
    with pytest.raises(ValueError, match="rand-"):
        P.make_device_augment(P.DeviceAugConfig(aa="original"))


N_DRAWS = 4096


def test_draws_match_jax_in_distribution():
    """The port's RandomResizedCrop boxes (h, w, top, left), its op picks
    and its mstd-noised magnitudes against JAX's over 4096 draws each
    (scipy ks_2samp, p > 1e-3)."""
    box = jax.jit(jax.vmap(lambda k: J._rrc_box(k, 256, (0.08, 1.0),
                                                (3 / 4, 4 / 3))))
    want = [np.asarray(v) for v in box(keys(11, N_DRAWS))]
    gen = torch.Generator().manual_seed(11)
    got = [v.numpy() for v in P.rrc_boxes(gen, N_DRAWS, 256, (0.08, 1.0),
                                          (3 / 4, 4 / 3), "cpu")]
    for name, g, w in zip(("top", "left", "h", "w"), got, want):
        assert stats.ks_2samp(g, w).pvalue > 1e-3, name
    k_op, k_mag = jax.random.split(jax.random.PRNGKey(12))
    ops_j = np.asarray(jax.random.randint(k_op, (N_DRAWS,), 0, 15))
    ops_p = torch.randint(0, 15, (N_DRAWS,), generator=gen).numpy()
    assert stats.ks_2samp(ops_p, ops_j).pvalue > 1e-3
    mags_j = np.clip(9 + 0.5 * np.asarray(jax.random.normal(
        k_mag, (N_DRAWS,))), 0, 10)
    imgs = torch.zeros(N_DRAWS, 2, 2, 3)
    seen = []

    def record(x, mags, signs, gs):
        seen.append((mags.clone(), signs.clone()))
        return x

    # the port's own draws, through rand_augment with a recording op table
    ops = P.ra_op_table
    P.ra_op_table = lambda inc: (record,) * 15
    try:
        P.rand_augment(imgs, gen, 1, 9.0, 0.5, 16)
    finally:
        P.ra_op_table = ops
    mags_p, signs_p = seen[0]
    assert stats.ks_2samp(mags_p.numpy(), mags_j).pvalue > 1e-3
    assert abs(float((signs_p > 0).float().mean()) - 0.5) < 0.03
