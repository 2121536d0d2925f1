"""The port's mixup/cutmix (train/mixup.py) against the JAX package's, on
the CPU.

JAX draws the parameters inside its step from ``jax.random``; the port
draws them on the host from a numpy generator and applies them with
``mix``. So the port is held against JAX on JAX's own draws: the test
repeats ``apply_mixup``'s key splits (JAX ``train/mixup.py:93-128`` and
``:145-164``), hands the draws to the port's ``mix`` and compares the
mixed images (NHWC there, NCHW here) and the soft targets within 1e-6.
The port's host draws are checked by their statistics: over 2,000 batch
draws from a fixed seed, the cutmix share and the mean lambdas lie within
about four standard deviations of their expected values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.train import mixup as jax_mixup
from tokenreduction_tpu_torch.train import mixup
from torch_threads import one_torch_thread  # noqa: F401

H = W = 16
NUM_CLASSES = 10
TOL = 1e-6
JAX_APPLY = jax_mixup.apply_mixup

CASES = {
    "batch": dict(mode="batch", prob=0.8),
    "batch cutmix only": dict(mode="batch", mixup_alpha=0.0),
    "batch mixup only": dict(mode="batch", cutmix_alpha=0.0),
    "batch minmax": dict(mode="batch", cutmix_minmax=(0.3, 0.7)),
    "pair": dict(mode="pair", prob=0.7),
    "pair odd batch": dict(mode="pair", prob=0.7),
    "elem": dict(mode="elem", prob=0.7),
    "elem minmax": dict(mode="elem", prob=0.7, cutmix_minmax=(0.3, 0.7)),
}


def jax_draws(key, B, cfg):
    """JAX's draws for one call of apply_mixup(key, ...), as a MixupDraw."""
    apply, use_cutmix, lam_mix, box = _jax_draws(key, B, cfg)
    n = 1 if cfg.mode == "batch" else B
    return mixup.MixupDraw(
        np.asarray(apply).reshape(n), np.asarray(use_cutmix).reshape(n),
        np.asarray(lam_mix, np.float32).reshape(n),
        np.asarray(box, np.int64).reshape(n, 4))


def _jax_draws(key, B, cfg):
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    shape = () if cfg.mode == "batch" else (B,)
    use_cutmix = jnp.logical_and(
        jax.random.uniform(k_switch, shape) < cfg.switch_prob,
        cfg.cutmix_alpha > 0)
    if cfg.mixup_alpha <= 0:
        use_cutmix = jnp.ones(shape, bool)
    lam_mix = jax.random.beta(k_lam_m, cfg.mixup_alpha or 1.0,
                              cfg.mixup_alpha or 1.0, shape)
    lam_cut = jax.random.beta(k_lam_c, cfg.cutmix_alpha or 1.0,
                              cfg.cutmix_alpha or 1.0, shape)
    if cfg.mode == "batch":
        if cfg.cutmix_minmax is not None:
            box = jax_mixup._rand_bbox_minmax(k_box, H, W, cfg.cutmix_minmax)
        else:
            box = jax_mixup._rand_bbox(k_box, H, W, lam_cut)
    else:
        keys = jax.random.split(k_box, B)
        if cfg.cutmix_minmax is not None:
            box = jax.vmap(lambda k: jax_mixup._rand_bbox_minmax(
                k, H, W, cfg.cutmix_minmax))(keys)
        else:
            box = jax.vmap(lambda k, lam: jax_mixup._rand_bbox(
                k, H, W, lam))(keys, lam_cut)
    apply = jax.random.uniform(k_apply, shape) < cfg.prob
    return apply, use_cutmix, lam_mix, jnp.stack(box, axis=-1)


@pytest.mark.parametrize("case", list(CASES))
def test_mix_on_jax_draws_matches_jax(case):
    kw = CASES[case]
    B = 7 if case == "pair odd batch" else 8
    jcfg = jax_mixup.MixupConfig(num_classes=NUM_CLASSES, **kw)
    pcfg = mixup.MixupConfig(num_classes=NUM_CLASSES, **kw)
    assert pcfg == mixup.MixupConfig(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    rng = np.random.default_rng(3)
    seen = set()
    for seed in range(6):
        images = rng.standard_normal((B, H, W, 3)).astype(np.float32)
        labels = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
        key = jax.random.PRNGKey(seed)
        want_im, want_t = JAX_APPLY(key, jnp.asarray(images),
                                    jnp.asarray(labels), jcfg)
        draw = jax_draws(key, B, jcfg)
        got_im, got_t = mixup.mix(
            torch.from_numpy(images.transpose(0, 3, 1, 2)),
            torch.from_numpy(labels), pcfg, draw)
        np.testing.assert_allclose(
            got_im.numpy().transpose(0, 2, 3, 1), np.asarray(want_im),
            rtol=0, atol=TOL)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=0, atol=TOL)
        seen.update(zip(draw.apply.tolist(), draw.use_cutmix.tolist()))
    if case == "pair odd batch":  # the middle element pairs with itself
        assert torch.equal(got_im[B // 2], torch.from_numpy(
            images[B // 2].transpose(2, 0, 1)))
    # the seeds reach every branch the config allows
    assert ((True, True) in seen) == (kw.get("cutmix_alpha") != 0.0)
    assert ((True, False) in seen) == (kw.get("mixup_alpha") != 0.0)


def test_cutmix_minmax_forces_alpha_one():
    cfg = mixup.MixupConfig(cutmix_alpha=0.0, cutmix_minmax=[0.2, 0.8])
    assert cfg.cutmix_alpha == 1.0 and cfg.cutmix_minmax == (0.2, 0.8)
    with pytest.raises(ValueError, match="exactly two"):
        mixup.MixupConfig(cutmix_minmax=(0.2,))
    with pytest.raises(ValueError, match="unknown mixup mode"):
        mixup.MixupConfig(mode="row")


def test_host_draw_statistics():
    """The default recipe (mixup 0.8, cutmix 1.0, switch 0.5, prob 1.0):
    over 2,000 batch draws the cutmix share is 0.5 within 0.05 (4.5
    standard deviations), the mean mixup lambda 0.5 within 0.04 (Beta(0.8,
    0.8): sd 0.31, about 1,000 draws) and the mean cutmix lambda that
    the boxes give that of timm's box draw; every box lies in the image
    and the same seed gives the same draws."""
    cfg = mixup.MixupConfig()
    rng = np.random.default_rng(0)
    draws = [mixup.draw_mixup(rng, 8, 224, 224, cfg) for _ in range(2000)]
    cut = np.concatenate([d.use_cutmix for d in draws])
    lam = np.concatenate([d.lam_mix for d in draws])
    assert all(d.apply.all() for d in draws)
    assert abs(cut.mean() - 0.5) < 0.05
    assert abs(lam[~cut].mean() - 0.5) < 0.04
    boxes = np.concatenate([d.box for d in draws])
    assert (boxes >= 0).all() and (boxes[:, [1, 3]] <= 224).all()
    assert (boxes[:, 0] <= boxes[:, 1]).all()
    # the cutmix lambda from the box area, against timm's rand_bbox
    # simulated here in plain numpy (lam ~ Beta(1, 1), a uniform centre,
    # the box clipped to the image): the means within 0.02 (sd about 0.01)
    area = (boxes[:, 1] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 2])
    lam_cut = 1 - area[cut] / 224.0 ** 2
    sim = np.random.default_rng(1)
    lam = sim.beta(1.0, 1.0, 200_000)
    half = (224 * np.sqrt(1 - lam)).astype(int) // 2
    cy, cx = sim.integers(0, 224, (2, 200_000))
    side_y = np.clip(cy + half, 0, 224) - np.clip(cy - half, 0, 224)
    side_x = np.clip(cx + half, 0, 224) - np.clip(cx - half, 0, 224)
    want = (1 - side_y * side_x / 224.0 ** 2).mean()
    assert abs(lam_cut.mean() - want) < 0.02
    again = mixup.draw_mixup(np.random.default_rng(0), 8, 224, 224, cfg)
    assert np.array_equal(again.box, draws[0].box)
    assert np.array_equal(again.lam_mix, draws[0].lam_mix)


def test_mixup_fn_mixes_on_the_images_device_without_a_sync():
    """make_mixup_fn draws on the host and returns the batch's images and
    soft targets; the targets of a draw sum to 1 per row."""
    fn = mixup.make_mixup_fn(mixup.MixupConfig(num_classes=NUM_CLASSES), 0)
    images = torch.randn(4, 3, H, W)
    labels = torch.tensor([1, 2, 3, 4])
    out, targets = fn(images, labels)
    assert out.shape == images.shape and targets.shape == (4, NUM_CLASSES)
    torch.testing.assert_close(targets.sum(-1), torch.ones(4))


def test_multilabel_labels_pass_through():
    images = torch.randn(2, 3, H, W)
    labels = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
    out, got = mixup.multilabel_passthrough(images, labels)
    assert out is images and got is labels
    stacked = torch.stack([labels, torch.ones_like(labels)], dim=1)
    _, got = mixup.multilabel_passthrough(images, stacked)
    assert torch.equal(got, torch.ones_like(labels))
    # JAX's pass-through (train/loop.py:545-552) takes the same max
    assert np.array_equal(np.asarray(stacked.numpy().max(axis=1)),
                          got.numpy())
