"""The port's two teachers and the distillation losses against the JAX
package, fp32 on the CPU.

``VisionTransformerTeacher`` (the DyViT teacher) takes a Flax init through
the weight bridge: its CLS logits and post-norm patch tokens within 1e-4
of each tensor's max, in ``.train()`` mode too (it stays deterministic
with drop rates above 0). RegNet at the tiny widths of
tests/test_regnet_teacher.py (``TINY``): logits within 1e-4 of their max
from a Flax init whose frozen BatchNorm statistics are off the identity;
the bridge maps every leaf (conv kernels to OIHW, the BatchNorms to
timm's names) with the values unchanged, and JAX's own timm converter
takes the port's state dict back to the Flax tree; the registry's
``regnety_160`` has the published widths, every Flax leaf's shape, and
refuses the ViT options. The losses: ``kl_div_log_target``,
``deit_distillation_loss`` (none, soft, hard) and
``dyvit_distillation_loss`` (KL and MSE token losses, the empty-mask
guard, no teacher) against JAX's on the same numpy inputs, values and
gradients; ``build_loss_fn`` built from one ``argparse.Namespace`` on
each side gives the same loss for DyViT with and without distillation
and for a distilled DeiT with a tiny RegNet teacher (soft and hard), and
refuses ``train_mode=False`` as JAX's loop does.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.models.convert import convert_regnet_state_dict
from tokenreduction_tpu.models.regnet import RegNet as JaxRegNet
from tokenreduction_tpu.models.regnet import RegNetConfig as JaxRegNetConfig
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import loop as jax_loop
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core.config import ViTConfig
from tokenreduction_tpu_torch.models.convert import (
    state_dict_from_flax,
    torch_names_from_flax,
)
from tokenreduction_tpu_torch.models.regnet import RegNet
from tokenreduction_tpu_torch.train import losses, loop

DIMS = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
TINY = dict(depths=(1, 2), widths=(16, 32), group_width=8, stem_width=8)


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, err_msg
    tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=err_msg)


def perturbed(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def images(b=2, seed=7, size=32):
    x = np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def teacher_params():
    module = jax_create_model("dyvit_small_patch16_224_teacher", **DIMS)[0]
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    return perturbed(variables["params"], 4)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_vit_teacher_matches_jax(mode):
    """(CLS logits, post-norm patch tokens); with drop rates above 0 the
    teacher stays deterministic whatever mode it is put in."""
    params = teacher_params()
    module = jax_create_model("dyvit_small_patch16_224_teacher", **DIMS)[0]
    x, x_nhwc = images()
    want = jax.jit(lambda p, x: module.apply({"params": p}, x, train=True))(
        params, jnp.asarray(x_nhwc))
    teacher, _ = create_model("dyvit_small_patch16_224_teacher",
                              device="cpu", **DIMS, drop_rate=0.1,
                              drop_path_rate=0.1)
    teacher.load_state_dict(state_dict_from_flax(params), strict=True)
    teacher.train(mode == "train")
    assert not teacher.training and not any(m.training
                                            for m in teacher.modules())
    with torch.no_grad():
        got = teacher(torch.from_numpy(x))
        again = teacher(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    assert got[1].shape == (2, 16, 64)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert_close(g, w)


@functools.lru_cache(maxsize=None)
def regnet_params(num_classes=10):
    """A Flax RegNet init at TINY with every leaf off the init (the frozen
    BatchNorms' mean, var, scale and bias included; var kept positive)."""
    module = JaxRegNet(cfg=JaxRegNetConfig(num_classes=num_classes,
                                           img_size=32, **TINY))
    params = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()["params"]
    params = perturbed(params, 6, scale=0.1)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.abs(a) + 0.5 if path[-1].key == "var" else a,
        params)


def port_regnet(params, num_classes=10):
    model, cfg = create_model("regnety_160", device="cpu",
                              num_classes=num_classes, img_size=32, **TINY)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model, cfg


def test_regnet_logits_match_jax():
    params = regnet_params()
    module = JaxRegNet(cfg=JaxRegNetConfig(num_classes=10, img_size=32,
                                           **TINY))
    x, x_nhwc = images(seed=3)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, jnp.asarray(x_nhwc))
    model, cfg = port_regnet(params)
    assert cfg.depths == (1, 2) and cfg.widths == (16, 32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 10)
    assert_close(got, want)
    # the BatchNorms are frozen buffers, no parameters
    assert not any(".bn." in n for n, _ in model.named_parameters())


def test_regnet_bridge_round_trips():
    """Every Flax leaf maps to a name of the port's state dict (strict
    load) with its value unchanged, and JAX's timm converter maps the
    port's state dict back to the Flax tree."""
    params = regnet_params()
    model, _ = port_regnet(params)
    state = model.state_dict()
    assert sorted(torch_names_from_flax(params)) == sorted(state)
    want = state_dict_from_flax(params)
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    back, skipped = convert_regnet_state_dict(
        {k: v.numpy() for k, v in state.items()})
    assert skipped == []
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(flat[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_regnety_160_registry():
    """The published RegNetY-160: widths, depths, group width and stem,
    every Flax leaf's shape and the parameter count; the ViT options are
    refused."""
    model, cfg = create_model("regnety_160", device="cpu", num_classes=7)
    assert (cfg.depths, cfg.widths, cfg.group_width, cfg.stem_width,
            cfg.num_classes) == ((2, 4, 11, 1), (224, 448, 1232, 3024), 112,
                                 32, 7)
    module, _ = jax_create_model("regnety_160", num_classes=7)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 224, 3)),
        train=False))["params"]
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    state = model.state_dict()
    assert sorted(want) == sorted(state)
    for name, t in want.items():
        assert tuple(state[name].shape) == tuple(t.shape), name
    assert model.s3.b11.conv2.conv.groups == 1232 // 112
    # the parameters: every Flax leaf but the frozen BatchNorms' buffers
    assert sum(p.numel() for p in model.parameters()) == sum(
        t.numel() for n, t in want.items() if ".bn." not in n)
    for bad in (dict(embed_dim=192), dict(reduction_loc=(3,))):
        with pytest.raises(ValueError, match="convnet teacher"):
            create_model("regnety_160", device="cpu", **bad)


def loss_inputs(seed=0, B=3, N=5, C=7, K=11):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    mask = (rng.random((B, N, 1)) > 0.4).astype(np.float32)
    scores = [rng.random((B, N)).astype(np.float32) for _ in range(2)]
    return dict(pred=r(B, K, scale=2), tokens=r(B, N, C), mask=mask,
                scores=scores, tcls=r(B, K, scale=2), ttok=r(B, N, C))


def both(fn_jax, fn_port, inputs, argnums):
    """(value, grads) of fn over the same numpy inputs on both sides: the
    gradients of the inputs at ``argnums``."""
    jval, jgrads = jax.value_and_grad(fn_jax, argnums=argnums)(
        *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(a).requires_grad_(i in argnums)
              for i, a in enumerate(inputs)]
    val = fn_port(*leaves)
    wrt = [leaves[i] for i in argnums]
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        wrt, torch.autograd.grad(val, wrt, allow_unused=True))]
    return (val, grads), (jval, jgrads)


@pytest.mark.parametrize("case", ["kl batchmean", "kl mean", "deit none",
                                  "deit soft", "deit hard"])
def test_kl_and_deit_distillation_match_jax(case):
    d = loss_inputs()
    base = np.asarray(1.7, np.float32)
    if case.startswith("kl"):
        avg = case.split()[1]
        inputs = (d["pred"], d["tcls"])

        def jf(s, t):
            return jax_losses.kl_div_log_target(
                jax.nn.log_softmax(s, -1), jax.nn.log_softmax(t, -1), avg)

        def pf(s, t):
            return losses.kl_div_log_target(
                torch.log_softmax(s, -1), torch.log_softmax(t, -1), avg)
    else:
        kind = case.split()[1]
        inputs = (np.asarray(base), d["pred"], d["tcls"])

        def jf(b, s, t):
            return jax_losses.deit_distillation_loss(b, s, t, kind, 0.5, 3.0)

        def pf(b, s, t):
            return losses.deit_distillation_loss(b, s, t, kind, 0.5, 3.0)
    (val, grads), (jval, jgrads) = both(jf, pf, inputs, (0, 1))
    assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5)
    for g, w in zip(grads, jgrads):
        assert_close(g, w)


@pytest.mark.parametrize("case", ["kl", "mse_token", "empty mask",
                                  "no teacher"])
def test_dyvit_distillation_loss_matches_jax(case):
    """The four terms against JAX's, with the gradients of the prediction,
    the tokens and the stages' scores; an all-dropped mask takes the
    reference's guard (no token loss)."""
    d = loss_inputs(seed=1)
    if case == "empty mask":
        d["mask"][:] = 0.0
    teacher = case != "no teacher"
    keep_rate = (0.7, 0.49)
    kw = dict(ratio_weight=2.0, cls_distill_weight=0.5,
              token_distill_weight=0.5, cls_weight=1.0,
              mse_token=case == "mse_token")
    inputs = (np.asarray(1.3, np.float32), d["pred"], d["tokens"], d["mask"],
              *d["scores"], d["tcls"], d["ttok"])

    def jf(base, pred, tok, mask, s0, s1, tcls, ttok):
        return jax_losses.dyvit_distillation_loss(
            base, pred, tok, mask, [s0, s1], keep_rate,
            tcls if teacher else None, ttok if teacher else None, **kw)

    def pf(base, pred, tok, mask, s0, s1, tcls, ttok):
        return losses.dyvit_distillation_loss(
            base, pred, tok, mask, [s0, s1], keep_rate,
            tcls if teacher else None, ttok if teacher else None, **kw)

    argnums = (0, 1, 2, 4, 5) if teacher else (0, 4, 5)
    (val, grads), (jval, jgrads) = both(jf, pf, inputs, argnums)
    assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5)
    for g, w in zip(grads, jgrads):
        assert_close(g, w)
    if case == "empty mask":
        assert float(grads[2].abs().max()) == 0.0  # no token loss


def loop_args(**kw):
    base = dict(smoothing=0.1, bce_loss=False, ratio_weight=2.0,
                cls_distill_weight=0.5, token_distill_weight=0.5,
                cls_weight=1.0, mse_token=False, dyvit_distill=False,
                distillation_type="none", distillation_alpha=0.5,
                distillation_tau=1.0, train_mode=True)
    return argparse.Namespace(**{**base, **kw})


def dyvit_cfgs():
    kw = dict(reduction_loc=(1, 2), keep_rate=(0.7,))
    jcfg = jax_create_model("dyvit_small_patch16_224", **DIMS, **kw)[1]
    return jcfg, ViTConfig(**DIMS, method="dyvit", **kw)


@pytest.mark.parametrize("case", ["dyvit", "dyvit distill",
                                  "deit soft regnet", "deit hard regnet"])
def test_build_loss_fn_matches_jax(case):
    """The loss_fn that build_loss_fn makes from one Namespace, over the
    same model outputs, targets and images: DyViT's ratio loss, its
    distillation against the dense teacher (through the bridge), and a
    distilled DeiT's soft and hard distillation against a tiny RegNet
    teacher (through the bridge)."""
    rng = np.random.default_rng(8)
    B, K = 2, 11
    x, x_nhwc = images(b=B, seed=9)
    y = rng.integers(0, K, B)
    d = loss_inputs(seed=2, B=B, N=16, C=64, K=K)
    if case.startswith("dyvit"):
        distill = case == "dyvit distill"
        args = loop_args(dyvit_distill=distill)
        jcfg, cfg = dyvit_cfgs()
        scores = [s for s in rng.random((2, B, 16)).astype(np.float32)]
        out = ((d["pred"], d["tokens"], d["mask"], scores) if distill
               else (d["pred"], scores))
        jteacher = pteacher = None
        if distill:
            module = jax_create_model("dyvit_small_patch16_224_teacher",
                                      **DIMS)[0]
            tp = teacher_params()

            def jteacher(im):
                return module.apply({"params": tp}, im, train=False)

            teacher, _ = create_model("dyvit_small_patch16_224_teacher",
                                      device="cpu", **DIMS)
            teacher.load_state_dict(state_dict_from_flax(tp), strict=True)
            pteacher = loop.make_teacher_apply(teacher)
    else:
        args = loop_args(distillation_type=case.split()[1])
        jcfg = jax_create_model("deit_small_patch16_224_local", **DIMS,
                                distilled=True)[1]
        cfg = ViTConfig(**{**DIMS, "distilled": True})
        out = (d["pred"], d["tcls"])
        params = regnet_params(num_classes=K)
        module = JaxRegNet(cfg=JaxRegNetConfig(num_classes=K, img_size=32,
                                               **TINY))

        def jteacher(im):
            return module.apply({"params": params}, im)

        pteacher = loop.make_teacher_apply(port_regnet(params, K)[0])
    jloss_fn = jax_loop.build_loss_fn(
        args, jcfg, jax_loop.build_base_criterion(args, False, False),
        jteacher)
    loss_fn = loop.build_loss_fn(
        args, cfg, loop.build_base_criterion(args, False, False), pteacher)

    def to(fn, tree):
        if isinstance(tree, (tuple, list)):
            return type(tree)(to(fn, t) for t in tree)
        return fn(tree)

    want = jloss_fn(to(jnp.asarray, out), jnp.asarray(y),
                    jnp.asarray(x_nhwc), None)
    got = loss_fn(to(torch.from_numpy, out), torch.from_numpy(y),
                  torch.from_numpy(x), None)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    with pytest.raises(ValueError, match="no-train-mode"):
        loop.build_loss_fn(loop_args(**{**vars(args), "train_mode": False}),
                           cfg, None)


def test_teacher_apply_takes_no_gradient_and_keeps_fp32():
    """The teacher runs in eval mode under no_grad in its own fp32
    parameters, whatever the student's inputs carry."""
    teacher, _ = create_model("regnety_160", device="cpu", img_size=32,
                              **TINY)
    teacher.train()
    apply = loop.make_teacher_apply(teacher)
    x = torch.zeros(2, 3, 32, 32, requires_grad=True)
    out = apply(x)
    assert not out.requires_grad and out.dtype == torch.float32
    assert not teacher.training and isinstance(teacher, RegNet)
