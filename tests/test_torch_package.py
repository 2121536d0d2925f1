"""Package boundary of the PyTorch port: no JAX, no build on the CPU,
launch counters untouched by CPU forwards and train steps, every name of
the JAX registry built and run, and refusals for what is not ported
yet."""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

TINY = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
SIZES = {"tiny": 192, "small": 384, "base": 768}

_CHILD = textwrap.dedent("""
    import sys

    import torch

    import tokenreduction_tpu_torch as T
    from tokenreduction_tpu_torch.ops.flash_attention import (
        fused_attention, fused_attention_qkv, fused_block_attention,
        fused_rect_attention, fused_rect_block)
    from tokenreduction_tpu_torch.ops.flash_attention_train import (
        attention_core_train)
    from tokenreduction_tpu_torch.ops.fused_full_block import fused_full_block
    from tokenreduction_tpu_torch.ops.fused_block_train import (
        attend_branch_train)
    from tokenreduction_tpu_torch.ops.fused_mlp import (
        fused_mlp_gather_residual, fused_mlp_residual)
    from tokenreduction_tpu_torch.ops.fused_mlp_train import mlp_branch
    from tokenreduction_tpu_torch.train import losses
    from tokenreduction_tpu_torch.train.optim import (
        OptimConfig, create_optimizer)
    from tokenreduction_tpu_torch.train.step import (
        StepConfig, init_train_state, make_train_step)

    tiny = dict(device="cpu", num_classes=11, img_size=32, embed_dim=64,
                num_heads=1, depth=4, patch_size=8, reduction_loc=(1, 2),
                keep_rate=(0.7,))
    tome, _ = T.create_model("tome_small_patch16_224", viz_mode=True, **tiny)
    with torch.no_grad():
        out, viz = tome.eval()(torch.randn(2, 3, 32, 32))
    assert out.shape == (2, 11), out.shape
    assert sorted(viz["Assignment_Maps"]) == [1, 2]
    tome.train()(torch.randn(2, 3, 32, 32)).sum().backward()
    ats, _ = T.create_model("ats_small_patch16_224", viz_mode=True, **tiny)
    with torch.no_grad():
        out, viz = ats.eval()(torch.randn(2, 3, 32, 32))
    assert out.shape == (2, 11), out.shape
    assert sorted(viz["Kept_Tokens"]) == [1, 2]
    ats.train()(torch.randn(2, 3, 32, 32)).sum().backward()
    for name in ("heuristic_small_patch16_224", "dyvit_small_patch16_224"):
        m, _ = T.create_model(name, viz_mode=True, **tiny)
        with torch.no_grad():
            out, viz = m.eval()(torch.randn(2, 3, 32, 32))
        assert out.shape == (2, 11), out.shape
        assert sorted(viz["Features"]) == [1, 2, 3], sorted(viz["Features"])
    heuristic, _ = T.create_model("heuristic_small_patch16_224", **tiny)
    heuristic.train()(torch.randn(2, 3, 32, 32)).sum().backward()
    dyvit, _ = T.create_model("dyvit_small_patch16_224",
                              dyvit_distillation=True, **tiny)
    logits, tokens, mask, decisions = dyvit.train()(
        torch.randn(2, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    assert tokens.shape == (2, 16, 64) and len(decisions) == 2
    (logits.sum() + sum(d.sum() for d in decisions)).backward()
    teacher, _ = T.create_model("dyvit_small_patch16_224_teacher",
                                **{k: v for k, v in tiny.items()
                                   if k not in ("reduction_loc", "keep_rate")})
    with torch.no_grad():
        assert teacher(torch.randn(2, 3, 32, 32))[1].shape == (2, 16, 64)
    regnet, _ = T.create_model("regnety_160", device="cpu", img_size=32,
                               depths=(1, 1), widths=(16, 32), group_width=8,
                               stem_width=8)
    with torch.no_grad():
        assert regnet(torch.randn(2, 3, 32, 32)).shape == (2, 1000)
    model, _ = T.create_model("topk_small_patch16_224", drop_path_rate=0.1,
                              **tiny)
    with torch.no_grad():
        out = model.eval()(torch.zeros(2, 3, 32, 32))
    assert out.shape == (2, 11), out.shape
    opt, _ = create_optimizer(
        dict(model.named_parameters()),
        OptimConfig(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01),
        lambda s: 1e-3, [])
    state = init_train_state(model, opt, ema=True, device="cpu")
    step = make_train_step(
        model, lambda o, t, i, p: losses.label_smoothing_ce(o, t, 0.1), opt,
        StepConfig(ema_decay=0.99996, amp=True),
        torch.Generator().manual_seed(0))
    state, metrics = step(state, {"image": torch.zeros(2, 3, 32, 32),
                                  "label": torch.tensor([1, 2])})
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
    assert not bad, bad
    assert "tokenreduction_tpu" not in sys.modules
    assert "tokenreduction_tpu_torch.ops._build" not in sys.modules
    counts = (fused_full_block.launches, fused_block_attention.launches,
              fused_mlp_gather_residual.launches, fused_mlp_residual.launches,
              fused_attention.launches, attend_branch_train.launches,
              attention_core_train.launches, mlp_branch.launches,
              fused_attention_qkv.launches, fused_rect_attention.launches,
              fused_rect_block.launches)
    assert counts == (0,) * 11, counts
    print("ok")
""")


def test_port_imports_and_runs_without_jax():
    """A fresh interpreter imports the port and runs a tiny ToMe, ATS and
    heuristic forward (eval and training), a tiny DyViT eval and
    distillation training forward, the two teachers' forwards, a tiny
    topk forward and one amp train step
    (drop_path 0.1) on the CPU with no JAX, Flax or optax module loaded, no
    kernel build and no kernel launch."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_config_is_a_verbatim_copy():
    """core/config.py is copied, not imported (importing the JAX package
    loads Flax): below the module docstring the two files are equal."""
    def body(path):
        text = path.read_text()
        return text[text.index('"""', 3) + 3:]

    assert body(REPO / "tokenreduction_tpu_torch/core/config.py") == \
        body(REPO / "tokenreduction_tpu/core/config.py")


def test_cpu_forward_leaves_launch_counters_at_zero():
    from tokenreduction_tpu_torch import create_model
    from tokenreduction_tpu_torch.ops.flash_attention import (
        fused_attention,
        fused_attention_qkv,
        fused_block_attention,
        fused_rect_attention,
        fused_rect_block,
    )
    from tokenreduction_tpu_torch.ops.flash_attention_train import (
        attention_core_train,
    )
    from tokenreduction_tpu_torch.ops.fused_full_block import fused_full_block
    from tokenreduction_tpu_torch.ops.fused_mlp import (
        fused_mlp_gather_residual,
        fused_mlp_residual,
    )

    wrappers = (fused_full_block, fused_block_attention,
                fused_mlp_gather_residual, fused_mlp_residual,
                fused_attention, attention_core_train, fused_attention_qkv,
                fused_rect_attention, fused_rect_block)
    before = [w.launches for w in wrappers]
    for name, kw in (("deit_small_patch16_224_local", {}),
                     ("topk_small_patch16_224",
                      dict(reduction_loc=(1, 2), keep_rate=(0.25,))),
                     ("tome_small_patch16_224",
                      dict(reduction_loc=(1, 2), keep_rate=(0.7,))),
                     ("ats_small_patch16_224",
                      dict(reduction_loc=(1, 2), keep_rate=(0.7,))),
                     ("heuristic_small_patch16_224",
                      dict(reduction_loc=(1, 2), keep_rate=(0.7,))),
                     ("dyvit_small_patch16_224",
                      dict(reduction_loc=(1, 2), keep_rate=(0.7,)))):
        model, _ = create_model(name, device="cpu", **TINY, **kw)
        with torch.no_grad():
            model.eval()(torch.zeros(1, 3, 32, 32))
    assert [w.launches for w in wrappers] == before == [0] * 9


@pytest.mark.parametrize("name", ["dyvit_tiny_patch16_224_teacher",
                                  "dyvit_small_patch16_224_teacher",
                                  "dyvit_base_patch16_224_teacher",
                                  "regnety_160"])
def test_registry_refuses_unported_methods(name):
    """The four names the port refused until the teachers were ported now
    build on the CPU and run a forward: the DyViT teachers at their size's
    widths (two blocks) return (CLS logits, patch tokens), RegNetY-160 at
    its published widths its logits."""
    from tokenreduction_tpu_torch import create_model

    kw = {} if name == "regnety_160" else dict(depth=2)
    model, cfg = create_model(name, device="cpu", img_size=64, **kw)
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 64, 64))
    if name == "regnety_160":
        assert cfg.widths == (224, 448, 1232, 3024)
        assert out.shape == (1, 1000)
    else:
        size = name.split("_")[1]
        assert out[0].shape == (1, 1000)
        assert out[1].shape == (1, 16, SIZES[size])
    assert all(bool(torch.isfinite(t).all())
               for t in (out if isinstance(out, tuple) else (out,)))


def test_registry_names_and_unknown_name():
    from tokenreduction_tpu_torch import create_model, list_models

    from tokenreduction_tpu.models.registry import (
        list_models as jax_list_models,
    )

    assert list_models() == sorted(
        [f"{p}_{s}_patch16_224{x}"
         for s in ("tiny", "small", "base")
         for p, x in (("deit", "_local"), ("deit", "_local_viz"),
                      ("topk", ""), ("evit", ""), ("tome", ""),
                      ("sit", ""), ("patchmerger", ""), ("sinkhorn", ""),
                      ("dpcknn", ""), ("kmedoids", ""), ("ats", ""),
                      ("heuristic", ""), ("dyvit", ""),
                      ("dyvit", "_teacher"))] + ["regnety_160"])
    assert list_models() == jax_list_models() and len(list_models()) == 43
    with pytest.raises(KeyError):
        create_model("resnet50", device="cpu")


def test_model_for_config_rebuilds_ported_methods_only():
    from tokenreduction_tpu_torch.core.config import ViTConfig
    from tokenreduction_tpu_torch.models.registry import model_for_config
    from tokenreduction_tpu_torch.reduction.tome import ToMeVisionTransformer
    from tokenreduction_tpu_torch.reduction.topk import TopKVisionTransformer

    cfg = ViTConfig(**TINY, method="topk", reduction_loc=(1,),
                    keep_rate=(0.5,))
    assert isinstance(model_for_config(cfg, device="cpu"),
                      TopKVisionTransformer)
    assert isinstance(model_for_config(cfg.replace(method="tome"),
                                       device="cpu"), ToMeVisionTransformer)
    with pytest.raises(NotImplementedError, match="not a method"):
        model_for_config(cfg.replace(method="deit"), device="cpu")


def test_unported_scores_and_ffn_raise():
    from tokenreduction_tpu_torch.core.layers import Block

    blk = Block(32, 2).eval()
    x = torch.zeros(1, 5, 32)
    with pytest.raises(NotImplementedError, match="no model"):
        blk.attend(x, score="full")
    # the MLP half's plain version runs on the CPU
    assert blk.ffn(x).shape == x.shape


def test_init_is_seeded_by_the_generator():
    from tokenreduction_tpu_torch import create_model

    def weights(seed):
        model, _ = create_model(
            "deit_tiny_patch16_224_local", device="cpu", **TINY,
            generator=torch.Generator().manual_seed(seed))
        return model.state_dict()

    a, b, c = weights(0), weights(0), weights(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"],
                           c["blocks.0.attn.qkv.weight"])
    assert a["blocks.0.attn.qkv.weight"].abs().max() <= 0.04
