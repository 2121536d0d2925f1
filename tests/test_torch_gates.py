"""The port's block gates, on the CPU: the width gates and the viz pin.

The fused full block takes at most ``FULL_BLOCK_MAX_N`` (256) tokens (JAX
gates its full block at the same width, ``core/layers.py:574-582``); a
wider score-less block runs its attention half and its MLP half apart. The
attention halves take head dim 64 and, in eval and in training (bf16 and
fp32), any width up to ``ATTENTION_MAX_N`` (the wide kernels above 256,
forward and backward), as JAX pads its attention kernels to any width; any
half at another head dim runs the plain ``Attention``. The MLP
half keeps its kernel at any width, as JAX's ``ffn`` does. With
``cfg.viz_mode`` every block is pinned to the plain composition, as JAX
pins its XLA composition (``force_xla=c.viz_mode``, ``models/deit.py:76``).

Which route a block takes is shown by counting the calls of each kernel
wrapper (each runs its plain version on a CPU tensor) and of the plain
modules, with a monkeypatch, in eval and in training. The eval forwards
run under ``torch.no_grad()``, as the port's eval entry points run them:
an eval forward that autograd records takes the plain composition
(``Block.eval_kernels``), since the eval kernels have no backward. The models have one
head of 64 (the kernels' head dim), 4x4 patches: a 64-pixel image gives
N = 257 tokens, one past the full block's limit, a 32-pixel image 65.
Beyond the limit the port's logits are held against the JAX model's (one
Flax init through the weight bridge, the same seeded numpy images) at
rtol = atol = 1e-4, and topk's kept tokens exactly.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu_torch import create_model, list_models
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.reduction import ats as ats_module
from torch_threads import one_torch_thread  # noqa: F401

WIDE = dict(num_classes=11, embed_dim=64, num_heads=1, depth=2, patch_size=4)
TOL = dict(rtol=1e-4, atol=1e-4)
# the kernel wrappers, by the module that calls them
WRAPPERS = {
    layers: ("fused_full_block", "fused_block_attention",
             "fused_mlp_residual", "fused_mlp_gather_residual",
             "attend_branch_train", "mlp_branch", "attention_core_train"),
    ats_module: ("fused_block_attention", "fused_rect_block",
                 "fused_mlp_residual", "ln_qkv"),
}
# the plain composition: its attention (by the module that calls it) and
# its MLP, counted under these names
PLAIN = ((layers, "attention_probs_ref", "plain_attention"),
         (ats_module, "attention_probs_ref", "plain_attention"),
         (layers.Mlp, "forward", "plain_mlp"))


def count_calls(monkeypatch) -> collections.Counter:
    """Wrap every kernel wrapper and plain module of the port's blocks
    with a call counter; returns the calls by wrapper name, the plain
    modules' as ``plain_attention`` and ``plain_mlp``."""
    calls = collections.Counter()

    def counted(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    for module, names in WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name,
                                counted(name, getattr(module, name)))
    for owner, name, key in PLAIN:
        monkeypatch.setattr(owner, name, counted(key, getattr(owner, name)))
    return calls


def split(calls) -> dict:
    """{"kernel": calls of kernel wrappers, "plain": calls of plain
    modules}."""
    plain = calls["plain_attention"] + calls["plain_mlp"]
    return {"kernel": sum(calls.values()) - plain, "plain": plain}


def images(img_size, b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal(
        (b, 3, img_size, img_size)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("img_size,tokens", [(32, 65), (64, 257)])
@pytest.mark.parametrize("train", [False, True])
def test_width_gate_routes_each_block(monkeypatch, img_size, tokens, train):
    """Within the limit every half of a dense block goes through a kernel
    wrapper (one ``fused_full_block`` per block in eval; the attention and
    MLP branches in training); one token past it an eval block runs
    ``fused_block_attention`` and ``fused_mlp_residual``, and an fp32
    training block ``attend_branch_train`` and ``mlp_branch`` (the wide
    fp32 backward on the card)."""
    calls = count_calls(monkeypatch)
    model, _ = create_model("deit_small_patch16_224_local", device="cpu",
                            img_size=img_size, **WIDE)
    model.train(train)
    x = torch.from_numpy(images(img_size)[0])
    with torch.set_grad_enabled(train):  # an eval forward runs no_grad
        out = model(x, generator=torch.Generator().manual_seed(0))
    assert model.embed(x).shape[1] == tokens
    assert out.shape == (2, 11)
    depth = WIDE["depth"]
    mlp = {"mlp_branch": depth} if train else {"fused_mlp_residual": depth}
    if tokens <= layers.FULL_BLOCK_MAX_N:
        want = ({"attend_branch_train": depth, **mlp} if train
                else {"fused_full_block": depth})
    else:
        want = {("attend_branch_train" if train else "fused_block_attention"):
                depth, **mlp}
    assert calls == want


@pytest.mark.parametrize("name,tokens,want", [
    ("deit_small_patch16_224_local", 257,
     {"attend_branch_train": 2, "mlp_branch": 2}),
    ("tome_small_patch16_224", 257,
     {"attend_branch_train": 1, "attention_core_train": 1,
      "mlp_branch": 2}),
])
def test_bf16_training_halves_take_the_kernels_past_256(monkeypatch, name,
                                                        tokens, want):
    """In bf16 (the amp step's dtype) a training attention half above 256
    tokens goes through the kernel wrappers, as within the limit: the
    branch, or with ToMe's size bias after its first merge the attention
    core (both with a bf16 backward at any width); on a CPU tensor each
    runs its plain version."""
    calls = count_calls(monkeypatch)
    kw = ({} if name.startswith("deit")
          else dict(reduction_loc=(0,), keep_rate=(0.9,)))
    model, _ = create_model(name, device="cpu", img_size=64, **WIDE, **kw)
    model = model.to(torch.bfloat16).train()
    x = torch.from_numpy(images(64)[0]).to(torch.bfloat16)
    out = model(x, generator=torch.Generator().manual_seed(0))
    assert model.embed(x).shape[1] == tokens
    out.float().sum().backward()
    assert calls == want


@pytest.mark.parametrize("head_dim", [32, 64])
def test_head_dim_gate(monkeypatch, head_dim):
    """A head dim other than 64 sends the attention halves to the plain
    ``Attention`` as well; the MLP halves keep their kernel."""
    calls = count_calls(monkeypatch)
    model, _ = create_model("deit_small_patch16_224_local", device="cpu",
                            img_size=32, **{**WIDE,
                                            "num_heads": 64 // head_dim})
    with torch.no_grad():
        model.eval()(torch.from_numpy(images(32)[0]))
    depth = WIDE["depth"]
    want = ({"fused_full_block": depth} if head_dim == 64
            else {"plain_attention": depth, "fused_mlp_residual": depth})
    assert calls == want


@functools.lru_cache(maxsize=None)
def wide_params(name):
    module, _ = jax_create_model(name, img_size=64, **WIDE)
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
        train=False))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("name,kw", [
    ("deit_small_patch16_224_local", {}),
    ("topk_small_patch16_224",
     dict(reduction_loc=(0,), keep_rate=(0.7,), viz_mode=True)),
    ("topk_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.7,))),
    ("tome_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.7,))),
    ("ats_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.7,))),
    ("evit_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.7,))),
])
def test_wide_model_matches_jax(name, kw):
    """N = 257: the port's blocks (the kernel wrappers' plain versions, or
    with viz mode the plain composition) give JAX's logits, and topk's
    kept tokens (block 0 at 257 tokens keeps 179 patches, block 1 runs at
    180)."""
    params = wide_params(name)
    jmodel, _ = jax_create_model(name, img_size=64, **WIDE, **kw)
    model, _ = create_model(name, device="cpu", img_size=64, **WIDE, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    x_nchw, x_nhwc = images(64)
    ref = jmodel.apply({"params": params}, jnp.asarray(x_nhwc), train=False)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x_nchw))
    if kw.get("viz_mode"):
        (ref, ref_viz), (out, viz) = ref, out
        np.testing.assert_array_equal(viz["Kept_Tokens"][0].numpy(),
                                      np.asarray(ref_viz["Kept_Tokens"][0]))
        assert viz["Kept_Tokens"][0].shape == (2, 179)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# every registered ViT name (regnety_160, a convnet, has no blocks), in
# eval and training (the DyViT teachers stay in eval mode)
PIN_CASES = [(name, train) for name in list_models()
             for train in (False, True) if name != "regnety_160"]


@pytest.mark.parametrize("name,train", PIN_CASES)
def test_viz_pin_launches_no_kernel(monkeypatch, name, train):
    """With ``viz_mode`` no kernel wrapper runs, in eval or in training;
    without it every block half goes through one, except in ATS's
    training, which is plain in JAX too (no ATS training kernel); DyViT's
    policy attention in training, plain PyTorch in both packages, is
    counted as neither."""
    calls = count_calls(monkeypatch)
    dims = dict(img_size=32, **{**WIDE, "depth": 4, "patch_size": 8})
    kw = dict(reduction_loc=(1, 2), keep_rate=(0.7,))
    x = torch.from_numpy(images(32)[0])
    model, _ = create_model(name, device="cpu", viz_mode=True, **dims, **kw)
    model.train(train)
    with torch.set_grad_enabled(model.training):  # eval runs no_grad
        model(x, generator=torch.Generator().manual_seed(0))
    got = split(calls)
    assert got["kernel"] == 0 and got["plain"] > 0
    calls.clear()
    model, _ = create_model(name, device="cpu", **dims, **kw)
    model.train(train)
    with torch.set_grad_enabled(model.training):  # eval runs no_grad
        model(x, generator=torch.Generator().manual_seed(0))
    got = split(calls)
    if train and name.startswith("ats"):
        assert got == {"kernel": 0, "plain": 2 * dims["depth"]}
    else:
        assert got["kernel"] > 0 and got["plain"] == 0


@pytest.mark.parametrize("name,want", [
    ("topk_small_patch16_224",
     {"fused_block_attention": 1, "fused_mlp_gather_residual": 1,
      "fused_full_block": 1}),
    ("ats_small_patch16_224",
     {"ln_qkv": 1, "fused_rect_block": 1, "fused_mlp_residual": 2,
      "fused_block_attention": 1}),
])
def test_mlp_halves_keep_their_kernels_past_the_limit(monkeypatch, name,
                                                      want):
    """A reducing block 0 at N = 257: its attention half runs its kernel
    wrapper (topk's with the CLS score, ATS's sampling block's
    rectangular one), its MLP half (topk's gathered one, ATS's) too, as
    JAX's ``ffn_gather`` and ``ffn`` have no width gate; block 1, at the
    180 kept tokens, takes the fused full block (topk) or the masked
    attention half (ATS)."""
    calls = count_calls(monkeypatch)
    model, _ = create_model(name, device="cpu", img_size=64, **WIDE,
                            reduction_loc=(0,), keep_rate=(0.7,))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(images(64)[0]))
    assert out.shape == (2, 11)
    assert calls == want


@pytest.mark.parametrize("name,kw,want", [
    ("deit_small_patch16_224_local", {}, [(False, False, False)] * 2),
    ("topk_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.7,)),
     [(True, False, False)]),
    ("kmedoids_small_patch16_224",
     dict(reduction_loc=(1,), keep_rate=(0.7,)), [(False, True, False)]),
    ("tome_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.9,)),
     [(False, False, True), (False, False, False)]),
    ("ats_small_patch16_224", dict(reduction_loc=(0,), keep_rate=(0.7,)),
     [(False, False, False)]),
])
def test_eval_halves_ask_for_what_their_score_reads(monkeypatch, name, kw,
                                                    want):
    """An eval attention half asks ``fused_block_attention`` for row0 only
    where its score is ``"cls"``, for colsum only where it is
    ``"colsum"``, for the head-mean keys only where it is ``"keys"``
    (above 256 tokens colsum costs the kernel a second walk over the
    keys), and gets None for what it did not ask for."""
    asked = []

    def recorded(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            out = fn(*a, **k)
            wants = (k.get("want_row0", True), k.get("want_colsum", True),
                     k.get("want_keys", False))
            asked.append(wants)
            # (out, row0, colsum), and the keys where asked for
            assert [t is not None for t in out[1:]] == \
                list(wants[:len(out) - 1])
            return out
        return run

    for module in (layers, ats_module):
        monkeypatch.setattr(module, "fused_block_attention",
                            recorded(module.fused_block_attention))
    model, _ = create_model(name, device="cpu", img_size=64, **WIDE, **kw)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(images(64)[0]))
    assert out.shape == (2, 11)
    assert asked == want
