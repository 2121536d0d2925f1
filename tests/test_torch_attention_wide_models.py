"""The port's models at N = 290 tokens (272-pixel images, 16-pixel patches)
against the JAX package's, fp32 on the CPU: the slice above 256 tokens.

Above 256 tokens every eval attention half goes through the kernel
wrappers (on the card the wide kernels, ``csrc/attention_wide_sm90.cu``
and ``csrc/attention_wide_tf32.cu``; on a CPU tensor their plain
versions), the fused full block keeps its 256-token gate, and an fp32
training attention half goes through the training wrappers too (on the
card the wide fp32 forward and ``csrc/attention_wide_tf32_bwd.cu``). Each
model is one Flax init through
``models/convert.py::state_dict_from_flax`` with a head dim of 64 (the
kernels'), given the same seeded numpy images on both sides: dense,
topk, ToMe, ATS, heuristic, EViT, DyViT and PatchMerger at keep 0.7. The
port runs without viz mode, so its blocks take the wrappers, and its
decisions are recorded where they are made (the ids the gathered MLP or
the idx prologue keeps, ATS's sample ids, ToMe's merges, PatchMerger's
assignments); the JAX model runs in viz mode, which gives its
decisions. Logits within 1e-4 (rtol and atol), decisions exactly equal;
no plain attention runs, and no fused full block. Then one fp32 train
step of topk through the training wrappers: its gradients within the
bounds of tests/test_torch_train.py.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.reduction import ats as ats_module
from tokenreduction_tpu_torch.reduction import tome as tome_module
from tokenreduction_tpu_torch.train import losses, step
from torch_trajectory import assert_step1_grads_close

IMG = 272  # 17 x 17 patches and CLS: N = 290
DIMS = dict(num_classes=11, img_size=IMG, embed_dim=128, num_heads=2,
            depth=4, patch_size=16)
REDUCE = dict(reduction_loc=(1, 2), keep_rate=(0.7,))
TOL = dict(rtol=1e-4, atol=1e-4)
METHODS = {
    "dense": ("deit_small_patch16_224_local", {}),
    "topk": ("topk_small_patch16_224", REDUCE),
    "tome": ("tome_small_patch16_224", REDUCE),
    "ats": ("ats_small_patch16_224", REDUCE),
    "heuristic": ("heuristic_small_patch16_224", REDUCE),
    "evit": ("evit_small_patch16_224", REDUCE),
    "dyvit": ("dyvit_small_patch16_224", REDUCE),
    "patchmerger": ("patchmerger_small_patch16_224", REDUCE),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs small products: in one thread, so that the
    test workers' thread pools do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def flax_params(name, kw_items):
    module, _ = jax_create_model(name, **DIMS, **dict(kw_items))
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
        train=False))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def images(b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal(
        (b, 3, IMG, IMG)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


def record(model, method, monkeypatch) -> dict:
    """Record the decisions of the model's next forward where its blocks
    make them, in the JAX viz keys: {key: {block: ids}}."""
    c = model.cfg
    rec = collections.defaultdict(dict)
    if method in ("topk", "evit"):
        for i in c.reduction_loc:
            blk = model.blocks[i]

            def gather(x, idx, generator=None, i=i, inner=blk.ffn_gather):
                if method == "topk":
                    rec["Kept_Tokens"][i] = idx[:, 1:] - 1
                else:  # CLS, the kept patches, the fused row
                    ids = idx[:, 1:-1] - 1
                    rec["Kept_Tokens"][i] = torch.cat(
                        [ids, torch.full_like(ids[:, :1], -1)], 1)
                return inner(x, idx, generator)

            blk.ffn_gather = gather
    elif method == "dyvit":
        for i in c.reduction_loc:
            blk = model.blocks[i]

            def attend(x, *, idx=None, i=i, inner=blk.attend, **kw):
                rec["Kept_Tokens"][i] = idx[:, 1:] - 1
                return inner(x, idx=idx, **kw)

            blk.attend = attend
    elif method == "ats":
        for i, blk in enumerate(model.blocks):
            def sampled(mod, args, out, i=i):
                if out[2] is not None:
                    rec["Kept_Tokens"][i] = out[2][:, 1:] - 1

            blk.register_forward_hook(sampled)
    elif method == "tome":
        matching = tome_module.bipartite_soft_matching
        blocks = [i for i, r in enumerate(model.removals) if r > 0]

        def recorded(metric, r, **kw):
            info = matching(metric, r, **kw)
            rec["Assignment_Maps"][blocks[len(rec["Assignment_Maps"])]] = \
                tome_module.merge_source_assignment(info)
            return info

        monkeypatch.setattr(tome_module, "bipartite_soft_matching", recorded)
    elif method == "patchmerger":
        for i, layer in zip(c.reduction_loc, model.cluster_layers):
            def clustered(mod, args, out, i=i):
                rec["Assignment_Maps"][i] = out[1].argmax(-2)

            layer.register_forward_hook(clustered)
    return rec


def count_routes(monkeypatch) -> collections.Counter:
    """Count the plain attention (by the module that calls it), the
    fused block attention and the fused full block, the last by whether
    it ran above 256 tokens (``fused_full_block`` past 256)."""
    calls = collections.Counter()

    def counted(key, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            wide = key == "fused_full_block" and a[0].shape[1] > 256
            calls[key + " past 256" if wide else key] += 1
            return fn(*a, **kw)
        return run

    for module in (layers, ats_module):
        monkeypatch.setattr(module, "attention_probs_ref", counted(
            "plain_attention", module.attention_probs_ref))
    monkeypatch.setattr(layers, "fused_full_block", counted(
        "fused_full_block", layers.fused_full_block))
    monkeypatch.setattr(layers, "fused_block_attention", counted(
        "fused_block_attention", layers.fused_block_attention))
    return calls


@pytest.mark.parametrize("method", METHODS)
def test_model_matches_jax_at_290_tokens(monkeypatch, method):
    name, kw = METHODS[method]
    params = flax_params(name, tuple(kw.items()))
    x_nchw, x_nhwc = images()
    jmodel, _ = jax_create_model(name, **DIMS, **kw, viz_mode=True)
    ref = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x_nhwc))
    ref, ref_viz = ref if isinstance(ref, tuple) else (ref, {})
    model, cfg = create_model(name, device="cpu", **DIMS, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.eval()
    assert model.embed(torch.from_numpy(x_nchw)).shape[1] == 290
    calls = count_routes(monkeypatch)
    rec = record(model, method, monkeypatch)
    with torch.no_grad():
        out = model(torch.from_numpy(x_nchw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert calls["plain_attention"] == 0
    assert calls["fused_full_block past 256"] == 0
    if method != "ats":  # ATS's blocks call the wrappers of their module
        assert calls["fused_block_attention"] > 0
    for key, blocks in rec.items():
        assert sorted(blocks) == sorted(
            i for i in ref_viz[key] if i in blocks), key
        for i, ids in blocks.items():
            np.testing.assert_array_equal(ids.numpy(),
                                          np.asarray(ref_viz[key][i]),
                                          err_msg=f"{key} block {i}")
    want_keys = {"topk": 1, "evit": 1, "dyvit": 1, "ats": 1, "tome": 1,
                 "patchmerger": 1}.get(method, 0)
    assert len(rec) == want_keys and all(len(b) for b in rec.values())


def test_fp32_train_step_matches_jax_at_290_tokens(monkeypatch):
    """topk's gradients through the training wrappers: every MLP half's
    mlp_branch and every attention half's attend_branch_train, those above
    256 tokens (fp32) included."""
    name, kw = METHODS["topk"]
    params = flax_params(name, tuple(kw.items()))
    x_nchw, x_nhwc = images(seed=11)
    y = np.random.default_rng(3).integers(0, 11, 2)
    module, _ = jax_create_model(name, **DIMS, **kw)
    want = jax.jit(jax.grad(lambda p: jax_losses.label_smoothing_ce(
        module.apply({"params": p}, jnp.asarray(x_nhwc), train=True,
                     rngs={}), jnp.asarray(y), 0.1)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want))
    calls = collections.Counter()
    for wrapper in ("attend_branch_train", "mlp_branch",
                    "attention_probs_ref"):
        fn = getattr(layers, wrapper)

        def counted(*a, wrapper=wrapper, fn=fn, **k):
            calls[wrapper] += 1
            return fn(*a, **k)

        monkeypatch.setattr(layers, wrapper, counted)
    model, _ = create_model(name, device="cpu", **DIMS, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.train()
    grads = {n: p.detach().clone().requires_grad_()
             for n, p in model.named_parameters()}
    _, got = step.loss_and_grads(
        model, lambda out, t, i, p: losses.label_smoothing_ce(out, t, 0.1),
        grads, torch.from_numpy(x_nchw), torch.from_numpy(y),
        step.StepConfig())
    # blocks 0 and 1 at 290 tokens, 2 and 3 (203 and 142): all on the
    # branch, no plain attention
    assert calls == {"mlp_branch": DIMS["depth"],
                     "attend_branch_train": DIMS["depth"]}
    assert_step1_grads_close({n: g.numpy() for n, g in got.items()},
                             {n: g.numpy() for n, g in want.items()})
