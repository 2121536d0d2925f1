"""The port's DyViT eval and the idx prologue of ``fused_block_attention``
against the JAX package, fp32 on the CPU.

``fused_block_attention(idx=)`` runs its plain version on CPU tensors
(``take_tokens`` then the block) against the JAX kernel in interpret mode,
whose prologue selects the rows with a one-hot product: K < N kept rows,
unsorted and with CLS, at head dim 16 and 64 (at D 128 with 2 heads and
K <= 24 the JAX side takes its head-stacked path), with and without the
head-mean keys, every output within rtol = atol = 1e-5. ``PredictorLG``
is held against Flax's at 1e-5. The model is held as
tests/test_torch_ats.py holds ATS: one Flax init through the weight
bridge (the score predictors included), the same seeded images, logits
and ``Features`` within 1e-4 and ``Kept_Tokens`` exactly, at keep 0.7 and
0.5. The refusals: DyViT training without a generator, DyViT on the
distilled backbone, and idx with a bias or a mask (DyViT's training
against JAX: tests/test_torch_dyvit_train.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.models.convert import convert_torch_state_dict
from tokenreduction_tpu.ops import flash_attention as jax_fa
from tokenreduction_tpu.reduction.dyvit import PredictorLG as JaxPredictor
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.convert import (
    state_dict_from_flax,
    torch_names_from_flax,
)
from tokenreduction_tpu_torch.ops import flash_attention as fa
from tokenreduction_tpu_torch.reduction.dyvit import PredictorLG

DIMS = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
LOC = (1, 2)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def block_params(D, seed):
    """Seeded fp32 attention-half params in Flax layout ([in, out])."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [1 + r(D, scale=0.1), r(D, scale=0.1), r(D, 3 * D), r(3 * D),
            r(D, D), r(D)]


def th(*arrays):
    """Port operands: 2-D kernels transposed to [out, in]."""
    return [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
            for a in arrays]


def kept_ids(N, K, seed):
    """DyViT's kept ids [B, K]: CLS first, then K - 1 patch ids in score
    order (unsorted)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, K), np.int32)
    for b in range(B):
        ids[b, 1:] = 1 + rng.permutation(N - 1)[:K - 1]
    return ids


@pytest.mark.parametrize("want_keys", [False, True])
@pytest.mark.parametrize("D,H", [(32, 2), (128, 2)])
@pytest.mark.parametrize("N,K", [(17, 12), (17, 8), (12, 5), (5, 2)])
def test_block_attention_idx_matches_jax(N, K, D, H, want_keys):
    x = np.random.default_rng(N * K).standard_normal((B, N, D)) \
        .astype(np.float32)
    p = block_params(D, seed=D + K)
    idx = kept_ids(N, K, seed=N + K)
    scale = (D // H) ** -0.5
    want = jax_fa.fused_block_attention(
        jnp.asarray(x), *map(jnp.asarray, p), H, scale, idx=jnp.asarray(idx),
        want_keys=want_keys, interpret=True)
    got = fa.fused_block_attention(torch.from_numpy(x), *th(*p), H, scale,
                                   idx=torch.from_numpy(idx),
                                   want_keys=want_keys)
    assert len(got) == len(want) == 3 + want_keys
    assert got[0].shape == (B, K, D) and got[1].shape == (B, H, K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)


def test_block_attention_idx_refusals():
    """idx takes no bias and no mask (the JAX kernel asserts it); an id
    out of range raises on the CPU (on the card it traps the kernel)."""
    D, N = 32, 9
    x = torch.zeros(B, N, D)
    p = th(*block_params(D, seed=0))
    idx = torch.from_numpy(kept_ids(N, 4, seed=0))
    for kw in (dict(bias=torch.zeros(B, N)),
               dict(mask=torch.ones(B, N, dtype=torch.bool))):
        with pytest.raises(ValueError, match="idx"):
            fa.fused_block_attention(x, *p, 2, 0.25, idx=idx, **kw)
    idx[1, 2] = N
    with pytest.raises((IndexError, RuntimeError)):
        fa.fused_block_attention(x, *p, 2, 0.25, idx=idx)


def test_predictor_matches_flax():
    C, N = 32, 13
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    policy = (rng.uniform(size=(B, N, 1)) > 0.3).astype(np.float32)
    module = JaxPredictor(C)
    params = jax.jit(lambda: module.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(policy)))()
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    want = module.apply({"params": params}, jnp.asarray(x),
                        jnp.asarray(policy))
    port = PredictorLG(C)
    prefixed = state_dict_from_flax({"score_predictor_0": params})
    port.load_state_dict({k[len("score_predictor.0."):]: v
                          for k, v in prefixed.items()}, strict=True)
    assert port.in_ln.eps == 1e-5
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(policy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def jax_model(**kw):
    return jax_create_model("dyvit_small_patch16_224", **DIMS,
                            reduction_loc=LOC, **kw)[0]


@functools.lru_cache(maxsize=None)
def init_params():
    """One Flax init (the keep rate adds no parameters)."""
    module = jax_model(keep_rate=(0.7,))
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(params, **kw):
    model, _ = create_model("dyvit_small_patch16_224", device="cpu", **DIMS,
                            reduction_loc=LOC, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def images(b=4, seed=7):
    x = np.random.default_rng(seed).standard_normal((b, 3, 32, 32)) \
        .astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("keep", [0.7, 0.5])
def test_logits_and_kept_tokens_match_jax(keep):
    kw = dict(keep_rate=(keep,), viz_mode=True)
    jmodel = jax_model(**kw)
    params = init_params()
    model = port_model(params, **kw).eval()
    x_nchw, x_nhwc = images()
    ref, ref_viz = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x_nhwc))
    with torch.no_grad():
        out, viz = model(torch.from_numpy(x_nchw))
    kept, ref_kept = viz["Kept_Tokens"], ref_viz["Kept_Tokens"]
    assert sorted(kept) == sorted(ref_kept) == list(LOC)
    # int(16 * keep^(s+1)) patches survive stage s
    assert [kept[i].shape[1] for i in LOC] == [
        int(16 * keep ** (s + 1)) for s in range(len(LOC))]
    for i, k in ref_kept.items():
        np.testing.assert_array_equal(kept[i].numpy(), np.asarray(k))
    assert sorted(viz["Features"]) == sorted(ref_viz["Features"])
    for i, feat in ref_viz["Features"].items():
        np.testing.assert_allclose(viz["Features"][i].numpy(),
                                   np.asarray(feat), **MODEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_ties_keep_the_lower_id():
    """Equal scores keep the lower patch id first, as the stable
    ``jnp.argsort`` does: with zero predictor outputs every score ties and
    the kept ids are 0, 1, 2, ..."""
    model = port_model(init_params(), keep_rate=(0.7,), viz_mode=True).eval()
    with torch.no_grad():
        for pred in model.score_predictor:
            pred.out_fc3.weight.zero_()
            pred.out_fc3.bias.zero_()
        _, viz = model(torch.from_numpy(images(b=2)[0]))
    for k in viz["Kept_Tokens"].values():
        np.testing.assert_array_equal(
            k.numpy(), np.broadcast_to(np.arange(k.shape[1]), k.shape))


def test_bridge_round_trips_score_predictors():
    """The Flax tree, predictors included, maps onto the port's module
    (strict load) and back: the port's names give every leaf unchanged,
    and the JAX converter, which loads timm names only, takes the backbone
    and skips exactly the predictors."""
    params = init_params()
    model = port_model(params, keep_rate=(0.7,))
    state = model.state_dict()
    names = torch_names_from_flax(params)
    assert sorted(names) == sorted(state)
    assert sum(n.startswith("score_predictor.") for n in names) == \
        len(LOC) * 10
    want = state_dict_from_flax(params)
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    back, skipped = convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()})
    assert sorted(skipped) == sorted(n for n in state
                                     if n.startswith("score_predictor."))
    assert sorted(back) == sorted(k for k in params
                                  if not k.startswith("score_predictor_"))


def test_refusals():
    """DyViT on the distilled backbone is refused, and training draws its
    Gumbel noise from an explicit generator: without one it raises."""
    model = port_model(init_params(), keep_rate=(0.7,))
    with pytest.raises(ValueError, match="generator"):
        model.train()(torch.from_numpy(images(b=2)[0]))
    with pytest.raises(ValueError, match="distilled"):
        create_model("dyvit_small_patch16_224", device="cpu", **DIMS,
                     reduction_loc=LOC, keep_rate=(0.7,), distilled=True)
