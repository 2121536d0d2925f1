"""The port's ATS against the JAX package, fp32 on the CPU.

The sampler gets the same seeded numpy scores on both sides: sample ids
and masks must be equal, ``num_sample_steps`` for K in 2..40 too. The
attention counterparts ATS runs (the masked ``fused_block_attention``,
``fused_attention`` and ``fused_attention_qkv``, and the rectangular
``fused_rect_attention`` and ``fused_rect_block``, each with a token that
is masked off and, for the rectangular ones, a kept row that re-samples a
dead token, whose softmax is uniform over all keys) are held against the
JAX kernels in interpret mode at rtol = atol = 1e-5, as
tests/test_torch_ops.py holds the others. The model is held as
tests/test_torch_tome.py holds ToMe: one Flax init through the weight
bridge, the same seeded images, logits and features within 1e-4 and
``Kept_Tokens`` exactly, at keep 0.7 (where K = 12 meets the float64
``arange`` quirk: 12 steps, not 11) and at keep 0.25. Training, which
has no kernel in either package, is held over one train step: the loss
and every gradient leaf within 1e-4 of its max, then the updated params.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.models.convert import convert_torch_state_dict
from tokenreduction_tpu.ops import ats as jax_ats
from tokenreduction_tpu.ops import flash_attention as jax_fa
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.ops import ats
from tokenreduction_tpu_torch.ops import flash_attention as fa
from tokenreduction_tpu_torch.train import losses, optim, step

DIMS = dict(num_classes=11, img_size=32, embed_dim=32, num_heads=2, depth=4,
            patch_size=8)
LOC = (1, 2)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
# (D, heads): head dim 16, and the card's head dim 64
ATTN_DIMS = [(32, 2), (128, 2)]


@pytest.mark.parametrize("K", range(2, 41))
def test_num_sample_steps_and_steps_match_jax(K):
    assert ats.num_sample_steps(K) == jax_ats.num_sample_steps(K)
    np.testing.assert_array_equal(
        ats.sample_steps(K).numpy(), np.asarray(jax_ats.sample_steps(K)))


def test_num_sample_steps_keeps_the_arange_quirk():
    assert ats.num_sample_steps(12) == 12  # (stop - start) / step > 11
    assert ats.num_sample_steps(138) == 137


def scores(N, seed, dead=0.3, degenerate=False):
    """Seeded CLS attention [B, 2, N-1], value norms and a mask [B, N]
    whose CLS is valid; ``degenerate``: zero significance, where every
    step ties and the first minimum decides."""
    rng = np.random.default_rng(seed)
    attn = rng.dirichlet(np.ones(N), size=(B, 2))[..., 1:].astype(np.float32)
    norms = rng.uniform(0.5, 2.0, (B, 2, N - 1)).astype(np.float32)
    if degenerate:
        attn[:] = 0.0
    mask = rng.uniform(size=(B, N)) > dead
    mask[:, 0] = True
    return attn, norms, mask


@pytest.mark.parametrize("N,K,dead,degenerate", [
    (17, 12, 0.0, False), (17, 12, 0.3, False), (13, 8, 0.5, False),
    (197, 138, 0.0, False), (138, 97, 0.2, False), (50, 13, 0.4, False),
    (17, 12, 0.3, True)])
def test_sampler_matches_jax(N, K, dead, degenerate):
    attn, norms, mask = scores(N, seed=N + K, dead=dead,
                               degenerate=degenerate)
    want_ids, want_mask = jax_ats.sample_ids_from_scores(
        jnp.asarray(attn), jnp.asarray(norms), jnp.asarray(mask), K)
    ids, new_mask = ats.sample_ids_from_scores(
        torch.from_numpy(attn), torch.from_numpy(norms),
        torch.from_numpy(mask), K)
    assert ids.shape == (B, ats.num_sample_steps(K) + 1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(new_mask.numpy(), np.asarray(want_mask))


def test_unique_pad_sorted_matches_jax():
    ids = np.random.default_rng(3).integers(1, 9, (4, 12))
    np.testing.assert_array_equal(
        ats.unique_pad_sorted(torch.from_numpy(ids), big=9).numpy(),
        np.asarray(jax_ats.unique_pad_sorted(jnp.asarray(ids), big=9)))


def test_adaptive_token_sampling_matches_jax():
    N, K = 17, 12
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((B, 2, N, N)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    v = rng.standard_normal((B, 2, N, 8)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.3
    mask[:, 0] = True
    want = jax_ats.adaptive_token_sampling(*map(jnp.asarray, (attn, v, mask)),
                                           K)
    got = ats.adaptive_token_sampling(*map(torch.from_numpy, (attn, v, mask)),
                                      K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0)


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


def token_mask(N, seed):
    """A validity mask [B, N] with CLS valid and some tokens off."""
    mask = np.random.default_rng(seed).uniform(size=(B, N)) > 0.3
    mask[:, 0] = True
    mask[:, N // 2] = False  # at least one fully masked query row
    return mask


def kept_rows(N, M, seed):
    """ATS's kept ids [B, M]: CLS, sorted sampled ids and 0-pads at the
    tail, with slot 1 re-sampling the dead token N // 2 (see
    ``token_mask``)."""
    rng = np.random.default_rng(seed)
    n_sampled = min(M - 1, N - 1) - 1
    ids = np.zeros((B, M), np.int32)
    for b in range(B):
        ids[b, 1:1 + n_sampled] = np.sort(
            1 + rng.permutation(N - 1)[:n_sampled])
    ids[:, 1] = N // 2
    return ids


@pytest.mark.parametrize("D,H", ATTN_DIMS)
@pytest.mark.parametrize("N", [17, 5])
def test_masked_block_attention_matches_jax(D, H, N):
    x = np.random.default_rng(N).standard_normal((B, N, D)) \
        .astype(np.float32)
    p = block_params(D, seed=D + N)
    mask = token_mask(N, seed=N)
    scale = (D // H) ** -0.5
    want = jax_fa.fused_block_attention(
        jnp.asarray(x), *map(jnp.asarray, p), H, scale,
        mask=jnp.asarray(mask), interpret=True)
    got = fa.fused_block_attention(torch.from_numpy(x), *th(*p), H, scale,
                                   mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("N,with_bias", [(17, False), (17, True), (5, False)])
def test_masked_attention_matches_jax(hd, N, with_bias):
    rng = np.random.default_rng(N + hd)
    q, k, v = (rng.standard_normal((B, 3, N, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.uniform(0, 1.4, (B, N)).astype(np.float32) if with_bias \
        else None
    mask = token_mask(N, seed=hd)
    scale = hd ** -0.5
    want = jax_fa.fused_attention(
        *map(jnp.asarray, (q, k, v)), scale,
        bias=None if bias is None else jnp.asarray(bias),
        mask=jnp.asarray(mask), interpret=True)
    got = fa.fused_attention(*map(torch.from_numpy, (q, k, v)), scale,
                             bias=None if bias is None
                             else torch.from_numpy(bias),
                             mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)


@pytest.mark.parametrize("D,H", ATTN_DIMS)
@pytest.mark.parametrize("masked,with_bias", [(True, False), (True, True),
                                              (False, False)])
def test_attention_qkv_matches_jax(D, H, masked, with_bias):
    N = 17
    rng = np.random.default_rng(D)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    mask = token_mask(N, seed=D) if masked else None
    bias = rng.uniform(0, 1.4, (B, N)).astype(np.float32) if with_bias \
        else None
    opt = dict(bias=bias, mask=mask)
    want = jax_fa.fused_attention_qkv(
        jnp.asarray(qkv), H, (D // H) ** -0.5, interpret=True,
        **{k: None if a is None else jnp.asarray(a) for k, a in opt.items()})
    got = fa.fused_attention_qkv(
        torch.from_numpy(qkv), H, (D // H) ** -0.5,
        **{k: None if a is None else torch.from_numpy(a)
           for k, a in opt.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)


RECT_NM = [(17, 13), (13, 9), (9, 4), (17, 5), (5, 4)]


def rect_case(D, N, M):
    rng = np.random.default_rng(N * M + D)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    mask = token_mask(N, seed=N + M)
    return qkv, x, mask, kept_rows(N, M, seed=M)


@pytest.mark.parametrize("D,H", ATTN_DIMS)
@pytest.mark.parametrize("N,M", RECT_NM)
def test_rect_attention_matches_jax(D, H, N, M):
    qkv, _, mask, ids = rect_case(D, N, M)
    onehot = np.eye(N, dtype=np.float32)[ids]
    scale = (D // H) ** -0.5
    want = jax_fa.fused_rect_attention(
        jnp.asarray(qkv), jnp.asarray(onehot), jnp.asarray(mask), H, scale,
        interpret=True)
    got = fa.fused_rect_attention(torch.from_numpy(qkv),
                                  torch.from_numpy(onehot),
                                  torch.from_numpy(mask), H, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_rect_attention_dead_row_is_uniform():
    """A kept row that re-samples a dead token averages the values of all
    N keys, dead ones included (the reference's pair mask)."""
    D, H, N, M = 32, 2, 9, 4
    qkv, _, mask, ids = rect_case(D, N, M)
    assert not mask[:, ids[0, 1]].any()
    got = fa.rect_attention_ref(torch.from_numpy(qkv), torch.from_numpy(ids),
                                torch.from_numpy(mask), H, (D // H) ** -0.5)
    np.testing.assert_allclose(got[:, 1].numpy(), qkv[:, :, 2 * D:].mean(1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D,H", ATTN_DIMS)
@pytest.mark.parametrize("N,M", RECT_NM)
def test_rect_block_matches_jax(D, H, N, M):
    qkv, x, mask, ids = rect_case(D, N, M)
    p = block_params(D, seed=N + M)
    scale = (D // H) ** -0.5
    want = jax_fa.fused_rect_block(
        jnp.asarray(qkv), jnp.asarray(x), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(p[4]), jnp.asarray(p[5]), H, scale,
        interpret=True)
    got = fa.fused_rect_block(
        torch.from_numpy(qkv), torch.from_numpy(x), torch.from_numpy(ids),
        torch.from_numpy(mask), *th(p[4], p[5]), H, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_rect_block_refuses_out_of_range_ids():
    qkv, x, mask, ids = rect_case(32, 9, 4)
    ids[1, 2] = 9
    p = th(*block_params(32, seed=0)[4:])
    with pytest.raises((IndexError, RuntimeError)):
        fa.fused_rect_block(torch.from_numpy(qkv), torch.from_numpy(x),
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            *p, 2, 0.25)


def jax_model(**kw):
    return jax_create_model("ats_small_patch16_224", **DIMS,
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
    model, _ = create_model("ats_small_patch16_224", device="cpu", **DIMS,
                            reduction_loc=LOC, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def images(b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal((b, 3, 32, 32)) \
        .astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("keep", [0.7, 0.25])
def test_logits_and_kept_tokens_match_jax(keep):
    kw = dict(keep_rate=(keep,), viz_mode=True)
    jmodel = jax_model(**kw)
    params = init_params()
    model = port_model(params, **kw).eval()
    x_nchw, x_nhwc = images(b=4)
    ref, ref_viz = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x_nhwc))
    with torch.no_grad():
        out, viz = model(torch.from_numpy(x_nchw))
    assert sorted(viz["Kept_Tokens"]) == sorted(ref_viz["Kept_Tokens"]) \
        == list(LOC)
    for i, kept in ref_viz["Kept_Tokens"].items():
        np.testing.assert_array_equal(viz["Kept_Tokens"][i].numpy(),
                                      np.asarray(kept))
    assert sorted(viz["Features"]) == sorted(ref_viz["Features"])
    for i, feat in ref_viz["Features"].items():
        np.testing.assert_allclose(viz["Features"][i].numpy(),
                                   np.asarray(feat), **MODEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_widths_and_pads():
    """keep 0.7 on the tiny config: 17 -> 13 (K = 12, 12 steps) -> 8
    (K = 8, 7 steps), pads -1 in Kept_Tokens only at the tail."""
    model = port_model(init_params(), keep_rate=(0.7,), viz_mode=True).eval()
    with torch.no_grad():
        _, viz = model(torch.from_numpy(images(b=4)[0]))
    kept = viz["Kept_Tokens"]
    assert [kept[i].shape[1] + 1 for i in LOC] == [13, 8]
    for k in kept.values():
        pads = k == -1
        # once a row pads, it pads to the end
        assert bool((pads[:, :-1] <= pads[:, 1:]).all())


def test_bridge_round_trips_ats_params():
    """ATS adds no parameters: the Flax tree maps onto the port's module
    (strict load) and back unchanged."""
    params = init_params()
    model = port_model(params, keep_rate=(0.7,))
    back, skipped = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert not skipped

    def flat(tree):
        return {jax.tree_util.keystr(path): leaf for path, leaf in
                jax.tree_util.tree_leaves_with_path(tree)}

    flat, flat_back = flat(params), flat(back)
    assert sorted(flat) == sorted(flat_back)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)


def test_refuses_attention_dropout():
    with pytest.raises(NotImplementedError, match="attn_drop_rate"):
        create_model("ats_tiny_patch16_224", device="cpu", **DIMS,
                     reduction_loc=LOC, keep_rate=(0.7,), attn_drop_rate=0.1)


RECIPE = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01)


def train_case():
    rng = np.random.default_rng(5)
    start = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        init_params())
    data = np.random.default_rng(11)
    x = data.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = data.integers(0, 11, 4)
    return start, x, y


def smoothing(out, t, *_):
    return losses.label_smoothing_ce(out, t, 0.1)


def test_train_loss_and_gradients_match_jax():
    """The training forward (plain on both sides) and autograd against
    jax.value_and_grad: loss and every gradient leaf within 1e-4 of the
    leaf's max."""
    start, x, y = train_case()
    module = jax_model(keep_rate=(0.7,))

    def jax_loss(p):
        out = module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.label_smoothing_ce(out, jnp.asarray(y), 0.1)

    jloss, jgrads = jax.value_and_grad(jax_loss)(
        jax.tree_util.tree_map(jnp.asarray, start))
    model = port_model(start, keep_rate=(0.7,))
    model.train()
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    loss, grads = step.loss_and_grads(model, smoothing, params,
                                      torch.from_numpy(x),
                                      torch.from_numpy(y), step.StepConfig())
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(grads) == sorted(want)
    for n, w in want.items():
        tol = 1e-4 * float(w.abs().max())
        np.testing.assert_allclose(grads[n].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=n)


def test_train_step_matches_jax():
    """One step of bench.py's recipe: the same loss, grad norm, params
    and EMA params as JAX's make_train_step."""
    start, x, y = train_case()
    module = jax_model(keep_rate=(0.7,))
    params = jax.tree_util.tree_map(jnp.asarray, start)
    tx, _ = jax_optim.create_optimizer(
        params, jax_optim.OptimConfig(**RECIPE), lambda s: 1e-3, [],
        steps_per_epoch=100)
    train_step = jax.jit(jax_step.make_train_step(
        lambda p, im, train, rngs: module.apply({"params": p}, im,
                                                train=train, rngs=rngs),
        lambda out, t, i, p: jax_losses.label_smoothing_ce(out, t, 0.1), tx,
        jax_step.StepConfig(ema_decay=0.99996)))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jstate, jm = train_step(
        jstate, {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
                 "label": jnp.asarray(y)}, jax.random.PRNGKey(0))

    model = port_model(start, keep_rate=(0.7,))
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(**RECIPE),
                                    lambda s: 1e-3, [], steps_per_epoch=100)
    state = step.init_train_state(model, opt, ema=True, device="cpu")
    port_step = step.make_train_step(model, smoothing, opt,
                                     step.StepConfig(ema_decay=0.99996))
    state, m = port_step(state, {"image": torch.from_numpy(x),
                                 "label": torch.from_numpy(y)})
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    for got, tree in ((state.params, jstate.params),
                      (state.ema_params, jstate.ema_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n, w in want.items():
            tol = 1e-4 * float(w.abs().max())
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       rtol=0, atol=tol, err_msg=n)
