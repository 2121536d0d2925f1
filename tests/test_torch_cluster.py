"""The port's cluster family (SiT, PatchMerger, Sinkhorn, DPC-KNN,
k-medoids) against the JAX package, fp32 on the CPU.

The ops get the same seeded numpy inputs on both sides: distances, merged
tokens and transport plans within rtol = atol = 1e-5, ids exactly:
``pairwise_dist``; ``cluster_dpc_knn`` with the same noise array and
without noise; ``merge_clusters`` with and without ``idx_token``;
``k_medoids_fit`` weighted, equal-weight (the first medoid taken from
JAX's draw) and in its sentinel case (an empty cluster takes token 0);
``log_optimal_transport``. The ``colsum`` score through ``Block.attend``,
eval and training, against the JAX block's aux, with the gradients of a
loss that reads it. The models are held as tests/test_torch_evit.py
holds EViT: one Flax init through the weight bridge, logits and every
viz artifact (ids exactly), in viz mode and without it, also at
``reduction_loc=(2, 1)`` (the stages counted in block order, as JAX's
``cnt``). Training:
k-medoids' loss and gradients against ``jax.value_and_grad``, its
``colsum`` blocks through ``Attention`` and ``attention_core_train``,
and one Sinkhorn step with ``project_sinkhorn`` against JAX's
``make_train_step``. The bridge maps every ``cluster_layers`` leaf, and
the registry builds the 18 new names.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.core.layers import Block as JaxBlock
from tokenreduction_tpu.models.convert import convert_torch_state_dict
from tokenreduction_tpu.ops import dpc_knn as jax_dpc
from tokenreduction_tpu.ops import kmedoids as jax_kmedoids
from tokenreduction_tpu.ops import sinkhorn as jax_sinkhorn
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.core.config import SIZE_PRESETS
from tokenreduction_tpu_torch.models.convert import (
    state_dict_from_flax,
    torch_names_from_flax,
)
from tokenreduction_tpu_torch.ops import dpc_knn, kmedoids, sinkhorn
from tokenreduction_tpu_torch.reduction import cluster
from tokenreduction_tpu_torch.train import losses, optim, step

DIMS = dict(num_classes=11, embed_dim=64, num_heads=1, depth=4, patch_size=8,
            img_size=32)
LOC = (1, 2)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
METHODS = ("sit", "patchmerger", "sinkhorn", "dpcknn", "kmedoids")


def th(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def tokens(B=2, N=20, C=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, N, C)).astype(np.float32)


def test_pairwise_dist_matches_jax():
    x, y = tokens(seed=1), tokens(N=7, seed=2)
    want = jax_dpc.pairwise_dist(jnp.asarray(x), jnp.asarray(y))
    got = dpc_knn.pairwise_dist(*th(x, y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("with_noise", [False, True])
def test_cluster_dpc_knn_matches_jax(with_noise):
    x = tokens(seed=3)
    noise = (np.random.default_rng(4).random((2, 20)).astype(np.float32)
             if with_noise else None)
    want = jax_dpc.cluster_dpc_knn(
        jnp.asarray(x), 6, 5,
        noise=None if noise is None else jnp.asarray(noise))
    got = dpc_knn.cluster_dpc_knn(
        torch.from_numpy(x), 6, 5,
        noise=None if noise is None else torch.from_numpy(noise))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_idx_token", [False, True])
def test_merge_clusters_matches_jax(with_idx_token):
    rng = np.random.default_rng(5)
    x = tokens(seed=6)
    idx_cluster = rng.integers(0, 6, (2, 20)).astype(np.int32)
    weight = np.exp(rng.standard_normal((2, 20, 1))).astype(np.float32)
    extra = ()
    if with_idx_token:
        extra = (rng.integers(0, 20, (2, 30)).astype(np.int32),
                 rng.random((2, 30, 1)).astype(np.float32))
    want = jax_dpc.merge_clusters(
        jnp.asarray(x), jnp.asarray(idx_cluster), 6, jnp.asarray(weight),
        *map(jnp.asarray, extra))
    got = dpc_knn.merge_clusters(*th(x, idx_cluster), 6,
                                 torch.from_numpy(weight), *th(*extra))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **OP_TOL)
    if with_idx_token:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   **OP_TOL)
    else:
        assert got[1:] == (None, None) and want[1:] == (None, None)


def sentinel_case():
    """Small integer tokens (every distance exact on both sides) with rows
    3 and 5 equal and the two highest weights, so both start as medoids:
    every token ties between them and goes to the first, the second's
    cluster is empty and takes token 0, an outlier that no cluster would
    pick for itself."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, (2, 12, 6)).astype(np.float32)
    x[:, 5] = x[:, 3]
    x[:, 0] = 9.0
    w = rng.permutation(np.arange(1, 13)).astype(np.float32)
    w = np.stack([w, w[::-1]])
    for b in range(2):
        w[b, [3, 5]] = 20.0, 19.0
        w[b, 0] = 0.5
    return x, w[..., None]


@pytest.mark.parametrize("case", ["weighted", "equal weight", "sentinel"])
def test_k_medoids_fit_matches_jax(case):
    iters, K = 3, 5
    first = None
    if case == "sentinel":
        x, w = sentinel_case()
        iters, K = 1, 4
    else:
        x = tokens(seed=8)
        w = None
        if case == "weighted":
            w = np.random.default_rng(9).random((2, 20, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3) if w is None else None
    want = jax_kmedoids.k_medoids_fit(
        jnp.asarray(x), K, iters, None if w is None else jnp.asarray(w),
        key=key)
    if w is None:  # JAX's draw of the first medoid
        first = int(jax.random.randint(key, (), 0, x.shape[1]))
    got = kmedoids.k_medoids_fit(torch.from_numpy(x), K, iters,
                                 None if w is None else torch.from_numpy(w),
                                 first=first)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **OP_TOL)
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    if case == "sentinel":
        # the empty cluster's medoid is token 0, to which nothing but
        # itself is nearest
        assert (got[1] == 0).any(dim=1).all()


def test_log_optimal_transport_matches_jax():
    scores = tokens(N=6, C=15, seed=10)
    want = jax_sinkhorn.log_optimal_transport(jnp.asarray(scores), 0.5, 4)
    got = sinkhorn.log_optimal_transport(torch.from_numpy(scores), 0.5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_colsum_score_matches_jax(train):
    """``Block.attend(score="colsum")``: the block's output and the
    attention mass per key, [B, N], against the JAX block's aux; in
    training also the gradients of a loss that reads both (the colsum
    cotangent through ``attention_core_train``'s plain backward)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    jblk = JaxBlock(dim=64, num_heads=1)
    params = jax.jit(lambda: jblk.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x)))()["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    cx = rng.standard_normal(x.shape).astype(np.float32)
    cs = rng.standard_normal((2, 17)).astype(np.float32)

    def jax_run(p, xx):
        out, (aux, _) = jblk.apply({"params": p}, xx, score="colsum",
                                   deterministic=not train,
                                   method=JaxBlock.attend)
        return (out * cx).sum() + (aux * cs).sum(), (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jax_run, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    blk = layers.Block(64, 1).train(train)
    state = {n[len("blocks.0."):]: t for n, t in state_dict_from_flax(
        {"blocks_0": params}).items()}
    blk.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out, (aux, _) = blk.attend(xt, score="colsum")
    assert aux.shape == (2, 17)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **OP_TOL)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux),
                               **OP_TOL)
    ((out * torch.from_numpy(cx)).sum()
     + (aux * torch.from_numpy(cs)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=1e-4, atol=1e-4)
    want = {n[len("blocks.0."):]: t for n, t in state_dict_from_flax(
        {"blocks_0": jax.tree_util.tree_map(np.asarray, jgrads[0])}).items()}
    for n, p in blk.named_parameters():
        if n.startswith(("norm2", "mlp")):
            continue  # the attention half does not reach the MLP
        tol = 1e-4 * float(want[n].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=0,
                                   atol=tol, err_msg=n)


CASES = {m: dict(reduction_loc=LOC, keep_rate=(0.7,)) for m in METHODS}
CASES["dpcknn equal weight"] = dict(reduction_loc=LOC, keep_rate=(0.7,),
                                    equal_weight=True)
# the stages counted in block order, not by their place in reduction_loc
# (JAX's cnt): at loc (2, 1) block 1 runs stage 0
CASES.update({f"{m} loc 2 1": dict(reduction_loc=(2, 1), keep_rate=(0.7,))
              for m in METHODS})


def jax_model(method, **kw):
    return jax_create_model(f"{method}_small_patch16_224", **DIMS, **kw)[0]


@functools.lru_cache(maxsize=None)
def init_params(case):
    module = jax_model(case.split()[0], **CASES[case])
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    return jax.tree_util.tree_map(np.asarray, variables.get("params", {}))


def port_model(case, params, **kw):
    model, _ = create_model(f"{case.split()[0]}_small_patch16_224",
                            device="cpu", **DIMS, **CASES[case], **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def images(b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal(
        (b, 3, 32, 32)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


# the viz artifacts holding ids, compared exactly
IDS = ("Kept_Tokens", "Assignment_Maps")


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_viz_match_jax(case):
    params = init_params(case)
    x_nchw, x_nhwc = images()
    module = jax_model(case.split()[0], viz_mode=True, **CASES[case])
    ref, ref_viz = jax.jit(lambda p, x: module.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x_nhwc))
    model = port_model(case, params, viz_mode=True).eval()
    with torch.no_grad():
        out, viz = model(torch.from_numpy(x_nchw))
        plain = port_model(case, params).eval()(torch.from_numpy(x_nchw))
    assert sorted(viz) == sorted(ref_viz)
    for key, ref_maps in ref_viz.items():
        maps = viz[key]
        assert sorted(maps) == sorted(ref_maps), key
        for i, w in ref_maps.items():
            if key in IDS:
                np.testing.assert_array_equal(maps[i].numpy(), np.asarray(w),
                                              err_msg=f"{key} {i}")
            else:
                np.testing.assert_allclose(maps[i].numpy(), np.asarray(w),
                                           err_msg=f"{key} {i}", **MODEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **MODEL_TOL)


def train_case(case):
    rng = np.random.default_rng(5)
    start = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        init_params(case))
    data = np.random.default_rng(11)
    x = data.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = data.integers(0, 11, 4)
    return start, x, y


def smoothing(out, t, *_):
    return losses.label_smoothing_ce(out, t, 0.1)


def test_kmedoids_train_loss_and_gradients_match_jax():
    """k-medoids' training forward (the blocks before each reduction
    through ``Attention`` and ``attention_core_train`` for the attention
    mass, the others through ``attend_branch_train``) against
    jax.value_and_grad: the loss and every gradient leaf within 1e-4 of
    the leaf's max."""
    start, x, y = train_case("kmedoids")
    module = jax_model("kmedoids", **CASES["kmedoids"])

    def jax_loss(p):
        out = module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.label_smoothing_ce(out, jnp.asarray(y), 0.1)

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree_util.tree_map(jnp.asarray, start))
    model = port_model("kmedoids", start).train()
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


def test_kmedoids_training_halves_follow_the_jax_gates(monkeypatch):
    """In training the blocks before each reduction (0 and 1 at LOC 1 2)
    ask for ``colsum`` and take ``Attention`` with the attention core, as
    the JAX gate admits only None, "cls" and "keys" to the branch; the
    other attention halves take ``attend_branch_train``, every MLP half
    ``mlp_branch``."""
    calls = {"attend": 0, "core": 0, "mlp": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    for name, attr in (("attend", "attend_branch_train"),
                       ("core", "attention_core_train"),
                       ("mlp", "mlp_branch")):
        monkeypatch.setattr(layers, attr, counted(name, getattr(layers, attr)))
    model = port_model("kmedoids", init_params("kmedoids")).train()
    model(torch.from_numpy(images()[0]))
    assert calls == {"attend": 2, "core": 2, "mlp": 4}


def test_sinkhorn_train_step_with_projection_matches_jax():
    """One step of bench.py's recipe with ``project_sinkhorn`` and the
    cluster layers at full LR: the same loss, grad norm, params and EMA
    params as JAX's make_train_step, and every cluster vector of unit
    norm after the step."""
    recipe = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01)
    start, x, y = train_case("sinkhorn")
    module = jax_model("sinkhorn", **CASES["sinkhorn"])
    params = jax.tree_util.tree_map(jnp.asarray, start)
    tx, _ = jax_optim.create_optimizer(
        params, jax_optim.OptimConfig(**recipe), lambda s: 1e-3,
        ["cluster_layers"], steps_per_epoch=100)
    cfg = dict(ema_decay=0.99996, project_sinkhorn=True)
    train_step = jax.jit(jax_step.make_train_step(
        lambda p, im, train, rngs: module.apply({"params": p}, im,
                                                train=train, rngs=rngs),
        lambda out, t, i, p: jax_losses.label_smoothing_ce(out, t, 0.1), tx,
        jax_step.StepConfig(**cfg)))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jstate, jm = train_step(
        jstate, {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
                 "label": jnp.asarray(y)}, jax.random.PRNGKey(0))

    model = port_model("sinkhorn", start)
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(**recipe),
                                    lambda s: 1e-3, model.new_module_names(),
                                    steps_per_epoch=100)
    state = step.init_train_state(model, opt, ema=True, device="cpu")
    port_step = step.make_train_step(model, smoothing, opt,
                                     step.StepConfig(**cfg))
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
    vs = [n for n in state.params if n.endswith(".v")]
    assert len(vs) == len(LOC)
    for n in vs:
        norms = torch.linalg.vector_norm(state.params[n], dim=-1)
        torch.testing.assert_close(norms, torch.ones_like(norms))


@pytest.mark.parametrize("case", ["sit", "patchmerger", "sinkhorn",
                                  "dpcknn"])
def test_bridge_round_trips_cluster_layers(case):
    """The Flax tree, cluster layers included, maps onto the port's module
    (strict load) with every leaf unchanged; the JAX converter, which
    loads timm names only, takes the backbone and skips exactly the
    cluster layers."""
    params = init_params(case)
    model = port_model(case, params)
    state = model.state_dict()
    names = torch_names_from_flax(params)
    assert sorted(names) == sorted(state)
    assert any(n.startswith("cluster_layers.") for n in names)
    want = state_dict_from_flax(params)
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    back, skipped = convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()})
    assert sorted(skipped) == sorted(n for n in state
                                     if n.startswith("cluster_layers."))
    assert sorted(back) == sorted(k for k in params
                                  if not k.startswith("cluster_layers_"))


def test_cluster_layers_init_like_flax():
    """Linear weights truncated normal (std 0.02), PatchMerger's queries
    and Sinkhorn's vectors N(0, 1), SiT's scale ones, from the generator."""
    for method, leaf in (("patchmerger", "queries"), ("sinkhorn", "v")):
        model, _ = create_model(f"{method}_small_patch16_224", device="cpu",
                                depth=1, reduction_loc=(3, 6, 9),
                                keep_rate=(0.7,))
        t = model.cluster_layers[0].get_parameter(leaf).detach()
        assert t.shape == (137, 384) and 0.9 < float(t.std()) < 1.1
    model, _ = create_model("sit_small_patch16_224", device="cpu", depth=1,
                            reduction_loc=(3, 6, 9), keep_rate=(0.7,))
    layer = model.cluster_layers[2]
    assert torch.equal(layer.scale, torch.ones(1, 1, 1))
    assert layer.weight_fc1.weight.abs().max() <= 0.04
    assert isinstance(layer, cluster.TokenSlimmingModule)


@pytest.mark.parametrize("name", [f"{m}_{s}_patch16_224"
                                  for m in ("evit",) + METHODS
                                  for s in ("tiny", "small", "base")])
def test_registry_builds_the_new_names(name):
    """Each of the 18 names builds at its size's widths and runs one
    forward (two blocks, a reduction at block 1, 16 patches)."""
    model, cfg = create_model(name, device="cpu", img_size=64, depth=2,
                              reduction_loc=(1,), keep_rate=(0.7,))
    size = name.split("_")[1]
    assert (cfg.embed_dim, cfg.num_heads) == tuple(
        SIZE_PRESETS[size].values())
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 1000) and bool(torch.isfinite(out).all())
