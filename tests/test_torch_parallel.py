"""The port's data parallel and FSDP training (``parallel/mesh.py``) on two
processes over gloo, against its single-process runs and the JAX
package's, on the CPU.

Each rank takes its rows of every global batch through ``global_order``,
so the references run on the global batches as they are
(tests/torch_mp_worker.py). Bounds:

- data parallel, tests/mp_worker.py's recipe (topk tiny, SGD, clip 1.0,
  mixup on JAX's own draws, accumulation 2, EMA 0.99, two steps): the
  losses and gradient norms within 1e-5 relative and every param and EMA
  leaf within 1e-5 of its max against the port's single process; against
  JAX's single-process
  run (tests/mp_worker.py's ``run`` on the same batches) the losses within
  1e-5 and the params' sum of |w| within 1e-6 relative, as
  tests/test_multiprocess.py holds JAX's two processes. ``--dist-eval``:
  top-1 and top-5 equal, the loss within 1e-6 relative, the multilabel mAP
  within 1e-6, against the whole set on one process and against JAX.
- FSDP (min_size 64, so that most leaves are split, drop-path 0.1 from
  one seeded generator; 128 wide blocks, 129 classes; Adam's eps 1e-3,
  tests/torch_mp_worker.py's EPS): two steps of
  AdamW, AdamP, NovoGrad, Adafactor (factored moments, one split along
  its averaged dim) and SGDP against the single-device step, the params
  and EMA with the bounds of tests/torch_trajectory.py (NovoGrad
  normalises by layers, SGDP not at all, so without the near-zero term),
  the moments within 1e-5 of each leaf's max; the
  checkpoint of the two ranks restored into one process and trained two
  more steps against the unsharded four.
- The placement rule equal to JAX's ``fsdp_shardings`` on conftest's
  virtual CPU devices, at DeiT-S's shapes.
- The train CLI with ``--fsdp --world_size 2 --dist_url``: rank 0 alone
  writes log.txt and the checkpoint, which the port's validate reads.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp_worker
import torch_mp_worker as W
from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.parallel.mesh import (
    data_parallel_mesh,
    fsdp_shardings as jax_fsdp_shardings,
)
from tokenreduction_tpu.train import mixup as jax_mixup
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.convert import (
    state_dict_from_flax,
    torch_names_from_flax,
)
from tokenreduction_tpu_torch.parallel import (
    DataParallel,
    dryrun_multichip,
    fsdp_shardings,
    global_order,
    global_rows,
)
from tokenreduction_tpu_torch.parallel.launch import free_port, spawn
from tokenreduction_tpu_torch.parallel.mesh import draw_rows
from tokenreduction_tpu_torch.train import losses
from tokenreduction_tpu_torch.train.optim import flax_axes, global_norm
from tokenreduction_tpu_torch.train.step import StepConfig, loss_and_grads
from tokenreduction_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_train_state,
)
from torch_trajectory import assert_params_close

WORLD = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")
# one thread a process: the tiny models gain nothing from more, and the
# ranks share the CPU with the other test workers
ENV = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
LR, CLIP = 1e-3, 1.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nhwc(batches):
    return [{"image": b["image"].transpose(0, 2, 3, 1),
             "label": b["label"]} for b in batches]


def torch_batches(batches):
    return [{k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()} for b in batches]


def jax_batch_draw(key, H, W_, cfg):
    """JAX's batch-mode mixup draws for ``apply_mixup(key, ...)`` (as
    tests/test_torch_mixup.py repeats them) as the port's MixupDraw."""
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    use_cutmix = jnp.logical_and(
        jax.random.uniform(k_switch) < cfg.switch_prob, cfg.cutmix_alpha > 0)
    lam_mix = jax.random.beta(k_lam_m, cfg.mixup_alpha, cfg.mixup_alpha)
    lam_cut = jax.random.beta(k_lam_c, cfg.cutmix_alpha, cfg.cutmix_alpha)
    box = jnp.stack(jax_mixup._rand_bbox(k_box, H, W_, lam_cut))
    apply = jax.random.uniform(k_apply) < cfg.prob
    return dict(apply=np.asarray(apply).reshape(1),
                use_cutmix=np.asarray(use_cutmix).reshape(1),
                lam_mix=np.asarray(lam_mix, np.float32).reshape(1),
                box=np.asarray(box, np.int64).reshape(1, 4))


@pytest.fixture(scope="module")
def start():
    """tests/mp_worker.py's Flax init through the weight bridge."""
    _, params, *_ = mp_worker.build(jax)
    return params, state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params))


def run_workers(tmp, job, inp):
    inputs, out = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "out.pt")
    torch.save(inp, inputs)
    results = spawn(WORLD, [sys.executable, WORKER, job, inputs, out],
                    env=ENV, timeout=300)
    return results, torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def ddp(start, tmp_path_factory):
    flax_params, params = start
    batches = [{"image": b["image"].transpose(0, 3, 1, 2).copy(),
                "label": b["label"]} for b in mp_worker.global_batches()]
    cfg = jax_mixup.MixupConfig(num_classes=W.NUM_CLASSES)
    draws = [jax_batch_draw(jax.random.split(jax.random.PRNGKey(100 + i))[1],
                            32, 32, cfg) for i in range(len(batches))]
    inp = {"params": params, "batches": torch_batches(batches),
           "draws": draws}
    results, got = run_workers(str(tmp_path_factory.mktemp("ddp")), "ddp",
                               inp)
    return inp, batches, results, got


def test_ddp_matches_the_single_process(ddp):
    inp, _, results, got = ddp
    want = W.ddp_run(inp)
    assert [r["world"] for r in results] == [WORLD] * WORLD
    for r in results:  # the same global loss on every rank
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    for key in ("params", "ema"):
        for n, w in want[key].items():
            np.testing.assert_allclose(
                got[key][n].numpy(), w.numpy(), rtol=0,
                atol=1e-5 * float(w.abs().max()), err_msg=f"{key} {n}")


def test_ddp_matches_jax_single_process(ddp, monkeypatch):
    _, batches, results, got = ddp
    monkeypatch.setattr(mp_worker, "global_batches",
                        lambda: nhwc(batches))
    ref = mp_worker.run(jax, data_parallel_mesh(1), rank=0, world=1)
    np.testing.assert_allclose([loss for loss, _ in results[0]["losses"]],
                               ref["losses"], rtol=1e-5)
    checksum = float(sum(t.abs().sum() for t in got["params"].values()))
    np.testing.assert_allclose(checksum, ref["checksum"], rtol=1e-6)
    for key in ("acc1", "acc5"):
        assert results[0]["stats"][key] == ref["stats"][key], key
    np.testing.assert_allclose(results[0]["stats"]["loss"],
                               ref["stats"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(results[0]["map"], ref["map"], rtol=1e-6,
                               atol=1e-8)


def test_dist_eval_matches_the_whole_set(ddp):
    """Each rank's DistributedEvalSampler split (10 images: 5 a rank),
    the sums all-reduced and the multilabel predictions all-gathered: the
    whole set's metrics on one process, from the same params."""
    inp, _, results, got = ddp
    model = W.build_model(inp["params"])
    stats, mean_ap = W.evaluate_both(model, got["params"], 1, 0)
    assert results[0]["stats"] == results[1]["stats"]
    for key in ("acc1", "acc5"):
        assert results[0]["stats"][key] == stats[key], key
    np.testing.assert_allclose(results[0]["stats"]["loss"], stats["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(results[0]["map"], mean_ap, rtol=1e-6,
                               atol=1e-8)


OPTIMIZERS = ("adamw", "adamp", "novograd", "adafactor", "sgdp")
# the optimizers whose update normalises each element by its own moment
ELEMENTWISE = ("adamw", "adamp", "adafactor")


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    model, _ = create_model("topk_small_patch16_224", device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            **W.WIDE)
    # seeded noise on every leaf, so that no leaf starts at zero (see
    # tests/test_torch_train.py's start_params)
    g = torch.Generator().manual_seed(1)
    params = {n: t + 0.02 * torch.randn(t.shape, generator=g)
              for n, t in model.state_dict().items()}
    rng = np.random.default_rng(3)
    batches = [{"image": rng.standard_normal((8, 3, 32, 32))
                .astype(np.float32),
                "label": rng.integers(0, W.WIDE["num_classes"], 8)}
               for _ in range(4)]
    inp = {"params": params, "dims": W.WIDE,
           "batches": torch_batches(batches), "optimizers": OPTIMIZERS}
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    results, got = run_workers(tmp, "fsdp", inp)
    return inp, results, got, tmp


def step1_grads(inp):
    """The single process's step-1 gradients (the same drop-path masks:
    the step's generator seeded as the workers' is) and their norm."""
    model = W.build_model(inp["params"], inp["dims"], drop_path_rate=0.1)
    model.train()
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    b = inp["batches"][0]
    _, g = loss_and_grads(model, lambda out, t, i, p: losses.cross_entropy(
        out, t), params, b["image"], b["label"], StepConfig(),
        torch.Generator().manual_seed(11))
    return ({n: t.numpy() for n, t in g.items()},
            float(global_norm(g.values())))


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_fsdp_matches_the_single_device_step(fsdp, opt):
    inp, results, got, _ = fsdp
    state, want_losses, _, _ = W.fsdp_run(inp, opt)
    res = got[opt]
    assert len(res["split"]) > 10  # most leaves split over the two ranks
    full = {n: tuple(t.shape) for n, t in state.params.items()}
    assert all(res["local"][n] != full[n] for n in res["split"])
    for r in results:
        np.testing.assert_allclose(r[opt], want_losses, rtol=1e-5)
    grads, norm = step1_grads(inp)
    lr = LR if opt in ELEMENTWISE else 0.0
    for key, want in (("params", state.params),
                      ("ema_params", state.ema_params)):
        assert_params_close(
            {n: t.detach().numpy() for n, t in res[key].items()},
            {n: t.detach().numpy() for n, t in want.items()}, grads, norm,
            CLIP, lr, 2)
    for part, tensors in state.opt_state.items():
        for n, w in tensors.items():
            np.testing.assert_allclose(
                res["opt_state"][part][n].numpy(), w.numpy(), rtol=0,
                atol=1e-5 * float(w.abs().max()) + 1e-30,
                err_msg=f"{part} {n}")


def test_fsdp_checkpoint_restores_into_one_process(fsdp):
    """AdamW's two FSDP steps on two ranks, saved whole by rank 0, then
    restored into a single-device state and stepped twice more: the
    unsharded run's four steps (each two steps with the step's generator
    seeded anew, as a resumed run restarts it)."""
    inp, _, _, tmp = fsdp
    tree, meta = load_checkpoint(os.path.join(tmp, "ckpt"))
    assert meta["step"] == 2
    fresh, _, _, _ = W.fsdp_run(inp, "adamw", steps=0)
    restored = restore_train_state(fresh, tree, meta)
    got, got_losses, _, _ = W.fsdp_run(inp, "adamw", state=restored)
    want, _, _, _ = W.fsdp_run(inp, "adamw")
    want, want_losses, _, _ = W.fsdp_run(inp, "adamw", state=want)
    assert got.step == want.step == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    grads, norm = step1_grads(inp)
    for key in ("params", "ema_params"):
        assert_params_close(
            {n: t.detach().numpy() for n, t in getattr(got, key).items()},
            {n: t.detach().numpy() for n, t in getattr(want, key).items()},
            grads, norm, CLIP, LR, 4)


@pytest.fixture(scope="module")
def deit_s():
    """DeiT-S topk@0.7's Flax param shapes and the port's params."""
    module, _ = jax_create_model("topk_small_patch16_224",
                                 reduction_loc=(3, 6, 9), keep_rate=(0.7,))
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 224, 3)),
        train=False))["params"]
    model, _ = create_model("topk_small_patch16_224", device="cpu",
                            reduction_loc=(3, 6, 9), keep_rate=(0.7,))
    return shapes, dict(model.named_parameters())


@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("min_size", [2 ** 14, 64])
def test_fsdp_placement_matches_jax(deit_s, world, min_size):
    """DeiT-S topk@0.7's leaves split along the dim JAX's fsdp_shardings
    picks over a mesh of ``world`` virtual CPU devices (Flax [in, out]
    kernels; the port's [out, in] ones through flax_axes)."""
    shapes, params = deit_s
    specs = jax_fsdp_shardings(shapes, data_parallel_mesh(world),
                               min_size=min_size)
    axis = jax.tree_util.tree_map(
        lambda s: next((a for a, p in enumerate(s.spec) if p is not None),
                       None), specs, is_leaf=lambda s: hasattr(s, "spec"))
    want = {n: None if a is None else flax_axes(n, params[n].dim())[a]
            for n, a in torch_names_from_flax(axis).items()}
    got = fsdp_shardings(params, world, min_size)
    assert got == want
    assert any(d is not None for d in got.values())


def test_global_order_and_row_draws():
    """Rank r's local rows are its part of each global microbatch, and a
    draw inside global_rows is the global draw's rows of this rank."""
    order = global_order(2, 2, 4)
    np.testing.assert_array_equal(order, [0, 1, 4, 5, 2, 3, 6, 7])
    full = torch.rand((8, 3), generator=torch.Generator().manual_seed(0))
    for rank in range(2):
        with global_rows(2, rank, groups=2):
            got = draw_rows(torch.rand, (4, 3),
                            generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(got, full[order[rank * 4:rank * 4 + 4]],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fsdp_on", [False, True])
def test_one_process_data_axis_is_the_plain_step(start, fsdp_on):
    """A world of one (no process group) through DataParallel, with FSDP
    or without: bit-equal to the plain step (as phase 11 of chip_smoke.py
    requires on one card over NCCL)."""
    rng = np.random.default_rng(3)
    inp = {"params": start[1], "batches": torch_batches([{
        "image": rng.standard_normal((8, 3, 32, 32)).astype(np.float32),
        "label": rng.integers(0, W.NUM_CLASSES, 8)} for _ in range(2)])}
    plain, plain_losses, _, _ = W.fsdp_run(inp, "adamw")
    dp = DataParallel(fsdp=fsdp_on, min_size=64)
    state, got_losses, _, _ = W.fsdp_run(inp, "adamw", dp)
    assert got_losses == plain_losses
    for n, t in plain.params.items():
        assert torch.equal(state.params[n], t), n
        assert torch.equal(state.ema_params[n], plain.ema_params[n]), n
    for part, tensors in plain.opt_state.items():
        for n, t in tensors.items():
            assert torch.equal(state.opt_state[part][n], t), (part, n)


def test_train_cli_fsdp_on_two_processes(tmp_path):
    """The CLI on two processes with --fsdp, --world_size and --dist_url
    (gloo on the CPU): one log.txt row from rank 0 (rank 1 writes and
    prints nothing), and a checkpoint the port's validate reads, finding
    the run's best accuracy again on the whole val set."""
    from tokenreduction_tpu_torch.evaluation import validate

    out = str(tmp_path / "run")
    argv = [sys.executable, "-m", "tokenreduction_tpu_torch.train.train_cli",
            "--device", "cpu", "--fsdp", "--world_size", "2", "--dist_url",
            f"tcp://localhost:{free_port()}", "--dataset", "synthetic",
            "--synthetic-n", "24", "--synthetic-classes", "5",
            "--model", "topk_tiny_patch16_224", "--input-size", "32",
            "--patch-size", "8", "--embed-dim", "64", "--depth", "2",
            "--num-heads", "1", "--reduction_loc", "1", "--keep_rate", "0.7",
            "--batch-size", "4", "--epochs", "1", "--warmup-epochs", "0",
            "--print-freq", "100", "--no-repeated-aug", "--dist-eval",
            "--mixup", "0", "--cutmix", "0", "--output_dir", out]
    spawn(WORLD, argv, env=ENV, cwd=str(tmp_path), timeout=300)
    rows = open(os.path.join(out, "log.txt")).read().splitlines()
    assert len(rows) == 1
    data = validate.main(["--checkpoint", out, "--dataset", "synthetic",
                          "--synthetic-n", "24", "--input-size", "32",
                          "-b", "8", "--device", "cpu"])
    _, meta = load_checkpoint(os.path.join(out, "best_checkpoint"))
    assert meta["run_args"]["fsdp"] and meta["run_args"]["world_size"] == 2
    assert data["Top1-Acc"] == pytest.approx(meta["max_accuracy"], abs=1e-4)


def test_dryrun_multichip_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun_multichip(2, device="cpu", timeout=300)
    assert "dryrun_multichip(2): ok on cpu (gloo)" in capsys.readouterr().out
