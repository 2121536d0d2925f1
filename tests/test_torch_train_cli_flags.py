"""The train CLI flags of ROADMAP.md Queue 1 item 4b on the port
(train/train_cli.py, train/loop.py) against the JAX CLI, on the CPU.

At the tiny widths of tests/torch_train_cases.py, with mixup, cutmix and
drop-path off (no draw in the step):

- ``--opt sgd --sched plateau --patience-epochs 1 --wandb_watch
  --finetune x.npz`` (a seeded Brain-Flax file written here) over three
  epochs: every log.txt row agrees with JAX's (losses and the per-module
  norms within 1e-4 relative, lr within 1e-6, the accuracies equal; the
  plateau decay at the same epoch), and so does ``meta.json``;
- ``--device_aug --eval`` on a cached set: the eval transform on the
  device gives JAX's loss and accuracies.

Where a draw differs (the augmentation's, AdaHessian's probe, the lr
noise: README's "Fidelity"), the port runs alone: ``--device_aug`` on the
synthetic set (the default recipe, RandAugment included), on a cached set
and multilabel (the ASL recipe), its host fallback for ThreeAugment,
``--opt adahessian`` (the plain composition pinned), ``--lr-noise``
(each row's lr the noise-free lr times a factor within the bound, the
same in a second run) and ``lookahead_adamw``, which the JAX CLI cannot
train.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_npz_loader import _params_to_brain_npz
from torch_train_cases import DATA, DIMS, QUIET, TOPK, read_log, read_meta, \
    run_port
from torch_threads import one_torch_thread  # noqa: F401

FLAGS = ["--opt", "sgd", "--sched", "plateau", "--patience-epochs", "1",
         "--wandb_watch", "--lr", "0.064", "--save_more_than_best"]


def run_jax(argv):
    from tokenreduction_tpu.train.train_cli import main as jax_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A seeded Brain-Flax ViT at the tiny widths."""
    from tokenreduction_tpu.models.registry import create_model

    module, _ = create_model("deit_tiny_patch16_224_local", num_classes=7,
                             img_size=32, embed_dim=32, depth=4,
                             num_heads=2, patch_size=8)
    v = jax.jit(lambda: module.init({"params": jax.random.PRNGKey(3)},
                                    jnp.zeros((1, 32, 32, 3)),
                                    train=False))()
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), v["params"])
    path = str(tmp_path_factory.mktemp("npz") / "vit.npz")
    np.savez(path, **_params_to_brain_npz(params, 2))
    return path


@pytest.fixture(scope="module")
def flag_runs(tmp_path_factory, npz):
    root = tmp_path_factory.mktemp("flags")
    argv = TOPK + DIMS + DATA + QUIET + FLAGS + [
        "--epochs", "3", "--finetune", npz]
    jax_out, port_out = str(root / "jax"), str(root / "port")
    jax_text = run_jax(argv + ["--output_dir", jax_out])
    port_text = run_port(argv + ["--output_dir", port_out])
    return jax_out, jax_text, port_out, port_text


def test_sgd_plateau_watch_npz_rows_match_jax(flag_runs):
    jax_out, jax_text, port_out, port_text = flag_runs
    want, got = read_log(jax_out), read_log(port_out)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1,
                                                                       2]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        norms = [k for k in w if "/" in k]
        assert "param_norm/blocks_3" in norms and "grad_norm/head" in norms
        for k in ["train_loss", "test_loss"] + norms:
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6, abs=1e-12)
        for k in ("test_acc1", "test_acc5", "max_accuracy"):
            assert g[k] == w[k], k
    # the accuracy did not improve after epoch 0, so the decay came at
    # the end of epoch 1 on both sides
    assert want[1]["lr"] == pytest.approx(0.1 * want[0]["lr"])
    for text in (jax_text, port_text):
        assert text.count("plateau: lr scale -> 0.1") == 1
        assert "finetune load: " in text and " 0 mismatched" in text


@pytest.mark.parametrize("name", ["best_checkpoint", "checkpoint"])
def test_sgd_plateau_watch_npz_meta_matches_jax(flag_runs, name):
    jax_out, _, port_out, _ = flag_runs
    want, got = read_meta(jax_out, name), read_meta(port_out, name)
    for k in ("epoch", "step", "ema_best", "max_accuracy", "model_cfg"):
        assert got[k] == want[k], k
    assert set(got["run_args"]) == set(want["run_args"])


def cached_set(root):
    from tokenreduction_tpu_torch.data import build_dataset
    from tokenreduction_tpu_torch.data.cache import build_decoded_cache

    ds, _ = build_dataset("", "synthetic", "train", num_classes=7,
                          img_size=40, synthetic_n=16)
    path = str(root / "cache")
    build_decoded_cache(ds, path, cache_size=37)  # 32 / 0.875 ~ 37
    return path


CACHED = ["--dataset", "cached", "--batch-size", "8", "--no-repeated-aug",
          "--print-freq", "100"]


def test_device_aug_eval_on_a_cached_set_matches_jax(tmp_path):
    """``--device_aug --eval``: the cached squares resized and centre
    cropped on the device, the params of one .pth."""
    from torch_train_cases import write_pth

    pth = str(tmp_path / "w.pth")
    write_pth(pth, "topk_tiny_patch16_224", 5, reduction_loc=(1, 3),
              keep_rate=(0.7,))
    argv = TOPK + DIMS + CACHED + ["--data", cached_set(tmp_path),
                                   "--device_aug", "--eval", "--finetune",
                                   pth]
    stats = {}
    for side, run in (("jax", run_jax), ("port", run_port)):
        text = run(argv)
        line = next(s for s in text.splitlines() if s.startswith("Eval: "))
        stats[side] = eval(line[len("Eval: "):], {"np": np})  # noqa: S307
    got, want = stats["port"], stats["jax"]
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=1e-4)
    assert got["acc1"] == pytest.approx(float(want["acc1"]))
    assert got["acc5"] == pytest.approx(float(want["acc5"]))


def finite_rows(out, epochs):
    rows = read_log(out)
    assert [r["epoch"] for r in rows] == list(range(epochs))
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("train_loss", "test_loss"))
    assert os.path.isfile(os.path.join(out, "best_checkpoint", "tree.pt"))
    return rows


@pytest.mark.parametrize("data", ["synthetic", "cached", "multilabel"])
def test_device_aug_trains(tmp_path, data, monkeypatch):
    """The default recipe (RandAugment, erasing; mixup for the multiclass
    sets) with the augmentation in the step: the Loader's batches are
    uint8 squares, and every step runs the aug."""
    from tokenreduction_tpu_torch.train import loop

    seen = []
    setup = loop.device_aug_setup

    def recorded(*a, **kw):
        aug, train_tf, eval_tf, val_tf = setup(*a, **kw)

        def aug_fn(images, generator):
            seen.append((images.dtype, tuple(images.shape)))
            return aug(images, generator)
        return aug_fn, train_tf, eval_tf, val_tf

    monkeypatch.setattr(loop, "device_aug_setup", recorded)
    if data == "cached":
        argv = CACHED + ["--data", cached_set(tmp_path)]
        square = 37
    else:
        argv = DATA + (["--dataset", "synthetic_multilabel"]
                       if data == "multilabel" else [])
        square = 37  # int(32 / 0.875 + 0.5)
    out = str(tmp_path / "run")
    run_port(TOPK + DIMS + argv + ["--epochs", "1", "--device_aug",
                                   "--output_dir", out])
    finite_rows(out, 1)
    steps = 2 if data == "cached" else 4
    assert seen == [(torch.uint8, (8, square, square, 3))] * steps


def test_device_aug_falls_back_for_three_augment(tmp_path):
    out = str(tmp_path / "run")
    text = run_port(TOPK + DIMS + DATA + QUIET + [
        "--epochs", "1", "--device_aug", "--ThreeAugment",
        "--output_dir", out])
    assert "falling back to host transforms" in text
    finite_rows(out, 1)


def test_adahessian_trains_on_the_plain_composition(tmp_path):
    out = str(tmp_path / "run")
    text = run_port(TOPK + DIMS + DATA + QUIET + [
        "--epochs", "1", "--opt", "adahessian", "--output_dir", out])
    assert "adahessian: the plain composition pinned" in text
    finite_rows(out, 1)


def test_lookahead_trains_where_jax_cannot(tmp_path):
    out = str(tmp_path / "run")
    run_port(TOPK + DIMS + DATA + QUIET + [
        "--epochs", "2", "--opt", "lookahead_adamw", "--output_dir", out])
    finite_rows(out, 2)


def test_lr_noise_scales_the_logged_lr(tmp_path):
    """Each row's lr is the noise-free run's times 1 + noise, |noise| <
    0.67 from epoch 1 on (noise on from 0.3 x 4 epochs), 1 before; a second
    run logs the same values."""
    base = TOPK + DIMS + DATA + QUIET + ["--epochs", "4", "--lr", "0.064",
                                         "--warmup-epochs", "0"]
    lrs = []
    for i, extra in enumerate(([], ["--lr-noise", "0.3"],
                               ["--lr-noise", "0.3"])):
        out = str(tmp_path / f"run{i}")
        run_port(base + extra + ["--output_dir", out])
        lrs.append(np.array([r["lr"] for r in finite_rows(out, 4)]))
    ratio = lrs[1] / lrs[0]
    assert ratio[0] == pytest.approx(1.0)  # the row of epoch 0 logs t = 1
    assert np.all(np.abs(ratio - 1) < 0.67) and np.any(ratio[1:] != 1.0)
    assert np.array_equal(lrs[1], lrs[2])
