"""The port's train CLI (train/train_cli.py, train/loop.py) against the JAX
package's, on the CPU.

Both CLIs train the tiny topk model (``topk_tiny_patch16_224`` at embed 32,
depth 4, 2 heads, 8-pixel patches, 32 px, reduction_loc 1 3, keep 0.7) for
two epochs on the synthetic set (32 images, batch 8, the ShardedSampler of
``--no-repeated-aug``) from one timm-named ``.pth`` (``--finetune``), with
mixup, cutmix and drop-path off, so that no random draw separates them:
the data pipeline is the same code on both sides, and so are the
schedule, the grouped AdamW, the EMA and the best-checkpoint rule. Every
``log.txt`` row agrees (train and test loss within 1e-4 relative, lr
within 1e-6, the accuracies equal), and so does the best checkpoint's
``meta.json``. The port alone: a resumed third epoch equals an
uninterrupted run's, its default recipe (mixup, cutmix, drop-path 0.1,
EMA) trains and its checkpoint validates, the ``--constant_cls`` alias,
the refusals (downloads) and the flags that no longer raise (``--fsdp``
among them; tests/test_torch_train_cli_flags.py and
tests/test_torch_parallel.py run them), the asynchronous
checkpointer.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tokenreduction_tpu_torch.train import train_cli
from tokenreduction_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
)

from torch_train_cases import (
    DATA,
    DIMS,
    QUIET,
    TOPK,
    read_log,
    read_meta,
    run_port,
    write_pth,
)

# lr 0.064 x 8 / 512 = 1e-3 after the linear scaling; epoch 0 warms up
RECIPE = ["--lr", "0.064", "--warmup-epochs", "1", "--save_more_than_best"]
# the flags that only one of the two CLIs has (none so far: the port
# keeps JAX's surface, --platform included, and --device is on both)
ONE_SIDED = set()


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pth") / "topk_tiny.pth")
    return path, write_pth(path, "topk_tiny_patch16_224", 11,
                           reduction_loc=(1, 3), keep_rate=(0.7,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pth):
    """(JAX run dir, JAX stdout, port run dir, port stdout) of the same
    two-epoch run."""
    from tokenreduction_tpu.train.train_cli import main as jax_main

    root = tmp_path_factory.mktemp("runs")
    argv = TOPK + DIMS + DATA + QUIET + RECIPE + [
        "--epochs", "2", "--finetune", pth[0]]
    jax_out, port_out = str(root / "jax"), str(root / "port")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(argv + ["--output_dir", jax_out])
    port_text = run_port(argv + ["--output_dir", port_out])
    return jax_out, buf.getvalue(), port_out, port_text


def test_log_rows_match_jax(runs):
    jax_out, _, port_out, _ = runs
    want, got = read_log(jax_out), read_log(port_out)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("train_loss", "test_loss"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6, abs=1e-12)
        for k in ("test_acc1", "test_acc5", "max_accuracy"):
            assert g[k] == w[k], k
    # a row's lr is the next epoch's (JAX: sched(epoch + 1)): epoch 1
    # trained at 1e-3 after epoch 0's warm-up
    assert want[0]["lr"] == pytest.approx(1e-3)


@pytest.mark.parametrize("name", ["best_checkpoint", "checkpoint"])
def test_meta_matches_jax(runs, name):
    jax_out, _, port_out, _ = runs
    want, got = read_meta(jax_out, name), read_meta(port_out, name)
    for k in ("epoch", "step", "ema_best", "max_accuracy", "model_cfg"):
        assert got[k] == want[k], k
    assert set(got["run_args"]) ^ set(want["run_args"]) <= ONE_SIDED
    assert got["run_args"]["lr"] == pytest.approx(want["run_args"]["lr"])
    assert got["step"] == 4 * (got["epoch"] + 1)  # 4 steps an epoch


def test_finetune_loads_every_parameter(runs, pth):
    _, jax_text, port_out, port_text = runs
    n = len(pth[1])
    assert f"finetune load: {n} loaded, 0 mismatched" in port_text
    assert f"finetune load: {n} loaded, 0 mismatched" in jax_text
    tree, _ = load_checkpoint(os.path.join(port_out, "checkpoint"))
    assert sorted(tree["params"]) == sorted(pth[1])


def test_resumed_epoch_equals_the_uninterrupted_run(tmp_path, pth):
    """Three epochs in one run against two, then ``--resume`` from the
    ``checkpoint`` dir for the third (16 images, a step schedule, which
    does not depend on --epochs): the resumed run logs epoch 2 only, with the
    uninterrupted run's losses, accuracies and lr, and ends at its
    params, EMA and optimizer moments."""
    argv = TOPK + DIMS + DATA + QUIET + [
        "--finetune", pth[0], "--lr", "0.064", "--warmup-epochs", "0",
        "--sched", "step", "--decay-epochs", "1", "--decay-rate", "0.5",
        "--save_more_than_best", "--synthetic-n", "16"]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    run_port(argv + ["--epochs", "3", "--output_dir", full])
    run_port(argv + ["--epochs", "2", "--output_dir", part])
    resumed = str(tmp_path / "resumed")
    run_port(argv + ["--epochs", "3", "--output_dir", resumed, "--resume",
                     os.path.join(part, "checkpoint")])
    want, got = read_log(full)[2], read_log(resumed)
    assert [r["epoch"] for r in got] == [2]
    got = got[0]
    for k in ("train_loss", "test_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    for k in ("test_acc1", "test_acc5", "lr"):
        assert got[k] == want[k], k
    a, meta_a = load_checkpoint(os.path.join(full, "checkpoint"))
    b, meta_b = load_checkpoint(os.path.join(resumed, "checkpoint"))
    assert meta_a["step"] == meta_b["step"] == 6  # 2 steps an epoch
    for part_name in ("params", "ema_params"):
        for n, t in a[part_name].items():
            torch.testing.assert_close(b[part_name][n], t, rtol=1e-6,
                                       atol=1e-7)
    for moment in ("mu", "nu"):
        for n, t in a["opt_state"][moment].items():
            torch.testing.assert_close(b["opt_state"][moment][n], t,
                                       rtol=1e-6, atol=1e-10)


def test_default_recipe_trains_and_validates(tmp_path):
    """The JAX CLI's defaults (mixup 0.8, cutmix 1.0, label smoothing
    0.1, drop-path 0.1, EMA, fp32) from the port's own init: finite
    losses, and the best checkpoint read by the port's validate, which
    finds the run's best accuracy again."""
    from tokenreduction_tpu_torch.evaluation import validate

    out = str(tmp_path / "run")
    text = run_port(TOPK + DIMS + DATA + ["--epochs", "1",
                                          "--output_dir", out])
    (row,) = read_log(out)
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["test_loss"])
    assert "finetune load" not in text
    assert read_meta(out)["run_args"]["mixup"] == 0.8
    data = validate.main(["--checkpoint", out, "--dataset", "synthetic",
                          "--synthetic-n", "32", "--input-size", "32",
                          "-b", "8", "--device", "cpu"])
    # validate reads the params that were best (the EMA's when they
    # were) and finds the loop's accuracy on the same 32 images
    assert data["Top1-Acc"] == pytest.approx(
        read_meta(out)["max_accuracy"], abs=1e-4)
    assert len([k for k in data if k.startswith("synthetic_")]) == 32


@pytest.mark.parametrize("flag,frozen", [
    ("--constant_cls", ("cls_token", "pos_embed")),
    ("--constant_pos", ())])
def test_constant_pos_alias(tmp_path, pth, flag, frozen):
    """The reference's alias (JAX train/loop.py:517): ``--constant_cls``
    freezes the CLS token and the position embeddings alike, and
    ``--constant_pos`` alone freezes nothing."""
    out = str(tmp_path / "run")
    run_port(TOPK + DIMS + DATA + QUIET + [
        "--epochs", "1", "--finetune", pth[0], "--lr", "0.064",
        "--warmup-epochs", "0", "--no-model-ema", "--output_dir", out,
        flag])
    tree, _ = load_checkpoint(os.path.join(out, "best_checkpoint"))
    for name in ("cls_token", "pos_embed", "blocks.0.attn.qkv.weight"):
        same = torch.equal(tree["params"][name], pth[1][name])
        assert same == (name in frozen), name


@pytest.mark.parametrize("argv,error,match", [
    (["--model-ema-force-cpu"], ValueError, "unsupported"),
    (["--pretrained"], ValueError, "local --finetune"),
    (["--teacher-path", "https://example.invalid/t.pth"], ValueError,
     "local --teacher-path"),
])
def test_unported_flags_raise_at_parse_time(argv, error, match):
    with pytest.raises(error, match=match):
        train_cli.parse_args(TOPK + argv + ["--device", "cpu"])


@pytest.mark.parametrize("argv,field,value", [
    (["--device_aug"], "device_aug", True),
    (["--opt", "sgd"], "opt", "sgd"),
    (["--sched", "plateau"], "sched", "plateau"),
    (["--lr-noise", "0.5"], "lr_noise", [0.5]),
    (["--wandb_watch"], "wandb_watch", True),
    (["--fsdp"], "fsdp", True)])
def test_formerly_refused_flags_parse(argv, field, value):
    """The flags of ROADMAP.md Queue 1 items 4b and 5 parse into the run's
    args (they raised until the port had them)."""
    args = train_cli.parse_args(TOPK + argv + ["--device", "cpu"])
    assert getattr(args, field) == value


def test_finetune_npz_raises(tmp_path):
    """A Brain-Flax .npz without encoder blocks (a hybrid backbone) is
    refused as JAX refuses it; a ViT's .npz loads
    (tests/test_torch_train_cli_flags.py)."""
    npz = str(tmp_path / "vit.npz")
    np.savez(npz, **{k: np.zeros(1) for k in (
        "embedding/kernel", "embedding/bias", "cls",
        "Transformer/posembed_input/pos_embedding",
        "Transformer/encoder_norm/scale", "Transformer/encoder_norm/bias")})
    with pytest.raises(ValueError, match="not a Brain-Flax ViT"):
        run_port(TOPK + DIMS + DATA + ["--finetune", npz, "--epochs", "1"])


def test_cli_needs_a_device_without_cuda(monkeypatch):
    """Without CUDA and without --device cpu the CLI raises instead of
    training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(TOPK + DIMS + DATA + ["--epochs", "1"])


def test_async_checkpointer_writes_the_snapshot(tmp_path):
    """``save`` snapshots the tensors it is given: changing them in place
    right after it returns (as the next train step does) leaves the
    written checkpoint as it was; an error of the background write is
    raised by the next ``wait``."""
    params = {"w": torch.arange(6.0).view(2, 3)}
    opt = {"mu": {"w": torch.ones(2, 3)}, "nu": {"w": torch.zeros(2, 3)}}
    ckptr = AsyncCheckpointer()
    ckptr.save(str(tmp_path / "c"), params=params, ema_params=None,
               opt_state=opt, epoch=3, step=7)
    params["w"].add_(100.0)
    opt["mu"]["w"].mul_(5.0)
    ckptr.wait()
    tree, meta = load_checkpoint(str(tmp_path / "c"))
    assert torch.equal(tree["params"]["w"], torch.arange(6.0).view(2, 3))
    assert torch.equal(tree["opt_state"]["mu"]["w"], torch.ones(2, 3))
    assert (meta["epoch"], meta["step"]) == (3, 7)
    (tmp_path / "file").write_text("")
    ckptr.save(str(tmp_path / "file" / "c"), params=params)
    with pytest.raises(OSError):
        ckptr.wait()
    ckptr.wait()  # the error is raised once


def _surface(module, model):
    """{option string: default} of a CLI module's whole parser for
    ``model`` (the common flags, the method's, the reference compat
    ones)."""
    import argparse

    parser = argparse.ArgumentParser(parents=[module.get_args_parser()])
    module.add_method_args(parser, model)
    module.add_reference_compat_args(parser)
    return {opt: action.default for action in parser._actions
            for opt in action.option_strings}


@pytest.mark.parametrize("model", [
    "topk_small_patch16_224", "dyvit_small_patch16_224",
    "dpcknn_small_patch16_224", "kmedoids_small_patch16_224",
    "sinkhorn_small_patch16_224", "heuristic_small_patch16_224"])
def test_flag_surface_matches_jax(model):
    """Every flag of the JAX CLI, with its default, for each method's
    two-pass parse."""
    from tokenreduction_tpu.train import train_cli as jax_cli

    assert _surface(train_cli, model) == _surface(jax_cli, model)


def test_eval_profile_and_steps_per_call(tmp_path, pth):
    """``--eval`` evaluates the finetuned params and trains nothing;
    ``--profile_dir`` writes a torch.profiler trace of the first epoch;
    ``--steps_per_call`` prints its NOTE and runs the steps one by one."""
    argv = TOPK + DIMS + DATA + QUIET + ["--finetune", pth[0]]
    out = str(tmp_path / "eval")
    text = run_port(argv + ["--eval", "--output_dir", out])
    assert "Eval: {'acc1'" in text
    assert not os.path.exists(os.path.join(out, "log.txt"))
    out = str(tmp_path / "run")
    text = run_port(argv + ["--epochs", "1", "--steps_per_call", "2",
                            "--profile_dir", str(tmp_path / "prof"),
                            "--output_dir", out])
    assert "NOTE: --steps_per_call 2" in text
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert read_meta(out)["step"] == 4
