"""The port's train CLI against the JAX package's on three more recipes,
on the CPU: the multilabel recipe (``synthetic_multilabel``: the
asymmetric loss, no mixup, the mAP in both accuracies), DeiT
distillation against a RegNet teacher (``--distillation-type hard``, the
teacher's weights from a timm-named ``.pth``), and equal-weight
k-medoids, which JAX's CLI cannot train.

Each CLI pair runs one epoch from the same ``.pth`` files with mixup,
cutmix and drop-path off; the ``log.txt`` rows agree within 1e-4
relative (the accuracies equal, the mAP within 1e-4).
"""

import contextlib
import io
import os

import numpy as np
import pytest

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
from torch_threads import one_torch_thread  # noqa: F401

ONE_EPOCH = ["--epochs", "1", "--lr", "0.064", "--warmup-epochs", "0"]
REGNET = dict(depths=(1, 1), widths=(16, 32), group_width=8, stem_width=8)
REGNET_FLAGS = ["--teacher-model", "regnety_160",
                "--teacher-regnet-depths", "1", "1",
                "--teacher-regnet-widths", "16", "32",
                "--teacher-regnet-group-width", "8",
                "--teacher-regnet-stem-width", "8"]


def run_both(tmp_path, argv):
    """(JAX's log rows, the port's) of the same run; JAX's stdout is
    returned too."""
    from tokenreduction_tpu.train.train_cli import main as jax_main

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(argv + ["--output_dir", jax_out])
    port_text = run_port(argv + ["--output_dir", port_out])
    return (read_log(jax_out), read_log(port_out), buf.getvalue(),
            port_text, jax_out, port_out)


def same_rows(want, got, acc_tol=0.0):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for g, w in zip(got, want):
        for k in ("train_loss", "test_loss"):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-12), k
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        for k in ("test_acc1", "test_acc5", "max_accuracy"):
            assert g[k] == pytest.approx(w[k], abs=acc_tol), k


def test_multilabel_matches_jax(tmp_path):
    pth = str(tmp_path / "topk.pth")
    write_pth(pth, "topk_tiny_patch16_224", 13, reduction_loc=(1, 3),
              keep_rate=(0.7,))
    data = [a if a != "synthetic" else "synthetic_multilabel" for a in DATA]
    want, got, *_ = run_both(tmp_path, TOPK + DIMS + data + QUIET +
                             ONE_EPOCH + ["--finetune", pth])
    same_rows(want, got, acc_tol=1e-4)
    assert got[0]["test_acc1"] == got[0]["test_acc5"]  # the mAP in both
    assert got[0]["test_loss"] == 0.0 and got[0]["train_loss"] > 0


def test_deit_distillation_against_a_regnet_teacher_matches_jax(tmp_path):
    """The reference's default distillation recipe (train.py:178,
    455-478), at tiny widths: a distilled DeiT student (dist token and
    head) from one .pth, a RegNetY teacher from another, hard
    distillation; both CLIs load every teacher entry."""
    student = str(tmp_path / "student.pth")
    teacher = str(tmp_path / "teacher.pth")
    write_pth(student, "deit_tiny_patch16_224_local", 17, distilled=True)
    state = write_pth(teacher, "regnety_160", 19, num_classes=7,
                      img_size=32, **REGNET)
    want, got, jax_text, port_text, jax_out, port_out = run_both(
        tmp_path, ["--model", "deit_tiny_patch16_224_local"] + DIMS + DATA +
        QUIET + ONE_EPOCH + ["--finetune", student,
                             "--distillation-type", "hard",
                             "--teacher-path", teacher] + REGNET_FLAGS)
    same_rows(want, got)
    loaded = f"{len(state)} loaded, 0 mismatched"
    assert f"teacher load ({teacher}): {loaded}" in port_text
    assert f"teacher load ({teacher}): {loaded}" in jax_text
    assert read_meta(port_out)["model_cfg"] == read_meta(jax_out)["model_cfg"]
    assert read_meta(port_out)["model_cfg"]["distilled"] is True


def test_equal_weight_kmedoids_trains_where_jax_cannot(tmp_path):
    """JAX's loop gives the ``cluster`` stream to DPC-KNN alone
    (train/loop.py:47-53), so its CLI fails on ``ops/kmedoids.py``'s
    assert for equal-weight k-medoids; the port draws the first medoid
    from its generator and trains (README "Fidelity")."""
    from tokenreduction_tpu.train.train_cli import main as jax_main

    argv = ["--model", "kmedoids_tiny_patch16_224", "--equal_weight",
            "--reduction_loc", "1", "3", "--keep_rate", "0.7"] + DIMS + \
        DATA + ["--epochs", "1"]
    with pytest.raises(AssertionError, match="needs a PRNG key"):
        with contextlib.redirect_stdout(io.StringIO()):
            jax_main(argv + ["--output_dir", str(tmp_path / "jax")])
    out = str(tmp_path / "port")
    run_port(argv + ["--output_dir", out])
    (row,) = read_log(out)
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["test_loss"])
    assert os.path.isfile(os.path.join(out, "best_checkpoint", "tree.pt"))
