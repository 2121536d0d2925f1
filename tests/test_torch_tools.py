"""The port's kernel tools against the JAX tools themselves.

``tools/tune_kernels.py`` (``mlp_chunked``, ``attn_joint``) and
``tools/proto_residual_fuse.py`` (``attend_block_res`` and its VJP) run
their Pallas kernels under ``force_tpu_interpret_mode``; the port's
counterparts (``tokenreduction_tpu_torch/tools/``) run their plain versions
on the CPU, from the same numpy-seeded inputs and weights carried across by
``_measure.from_jax_layout``. The JAX tools fix D = 384 and 6 heads; B = 2
and N = 13 (odd) or 68 (topk@0.7's narrowest width).

Tolerances: fp32, 1e-4 of max|JAX| (the two sides sum in other orders,
and the TPU kernel's GELU takes a rational erf within 1.5e-7); bf16, as the
tools run, 2e-2 of max|JAX| (each side rounds the LN output, qkv or the
hidden tensor, the probabilities and the result to bf16, and one bf16
ulp is 2^-8 of a value: a sum that rounds apart moves a rounded
intermediate by an ulp)."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tokenreduction_tpu_torch.ops.flash_attention import (
    fused_block_attention_ref,
)
from tokenreduction_tpu_torch.tools import _measure
from tokenreduction_tpu_torch.tools import proto_residual_fuse as port_res
from tokenreduction_tpu_torch.tools import tune_kernels as port_tune
from tools import proto_residual_fuse as jax_res
from tools import tune_kernels as jax_tune

D, H = 384, 6
SCALE = (D // H) ** -0.5
B = 2
NS = (13, 68)
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PARAMS = ("ls", "lb", "wqkv", "bqkv", "wproj", "bproj")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny products: in one thread, so that the test
    workers' thread pools do not contend for the cores (a tool's CPU run
    took 0.7 s in one thread and 7-16 s in eight on a busy machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def weights_np(seed: int) -> dict:
    """A DeiT-S block's weights in the JAX tools' [in, out] layout, with
    LN parameters and biases away from 1 and 0."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    return {"ls": r(D, scale=0.1, shift=1.0), "lb": r(D, scale=0.1),
            "wqkv": r(D, 3 * D), "bqkv": r(3 * D, scale=0.1),
            "wproj": r(D, D), "bproj": r(D, scale=0.1),
            "w1": r(D, 4 * D), "b1": r(4 * D, scale=0.1),
            "w2": r(4 * D, D), "b2": r(D, scale=0.1)}


def both(arrays: dict, dtype: str):
    """(JAX arrays, the port's tensors) of the same values: rounded to the
    dtype on the JAX side, carried across exactly."""
    jdt, tdt, _ = DTYPES[dtype]
    j = {k: jnp.asarray(v, jdt) for k, v in arrays.items()}
    t = _measure.from_jax_layout(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in j.items()},
        dtype=tdt)
    return j, t


def inputs(n: int, dtype: str, seed: int = 2):
    x = np.random.default_rng(seed).standard_normal((B, n, D)) \
        .astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    xj = jnp.asarray(x, jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def close(got, want, tol, what):
    got, want = (np.asarray(a.detach().float() if torch.is_tensor(a) else
                            jnp.asarray(a, jnp.float32), np.float64)
                 for a in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: {err:.3e} of max|want| > {tol}"


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_chunked_matches_jax(dtype, n):
    wj, wt = both(weights_np(0), dtype)
    xj, xt = inputs(n, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_tune.mlp_chunked(xj, wj, 4)
    for chunks in (2, 4):
        got = port_tune.mlp_chunked(xt, wt, chunks)
        assert got.dtype == xt.dtype
        close(got, want, DTYPES[dtype][2], f"mlp_chunked chunks={chunks}")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_joint_matches_jax(dtype, n):
    wj, wt = both(weights_np(1), dtype)
    xj, xt = inputs(n, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_tune.attn_joint(xj, wj, H, SCALE, 2)
    tol = DTYPES[dtype][2]
    got, (row0, colsum) = port_tune.attn_joint(xt, wt, H, SCALE,
                                              with_scores=True)
    close(got, want, tol, "attn_joint")
    # the by-products: the port's fused_block_attention_ref's
    _, row0_ref, colsum_ref = fused_block_attention_ref(
        xt, *(wt[k] for k in PARAMS), H, SCALE)
    close(row0, row0_ref, tol, "row0")
    close(colsum, colsum_ref, tol, "colsum")
    assert row0.dtype == colsum.dtype == torch.float32
    assert tuple(row0.shape) == tuple(colsum.shape) == (B, H, n)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_block_res_matches_jax(dtype, n):
    """The forward (out, row0) and the VJP in x and the six parameters,
    with cotangents (dy, drow0), against jax.vjp of the JAX tool's
    custom_vjp; each gradient leaf within the tolerance of its own max."""
    wj, wt = both({k: v for k, v in weights_np(2).items() if k in PARAMS},
                  dtype)
    xj, xt = inputs(n, dtype)
    rng = np.random.default_rng(3)
    s = np.array([1 / 0.9, 0.0], np.float32)
    dy = rng.standard_normal((B, n, D)).astype(np.float32)
    drow0 = rng.standard_normal((B, H, n)).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]

    def f(x, *params):
        return jax_res.attend_block_res(x, *params, jnp.asarray(s), H, SCALE,
                                        1e-6)

    with pltpu.force_tpu_interpret_mode():
        (out_j, row0_j), vjp = jax.vjp(f, xj, *(wj[k] for k in PARAMS))
        grads_j = vjp((jnp.asarray(dy, jdt), jnp.asarray(drow0)))

    x = xt.clone().requires_grad_()
    params = [wt[k].clone().requires_grad_() for k in PARAMS]
    out, row0 = port_res.attend_block_res(x, *params, torch.from_numpy(s),
                                          H, SCALE)
    grads = torch.autograd.grad(
        (out, row0), (x, *params),
        (torch.from_numpy(dy).to(tdt), torch.from_numpy(drow0)))
    close(out, out_j, tol, "out")
    close(row0, row0_j, 1e-4 if dtype == "fp32" else tol, "row0")
    for name, got, want in zip(("dx", *PARAMS), grads, grads_j):
        assert got.dtype == tdt, name
        # JAX's gradients of the matrices are in its [in, out] layout
        close(got.T if got.dim() == 2 else got, want, tol, f"d {name}")


def test_tool_arguments_and_counters():
    """chunks must divide as on the TPU, and the CPU runs launch nothing."""
    _, wt = both(weights_np(0), "fp32")
    _, xt = inputs(13, "fp32")
    with pytest.raises(ValueError, match="chunks"):
        port_tune.mlp_chunked(xt, wt, 5)
    assert port_tune.attn_joint.launches == port_tune.mlp_chunked.launches \
        == port_res.attend_block_res.launches == 0
    back = _measure.from_jax_layout(weights_np(0))
    assert tuple(back["wqkv"].shape) == (3 * D, D)
    assert torch.equal(back["w2"], torch.from_numpy(weights_np(0)["w2"]).T)


MODULES = ("tune_kernels", "proto_residual_fuse", "profile_kernels",
           "profile_keep025", "profile_train_kernels")


@pytest.mark.parametrize("name", MODULES)
def test_tool_help(name, capsys):
    mod = importlib.import_module(f"tokenreduction_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--iters" in out


@pytest.mark.parametrize("name,argv", [
    ("tune_kernels", ["--part", "all"]),
    ("proto_residual_fuse", []),
    ("profile_kernels", []),
    ("profile_train_kernels", []),
])
def test_tool_runs_on_the_cpu(name, argv, capsys):
    """Each tool end to end on the CPU at one image and one call a run:
    the plain versions, timed by the host's clock."""
    mod = importlib.import_module(f"tokenreduction_tpu_torch.tools.{name}")
    mod.main([*argv, "--device", "cpu", "--batch", "1", "--iters", "1"])
    out = capsys.readouterr().out
    assert "host clock, CPU" in out and "CUDA" not in out


# the tools of the attention-core prototypes, the profilers and the gates
MORE = ("proto_attn", "proto_attn_bwd", "proto_gelu", "proto_opt",
        "profile_eval", "profile_train", "bench_input", "accuracy_gate",
        "tpu_parity")


@pytest.mark.parametrize("name", MORE)
def test_more_tool_help(name, capsys):
    mod = importlib.import_module(f"tokenreduction_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("proto_attn", ["--batch", "1", "--iters", "1"]),
    ("proto_attn_bwd", ["--batch", "1", "--iters", "1"]),
    ("proto_gelu", ["--batch", "1", "--iters", "1"]),
    ("proto_opt", ["--iters", "1", "--model", "topk_tiny_patch16_224"]),
    ("profile_eval", ["--batch", "1", "--iters", "1", "--size", "tiny"]),
    ("profile_train", ["--batch", "2", "--iters", "1", "--img-size", "32",
                       "--size", "tiny"]),
])
def test_more_tools_run_on_the_cpu(name, argv, capsys):
    """Each tool end to end on the CPU at a tiny size: the plain versions,
    timed by the host's clock."""
    mod = importlib.import_module(f"tokenreduction_tpu_torch.tools.{name}")
    mod.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "host clock, CPU" in out and "CUDA" not in out


def test_bench_input_runs_on_the_cpu(capsys):
    from tokenreduction_tpu_torch.tools import bench_input

    bench_input.main(["--host", "--n", "8", "--host-batch", "4", "--device",
                      "--device-name", "cpu", "--batch", "2", "--iters", "1",
                      "--src", "64", "--input-size", "48"])
    out = capsys.readouterr().out
    assert "cache build" in out and "raw uint8 collate" in out
    assert "device aug" in out and "host clock, CPU" in out


def test_accuracy_gate_fails_loudly_without_weights(tmp_path, monkeypatch):
    from tokenreduction_tpu_torch.tools import accuracy_gate

    monkeypatch.setenv("TOKENREDUCTION_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        accuracy_gate.main(["--device", "cpu"])
    assert e.value.code == 2


def test_accuracy_gate_parity_on_a_tiny_state(tmp_path, capsys,
                                              monkeypatch):
    """The parity step on a seeded tiny ViT state dict in the released
    .pth's layout, against tests/oracles.py's eager forward (loaded from
    its path, sys.path left as it was); exit 2 without the ImageNet tree
    or without the tests directory."""
    from oracles import make_vit_state
    from tokenreduction_tpu_torch.tools import accuracy_gate

    pth = tmp_path / accuracy_gate.WEIGHT_FILE
    torch.save({"model": make_vit_state(2, 64, 1, 16, 1000, seed=3,
                                        n_tokens=196)}, pth)
    argv = ["--weights", str(pth), "--device", "cpu", "--depth", "2",
            "--embed-dim", "64", "--num-heads", "1"]
    path_before = list(sys.path)
    accuracy_gate.main(argv)
    assert sys.path == path_before
    out = capsys.readouterr().out
    assert "logit parity" in out and "PASS" in out
    with pytest.raises(SystemExit) as e:
        accuracy_gate.main([*argv, "--data", str(tmp_path / "nope")])
    assert e.value.code == 2
    monkeypatch.setattr(accuracy_gate, "TESTS", tmp_path / "no_tests")
    with pytest.raises(SystemExit) as e:
        accuracy_gate.main(argv)
    assert e.value.code == 2


def test_tpu_parity_runs_on_the_cpu(tmp_path, capsys):
    """Both phases of the gate in this process at DeiT-Ti width: the CPU
    reference, then every gate (on the CPU every route is the plain one)."""
    from tokenreduction_tpu_torch.tools import tpu_parity

    ref = str(tmp_path / "ref.pt")
    common = ["--batch", "1", "--methods", "topk", "--sizes", "tiny",
              "--img-size", "128", "--ref", ref]
    assert tpu_parity.main([*common, "--cpu-phase"]) == 0
    assert tpu_parity.main([*common, "--device", "cpu", "--mt-steps", "16",
                            "--mt-batch", "1"]) == 0
    out = capsys.readouterr().out
    assert "topk-tiny@0.7/train" in out and "minitrain 16 steps" in out
    assert "all 2 eval + 2 train configs pass" in out
