"""The port's attention-core prototypes against the JAX tools' own kernels.

``tools/proto_attn.py``'s ``make_kernel`` (every arrangement) and
``tools/proto_attn_bwd.py``'s ``make_bwd_kernel`` (both) run in a
``pl.pallas_call`` that this file builds at B = 2 with the tools'
BlockSpecs (their ``build()`` fixes B = 256 and a timed scan), under
``force_tpu_interpret_mode``; the port's counterparts
(``tokenreduction_tpu_torch/tools/proto_attn.py``, ``proto_attn_bwd.py``)
run their plain versions on the CPU from the same numpy-seeded inputs, the
weights carried across by ``_measure.from_jax_layout``. The tools fix
D = 384 and 6 heads; N = 13 (odd) and 16.

Tolerances: fp32, 1e-4 of max|JAX| (the two sides sum in other orders);
bf16, 2e-2 of max|JAX| (each side rounds qkv, the probabilities, the merged
heads, ds and the gradients of q, k and v to bf16, and one bf16 ulp is
2^-8 of a value: a sum that rounds apart moves a rounded intermediate by
an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tokenreduction_tpu_torch.tools import _measure
from tokenreduction_tpu_torch.tools import proto_attn as port_attn
from tokenreduction_tpu_torch.tools import proto_attn_bwd as port_bwd
from tools import proto_attn as jax_attn
from tools import proto_attn_bwd as jax_bwd

D, H = 384, 6
B = 2
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny products: in one thread, so that the test
    workers' thread pools do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def weights_np(seed: int) -> dict:
    """A block's weights in the JAX tools' [in, out] layout (LN parameters
    and biases away from 1 and 0)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    return {"ls": r(D, scale=0.1, shift=1.0), "lb": r(D, scale=0.1),
            "wqkv": r(D, 3 * D), "bqkv": r(3 * D, scale=0.1),
            "wproj": r(D, D)}


def both(arrays: dict, dtype: str):
    """(JAX arrays, the port's tensors) of the same values: rounded to the
    dtype on the JAX side, carried across exactly."""
    jdt, tdt, _ = DTYPES[dtype]
    j = {k: jnp.asarray(v, jdt) for k, v in arrays.items()}
    t = _measure.from_jax_layout(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in j.items()},
        dtype=tdt)
    return j, t


def normal(shape, seed: int, dtype: str):
    """(JAX array, torch tensor) of N(0, 1) values in the dtype."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    aj = jnp.asarray(a, jdt)
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).to(tdt)


def close(got, want, tol, what):
    got = np.asarray(got.detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: {err:.3e} of max|want| > {tol}"


def jax_forward(variant: str, n: int, x, wqkv, wproj, G: int = 1):
    """The JAX tool's kernel in the tool's pallas_call layout at B = 2."""
    const = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: tuple(0 for _ in shape), memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        return pl.pallas_call(
            jax_attn.make_kernel(variant, n, G), grid=(B // G,),
            in_specs=[pl.BlockSpec((G, n, D), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
                      const((D, 3 * D)), const((D, D))],
            out_specs=pl.BlockSpec((G, n, D), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((B, n, D), x.dtype),
        )(x, wqkv, wproj)


def jax_backward(variant: str, n: int, x, w, dy, drow0, G: int = 1):
    """The JAX tool's backward kernel in the tool's pallas_call layout at
    B = 2: (dx, dwqkv, dwproj), the weights' gradients in fp32 and its
    [in, out] layout."""
    const = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: tuple(0 for _ in shape), memory_space=pltpu.VMEM)
    rows = pl.BlockSpec((G, n, D), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        return pl.pallas_call(
            jax_bwd.make_bwd_kernel(variant, n, G), grid=(B // G,),
            in_specs=[rows, const((1, D)), const((1, D)), const((D, 3 * D)),
                      const((1, 3 * D)), const((D, D)), rows,
                      pl.BlockSpec((G, H, 1, n), lambda i: (i, 0, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=[rows, const((D, 3 * D)), const((D, D))],
            out_shape=[jax.ShapeDtypeStruct((B, n, D), x.dtype),
                       jax.ShapeDtypeStruct((D, 3 * D), jnp.float32),
                       jax.ShapeDtypeStruct((D, D), jnp.float32)],
        )(x, w["ls"][None], w["lb"][None], w["wqkv"], w["bqkv"][None],
          w["wproj"], dy, drow0[:, :, None, :])


@pytest.mark.parametrize("n", (13, 16))
@pytest.mark.parametrize("dtype", DTYPES)
def test_proto_attn_matches_jax(dtype, n):
    """Every arrangement of the JAX tool against the port's same
    arrangement."""
    wj, wt = both({k: v for k, v in weights_np(0).items()
                   if k in ("wqkv", "wproj")}, dtype)
    xj, xt = normal((B, n, D), 1, dtype)
    tol = DTYPES[dtype][2]
    want = {v: jax_forward(v, n, xj, wj["wqkv"], wj["wproj"])
            for v in port_attn.VARIANTS}
    for variant in port_attn.VARIANTS:
        got = port_attn.proto_attn(xt, wt, variant)
        assert got.dtype == xt.dtype
        close(got, want[variant], tol, f"proto_attn {variant}")


@pytest.mark.parametrize("n", (13, 16))
@pytest.mark.parametrize("dtype", DTYPES)
def test_proto_attn_bwd_matches_jax(dtype, n):
    """Both arrangements' dx, dwqkv and dwproj against the JAX tool's
    same arrangement, each within the tolerance of its own max. (On the
    TPU the tool's pack2 compiled only at N a multiple of 8; in interpret
    mode it runs at 13 too.)"""
    wj, wt = both(weights_np(2), dtype)
    xj, xt = normal((B, n, D), 3, dtype)
    dyj, dyt = normal((B, n, D), 4, dtype)
    drow0 = (0.1 * np.random.default_rng(5).standard_normal((B, H, n))) \
        .astype(np.float32)
    tol = DTYPES[dtype][2]
    for variant in port_bwd.VARIANTS:
        want = jax_backward(variant, n, xj, wj, dyj, jnp.asarray(drow0))
        got = port_bwd.proto_attn_bwd(xt, wt, dyt, torch.from_numpy(drow0),
                                      variant)
        assert got[0].dtype == xt.dtype
        assert got[1].dtype == got[2].dtype == torch.float32
        for name, g, w_ in zip(port_bwd.OUTPUTS, got, want):
            # the JAX tool's weight gradients are in its [in, out] layout
            close(g.T if g.dim() == 2 else g, w_, tol, f"{variant} {name}")


def test_proto_arguments_and_counters():
    """The arrangements by name, and no launch on the CPU."""
    _, wt = both(weights_np(0), "fp32")
    _, xt = normal((B, 13, D), 1, "fp32")
    with pytest.raises(ValueError, match="variant"):
        port_attn.proto_attn(xt, wt, "pairs")
    dy = torch.zeros_like(xt)
    drow0 = torch.zeros(B, H, 13)
    with pytest.raises(ValueError, match="variant"):
        port_bwd.proto_attn_bwd(xt, wt, dy, drow0, "pack4")
    assert port_attn.proto_attn.launches == 0
    assert port_bwd.proto_attn_bwd.launches == 0
