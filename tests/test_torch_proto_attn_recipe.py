"""The arithmetic of the attention prototypes' sm_90a kernels, in plain
PyTorch, against the JAX tools themselves.

``tokenreduction_tpu_torch/csrc/proto_attn.cu`` (#14) and
``csrc/proto_attn_bwd.cu`` (#15) compute in their own order, which a CPU
cannot run as CUDA. This file writes that order out in PyTorch
(``recipe_attention``, ``recipe_attention_bwd``, and around them the launches
of the tools' chains) and holds it against ``tools/proto_attn.py``'s
``make_kernel`` and ``tools/proto_attn_bwd.py``'s ``make_bwd_kernel``, their
Pallas kernels in interpret mode (``force_tpu_interpret_mode``, through the
pallas_call layouts of tests/test_torch_proto_attn.py): in bf16 each
arrangement against the JAX tool's same arrangement, in fp32 (where the
arrangements differ only in their sums' order) against its loop. The
kernels' order:

- both: per (image, head), q, k and v on 64-row tiles, rows past N zeros;
  logits in base-2 units (q.k * scale * log2 e; key columns past N at
  -inf); ex2 less the exact row max, 1/sum, P = e * (1 / sum) in fp32;
- #14 loop: P rounded, O = P V in fp32, rounded; avpair: each head pair's
  O as the sum over its two K halves, P_h [V_h | 0] then P_h+1 [0 |
  V_h+1], into one 128-column fp32 accumulator, rounded; stacked: S_h^T =
  K_h Q_h^T, every head's logits of the same query rows stacked into one
  buffer [H x rows, keys] and one softmax pass over its rows, O_h^T =
  V_h^T P_h^T, transposed back, rounded; the projection and the residual
  as the GEMM launch after the kernel (x + proj in fp32, rounded once);
- #15: the row statistics recomputed from q and k as above; dP = dO V^T
  with drow0 added on query row 0; delta = sum over the keys of P dP in
  full (fp32 P); dS = round(P (dP - delta) * scale); merged = round(round(P)
  V); dV = round(round(P)^T dO), dK = round(dS^T Q); dQ summed in fp32 over
  the key tiles in order (loop: dS K a key tile at a time into the fp32 dQ;
  pack2: [dS; P] [K | V] a key tile at a time into one accumulator, its dq
  quadrant kept, and [dS | P]^T [Q | dO], its dk and dv quadrants kept),
  each rounded once; around it the tool's chain: LayerNorm and the qkv GEMM
  (rounded), do = dy Wproj (rounded), the fp32 weight gradients, dln =
  dqkv Wqkv and the LayerNorm backward.

Inputs: seeded numpy, the same to both sides; B = 2 with N = 13 (an image
shorter than one tile) and 72 (a second, partial key and query tile).
Bounds, each over the tensor's max|JAX|: fp32 1e-4 (the two sides sum in
other orders, and the JAX tools take exp, not ex2); bf16 2e-2 (each side
rounds qkv, the probabilities, the merged heads, ds and the gradients to
bf16, and a sum that rounds apart moves a rounded value by an ulp, 2^-8).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_proto_attn import (
    B,
    D,
    DTYPES,
    H,
    both,
    close,
    jax_backward,
    jax_forward,
    normal,
    weights_np,
)
from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_bwd_ref,
    layer_norm_stats,
    linear_f32,
    packed_heads,
)
from tokenreduction_tpu_torch.tools import proto_attn as port_attn
from tokenreduction_tpu_torch.tools import proto_attn_bwd as port_bwd

HD = D // H
SCALE = HD ** -0.5
EPS = 1e-6
TILE = 64  # the kernels' rows a tile (query or key)
LOG2E = 1.4426950408889634
WIDTHS = (13, 72)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny products in one thread (the test workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the kernels' arithmetic
def c2() -> torch.Tensor:
    """scale * log2 e, one fp32 product as the kernels form it."""
    return torch.tensor(SCALE, dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)


def padded_heads(t, n: int):
    """[B, H, T, 64] fp32 of the [B, N, 64 H] heads view, rows past N
    zeros (T: N rounded up to a tile)."""
    Bn, _, Dn = t.shape
    T = -(-n // TILE) * TILE
    out = torch.zeros(Bn, T, Dn)
    out[:, :n] = t.float()
    return out.view(Bn, T, Dn // HD, HD).transpose(1, 2)


def probs(q, k, n: int):
    """(P fp32, base-2 row max, 1/sum) of q, k [.., T, 64]: base-2 logits,
    key columns past N at -inf, ex2 less the exact row max, P = e * (1 /
    sum)."""
    T = q.shape[-2]
    key_bias = torch.full((T,), -math.inf)
    key_bias[:n] = 0.0
    x = q @ k.transpose(-1, -2) * c2() + key_bias
    m = x.amax(-1, keepdim=True)
    e = torch.exp2(x - m)
    r = 1.0 / e.sum(-1, keepdim=True)
    return e * r, m, r


def recipe_attention(qkv, variant: str):
    """merged [B, N, D] of the packed qkv in proto_attn.cu's order for the
    arrangement."""
    dt = qkv.dtype
    Bn, n, _ = qkv.shape
    q, k, v = (padded_heads(t.transpose(1, 2).reshape(Bn, n, D), n)
               for t in packed_heads(qkv, H))
    T = q.shape[-2]
    if variant == "stacked":
        # S_h^T = K_h Q_h^T; the heads' logits of the same query rows
        # stacked into one buffer, one softmax pass over its rows
        st = k @ q.transpose(-1, -2)                        # [B, H, keys, q]
        buf = st.transpose(-1, -2).reshape(Bn, H * T, T)    # rows (h, q)
        key_bias = torch.full((T,), -math.inf)
        key_bias[:n] = 0.0
        x = buf * c2() + key_bias
        e = torch.exp2(x - x.amax(-1, keepdim=True))
        p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt).float()
        pt = p.view(Bn, H, T, T).transpose(-1, -2)          # P_h^T [keys, q]
        o = (v.transpose(-1, -2) @ pt).transpose(-1, -2)    # (V^T P^T)^T
    else:
        p = probs(q, k, n)[0].to(dt).float()
        if variant == "loop":
            o = p @ v
        else:  # avpair: [P_h | P_h+1] blockdiag(V_h, V_h+1), K half by half
            z = torch.zeros_like(v[:, 0::2])
            acc = p[:, 0::2] @ torch.cat([v[:, 0::2], z], -1)
            acc = acc + p[:, 1::2] @ torch.cat([z, v[:, 1::2]], -1)
            o = torch.stack([acc[..., :HD], acc[..., HD:]], 2) \
                .reshape(Bn, H, T, HD)
    return o.to(dt)[:, :, :n].transpose(1, 2).reshape(Bn, n, D)


def recipe_proto_attn(x, w, variant: str):
    """x + proj(attn(qkv(x))): the qkv GEMM launch (fp32 sum, rounded), the
    kernel, the proj GEMM launch with the residual (x + proj in fp32,
    rounded once)."""
    dt = x.dtype
    qkv = (x.float() @ w["wqkv"].float().T).to(dt)
    merged = recipe_attention(qkv, variant)
    return (x.float() + merged.float() @ w["wproj"].float().T).to(dt)


def recipe_attention_bwd(qkv, dout, drow0, variant: str):
    """(merged [B, N, D], dqkv [B, N, 3D]) in proto_attn_bwd.cu's order."""
    dt = qkv.dtype
    Bn, n, _ = qkv.shape
    q, k, v = (padded_heads(t.transpose(1, 2).reshape(Bn, n, D), n)
               for t in packed_heads(qkv, H))
    do = padded_heads(dout, n)
    T = q.shape[-2]
    # the first pass: the statistics recomputed, delta in full
    p, _, _ = probs(q, k, n)
    dp = do @ v.transpose(-1, -2)
    dp[:, :, 0, :n] += drow0.float()  # the row0 cotangent, query row 0
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * SCALE).to(dt).float()
    pc = p.to(dt).float()
    dq = torch.zeros(Bn, H, T, HD)
    if variant == "loop":
        merged = pc @ v
        for kt in range(T // TILE):  # dS K, a key tile at a time, in order
            keys = slice(kt * TILE, (kt + 1) * TILE)
            dq = dq + ds[..., keys] @ k[:, :, keys]
        dk = ds.transpose(-1, -2) @ q
        dv = pc.transpose(-1, -2) @ do
    else:  # pack2
        acc = torch.zeros(Bn, H, 2 * T, 2 * HD)
        for kt in range(T // TILE):  # [dS; P] [K | V], a key tile at a time
            keys = slice(kt * TILE, (kt + 1) * TILE)
            acc = acc + torch.cat([ds[..., keys], pc[..., keys]], 2) \
                @ torch.cat([k[:, :, keys], v[:, :, keys]], -1)
        dq, merged = acc[:, :, :T, :HD], acc[:, :, T:, HD:]
        m2 = torch.cat([ds, pc], -1).transpose(-1, -2) \
            @ torch.cat([q, do], -1)                        # [dS | P]^T [Q | dO]
        dk, dv = m2[:, :, :T, :HD], m2[:, :, T:, HD:]

    def heads(t):
        return t.to(dt)[:, :, :n].transpose(1, 2).reshape(Bn, n, D)

    return heads(merged), torch.cat([heads(dq), heads(dk), heads(dv)], -1)


def recipe_proto_attn_bwd(x, w, dy, drow0, variant: str):
    """(dx, dwqkv, dwproj) in the order of proto_attn_bwd's chain: the
    layer_norm and qkv gemm launches (rounded), do = dy Wproj (the gemm
    launch with w_kn, rounded), the kernel, the two fp32 weight gradients,
    dln = dqkv Wqkv in fp32, the LayerNorm backward (rounded)."""
    dt = x.dtype
    Bn, n, _ = x.shape
    x_hat, rstd = layer_norm_stats(x.float().reshape(Bn * n, D), EPS)
    ln = (x_hat * w["ls"].float() + w["lb"].float()).to(dt)
    qkv = linear_f32(ln, w["wqkv"], w["bqkv"]).to(dt).reshape(Bn, n, 3 * D)
    dy2 = dy.reshape(Bn * n, D).float()
    dout = (dy2 @ w["wproj"].float()).to(dt).reshape(Bn, n, D)
    merged, dqkv = recipe_attention_bwd(qkv, dout, drow0, variant)
    dqkv = dqkv.reshape(Bn * n, 3 * D).float()
    dwproj = dy2.T @ merged.reshape(Bn * n, D).float()
    dwqkv = dqkv.T @ ln.float()
    dx = layer_norm_bwd_ref(dqkv @ w["wqkv"].float(), x_hat, rstd, w["ls"])[0]
    return dx.to(dt).reshape(Bn, n, D), dwqkv, dwproj


# ---- the JAX side, once per arrangement, width and dtype: in bf16 the JAX
# tool's same arrangement (its rounding points); in fp32, where a rounding
# to the dtype changes nothing and the arrangements differ only in their
# sums' order, the JAX tool's loop for every arrangement
def jax_variant(variant: str, dtype: str) -> str:
    return variant if dtype == "bf16" else "loop"


@functools.lru_cache(maxsize=None)
def forward_case(variant: str, n: int, dtype: str):
    wj, wt = both({k: v for k, v in weights_np(0).items()
                   if k in ("wqkv", "wproj")}, dtype)
    xj, xt = normal((B, n, D), 1, dtype)
    return jax_forward(variant, n, xj, wj["wqkv"], wj["wproj"]), wt, xt


@functools.lru_cache(maxsize=None)
def backward_case(variant: str, n: int, dtype: str, row0_only: bool = False):
    """row0_only: dy = 0 and drow0 ~ N(0, 1), so that the whole gradient
    comes through the row0 cotangent (at the tool's N(0, 0.1^2) beside dy
    its part of dx and dwqkv lies under the bounds)."""
    wj, wt = both(weights_np(2), dtype)
    xj, xt = normal((B, n, D), 3, dtype)
    dyj, dyt = normal((B, n, D), 4, dtype)
    drow0 = np.random.default_rng(5).standard_normal((B, H, n)) \
        .astype(np.float32)
    if row0_only:
        dyj, dyt = dyj * 0, dyt * 0
    else:
        drow0 = drow0 * np.float32(0.1)
    want = jax_backward(variant, n, xj, wj, dyj, jnp.asarray(drow0))
    return want, wt, xt, dyt, torch.from_numpy(drow0)


@pytest.mark.parametrize("variant", port_attn.VARIANTS)
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_proto_attn_recipe_matches_jax(dtype, n, variant):
    want, wt, xt = forward_case(jax_variant(variant, dtype), n, dtype)
    got = recipe_proto_attn(xt, wt, variant)
    assert got.dtype == xt.dtype
    close(got, want, DTYPES[dtype][2], f"proto_attn {variant} recipe")


@pytest.mark.parametrize("variant", port_bwd.VARIANTS)
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_proto_attn_bwd_recipe_matches_jax(dtype, n, variant):
    want, wt, xt, dyt, drow0 = backward_case(jax_variant(variant, dtype), n,
                                             dtype)
    got = recipe_proto_attn_bwd(xt, wt, dyt, drow0, variant)
    assert got[0].dtype == xt.dtype
    for name, g, w_ in zip(port_bwd.OUTPUTS, got, want):
        # the JAX tool's weight gradients are in its [in, out] layout
        close(g.T if g.dim() == 2 else g, w_, DTYPES[dtype][2],
              f"{variant} {name} recipe")


@pytest.mark.parametrize("variant", port_bwd.VARIANTS)
def test_proto_attn_bwd_recipe_row0_path(variant):
    """The gradient through the row0 cotangent alone (dy = 0), bf16 at
    N = 72: dx and dwqkv against the JAX tool's same arrangement (dwproj
    is 0 on both sides)."""
    dtype, n = "bf16", 72
    want, wt, xt, dyt, drow0 = backward_case(variant, n, dtype, True)
    got = recipe_proto_attn_bwd(xt, wt, dyt, drow0, variant)
    assert float(got[2].abs().max()) == 0.0
    close(got[0], want[0], DTYPES[dtype][2], f"{variant} dx, row0 alone")
    close(got[1].T, want[1], DTYPES[dtype][2], f"{variant} dwqkv, row0 alone")


@pytest.mark.parametrize("n", WIDTHS)
def test_recipes_agree_across_arrangements(n):
    """The arrangements compute one function: avpair's zero blocks add
    exact zeros, stacked's transposed products and pack2's quadrants move
    fp32 sums only, each within a bf16 rounding of loop."""
    _, qkv = normal((B, n, 3 * D), 6, "bf16")
    loop = recipe_attention(qkv, "loop")
    for variant in ("avpair", "stacked"):
        close(recipe_attention(qkv, variant), loop.float().numpy(), 2e-2,
              f"{variant} against loop")
    _, dout = normal((B, n, D), 7, "bf16")
    drow0 = 0.1 * torch.randn(B, H, n, generator=torch.Generator()
                              .manual_seed(8))
    for a, b in zip(recipe_attention_bwd(qkv, dout, drow0, "pack2"),
                    recipe_attention_bwd(qkv, dout, drow0, "loop")):
        close(a, b.float().numpy(), 2e-2, "pack2 against loop")
