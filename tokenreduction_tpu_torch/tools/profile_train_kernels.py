"""Per-width forward + backward timings of the port's training branches
on the card: the counterpart of ``tools/profile_train_kernels.py`` (where
the backward loses its budget of twice the forward's operations).

For N = 197, 138, 97, 68 it times value and grad of a chain of
``attend_branch_train`` (#9) and of ``mlp_branch`` (#10) halves, bf16, at
B x N (the gradients of the weights, as the JAX tool takes them), and
prints each time per branch beside its bound (forward + backward: three
times the forward's operations) and its share of the bf16 peak.

    python -m tokenreduction_tpu_torch.tools.profile_train_kernels

runs on the card; ``--device cpu`` runs the plain versions, timed by the
host's clock.
"""

from __future__ import annotations

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.ops.fused_block_train import attend_branch_train
from tokenreduction_tpu_torch.ops.fused_mlp_train import mlp_branch
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.profile_kernels import report

ITERS = 20
WIDTHS = (197, 138, 97, 68)
ATTN = ("ls", "lb", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("ls", "lb", "w1", "b1", "w2", "b2")


def vjp_chain(kind: str, n: int, device, iters: int, B: int):
    """fn(): the gradients of the mean of ``iters`` chained branches
    c + 1e-3 branch(c) with respect to the branch's weights."""
    w = M.weights(device)
    names = ATTN if kind == "attn" else MLP
    params = [w[k].requires_grad_() for k in names]
    x0 = M.inputs(B, n, device, seed=1)

    def fn():
        for t in params:
            t.grad = None
        c = x0
        for _ in range(iters):
            if kind == "attn":
                br, _ = attend_branch_train(c, *params, M.H, M.SCALE, M.EPS)
            else:
                br = mlp_branch(c, *params, M.EPS)
            c = c + br * 1e-3
        c.float().mean().backward()

    return fn


def train_cost(kind: str, B: int, n: int):
    flops, nbytes = (M.attn_cost if kind == "attn" else M.mlp_cost)(B, n)
    return 3 * flops, 2 * nbytes


def main(argv=None):
    args = M.parser("Per-width forward + backward times of the training "
                    "branches against their bounds.").parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    for kind, label in (("attn", "attn fwd+bwd"), ("mlp", "mlp  fwd+bwd")):
        for n in WIDTHS:
            fn = vjp_chain(kind, n, device, iters, args.batch)
            ms = M.timeit(fn, device, 1, reps=3) / iters
            print(report(label, n, ms, train_cost(kind, args.batch, n),
                         device), flush=True)


if __name__ == "__main__":
    main()
