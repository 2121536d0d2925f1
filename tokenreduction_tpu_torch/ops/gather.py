"""Batched token gather and scatter-add (counterpart of
tokenreduction_tpu/ops/gather.py).

The TPU package runs floating gathers as one-hot matmuls on the MXU; on
the card ``torch.gather`` is the plain gather. Its scatter-add keeps two
forms: on the CPU the sequential ``.at[].add`` of the JAX package's CPU
path, and on the card the one-hot product of its TPU path, because
``index_add_`` on CUDA floats sums colliding rows in an order that
changes from run to run.
"""

from __future__ import annotations

import torch


def take_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, K] -> [B, K, C] (reference models/topk.py:92)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))


def scatter_add_tokens(dst: torch.Tensor, idx: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """dst [B, T, C] + src [B, K, C] added at token positions idx [B, K],
    out of place and differentiable.

    CPU: the rows are added one at a time in order k = 0..K-1, the JAX
    CPU path's ``dst.at[b, idx].add(src)``. CUDA: dst + onehot(idx)^T
    src, one batched product summing in fp32 and rounded once to dst's
    dtype (the JAX TPU path, ops/gather.py:78-83): the same bits from run
    to run; where three or more rows meet one token the sum may differ
    from the sequential order in the last place."""
    if not dst.is_cuda:
        out = dst.clone()
        rows = torch.arange(dst.shape[0], device=dst.device)
        for k in range(idx.shape[1]):
            out[rows, idx[:, k]] += src[:, k]
        return out
    onehot = torch.nn.functional.one_hot(idx.long(), dst.shape[1]).float()
    added = torch.bmm(onehot.transpose(1, 2), src.float())
    return dst + added.to(dst.dtype)
