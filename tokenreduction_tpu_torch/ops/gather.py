"""Batched token gather and scatter-add (counterpart of
tokenreduction_tpu/ops/gather.py).

The TPU package runs floating gathers as one-hot matmuls on the MXU; on
the card ``torch.gather`` is the plain gather. Its scatter-add keeps two
forms: on the CPU the sequential ``.at[].add`` of the JAX package's CPU
path, and on the card the one-hot product of its TPU path, because
``index_add_`` on CUDA floats sums colliding rows in an order that
changes from run to run. ``take_rows`` (the cluster family's distance
rows and columns) and ``complement_idx`` (EViT's fused patches) are a
plain gather and a sort on every device.
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


def take_rows(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Gather along ``axis`` of x with batched ids idx [B, K] (JAX
    ops/gather.py:44-64): for x [B, N, M], axis 1 gives out[b, k, m] =
    x[b, idx[b, k], m], axis 2 out[b, n, k] = x[b, n, idx[b, k]]."""
    shape = [1] * x.dim()
    shape[0], shape[axis] = idx.shape
    size = list(x.shape)
    size[axis] = idx.shape[1]
    return torch.gather(x, axis, idx.long().view(shape).expand(size))


def complement_idx(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Sorted complement of idx [B, K] within range(dim) -> [B, dim - K]
    (JAX ops/gather.py:88-102, reference models/evit.py:25-46): zeros
    scattered at the selected positions of an arange, sorted, the first K
    dropped. Where 0 is selected the K zeros sort to the front; where it
    is not, one of the K + 1 zeros is the unselected 0 and stays."""
    K = idx.shape[1]
    a = torch.arange(dim, dtype=idx.dtype, device=idx.device) \
        .expand(idx.shape[0], dim)
    masked = a.scatter(1, idx.long(), 0)
    return torch.sort(masked, dim=-1)[0][:, K:]
