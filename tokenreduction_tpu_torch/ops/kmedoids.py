"""Weighted k-medoids token clustering (reference models/kmedoids.py:40-85).

Counterpart of ``tokenreduction_tpu/ops/kmedoids.py``, plain PyTorch on
every device. Each medoid update is one masked argmin over a [B, N, K]
score tensor; the masked entries hold the reference's sentinel sum
``1e6 * N`` in x's dtype, so an empty cluster takes token 0 as its
medoid, as in the reference.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.dpc_knn import pairwise_dist
from tokenreduction_tpu_torch.ops.gather import take_rows, take_tokens


def farthest_point_init(x, cluster_num: int, first) -> torch.Tensor:
    """Equal-weight init (reference kmedoids.py:44-59): the first medoid
    ``first`` (an int or a 0-d tensor, one draw shared across the batch),
    then each next the token farthest from its nearest chosen medoid.
    Returns int64 ids [B, cluster_num]."""
    B, N, _ = x.shape
    cluster_idx = torch.as_tensor(first, device=x.device).long() \
        .reshape(1, 1).expand(B, 1)
    for _ in range(1, cluster_num):
        inter = pairwise_dist(x, take_tokens(x, cluster_idx))  # [B, N, k]
        # the chosen tokens' rows are zeroed: never picked again
        chosen = torch.zeros(B, N, dtype=torch.bool, device=x.device) \
            .scatter(1, cluster_idx, True)
        inter = torch.where(chosen[..., None], 0.0, inter)
        new_idx = inter.amax(-1).argmax(-1)
        cluster_idx = torch.cat([cluster_idx, new_idx[:, None]], dim=-1)
    return cluster_idx


def k_medoids_fit(x, cluster_num: int, iterations: int = 5,
                  token_weight=None, first=None):
    """x [B, N, C]; token_weight: None (equal weights, farthest-point init
    from the medoid ``first``) or [B, N, 1] (init: the top-k weights).
    Returns (centers [B, K, C], cluster_idx [B, K], assignment [B, N])."""
    B, N, C = x.shape
    if token_weight is None:
        if first is None:
            raise ValueError("equal-weight k-medoids needs its first medoid "
                             "(drawn from the model's generator)")
        cluster_idx = farthest_point_init(x, cluster_num, first)
        token_weight = torch.ones(B, N, 1, dtype=x.dtype, device=x.device)
    else:
        # the attention-mass top-k (reference kmedoids.py:63-64)
        cluster_idx = torch.topk(token_weight[..., 0], cluster_num,
                                 dim=-1)[1]
    dist_matrix = pairwise_dist(x, x)
    # row i scaled by weight_i: each row's total distance to all tokens
    row_total = dist_matrix.sum(-1) * token_weight[..., 0]  # [B, N]
    masked_total = torch.full((), 1e6 * N, dtype=x.dtype, device=x.device)
    clusters = torch.arange(cluster_num, device=x.device)
    for _ in range(iterations):
        assignment = take_rows(dist_matrix, cluster_idx, axis=2).argmin(-1)
        onehot = assignment[..., None] == clusters  # [B, N, K]
        scores = torch.where(onehot, row_total[..., None], masked_total)
        cluster_idx = scores.argmin(1)  # [B, K]
    assignment = take_rows(dist_matrix, cluster_idx, axis=2).argmin(-1)
    return take_tokens(x, cluster_idx), cluster_idx, assignment
