"""DPC-KNN token clustering (reference models/dpcknn.py:44-140).

Counterpart of ``tokenreduction_tpu/ops/dpc_knn.py``, plain PyTorch on
every device (the JAX package has no kernel here either). The
reference's hidden ``torch.rand`` density noise is the explicit ``noise``
argument. The k nearest distances are ``torch.topk(..., largest=False)``,
exact, as JAX's ``approx_min_k`` is on the CPU. The merge keeps the JAX
package's one-hot batched products: ``index_add_`` on CUDA floats sums
colliding rows in an order that changes from run to run.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.gather import take_rows


def pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [B, N, M] of x [B, N, C] and y [B, M, C] by the
    matmul identity, the product accumulated in fp32 (fp32 out)."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True)
    xy = torch.bmm(x.float(), y.float().transpose(1, 2))
    d2 = x2 + y2.transpose(1, 2) - 2.0 * xy
    return torch.sqrt(torch.clamp(d2, min=0.0))


def cluster_dpc_knn(x, cluster_num: int, k: int, noise=None):
    """Density-peak clustering with kNN density. x [B, N, C]; noise: None
    or [B, N] uniform(0, 1) draws. Returns (idx_cluster [B, N] in
    [0, cluster_num), index_down [B, cluster_num])."""
    B, N, C = x.shape
    dist_matrix = pairwise_dist(x, x) / (C ** 0.5)
    # local density from the k nearest neighbours (self included)
    dist_nearest = torch.topk(dist_matrix, k, dim=-1, largest=False)[0]
    density = torch.exp(-(dist_nearest ** 2).mean(-1))
    if noise is not None:
        density = density + noise * 1e-6
    # distance to the nearest token of higher density
    mask = (density[:, None, :] > density[:, :, None]).to(x.dtype)
    dist_max = dist_matrix.reshape(B, -1).amax(-1)[:, None, None]
    dist_ind = dist_matrix * mask + dist_max * (1.0 - mask)
    dist = dist_ind.amin(-1)
    score = dist * density
    index_down = torch.topk(score, cluster_num, dim=-1)[1]
    # every token to its nearest centre
    idx_cluster = take_rows(dist_matrix, index_down, axis=1).argmin(1)
    # centres belong to their own cluster (reference dpcknn.py:96-98)
    match = index_down[:, None, :] == torch.arange(
        N, device=x.device)[None, :, None]  # [B, N, K]
    center_id = (match * torch.arange(cluster_num, device=x.device)).sum(-1)
    idx_cluster = torch.where(match.any(-1), center_id, idx_cluster)
    return idx_cluster, index_down


def merge_clusters(x, idx_cluster, cluster_num: int, token_weight=None,
                   idx_token=None, agg_weight=None):
    """Weighted average of the tokens of each cluster (reference
    dpcknn.py:103-140) by one-hot batched products summed in fp32.
    Returns (x_merged [B, K, C], idx_token_new, agg_weight_new), the last
    two None without idx_token."""
    B, N, C = x.shape
    if token_weight is None:
        token_weight = torch.ones(B, N, 1, dtype=x.dtype, device=x.device)
    onehot = (idx_cluster[..., None] == torch.arange(
        cluster_num, device=x.device)).to(x.dtype)  # [B, N, K]
    all_weight = (torch.bmm(token_weight.float().transpose(1, 2),
                            onehot.float())[:, 0].to(x.dtype) + 1e-6)
    # each token's cluster weight through the same one-hot
    w_of_token = torch.bmm(onehot, all_weight[..., None])  # [B, N, 1]
    norm_weight = token_weight / w_of_token
    x_merged = torch.bmm(onehot.float().transpose(1, 2),
                         (x * norm_weight).float()).to(x.dtype)
    idx_token_new = agg_weight_new = None
    if idx_token is not None:
        idx_token_new = torch.gather(idx_cluster, 1, idx_token)
        weight_t = torch.gather(norm_weight[..., 0], 1, idx_token)
        agg_weight_new = agg_weight * weight_t[..., None]
    return x_merged, idx_token_new, agg_weight_new
