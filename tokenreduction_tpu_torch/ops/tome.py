"""ToMe bipartite soft matching and merge ops (counterpart of
tokenreduction_tpu/ops/tome.py:24-117, reference models/tome.py:230-338).

Semantics, as in the JAX package, as index tensors and gathers:
- tokens split into even (src/a) and odd (dst/b) sets;
- cosine similarity a @ b^T of the L2-normed head-mean keys, fp32;
- the r highest-scoring src tokens merge into their best dst token, r
  clamped to (t - protected) // 2;
- the merged output is cat([unmerged src, dst]): the token order changes;
  the unmerged indices are sorted when a class token is present, so CLS
  stays first;
- a reference quirk kept: the merge always scatter-adds, so source
  tracking sums.
The sort is stable (``jnp.argsort`` is; ``torch.argsort`` only with
``stable=True``), so tied scores merge the same tokens on both sides.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tokenreduction_tpu_torch.ops.gather import scatter_add_tokens, take_tokens


class MergeInfo(NamedTuple):
    unm_idx: Optional[torch.Tensor]  # [B, Ta - r] indices into the src set
    src_idx: Optional[torch.Tensor]  # [B, r] indices into the src set
    dst_idx: Optional[torch.Tensor]  # [B, r] indices into the dst set
    r: int
    t: int  # token count before merging


def bipartite_soft_matching(metric: torch.Tensor, r: int,
                            class_token: bool = True,
                            distill_token: bool = False) -> MergeInfo:
    """metric: [B, T, C] head-mean keys. Returns the merge indices.

    ``distill_token``: DeiT-distilled backbones carry the dist token at
    index 1 = dst-set column 0; like the CLS row it never merges
    (reference tome.py:245-266)."""
    t = metric.shape[1]
    protected = int(class_token) + int(distill_token)
    r = min(r, (t - protected) // 2)
    if r <= 0:
        return MergeInfo(None, None, None, 0, t)
    metric = metric / metric.norm(dim=-1, keepdim=True)
    a, b = metric[:, ::2].float(), metric[:, 1::2].float()
    scores = a @ b.transpose(1, 2)
    if class_token:
        scores[:, 0, :] = -torch.inf
    if distill_token:
        scores[:, :, 0] = -torch.inf
    node_max = scores.amax(-1)
    node_idx = scores.argmax(-1)  # the first of tied maxima, as jnp.argmax
    edge_idx = torch.argsort(-node_max, dim=-1, stable=True)  # descending
    unm_idx = edge_idx[:, r:]
    src_idx = edge_idx[:, :r]
    dst_idx = torch.gather(node_idx, 1, src_idx)
    if class_token:
        unm_idx = unm_idx.sort(dim=1).values
    return MergeInfo(unm_idx, src_idx, dst_idx, r, t)


def merge_tokens_tome(info: MergeInfo, x: torch.Tensor) -> torch.Tensor:
    """Apply the merge to x [B, T, C] -> [B, T - r, C] (sum semantics)."""
    if info.r <= 0:
        return x
    src, dst = x[:, ::2], x[:, 1::2]
    unm = take_tokens(src, info.unm_idx)
    src_sel = take_tokens(src, info.src_idx)
    dst = scatter_add_tokens(dst, info.dst_idx, src_sel)
    return torch.cat([unm, dst], dim=1)


def merge_wavg(info: MergeInfo, x: torch.Tensor,
               size: Optional[torch.Tensor]):
    """Size-weighted average merge (reference tome.py:309-323): returns
    (x, size), size [B, T - r, 1] in x's dtype."""
    if size is None:
        size = torch.ones_like(x[..., :1])
    x = merge_tokens_tome(info, x * size)
    size = merge_tokens_tome(info, size)
    return x / size, size


def merge_source_assignment(info: MergeInfo,
                            class_token: bool = True) -> torch.Tensor:
    """Per-block cluster assignment of each pre-merge token (reference
    models/tome.py:91-99): merge an identity source matrix, label each row
    by its index + 1, take the column-wise max, then shift (-2 and drop
    the CLS column with a class token) so ids index the merged non-CLS
    tokens. Returns [B, T - (1 if cls)] int32. The identity's rows are
    0/1 with disjoint supports, so every order of the sums gives the same
    numbers."""
    B, t = info.unm_idx.shape[0], info.t
    device = info.unm_idx.device
    eye = torch.eye(t, device=device).expand(B, t, t)
    source = merge_tokens_tome(info, eye)  # [B, t - r, t]
    row_ids = torch.arange(1, source.shape[1] + 1, dtype=torch.float32,
                           device=device)
    assign = (source * row_ids[None, :, None]).amax(-2)
    assign = assign[:, 1:] - 2.0 if class_token else assign - 1.0
    return assign.to(torch.int32)
