"""Batched token gather (counterpart of tokenreduction_tpu/ops/gather.py).

The TPU package runs floating gathers as one-hot matmuls on the MXU; on
the card ``torch.gather`` is the plain gather.
"""

from __future__ import annotations

import torch


def take_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, K] -> [B, K, C] (reference models/topk.py:92)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))
