"""Adaptive Token Sampling under static shapes (reference models/ats.py).

Counterpart of ``tokenreduction_tpu/ops/ats.py``. The reference produces
a ragged per-image token count via ``torch.unique`` + ``pad_sequence``
(ats.py:77-83). Here the output width is always the static
``num_sample_steps(sample_count) + 1`` (the CLS slot, then the sample
slots); duplicate samples become CLS-index (0) padding with mask False,
the reference's padding convention at a fixed width. Masked attention
makes the pad rows inert, so logits match the ragged computation.

Everything here is plain PyTorch on any device: the sampler is a handful
of small sorts and reductions, which the JAX package also leaves to XLA.
``torch.argmin`` keeps the first minimum, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def num_sample_steps(sample_count: int) -> int:
    """Exact torch.arange length semantics for the reference's step grid
    (ats.py:48): ceil((stop-start)/step) in float64. Due to fp rounding
    this is K-1 for most K but K for some (e.g. K=12, where
    (stop-start)/step = 11.000000000000002) -- a reference quirk that
    changes the sampled-token count and must be replicated for
    assignment fidelity."""
    K = sample_count
    start, stop, step = 1 / (2 * K), (2 * K - 1) / (2 * K), 2 / (2 * K)
    return int(np.ceil((stop - start) / step))


def sample_steps(sample_count: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """torch.arange(1/(2K), (2K-1)/(2K), 2/(2K)) CDF midpoints
    (reference ats.py:48), with the exact arange length, the values
    computed in float64 and rounded once to ``dtype``. Made on ``device``:
    a copy from the host would wait for the card at every sampling
    block."""
    K = sample_count
    i = torch.arange(num_sample_steps(K), dtype=torch.float64, device=device)
    return (1 / (2 * K) + i * (2 / (2 * K))).to(dtype)


def unique_pad_sorted(ids: torch.Tensor, big: int) -> torch.Tensor:
    """Static-shape torch.unique(sorted=True) + zero padding at the end.

    ids: [B, M] integer sample ids (>= 1, < big). Returns [B, M] with the
    unique values sorted ascending at the front and 0s padding the tail.
    """
    s = torch.sort(ids, dim=-1).values
    prev = torch.cat([torch.full_like(s[:, :1], -1), s[:, :-1]], dim=-1)
    vals = torch.where(s == prev, big, s)
    vals = torch.sort(vals, dim=-1).values
    return torch.where(vals == big, 0, vals)


def _sample(sig, mask, sample_count: int, eps: float):
    """(unique ids [B, K], new mask [B, K]) from the significance
    [B, N-1] of the patch tokens (reference ats.py:60-83)."""
    B, N = mask.shape
    normed = sig / (sig.sum(dim=-1, keepdim=True) + eps)
    cdf = torch.cumsum(normed, dim=1)
    cdf = torch.where(mask[:, 1:], cdf, cdf + 0.1)  # bump dead tokens
    steps = sample_steps(sample_count, cdf.dtype, cdf.device)
    dist = (steps[None, :, None] - cdf[:, None, :]).abs()
    sampled = dist.argmin(dim=-1) + 1  # ids in [1, N-1]
    unique_ids = unique_pad_sorted(sampled, big=N)
    ones = torch.ones(B, 1, dtype=torch.bool, device=mask.device)
    new_mask = torch.cat([ones, unique_ids != 0], dim=-1)
    # CLS first; 0-pads gather the CLS row (inert under the mask)
    unique_ids = torch.cat([torch.zeros_like(unique_ids[:, :1]), unique_ids],
                           dim=-1)
    return unique_ids, new_mask


def sample_ids_from_scores(cls_attn, value_norms, mask,
                           sample_count: int, eps: float = 1e-6):
    """Sampling decision from the CLS attention row and value norms.

    cls_attn: [B, H, N-1] (CLS->patch probabilities); value_norms:
    [B, H, N-1]; mask: bool [B, N]. Returns (unique_ids [B, K],
    new_mask [B, K]) -- identical ids to the full-probs path, computed
    without materializing the [B, H, N, N] tensor."""
    sig = torch.sum(cls_attn * value_norms, dim=1)  # [B, N-1]
    return _sample(sig, mask, sample_count, eps)


def adaptive_token_sampling(attn, v, mask, sample_count: int,
                            eps: float = 1e-6):
    """Inverse-transform sampling of tokens by CLS-attention significance.

    attn: [B, H, N, N] probabilities; v: [B, H, N, hd]; mask: bool [B, N].
    Returns (new_attn [B, H, K, N], new_mask [B, K],
    unique_sampled_token_ids [B, K]) with K = num_sample_steps + 1
    (reference ats.py:52-89).
    """
    cls_attn = attn[:, :, 0, 1:]  # [B, H, N-1]
    value_norms = torch.linalg.vector_norm(v[:, :, 1:, :], dim=-1)
    sig = torch.sum(cls_attn * value_norms, dim=1)
    unique_ids, new_mask = _sample(sig, mask, sample_count, eps)
    B, H, _, N = attn.shape
    new_attn = torch.gather(
        attn, 2, unique_ids[:, None, :, None].expand(B, H, -1, N))
    return new_attn, new_mask, unique_ids
