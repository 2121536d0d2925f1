"""Log-space Sinkhorn optimal transport (reference models/sinkhorn.py:25-56).

Counterpart of ``tokenreduction_tpu/ops/sinkhorn.py``, plain PyTorch on
every device: a fixed count of iterations (a config field), in the
scores' dtype (fp32 in the models).
"""

from __future__ import annotations

import torch


def log_sinkhorn_iterations(Z, log_mu, log_nu, iters: int):
    """Sinkhorn normalisation in log space; Z [B, M, N]."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores, eps: float, iters: int):
    """Differentiable OT with uniform marginals 1/(M+N), returned in
    probability space scaled by M+N; scores [B, M, N]."""
    b, m, n = scores.shape
    norm = -torch.log(torch.full((), m + n, dtype=scores.dtype,
                                 device=scores.device))
    log_mu, log_nu = norm.expand(b, m), norm.expand(b, n)
    Z = log_sinkhorn_iterations(scores / eps, log_mu, log_nu, iters)
    return torch.exp(Z - norm)
