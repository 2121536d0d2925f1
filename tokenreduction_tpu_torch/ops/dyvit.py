"""DyViT's policy softmax and straight-through Gumbel-softmax (reference
models/dyvit.py:39-51, torch.nn.functional.gumbel_softmax with
hard=True).

Counterpart of ``tokenreduction_tpu/ops/dyvit.py``. The JAX package has
no kernel here (XLA computes both), so these are plain PyTorch on every
device. The Gumbel noise comes from the explicit ``torch.Generator`` that
the model's forward hands down, the same generator as dropout and drop
path, where JAX draws from a ``gumbel`` stream of its own.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.parallel.mesh import draw_rows


def softmax_with_policy(attn, policy, eps: float = 1e-6):
    """The policy-masked softmax over the last axis, differentiable in the
    policy.

    attn: [B, H, N, N] logits; policy: [B, N, 1], a soft {0, 1} mask of
    the keys. Each query keeps itself (the identity escape ``policy + (1 -
    policy) * eye``); the exponentials are fp32, ``eps / N`` is added to
    each before the division by ``sum + eps``, and the result takes the
    logits' dtype, as the reference does."""
    B, N, _ = policy.shape
    attn_policy = policy.reshape(B, 1, 1, N)
    eye = torch.eye(N, dtype=attn_policy.dtype, device=attn_policy.device) \
        .reshape(1, 1, N, N)
    attn_policy = attn_policy + (1.0 - attn_policy) * eye
    max_att = attn.amax(dim=-1, keepdim=True)
    attn = torch.exp((attn - max_att).float()) * attn_policy.float()
    attn = (attn + eps / N) / (attn.sum(dim=-1, keepdim=True) + eps)
    return attn.to(max_att.dtype)


def gumbel_uniform(shape, dtype, device, generator: torch.Generator):
    """Uniforms in ``dtype`` on [finfo(dtype).tiny, 1) from ``generator``,
    the range of JAX's ``uniform(minval=tiny, maxval=1)``."""
    u = draw_rows(torch.rand, shape, generator=generator, dtype=dtype,
                  device=device)
    return u.clamp_min(torch.finfo(dtype).tiny)


def gumbel_softmax_hard(logits, generator: torch.Generator,
                        tau: float = 1.0):
    """Straight-through hard Gumbel-softmax over the last axis: the one-hot
    of the argmax of ``softmax((logits + g) / tau)`` forward, the soft
    values' gradient backward; g = -log(-log(u)) with u drawn in the
    logits' dtype (``gumbel_uniform``)."""
    u = gumbel_uniform(logits.shape, logits.dtype, logits.device, generator)
    gumbels = -torch.log(-torch.log(u))
    y_soft = torch.softmax((logits + gumbels) / tau, dim=-1)
    index = y_soft.argmax(dim=-1, keepdim=True)
    y_hard = (torch.arange(logits.shape[-1], device=logits.device)
              == index).to(logits.dtype)
    return y_hard + y_soft - y_soft.detach()
