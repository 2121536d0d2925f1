"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device: with no device given and
    no CUDA device present this raises, instead of carrying on quietly on
    the CPU (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")
