"""tokenreduction_tpu_torch: the PyTorch and CUDA port of tokenreduction_tpu.

The JAX package beside it is the reference this port is held against. This
package imports ``torch`` and never ``jax`` or ``flax``. Its hot path runs
hand-written CUDA kernels for Hopper (``csrc/``, built at first use); on
a CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from tokenreduction_tpu_torch.models.registry import (  # noqa: E402,F401
    create_model,
    list_models,
)
