"""PyTorch/CUDA port of VMG for an NVIDIA H100.

The JAX package ``vmg_tpu`` is the reference; this package imports torch
and never jax.  Every Pallas kernel on the serving path has a hand-written
CUDA counterpart under ``csrc/`` (built at first use by ``_build``) with a
plain PyTorch version beside it in ``ops/``; CPU tensors take the plain
version, CUDA tensors the kernel.  Each such kernel is a PyTorch operator
of the ``vmg`` namespace (``ops/library.py``), registered when this package
is imported (its models import every module that defines one), so a
program exported with them (``ckpt/export.py``) loads after ``import
vmg_tpu_torch``.
"""

from vmg_tpu_torch.configs import (FEW_LEVELS_PRESET, FULL_PRESET, TINY_TEST_PRESET,
                                   VMGNetworkConfig)
from vmg_tpu_torch.models.vmg import VMG, create_model

__all__ = ["FEW_LEVELS_PRESET", "FULL_PRESET", "TINY_TEST_PRESET", "VMGNetworkConfig", "VMG",
           "create_model"]
