"""fluidsim_tpu_torch — the PyTorch/CUDA port of fluidsim_tpu.

The JAX package ``fluidsim_tpu`` is the reference this package is checked
against; this package imports neither it nor JAX.  Plain tensor code is
PyTorch; the hot kernels are CUDA C++ for Hopper (``csrc/``), built on first
use by ``kernels/_build.py``.
"""

from .config import PRESETS, SimConfig, SourceSpec, get_preset
from .engine import Engine
from .state import FluidState, zeros_state

__all__ = [
    "PRESETS",
    "SimConfig",
    "SourceSpec",
    "get_preset",
    "Engine",
    "FluidState",
    "zeros_state",
]
