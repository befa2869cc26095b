"""State carried across packages as NumPy arrays.

``state_from_numpy`` builds a port ``FluidState`` from a dict holding one
array per field of ``FluidState`` (for example ``np.asarray`` of each field
of the JAX package's state); ``state_to_numpy`` goes the other way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..state import FluidState

FIELD_DTYPES = {
    "density": np.float32,
    "velocity": np.float32,
    "pressure": np.float32,
    "obstacles": np.bool_,
    "step": np.int32,
    "time": np.float32,
}


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> FluidState:
    """A ``FluidState`` on ``device`` holding copies of ``arrays``; every
    field must be present with the dtype of the JAX state."""
    fields = {}
    for name, dtype in FIELD_DTYPES.items():
        a = np.asarray(arrays[name])
        if a.dtype != dtype:
            raise ValueError(f"{name}: expected {np.dtype(dtype)}, got {a.dtype}")
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return FluidState(**fields)


def state_to_numpy(state: FluidState) -> Dict[str, np.ndarray]:
    """One NumPy array per field of ``state``."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}
