"""State carried across packages as NumPy arrays.

``state_from_numpy`` builds a port ``FluidState`` from a dict holding one
array per field of ``FluidState`` (for example ``np.asarray`` of each field
of the JAX package's state); ``state_to_numpy`` goes the other way.

The fields (density, velocity, pressure) are float32 or bfloat16.  NumPy
has no bfloat16 of its own: the JAX package's bfloat16 arrays come out of
``np.asarray`` with the ``ml_dtypes`` extension dtype named ``bfloat16``,
which is taken as it is (this module does not import ``ml_dtypes``, which a
machine without JAX may lack).  Float32 arrays whose values are all
bfloat16 values are taken too when ``dtype="bfloat16"`` is asked for (the
conversion is then exact), and ``state_to_numpy`` returns bfloat16 fields
that way, as float32 arrays.  ``to_bits`` and ``from_bits`` carry a tensor
as the raw pattern of its storage (bfloat16 as ``uint16``), which
``io/checkpoint.save_checkpoint_sharded`` writes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..dtypes import torch_dtype
from ..state import FluidState

FIELDS = ("density", "velocity", "pressure")
OTHER_DTYPES = {
    "obstacles": np.bool_,
    "step": np.int32,
    "time": np.float32,
}


def _field(name: str, a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        if dtype != torch.bfloat16:
            raise ValueError(f"{name}: bfloat16 values for {dtype} fields")
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
    if a.dtype != np.float32:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {a.dtype}")
    t = torch.from_numpy(np.array(a))
    if dtype != torch.float32:
        narrow = t.to(dtype)
        if not bool(((narrow.float() == t) | torch.isnan(t)).all()):
            raise ValueError(f"{name}: float32 values that {dtype} does not hold")
        t = narrow
    return t.to(device)


def state_from_numpy(arrays: Dict[str, np.ndarray], device,
                     dtype: Optional[str] = None) -> FluidState:
    """A ``FluidState`` on ``device`` holding copies of ``arrays``; every
    field must be present.  ``dtype`` ("float32" or "bfloat16") is the
    fields' storage dtype; None takes it from the density array (bfloat16
    for an ``ml_dtypes`` bfloat16 array, else float32)."""
    if dtype is None:
        dtype = ("bfloat16" if np.asarray(arrays["density"]).dtype.name == "bfloat16"
                 else "float32")
    fdt = torch_dtype(dtype)
    fields = {name: _field(name, np.asarray(arrays[name]), fdt, device) for name in FIELDS}
    for name, want in OTHER_DTYPES.items():
        a = np.asarray(arrays[name])
        if a.dtype != want:
            raise ValueError(f"{name}: expected {np.dtype(want)}, got {a.dtype}")
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return FluidState(**fields)


def state_to_numpy(state: FluidState) -> Dict[str, np.ndarray]:
    """One NumPy array per field of ``state``; bfloat16 fields come back as
    float32 arrays of their (exact) values."""
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[f.name] = t.numpy()
    return out


def to_bits(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a NumPy array of its storage: bfloat16 as the
    ``uint16`` bit patterns, any other dtype as it is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_bits(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor ``to_bits`` gave ``a`` for, on the host: ``dtype`` is its
    name (``"bfloat16"`` reads ``uint16`` patterns back)."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = a.copy()
    if dtype == "bfloat16":
        if a.dtype != np.uint16:
            raise ValueError(f"bfloat16 bits are stored as uint16, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    if str(t.dtype).replace("torch.", "") != dtype:
        raise ValueError(f"expected {dtype}, got {a.dtype}")
    return t
