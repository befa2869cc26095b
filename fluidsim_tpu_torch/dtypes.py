"""Field storage dtypes.

Fields are stored in ``SimConfig.dtype``, float32 or bfloat16; every
accumulation that matters (backtrace coordinates, weights, the Jacobi solve,
divergence and gradient) runs in float32, as in the JAX package.  A Python
scalar that the JAX package multiplies into a narrow field is a weakly typed
constant there, so it is rounded to the field's dtype first:
``storage_scalar`` gives that value.
"""

from __future__ import annotations

import functools

import torch

STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``SimConfig.dtype`` name."""
    try:
        return STORAGE_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported field dtype {name!r}") from None


@functools.lru_cache(maxsize=256)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def storage_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (round to nearest even), as a Python
    float.  Cached: the step asks for the same few constants every time."""
    return _rounded(float(x), dtype)


def scale_in(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x · s`` in ``x``'s dtype with ``s`` a constant of that dtype (the
    JAX package's ``x * jnp.asarray(s, x.dtype)``): for float32 the plain
    product, for bfloat16 the exact product of the two bfloat16 values
    rounded once."""
    if x.dtype == torch.float32:
        return x * s
    return (x.float() * storage_scalar(s, x.dtype)).to(x.dtype)
