"""Spectral Poisson projection (``pressure_solver="fft"``), the counterpart
of ``fluidsim_tpu/ops/fft_poisson.py``.

An exact projection for obstacle-free closed boxes.  The solver family's
divergence and gradient are central differences of spacing 2, so
``div∘grad`` is the wide Laplacian ``Σ_axis p(x±2) − 2p(x)`` over 4;
solving with its eigenvalues makes the projected field's central-difference
divergence vanish up to the operator's checkerboard null space.  No-flux
walls come from mirror extension to 2N per axis (the wall-normal component
odd, the rest even); the periodic solve on the extension restricts to the
Neumann solution, and the zero-eigenvalue modes are projected out.

The JAX package computes these FFTs with XLA outside any Pallas kernel, so
the port computes them with ``torch.fft`` in float32; the eigenvalue table
is computed on the host in float64 and rounded to float32, as there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _mirror(f, parities):
    """Extend to 2N per axis: ``[f, ±reverse(f)]`` with the given parity
    (+1 even, −1 odd) per axis."""
    for ax, s in enumerate(parities):
        f = torch.cat([f, s * torch.flip(f, dims=(ax,))], dim=ax)
    return f


def _crop(f, n: int):
    return f[tuple(slice(0, n) for _ in range(f.ndim))]


def _cdiff(f, axis: int):
    """Central difference ``(f(x+1) − f(x−1))/2``, periodic (valid on the
    mirror extension)."""
    return 0.5 * (torch.roll(f, -1, axis) - torch.roll(f, 1, axis))


def _wide_inv_eigenvalues(shape_ext, rfft_axis_len: int) -> np.ndarray:
    """``1/eigenvalue`` of the wide Laplacian ``Σ p(x±2) − 2p`` on the
    periodic extension, 0 where the eigenvalue (numerically) vanishes;
    float32, computed in float64 as the JAX package computes it."""
    dims = len(shape_ext)
    total = None
    for ax in range(dims):
        m = shape_ext[ax]
        if ax == dims - 1:
            freqs = np.arange(rfft_axis_len, dtype=np.float64) / m
        else:
            freqs = np.fft.fftfreq(m)
        lam = 2.0 * np.cos(4.0 * np.pi * freqs) - 2.0
        bshape = [1] * dims
        bshape[ax] = len(freqs)
        lam = lam.reshape(bshape)
        total = lam if total is None else total + lam
    inv = np.where(np.abs(total) > 1e-8, 1.0 / np.where(total == 0, 1, total), 0.0)
    return inv.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _inv_table(shape_ext, rfft_axis_len: int, device: torch.device) -> torch.Tensor:
    """``_wide_inv_eigenvalues`` on ``device``, built once per grid (a
    constant of the step, as XLA folds it into the compiled program)."""
    return torch.from_numpy(_wide_inv_eigenvalues(shape_ext, rfft_axis_len)).to(device)


# The mirror parity of each component along the [z, y, x] axes: component c
# points along grid axis 2 − c and is odd across its own walls.
_PARITIES = {0: (1, 1, -1), 1: (1, -1, 1), 2: (-1, 1, 1)}


def project_3d_fft(vel: torch.Tensor):
    """Exact wide-operator projection of a ``(3, N, N, N)`` velocity
    (obstacle-free closed box), computed in float32.  Returns ``(vel, p)``
    in ``vel``'s dtype, ``p`` cropped to N³."""
    n = vel.shape[-1]
    dtype = vel.dtype
    ext = [_mirror(vel[c].to(torch.float32), _PARITIES[c]) for c in range(3)]
    div = _cdiff(ext[0], 2) + _cdiff(ext[1], 1) + _cdiff(ext[2], 0)

    # div∘grad = wide_lap/4  ⇒  wide_lap(p) = 4·div
    rhs_hat = torch.fft.rfftn(4.0 * div)
    inv = _inv_table(tuple(div.shape), rhs_hat.shape[-1], div.device)
    p_ext = torch.fft.irfftn(rhs_hat * inv, s=div.shape)

    out = [ext[0] - _cdiff(p_ext, 2), ext[1] - _cdiff(p_ext, 1), ext[2] - _cdiff(p_ext, 0)]
    return (torch.stack([_crop(o, n) for o in out]).to(dtype), _crop(p_ext, n).to(dtype))
