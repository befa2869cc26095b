"""K9, the whole 2D Jacobi solve: its plain twin and its wrapper.

Counterpart of ``fluidsim_tpu/pallas/resident2d.py`` (``lin_solve_2d_resident``
→ ``_solve2d_kernel``): ``iters`` sweeps of the reference-parity 2D solve in
one launch, in the smoothing mode (``smooth=True``: the rhs is the current
iterate, interior obstacle cells reset to ``x0``) or the fixed-rhs mode
(the rhs is ``x0``, obstacle cells keep the previous iterate), each sweep
followed by ``set_bnd_2d(b)`` with its corners and obstacle mirror; true
division by ``c``.  The CUDA kernel is ``csrc/resident2d.cu``: one
thread-block cluster of ``CLUSTER_BLOCKS`` blocks, one hardware barrier a
sweep.
``lin_solve_2d_resident_plain`` is the whole-array formulation
(``ops/linsolve.sweeps_2d``, the JAX ``diffuse_smooth_2d`` and
``lin_solve_2d`` in one): it serves CPU tensors and is the reference the
kernel is checked against.

The obstacle mask is a ``torch.bool`` tensor (one byte per cell, which the
kernel reads as ``uint8``, nonzero = solid).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linsolve import sweeps_2d
from . import _build
from .advect import _check_volume


# The cluster's size for every launch of the step; chip_smoke.py times the
# one-block form (``blocks=1``) beside it.
CLUSTER_BLOCKS = 8


def _f32(v: float) -> float:
    return float(np.float32(v))


def lin_solve_2d_resident_plain(b: int, x, x0, a: float, c: float, obst,
                                iters: int, smooth: bool = False):
    """Plain PyTorch twin of the K9 kernel: ``ops/linsolve.sweeps_2d`` with
    ``a`` and ``c`` rounded to float32, as the kernel takes them."""
    return sweeps_2d(b, x, x0, _f32(a), _f32(c), obst, iters, smooth)


def lin_solve_2d_resident(b: int, x, x0, a: float, c: float, obst,
                          iters: int, smooth: bool = False,
                          blocks: int = CLUSTER_BLOCKS):
    """Solve with the K9 kernel: ``iters`` 2D Jacobi sweeps from ``x``
    (``smooth``: the self-smoothing mode), ``set_bnd_2d(b)`` after each, with
    the obstacle branches when the bool mask ``obst`` is given, on a cluster
    of ``blocks`` (1 to 8) blocks.

    CUDA tensors launch ``csrc/resident2d.cu``; CPU tensors run
    ``lin_solve_2d_resident_plain``.  Returns a new float32 ``(N, N)``
    tensor.  ``lin_solve_2d_resident.launches`` counts calls that launched
    the kernel, ``lin_solve_2d_resident.smooth_launches`` those of them in
    the smoothing mode."""
    if b not in (0, 1, 2):
        raise ValueError(f"boundary code must be 0..2, got {b}")
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"x: expected a square (N, N) field, got {tuple(x.shape)}")
    n = x.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("x", x, (n, n))
    _check_volume("x0", x0, (n, n))
    tensors = [x0]
    if obst is not None:
        _check_volume("obst", obst, (n, n), torch.bool)
        tensors.append(obst)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")

    if x.device.type == "cpu":
        return lin_solve_2d_resident_plain(b, x, x0, a, c, obst, iters, smooth)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    lib = _build.load_library()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if iters > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_solve_2d(
            x.data_ptr(), x0.data_ptr(), None if obst is None else obst.data_ptr(),
            out.data_ptr(), None if tmp is None else tmp.data_ptr(), n, int(b),
            _f32(a), _f32(c), int(iters), int(bool(smooth)), int(blocks), stream,
        )
    _build.check(lib, err, "2D Jacobi solve kernel launch")
    lin_solve_2d_resident.launches += 1
    lin_solve_2d_resident.smooth_launches += bool(smooth)
    return out


lin_solve_2d_resident.launches = 0
lin_solve_2d_resident.smooth_launches = 0
