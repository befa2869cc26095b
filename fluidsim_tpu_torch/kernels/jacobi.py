"""K6: the temporally blocked Jacobi solve, its plain twin and its wrapper.

Counterpart of ``fluidsim_tpu/pallas/jacobi.py`` (``jacobi_3d_pallas`` →
``_jacobi_kernel``), the general no-obstacle solve ``x ← (x0 + a·Σ₆x)·inv_c``
with ``inv_c = f32(1)/f32(c)``, the ``set_bnd_3d(b)`` faces written once at
the end.  The CUDA kernel is ``csrc/jacobi.cu``: three sweeps per launch
out of shared memory, streamed along z, with corrected neighbour reads at
the walls.
``jacobi_3d_plain`` is the same arithmetic in plain PyTorch: it writes the
faces after every sweep instead, which gives every interior cell the same
neighbour values as the corrected reads.  It serves CPU tensors and is the
reference the kernel is checked against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boundary import apply_faces_3d, set_bnd_3d
from ..ops.linsolve import _nbr_sum_3d
from . import _build
from .advect import _check_volume


def solve_coefficients(a: float, c: float):
    """``(f32(a), f32(1)/f32(c))`` as Python floats, as the TPU kernel takes
    them."""
    return float(np.float32(a)), float(np.float32(1.0) / np.float32(c))


def jacobi_3d_plain(b: int, x, x0, a: float, c: float, iters: int):
    """Plain PyTorch twin of the K6 kernel: ``iters`` sweeps of
    ``(x0 + a·nbr)·inv_c`` on the interior of the float32 ``(N, N, N)``
    ``x`` (normalised by ``set_bnd_3d(b)`` first), the faces after each."""
    a32, inv_c = solve_coefficients(a, c)
    x0_int = x0[(slice(1, -1),) * 3]
    x = set_bnd_3d(b, x)
    for _ in range(iters):
        upd = (x0_int + a32 * _nbr_sum_3d(x)) * inv_c
        x = apply_faces_3d(b, F.pad(upd, (1, 1, 1, 1, 1, 1)))
    return x


def jacobi_3d_kernel(b: int, x, x0, a: float, c: float, iters: int):
    """Solve with the K6 kernel: ``iters`` Jacobi sweeps, then the
    ``set_bnd_3d(b)`` faces.

    CUDA tensors launch ``csrc/jacobi.cu``; CPU tensors run
    ``jacobi_3d_plain``.  Returns a new float32 ``(N, N, N)`` tensor.
    ``jacobi_3d_kernel.launches`` counts calls that launched the kernel."""
    if b not in (0, 1, 2, 3):
        raise ValueError(f"boundary code must be 0..3, got {b}")
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    n = x.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("x", x, (n, n, n))
    _check_volume("x0", x0, (n, n, n))
    if x0.device != x.device:
        raise ValueError("x and x0 must be on one device")

    if x.device.type == "cpu":
        return jacobi_3d_plain(b, x, x0, a, c, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    lib = _build.load_library()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    a32, inv_c = solve_coefficients(a, c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_jacobi(
            x.data_ptr(), x0.data_ptr(), out.data_ptr(), tmp.data_ptr(), n,
            int(b), a32, inv_c, int(iters), stream,
        )
    _build.check(lib, err, "Jacobi kernel launch")
    jacobi_3d_kernel.launches += 1
    return out


jacobi_3d_kernel.launches = 0
