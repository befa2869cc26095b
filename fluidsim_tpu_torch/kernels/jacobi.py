"""K6, the temporally blocked Jacobi solve, and K4, the whole-volume Jacobi
solve: their plain twins and their wrappers.

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

K4 is the counterpart of ``fluidsim_tpu/pallas/resident.py``
(``jacobi_3d_resident`` → ``_jacobi_kernel`` / ``_jacobi_obst_kernel``,
solve ``_solve_loop`` with ``sweep_block = 1``): the same sweeps from a given
start, the faces after each, and with an obstacle mask (``b = 0``) the
solid cells held at their start value through the ``coef`` and ``frozen``
volumes.  The CUDA kernel is ``csrc/jacobi_resident.cu``, one launch per
sweep; ``jacobi_3d_resident_plain`` is its twin.

Both solves are float32: bfloat16 inputs are solved on their float32 values
and the result rounded back (the JAX ``jacobi_3d_resident``'s edge upcast).
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
    if x.dtype == torch.bfloat16:
        return jacobi_3d_plain(b, x.float(), x0.float(), a, c, iters).to(x.dtype)
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
    if x.dtype == torch.bfloat16:
        return jacobi_3d_kernel(b, x.float(), x0.float(), a, c, iters).to(x.dtype)
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


def jacobi_3d_resident_plain(b: int, x, x0, a: float, c: float, iters: int,
                             obst=None):
    """Plain PyTorch twin of the K4 kernel: ``iters`` sweeps of
    ``(x0 + a·nbr)·inv_c`` (``x0 + nbr`` when ``a == 1``) from the float32
    ``(N, N, N)`` start ``x``, the faces after each.  Without a mask the x
    operands take the x face rule (``sx·`` the cell itself next to an x
    wall, the TPU kernel's ``_nbr_sum_selx``); with the bool mask ``obst``
    (``b == 0``) the sweep is ``rhs·((1 − m)·inv_c) + m·x_start``."""
    if x.dtype == torch.bfloat16:
        return jacobi_3d_resident_plain(b, x.float(), x0.float(), a, c, iters,
                                        obst).to(x.dtype)
    a32, inv_c = solve_coefficients(a, c)
    f32 = torch.float32
    core = (slice(1, -1),) * 3
    x0_int = x0[core]
    if obst is not None:
        mf = obst[core].to(f32)
        coef = (1.0 - mf) * inv_c
        frozen = mf * x[core]
    p = x
    for _ in range(iters):
        src = p
        if obst is None:
            src = p.clone()
            for dst, own in ((0, 1), (-1, -2)):
                src[..., dst] = -p[..., own] if b == 1 else p[..., own]
        nbr = _nbr_sum_3d(src)
        rhs = x0_int + (nbr if a32 == 1.0 else a32 * nbr)
        upd = rhs * inv_c if obst is None else rhs * coef + frozen
        p = apply_faces_3d(b, F.pad(upd, (1, 1, 1, 1, 1, 1)))
    return p


def jacobi_3d_resident(b: int, x, x0, a: float, c: float, iters: int, obst=None):
    """Solve with the K4 kernel: ``iters`` Jacobi sweeps from ``x``, the
    ``set_bnd_3d(b)`` faces after each, with the obstacle copy-through when
    the bool mask ``obst`` is given (``b == 0`` only).

    CUDA tensors launch ``csrc/jacobi_resident.cu``; CPU tensors run
    ``jacobi_3d_resident_plain``.  Returns a new float32 ``(N, N, N)``
    tensor.  ``jacobi_3d_resident.launches`` counts calls that launched the
    kernel."""
    if x.dtype == torch.bfloat16:
        return jacobi_3d_resident(b, x.float(), x0.float(), a, c, iters, obst).to(x.dtype)
    if b not in (0, 1, 2, 3):
        raise ValueError(f"boundary code must be 0..3, got {b}")
    if obst is not None and b != 0:
        raise ValueError("the obstacle copy-through is for b == 0 only")
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    n = x.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("x", x, (n, n, n))
    _check_volume("x0", x0, (n, n, n))
    tensors = [x0]
    if obst is not None:
        _check_volume("obst", obst, (n, n, n), torch.bool)
        tensors.append(obst)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")

    if x.device.type == "cpu":
        return jacobi_3d_resident_plain(b, x, x0, a, c, iters, obst)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    lib = _build.load_library()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if iters > 1 else None
    a32, inv_c = solve_coefficients(a, c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_jacobi_resident(
            x.data_ptr(), x0.data_ptr(), None if obst is None else obst.data_ptr(),
            out.data_ptr(), None if tmp is None else tmp.data_ptr(), n, int(b),
            a32, inv_c, int(iters), stream,
        )
    _build.check(lib, err, "resident Jacobi kernel launch")
    jacobi_3d_resident.launches += 1
    return out


jacobi_3d_resident.launches = 0
