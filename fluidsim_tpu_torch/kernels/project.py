"""K7, the slab route's divergence and gradient kernels, their plain twins
and their wrappers; the slab route (K7 → K6 → K7); the projection's route
between it and the resident K3 kernel; and the Jacobi solve's route between
K4 and K6.

Counterpart of ``fluidsim_tpu/pallas/project.py``: ``_div_kernel`` and
``_grad_kernel`` around ``jacobi_3d_pallas``, and ``project_3d_pallas``,
which takes the resident kernel when its volumes fit on chip and the slab
kernels otherwise.  Here the limit is the card's L2: the resident kernels
sweep their iterates once per launch, which is cheap while the solve's
working set (two iterates and the rhs) stays in L2 and costs a full HBM
round trip per sweep once it does not (``resident_fits``).  The slab route
solves in float32 whatever the solve dtype, as the JAX package's does, and
takes bfloat16 fields through a float32 copy, rounding its results back
(the JAX ``project_3d_pallas``'s edge upcast).  An obstacle mask keeps K3
at any size: the slab kernels have none.

The CUDA kernels are ``csrc/project_slab.cu`` (K7) and ``csrc/jacobi.cu``
(K6).  The twins share the K3 twin's divergence and gradient.

The solve's route (``jacobi_3d_solve``) is that of the JAX
``jacobi_3d_pallas`` and ``project_3d(use_pallas=True)``: the resident K4
where its float32 volumes fit (here the card's L2), else K6; with an
obstacle mask K4 at any size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .advect import _check_volume
from .jacobi import (
    jacobi_3d_kernel,
    jacobi_3d_plain,
    jacobi_3d_resident,
    jacobi_3d_resident_plain,
)
from .resident import (
    divergence_interior,
    project_3d_resident,
    project_3d_resident_plain,
    project_gradient,
    solve_torch_dtype,
)

# The L2 of an NVIDIA H100, the card the route is chosen for where the
# tensors are not on a card (the CPU tests run the card's route).
H100_L2_BYTES = 50 * 1024 * 1024


def resident_fits(n: int, solve_bytes: int, l2_bytes: int) -> bool:
    """Whether the resident projection's solve working set, ``3·n³`` cells
    of ``solve_bytes`` each, fits an L2 of ``l2_bytes``."""
    return 3 * n ** 3 * solve_bytes <= l2_bytes


def l2_bytes(device) -> int:
    """The L2 size of ``device``: a card's own, else (the CPU, or None) the
    H100's."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(device).L2_cache_size
    return H100_L2_BYTES


def resident_route(n: int, solve_dtype, device) -> bool:
    """Whether the projection of an ``n³`` grid on ``device`` takes the
    resident kernels (K2, K3) rather than the slab route."""
    return resident_fits(n, solve_torch_dtype(solve_dtype).itemsize, l2_bytes(device))


# -- K7 --------------------------------------------------------------------


def divergence_3d_plain(vel):
    """Plain PyTorch twin of K7's divergence: ``(N, N, N)``, zero faces."""
    return F.pad(divergence_interior(vel), (1, 1, 1, 1, 1, 1))


def _slab_inputs(vel, p=None) -> int:
    n = vel.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("vel", vel, (3, n, n, n))
    if p is not None:
        _check_volume("p", p, (n, n, n))
        if p.device != vel.device:
            raise ValueError("vel and p must be on one device")
    if vel.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vel.device}")
    return n


def divergence_3d_kernel(vel):
    """K7's divergence of the float32 ``(3, N, N, N)`` ``vel``: CUDA tensors
    launch ``csrc/project_slab.cu``, CPU tensors run ``divergence_3d_plain``.
    ``divergence_3d_kernel.launches`` counts launches."""
    n = _slab_inputs(vel)
    if vel.device.type == "cpu":
        return divergence_3d_plain(vel)
    lib = _build.load_library()
    div = torch.empty((n, n, n), dtype=torch.float32, device=vel.device)
    with torch.cuda.device(vel.device):
        err = lib.fs_divergence(vel.data_ptr(), div.data_ptr(), n,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "divergence kernel launch")
    divergence_3d_kernel.launches += 1
    return div


divergence_3d_kernel.launches = 0


def gradient_3d_kernel(vel, p):
    """K7's gradient step and velocity faces, ``v − 0.5·(p₊ − p₋)·N`` on the
    interior cells, then each component's ``set_bnd`` faces: CUDA tensors
    launch ``csrc/project_slab.cu``, CPU tensors run its twin
    ``resident.project_gradient``.
    ``gradient_3d_kernel.launches`` counts launches."""
    n = _slab_inputs(vel, p)
    if vel.device.type == "cpu":
        return project_gradient(vel, p)
    lib = _build.load_library()
    out = torch.empty_like(vel)
    with torch.cuda.device(vel.device):
        err = lib.fs_gradient(vel.data_ptr(), p.data_ptr(), out.data_ptr(), n,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "gradient kernel launch")
    gradient_3d_kernel.launches += 1
    return out


gradient_3d_kernel.launches = 0


# -- the routes --------------------------------------------------------------


def _project_slab(vel, iters: int, divergence, jacobi, gradient):
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    if vel.dtype == torch.bfloat16:
        out, p = _project_slab(vel.float(), iters, divergence, jacobi, gradient)
        return out.to(vel.dtype), p.to(vel.dtype)
    div = divergence(vel)
    p = jacobi(0, torch.zeros_like(div), div, 1.0, 6.0, iters)
    return gradient(vel, p), p


def project_3d_slab_kernel(vel, iters: int):
    """The slab route: K7 divergence, K6 (``b=0, a=1, c=6`` from zero),
    K7 gradient, in float32 (a bfloat16 ``vel`` through a float32 copy).
    Returns ``(vel', p)`` in ``vel``'s dtype."""
    return _project_slab(vel, iters, divergence_3d_kernel, jacobi_3d_kernel,
                         gradient_3d_kernel)


def project_3d_slab_plain(vel, iters: int):
    """The slab route with the twins."""
    return _project_slab(vel, iters, divergence_3d_plain, jacobi_3d_plain,
                         project_gradient)


def _slab(vel, obst, solve_dtype, resident) -> bool:
    if obst is not None:
        return False
    if resident is None:
        resident = resident_route(vel.shape[-1], solve_dtype, vel.device)
    return not resident


def project_3d_kernel(vel, iters: int, obst=None, solve_dtype=None, resident=None,
                      sweep_block: int = 1):
    """Project ``vel`` with ``iters`` Jacobi sweeps: K3 (its solve in blocks
    of ``sweep_block``, K5, where ``resident.projection_block`` allows)
    where the solve fits the card's L2 or there is an obstacle mask, else
    the slab route in float32 (``solve_dtype`` and ``sweep_block`` are then
    ignored, as the JAX ``project_3d_pallas``'s slab route ignores them).
    ``resident`` is ``resident_route``'s answer where the caller has it.
    Returns ``(vel', p)``."""
    if _slab(vel, obst, solve_dtype, resident):
        return project_3d_slab_kernel(vel, iters)
    return project_3d_resident(vel, iters, obst=obst, solve_dtype=solve_dtype,
                               sweep_block=sweep_block)


def project_3d_plain(vel, iters: int, obst=None, solve_dtype=None, resident=None,
                     sweep_block: int = 1):
    """``project_3d_kernel``'s route with the kernels' twins."""
    if _slab(vel, obst, solve_dtype, resident):
        return project_3d_slab_plain(vel, iters)
    return project_3d_resident_plain(vel, iters, obst=obst, solve_dtype=solve_dtype,
                                     sweep_block=sweep_block)


def _resident_solve(x, obst, resident) -> bool:
    if obst is not None:
        return True
    if resident is None:
        resident = resident_route(x.shape[-1], "float32", x.device)
    return resident


def jacobi_3d_solve(b: int, x, x0, a: float, c: float, iters: int, obst=None,
                    resident=None):
    """``iters`` Jacobi sweeps from ``x``: K4 where the float32 solve fits
    the card's L2 or there is an obstacle mask, else K6.  ``resident`` is
    ``resident_route(n, "float32", device)``'s answer where the caller has
    it."""
    if _resident_solve(x, obst, resident):
        return jacobi_3d_resident(b, x, x0, a, c, iters, obst)
    return jacobi_3d_kernel(b, x, x0, a, c, iters)


def jacobi_3d_solve_plain(b: int, x, x0, a: float, c: float, iters: int, obst=None,
                          resident=None):
    """``jacobi_3d_solve``'s route with the kernels' twins."""
    if _resident_solve(x, obst, resident):
        return jacobi_3d_resident_plain(b, x, x0, a, c, iters, obst)
    return jacobi_3d_plain(b, x, x0, a, c, iters)
