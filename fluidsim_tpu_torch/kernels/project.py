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

K7e is K7 on one shard of the sharded step (``parallel/step.py``): the same
divergence and gradient on the shard's ``lz`` planes, the one plane of each
neighbour that a stencil reads along z taken in place as a halo plane (on
the neighbour's card, through a peer pointer, on a mesh over cards), the
global z faces only where the shard holds a global wall
(``kernels/halo.rank_walls`` at halo 0).  Its CUDA
entries are ``fs_divergence_ext`` and ``fs_gradient_ext`` in
``csrc/project_slab.cu``.

The solve's route (``jacobi_3d_solve``) is that of the JAX
``jacobi_3d_pallas`` and ``project_3d(use_pallas=True)``: the resident K4
where its float32 volumes fit (here the card's L2), else K6; with an
obstacle mask K4 at any size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build
from .advect import _check_volume
from .halo import _check_wall, _mirror_ext, _nonborder_solid, slab_faces
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


@spanned("kernel.K7")
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


@spanned("kernel.K7")
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


# -- K7e -------------------------------------------------------------------


def _with_halo(x, below, above):
    """The ``(lz, n, n)`` field ``x`` between its halo planes ``below`` and
    ``above`` (``(n, n)``; zeros where None)."""
    below, above = (x.new_zeros(x.shape[1:]) if h is None else h for h in (below, above))
    return torch.cat([below[None], x, above[None]])


def divergence_ext_plain(vel, vz_below, vz_above, wall_lo: int, wall_hi: int):
    """Plain PyTorch twin of K7e's divergence: ``divergence_interior`` on the
    shard's ``(3, lz, n, n)`` velocity ``vel``, the z component's halo planes
    ``vz_below`` and ``vz_above`` (``(n, n)``, None past a global wall)
    around it, into the shard's ``(lz, n, n)`` planes with zero y and x
    faces and a zero plane at each global z wall the shard holds (its planes
    ``wall_lo``, ``wall_hi``): ``divergence_3d_plain`` restricted to the
    shard."""
    vz = _with_halo(vel[2], vz_below, vz_above)
    vxy = F.pad(vel[:2], (0, 0, 0, 0, 1, 1))
    div = F.pad(divergence_interior(torch.cat([vxy, vz[None]])), (1, 1, 1, 1))
    for wall in (wall_lo, wall_hi):
        if 0 <= wall < div.shape[0]:
            div[wall] = 0.0
    return div


def gradient_slab(vel, p_ext, wall_lo: int, wall_hi: int, obst=None, z_offset: int = 0):
    """``project_3d``'s gradient step and faces on the float32 slab ``vel``
    ``(3, m, n, n)`` of an ``n³`` grid: ``v − 0.5·(p₊ − p₋)·N`` on the cells
    with x and y in ``[1, n − 2]`` from ``p_ext`` ``(m + 2, n, n)`` (one
    more plane each side), the global z faces at slab planes ``wall_lo`` and
    ``wall_hi`` where the slab holds them (``slab_faces``, z → y → x), and
    with the bool mask ``obst`` ``(m, n, n)`` (plane 0 at global z
    ``z_offset``) no step in its solids and then the obstacle mirror, its
    neighbours read wrapped.  Planes past a global wall and, with a mask, the
    slab's first and last planes are margin the caller drops.  The
    whole-volume arithmetic of ``ops/project.project_3d`` and
    ``resident.project_gradient``."""
    nf = float(vel.shape[-1])
    grads = (
        0.5 * (p_ext[1:-1, 1:-1, 2:] - p_ext[1:-1, 1:-1, :-2]) * nf,
        0.5 * (p_ext[1:-1, 2:, 1:-1] - p_ext[1:-1, :-2, 1:-1]) * nf,
        0.5 * (p_ext[2:, 1:-1, 1:-1] - p_ext[:-2, 1:-1, 1:-1]) * nf,
    )
    writes = None if obst is None else _nonborder_solid(obst, vel.shape[-1], z_offset)
    out = []
    for c, g in enumerate(grads):
        if obst is not None:
            g = torch.where(obst[:, 1:-1, 1:-1], 0.0, g)
        comp = vel[c].clone()
        comp[:, 1:-1, 1:-1] = comp[:, 1:-1, 1:-1] - g
        comp = slab_faces(c + 1, comp, wall_lo, wall_hi)
        if obst is not None:
            comp = _mirror_ext(comp, obst, writes, 2 - c)
        out.append(comp)
    return torch.stack(out)


def gradient_ext_plain(vel, p, p_below, p_above, wall_lo: int, wall_hi: int):
    """Plain PyTorch twin of K7e's gradient: ``gradient_slab`` on the
    shard's ``(3, lz, n, n)`` velocity with its ``(lz, n, n)`` pressure
    between the pressure's halo planes ``p_below`` and ``p_above`` (``(n,
    n)``, None past a global wall), the walls at the shard's planes
    ``wall_lo`` and ``wall_hi``: ``project_gradient`` restricted to the
    shard."""
    return gradient_slab(vel, _with_halo(p, p_below, p_above), wall_lo, wall_hi)


def _ext_inputs(vel, p, halo, wall_lo, wall_hi):
    """``(n, lz, wall_lo, wall_hi)`` of a K7e call on the shard's velocity
    ``vel`` (each component's planes contiguous, any stride between
    components) and pressure ``p``, with the halo planes ``halo`` ``(below,
    above)``, checked: a plane on each side without a global wall."""
    if vel.dim() != 4 or vel.shape[0] != 3:
        raise ValueError(f"expected a (3, lz, n, n) slab, got {tuple(vel.shape)}")
    n, lz = vel.shape[-1], vel.shape[1]
    if n < 3 or lz < 2:
        raise ValueError(f"expected n >= 3 and lz >= 2, got n={n}, lz={lz}")
    # Each component's planes contiguous; the components' stride is free
    # (K11's kept planes are a view of its extended result).
    _check_volume("vel[0]", vel[0], (lz, n, n))
    if vel.shape[-2] != n or vel.stride(0) < lz * n * n:
        raise ValueError(f"vel: expected (3, lz, n, n) with lz·n² floats or more between "
                         f"components, got shape {tuple(vel.shape)}, strides {vel.stride()}")
    if p is not None:
        _check_volume("p", p, (lz, n, n))
    wall_lo = _check_wall("wall_lo", wall_lo, 0, 0)
    wall_hi = _check_wall("wall_hi", wall_hi, lz - 1, lz - 1)
    for side, plane, wall in (("below", halo[0], wall_lo), ("above", halo[1], wall_hi)):
        if (plane is None) != (wall >= 0):
            raise ValueError(f"the halo plane {side}: expected one exactly where the shard "
                             f"holds no global wall on that side")
        if plane is not None:
            _check_volume(f"the halo plane {side}", plane, (n, n))
    if p is not None and p.device != vel.device:
        raise ValueError("the slab's velocity and pressure must be on one device")
    # A CUDA shard's kernels read a halo plane on a neighbour's card through
    # its peer pointer (the mesh turned peer access on).
    if any(t is not None and t.device != vel.device
           and not (t.device.type == vel.device.type == "cuda") for t in halo):
        raise ValueError("the slab and its halo planes must be on one device (or, on "
                         "CUDA, on cards of one mesh)")
    if vel.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vel.device}")
    return n, lz, wall_lo, wall_hi


def _ptr(t):
    return 0 if t is None else t.data_ptr()


@spanned("kernel.K7e")
def divergence_ext_kernel(vel, vz_below, vz_above, wall_lo: int, wall_hi: int):
    """K7e's divergence of the shard's float32 ``(3, lz, n, n)`` velocity
    ``vel`` (each component's planes contiguous, the components' stride
    free) into its ``(lz, n, n)`` planes, the z component's halo planes
    ``vz_below`` and ``vz_above`` (``(n, n)``, read in place; None exactly
    where the shard holds that global wall), the global z walls at the
    shard's planes ``wall_lo`` (0 or ``NO_WALL``) and ``wall_hi`` (lz − 1 or
    ``NO_WALL``): CUDA tensors launch ``fs_divergence_ext``
    (``csrc/project_slab.cu``), CPU tensors run ``divergence_ext_plain``.
    ``divergence_ext_kernel.launches`` counts launches.  On CUDA a halo plane
    may lie on a neighbour shard's card (``reads_peers``): the kernel reads
    it through its peer pointer, on the current stream of ``vel``'s card."""
    n, lz, wall_lo, wall_hi = _ext_inputs(vel, None, (vz_below, vz_above), wall_lo, wall_hi)
    if vel.device.type == "cpu":
        return divergence_ext_plain(vel, vz_below, vz_above, wall_lo, wall_hi)
    lib = _build.load_library()
    div = torch.empty((lz, n, n), dtype=torch.float32, device=vel.device)
    with torch.cuda.device(vel.device):
        err = lib.fs_divergence_ext(vel.data_ptr(), vel.stride(0), _ptr(vz_below),
                                    _ptr(vz_above), div.data_ptr(), n, lz, wall_lo, wall_hi,
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "extended-slab divergence kernel launch")
    divergence_ext_kernel.launches += 1
    return div


divergence_ext_kernel.launches = 0
divergence_ext_kernel.reads_peers = True


@spanned("kernel.K7e")
def gradient_ext_kernel(vel, p, p_below, p_above, wall_lo: int, wall_hi: int):
    """K7e's gradient step and velocity faces on the shard's float32 ``(3,
    lz, n, n)`` velocity ``vel`` (laid out as ``divergence_ext_kernel``'s)
    from its ``(lz, n, n)`` pressure ``p`` and
    the pressure's halo planes ``p_below`` and ``p_above`` (as
    ``divergence_ext_kernel``'s, with its walls), into a ``(3, lz, n, n)``
    velocity: CUDA tensors launch ``fs_gradient_ext``
    (``csrc/project_slab.cu``), CPU tensors run ``gradient_ext_plain``.
    ``gradient_ext_kernel.launches`` counts launches.  Its halo planes may
    lie on a neighbour's card, as ``divergence_ext_kernel``'s."""
    n, lz, wall_lo, wall_hi = _ext_inputs(vel, p, (p_below, p_above), wall_lo, wall_hi)
    if vel.device.type == "cpu":
        return gradient_ext_plain(vel, p, p_below, p_above, wall_lo, wall_hi)
    lib = _build.load_library()
    out = torch.empty((3, lz, n, n), dtype=torch.float32, device=vel.device)
    with torch.cuda.device(vel.device):
        err = lib.fs_gradient_ext(vel.data_ptr(), vel.stride(0), p.data_ptr(), _ptr(p_below),
                                  _ptr(p_above), out.data_ptr(), n, lz, wall_lo, wall_hi,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "extended-slab gradient kernel launch")
    gradient_ext_kernel.launches += 1
    return out


gradient_ext_kernel.launches = 0
gradient_ext_kernel.reads_peers = True


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
