"""K9, the whole 2D Jacobi solve: its plain twin and its wrapper.

Counterpart of ``fluidsim_tpu/pallas/resident2d.py`` (``lin_solve_2d_resident``
→ ``_solve2d_kernel``): ``iters`` sweeps of the reference-parity 2D solve in
one launch, in the smoothing mode (``smooth=True``: the rhs is the current
iterate, interior obstacle cells reset to ``x0``) or the fixed-rhs mode
(the rhs is ``x0``, obstacle cells keep the previous iterate), each sweep
followed by ``set_bnd_2d(b)`` with its corners and obstacle mirror; true
division by ``c``.  The CUDA kernel is ``csrc/resident2d.cu``: one
thread-block cluster of ``CLUSTER_BLOCKS`` blocks, one hardware barrier a
sweep, on one of two routes that ``solve2d_route`` picks before the launch:
"strips" (each block keeps a strip of rows of both iterates, x0 and the mask
in its shared memory and reads its neighbours' rows through the cluster's
distributed shared memory) wherever a strip fits, "l2" (the iterates
ping-pong through global memory) above that; ``solve2d_launches`` counts
launches by route.
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
from ..utils.profiling import spanned
from . import _build
from .advect import _check_volume


# The cluster's size for every launch of the step: 16 blocks, a non-portable
# cluster (an H100 takes up to 16; 8 is the portable size), which ran the
# strips route 19-22% faster than 8 on an H100 (chip_smoke.py phase 18);
# chip_smoke.py times the one-block form (``blocks=1``) beside it.
CLUSTER_BLOCKS = 16

# The strips route's halo rows past each end of a strip (csrc/resident2d.cu's
# kHalo for the two copies of the iterate, kMaskHalo for x0 and the mask),
# and the shared memory a block may opt in to on an NVIDIA H100, which the
# gate decides for where the tensors are not on a card.
STRIP_HALO = 2
STRIP_MASK_HALO = 1
H100_SMEM_OPTIN = 232_448

# Launches of K9 by route: "strips" (distributed shared memory) and "l2".
solve2d_launches = {"strips": 0, "l2": 0}


def strip_bounds(n: int, blocks: int):
    """The ``[lo, hi)`` rows of each of ``blocks`` strips of ``n`` rows, as
    the kernel cuts them: strip ``r`` holds ``[r·n//blocks,
    (r+1)·n//blocks)``."""
    return [(r * n // blocks, (r + 1) * n // blocks) for r in range(blocks)]


def strip_smem(n: int, blocks: int) -> int:
    """Bytes of shared memory a block of the strips route takes: two
    float32 copies of the tallest strip (``ceil(n / blocks)`` rows of ``n``
    cells) with ``STRIP_HALO`` rows past each end, and its float32 x0 and
    its mask's bytes with ``STRIP_MASK_HALO``."""
    rows = -(-n // blocks)
    return (8 * (rows + 2 * STRIP_HALO) + 5 * (rows + 2 * STRIP_MASK_HALO)) * n


def solve2d_route(n: int, blocks: int = CLUSTER_BLOCKS, device=None) -> str:
    """K9's route for an ``n²`` solve on a cluster of ``blocks`` blocks on
    ``device``: "strips" where a block's strip (``strip_smem``) fits the
    shared memory it may opt in to (the card's, or the H100's where
    ``device`` is not a card), else "l2".  The mask's bytes are counted
    whether there is a mask or not, so the route depends on ``n`` and
    ``blocks`` alone: on an H100, n ≤ 507 at 16 blocks, n ≤ 363 at 8."""
    if blocks < 1:
        return "l2"  # no cluster: the launch refuses it
    optin = H100_SMEM_OPTIN
    if device is not None and torch.device(device).type == "cuda":
        from .resident import _card_limits

        index = torch.device(device).index
        optin = _card_limits(torch.cuda.current_device() if index is None else index)[1]
    return "strips" if strip_smem(n, blocks) <= optin else "l2"


def _f32(v: float) -> float:
    return float(np.float32(v))


def lin_solve_2d_resident_plain(b: int, x, x0, a: float, c: float, obst,
                                iters: int, smooth: bool = False):
    """Plain PyTorch twin of the K9 kernel: ``ops/linsolve.sweeps_2d`` with
    ``a`` and ``c`` rounded to float32, as the kernel takes them."""
    return sweeps_2d(b, x, x0, _f32(a), _f32(c), obst, iters, smooth)


@spanned("kernel.K9")
def lin_solve_2d_resident(b: int, x, x0, a: float, c: float, obst,
                          iters: int, smooth: bool = False,
                          blocks: int = CLUSTER_BLOCKS):
    """Solve with the K9 kernel: ``iters`` 2D Jacobi sweeps from ``x``
    (``smooth``: the self-smoothing mode), ``set_bnd_2d(b)`` after each, with
    the obstacle branches when the bool mask ``obst`` is given, on a cluster
    of ``blocks`` (1 to 16; above 8 a non-portable cluster) blocks.

    CUDA tensors launch ``csrc/resident2d.cu`` on ``solve2d_route``'s
    route (a launch that fails raises); CPU tensors run
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
    route = solve2d_route(n, int(blocks), x.device)
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if iters > 1 and route == "l2" else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_solve_2d(
            x.data_ptr(), x0.data_ptr(), None if obst is None else obst.data_ptr(),
            out.data_ptr(), None if tmp is None else tmp.data_ptr(), n, int(b),
            _f32(a), _f32(c), int(iters), int(bool(smooth)), int(blocks),
            int(route == "strips"), stream,
        )
    _build.check(lib, err, "2D Jacobi solve kernel launch")
    lin_solve_2d_resident.launches += 1
    lin_solve_2d_resident.smooth_launches += bool(smooth)
    solve2d_launches[route] += 1
    return out


def cluster_barriers(syncs: int, blocks: int = CLUSTER_BLOCKS, device=None) -> None:
    """Launch ``syncs`` cluster barriers and nothing else on a cluster of
    ``blocks`` blocks of 1024 threads on ``device`` (the current card when
    None): the floor of a K9 launch of ``syncs`` sweeps, which
    ``chip_smoke.py`` times beside it."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        err = lib.fs_cluster_barriers(int(blocks), int(syncs),
                                      torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cluster barrier launch")


lin_solve_2d_resident.launches = 0
lin_solve_2d_resident.smooth_launches = 0
