"""The halo exchange and the sharded pressure solve of fluidsim_tpu_torch
(``parallel/halo.py``, K10's twin in ``kernels/halo.py``) against the JAX
package's ``parallel/halo.py`` and ``pallas/halo_kernel.py``.

The JAX functions run under ``shard_map`` on the host devices that
tests/conftest.py makes (8); the port runs on ``make_mesh(["cpu"] * k)``,
where K10's wrapper takes its plain twin.  Inputs come from numpy seeds;
the solve's inputs have ``set_bnd_3d``-consistent faces (K10's input
contract, as tests/test_sharding.py feeds the JAX kernel).

Tolerances, with what was observed:

* ``halo_exchange_z``: bitwise (copies).
* ``backend="xla"`` against the JAX ``backend="xla"``: rtol = atol = 2e-6;
  observed at most 2.4e-7 (XLA on the CPU contracts ``x0 + a·nbr`` into an
  FMA; the port divides by ``c`` as XLA does).  The port's T = 2 and T = 4
  equal its T = 1 bitwise, as the deep halo covers T sweeps exactly.
* ``backend="pallas"`` (K10's twin) against the JAX kernel in interpret
  mode: bitwise expected and observed; bound rtol = atol = 2e-6.
* ``jacobi_ext_plain`` against ``jacobi_ext_pallas(interpret=True)`` on one
  slab per rank kind: bitwise on the planes the caller keeps (the outer T
  planes of each end are erosion margin, which the two define differently).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fluidsim_tpu.pallas.halo_kernel import NO_WALL as J_NO_WALL
from fluidsim_tpu.pallas.halo_kernel import jacobi_ext_pallas
from fluidsim_tpu.parallel.halo import halo_exchange_z as j_exchange
from fluidsim_tpu.parallel.halo import jacobi_3d_sharded as j_jacobi_sharded
from fluidsim_tpu.parallel.sharding import make_mesh as j_make_mesh

from fluidsim_tpu_torch.config import preset_vortex_128
from fluidsim_tpu_torch.kernels.halo import (
    NO_WALL,
    jacobi_ext_kernel,
    jacobi_ext_plain,
)
from fluidsim_tpu_torch.ops.boundary import set_bnd_3d
from fluidsim_tpu_torch.parallel import halo_exchange_z, jacobi_3d_sharded, make_mesh
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

torch.set_num_threads(1)

N = 32


def solve_inputs(b, seed, n=N):
    """``(x, x0)``: x with the faces ``set_bnd_3d(b)`` gives it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n, n)).astype(np.float32)
    x0 = rng.standard_normal((n, n, n)).astype(np.float32)
    return set_bnd_3d(b, torch.from_numpy(x)).numpy(), x0


def mask32():
    return build_obstacle_mask(preset_vortex_128().replace(size=N))


def port_solve(x, x0, shards, iters=4, **kw):
    obst = kw.pop("obst", None)
    return jacobi_3d_sharded(torch.from_numpy(x), torch.from_numpy(x0), 1.0, 6.0, iters,
                             make_mesh(["cpu"] * shards),
                             obst=None if obst is None else torch.from_numpy(obst),
                             **kw).numpy()


def jax_solve(x, x0, shards, iters=4, **kw):
    obst = kw.pop("obst", None)
    return np.asarray(j_jacobi_sharded(
        jnp.asarray(x), jnp.asarray(x0), 1.0, 6.0, iters, j_make_mesh(jax.devices()[:shards]),
        obst=None if obst is None else jnp.asarray(obst), **kw))


# -- halo_exchange_z -------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shards", [4, 8])
def test_halo_exchange_matches_jax(shards, axis, depth):
    """Every shard's (below, above) edge slabs, zeros past the global edges,
    bitwise; on channel-stacked fields (axis 1) all channels at once."""
    rng = np.random.default_rng(shards * 10 + depth)
    shape = (N, 8, 8) if axis == 0 else (3, N, 8, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    spec = P("z") if axis == 0 else P(None, "z")
    run = jax.shard_map(lambda xl: j_exchange(xl, "z", depth, axis),
                        mesh=j_make_mesh(jax.devices()[:shards]),
                        in_specs=(spec,), out_specs=(spec, spec))
    j_below, j_above = (np.asarray(v) for v in run(jnp.asarray(x)))
    pairs = halo_exchange_z(torch.chunk(torch.from_numpy(x), shards, axis), depth, axis)
    below = torch.cat([b for b, _ in pairs], axis).numpy()
    above = torch.cat([a for _, a in pairs], axis).numpy()
    np.testing.assert_array_equal(below, j_below)
    np.testing.assert_array_equal(above, j_above)


def test_halo_depth_beyond_the_slab_raises():
    x = torch.zeros(N, 4, 4)
    with pytest.raises(ValueError, match="local slab depth"):
        halo_exchange_z(torch.chunk(x, 8), depth=5)
    with pytest.raises(ValueError, match="local slab depth"):
        jax.shard_map(lambda xl: j_exchange(xl, "z", 5),
                      mesh=j_make_mesh(jax.devices()[:8]),
                      in_specs=(P("z"),), out_specs=(P("z"), P("z")))(jnp.zeros((N, 4, 4)))


# -- the sharded solve, plain backend ---------------------------------------------

@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_xla_backend_matches_jax(b):
    """8 shards of 4 planes, 4 sweeps at T = 1, 2, 4: each within 2e-6 of the
    JAX ``backend="xla"``, and T = 2, 4 bitwise the port's T = 1."""
    x, x0 = solve_inputs(b, 100 + b)
    per_sweep = port_solve(x, x0, 8, b=b, block_iters=1, backend="xla")
    for t in (1, 2, 4):
        got = port_solve(x, x0, 8, b=b, block_iters=t, backend="xla")
        ref = jax_solve(x, x0, 8, b=b, block_iters=t, backend="xla")
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6, err_msg=f"T={t}")
        np.testing.assert_array_equal(got, per_sweep, err_msg=f"T={t} vs T=1")


@pytest.mark.parametrize("t", [1, 4])
def test_xla_backend_with_mask_matches_jax(t):
    """The obstacle copy-through at b = 0, the mask's halo exchanged once."""
    x, x0 = solve_inputs(0, 110 + t)
    obst = mask32()
    got = port_solve(x, x0, 8, block_iters=t, backend="xla", obst=obst)
    ref = jax_solve(x, x0, 8, block_iters=t, backend="xla", obst=obst)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


# -- the sharded solve, K10 ----------------------------------------------------------

@pytest.mark.parametrize("b,masked,t", [
    pytest.param(0, False, 2, id="0-False"),
    pytest.param(3, False, 2, id="3-False"),
    pytest.param(0, True, 2, id="0-True"),
    pytest.param(1, False, 3, id="1-False-T3"),
    pytest.param(0, True, 4, id="0-True-T4"),
])
def test_kernel_backend_matches_jax_interpret(b, masked, t):
    """K10's twin per shard, 4 shards of 8 planes, two rounds of T sweeps on
    the persistent extended buffer (T = 2, 3 and 4: one launch a round of
    K10 on the card), against the JAX Pallas kernel in interpret mode."""
    x, x0 = solve_inputs(b, 120 + b + masked)
    obst = mask32() if masked else None
    if masked:
        x = np.where(obst, 0.0, x).astype(np.float32)  # the solve's zero in solids
    got = port_solve(x, x0, 4, iters=2 * t, b=b, block_iters=t, backend="pallas", obst=obst)
    ref = jax_solve(x, x0, 4, iters=2 * t, b=b, block_iters=t, backend="pallas",
                    interpret=True, obst=obst)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("rank", ["first", "middle", "last"])
def test_jacobi_ext_plain_matches_pallas_interpret(rank):
    """One extended slab (lz = 8, T = 3) per rank kind: the global z wall at
    slab plane T (first shard), none, or at T + lz - 1 (last shard)."""
    t, lz, b = 3, 8, 3
    x, x0 = solve_inputs(b, 130)
    shard = {"first": 0, "middle": 1, "last": 3}[rank]
    pad = ((t, t), (0, 0), (0, 0))
    start = shard * lz

    def ext(v):
        return np.pad(v, pad)[start:start + lz + 2 * t]

    wall_lo = t if rank == "first" else NO_WALL
    wall_hi = t + lz - 1 if rank == "last" else NO_WALL
    got = jacobi_ext_plain(torch.from_numpy(ext(x)), torch.from_numpy(ext(x0)), 1.0, 6.0,
                           t, wall_lo, wall_hi, b).numpy()
    ref = np.asarray(jacobi_ext_pallas(
        jnp.asarray(ext(x)), jnp.asarray(ext(x0)), 1.0, 6.0, t,
        J_NO_WALL if wall_lo == NO_WALL else wall_lo,
        J_NO_WALL if wall_hi == NO_WALL else wall_hi, b=b, interpret=True))
    np.testing.assert_array_equal(got[t:t + lz], ref[t:t + lz])


def test_sharded_solve_errors():
    """The JAX package's ValueErrors; ``backend="rdma"`` (ported: it raised
    before K12 and K13) needs T >= 2 and solves."""
    x = torch.zeros(N, N, N)
    mesh = make_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 20, mesh, block_iters=3)
    with pytest.raises(ValueError, match="local slab depth"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 20, mesh, block_iters=5)
    with pytest.raises(ValueError, match="b == 0"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 4, mesh, b=1, obst=torch.zeros_like(x, dtype=bool))
    with pytest.raises(ValueError, match="block_iters >= 2"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 4, mesh, backend="pallas")
    with pytest.raises(ValueError, match="backend must be"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 4, mesh, backend="cuda")
    with pytest.raises(ValueError, match="block_iters >= 2"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 4, mesh, backend="rdma")
    assert torch.equal(jacobi_3d_sharded(x, x, 1.0, 6.0, 4, mesh, block_iters=2,
                                         backend="rdma"), x)


def test_jacobi_ext_wrapper_checks():
    """K10's wrapper takes its twin for CPU tensors and refuses what the kernel
    does not take."""
    xp = torch.randn(12, 16, 16)
    assert torch.equal(jacobi_ext_kernel(xp, xp, 1.0, 6.0, 2, 2, NO_WALL),
                       jacobi_ext_plain(xp, xp, 1.0, 6.0, 2, 2, NO_WALL))
    with pytest.raises(ValueError, match="wall_lo"):
        jacobi_ext_kernel(xp, xp, 1.0, 6.0, 2, -1, NO_WALL)
    with pytest.raises(ValueError, match="wall_hi"):
        jacobi_ext_kernel(xp, xp, 1.0, 6.0, 2, NO_WALL, 12)
    with pytest.raises(TypeError):
        jacobi_ext_kernel(xp.double(), xp.double(), 1.0, 6.0, 2, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="t_iters"):
        jacobi_ext_kernel(xp, xp, 1.0, 6.0, 0, NO_WALL, NO_WALL)
