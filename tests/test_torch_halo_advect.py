"""The sharded advection of fluidsim_tpu_torch (``parallel/halo.
advect_multi_3d_sharded``, K11's twin in ``kernels/halo.py``) against the
JAX package's ``advect_multi_3d_sharded`` and ``advect_ext_pallas`` in
interpret mode, and against the port's own unsharded K1 twin.

The JAX side runs under ``shard_map`` on 4 of tests/conftest.py's host
devices; the port on ``make_mesh(["cpu"] * 4)``, where K11's wrapper takes
its plain twin.  32³ on 4 shards of 8 planes, window 1 and two substeps: a
halo of 2 planes, 4 with a mask (the mirror reads one plane further each
substep).  The velocity moves some cells more than one cell a substep, so
the window clamp is exercised.

Tolerances, with what was observed:

* against the JAX sharded advection: rtol 5e-4, atol 5e-5, the JAX
  package's own bound for its kernel against its single-chip kernel
  (tests/test_sharding.py); observed at most 8.7e-6 on fields of unit scale,
  about 70% of cells bitwise (XLA on the CPU contracts the two-tap
  arithmetic into FMAs inside the interpreted kernel);
* against the port's unsharded ``advect_multi_3d_plain`` (K1's twin, the
  same substeps on the whole grid): bitwise expected and observed; same
  bound;
* ``advect_ext_plain`` against ``advect_ext_pallas(interpret=True)`` on one
  middle slab at K = 2: the planes the caller keeps, same bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidsim_tpu.pallas.halo_kernel import advect_ext_pallas
from fluidsim_tpu.parallel.halo import advect_multi_3d_sharded as j_advect_sharded
from fluidsim_tpu.parallel.sharding import make_mesh as j_make_mesh

from fluidsim_tpu_torch.config import preset_vortex_128
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_plain
from fluidsim_tpu_torch.kernels.halo import (
    advect_ext_kernel,
    advect_ext_plain,
    ext_halo,
)
from fluidsim_tpu_torch.parallel import make_mesh
from fluidsim_tpu_torch.parallel.halo import advect_multi_3d_sharded
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

torch.set_num_threads(1)

N = 32
SHARDS = 4
DT = 0.05


def inputs(seed, n_fields):
    rng = np.random.default_rng(seed)
    vel = (rng.standard_normal((3, N, N, N)) * 0.5).astype(np.float32)
    fields = rng.standard_normal((n_fields, N, N, N)).astype(np.float32)
    return vel, fields


def close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)


@pytest.mark.parametrize("case", ["self", "density", "self with mask"])
def test_sharded_advection_matches_jax_and_unsharded(case):
    vel, fields = inputs({"self": 1, "density": 2, "self with mask": 3}[case], 3)
    bs = (0,) if case == "density" else (1, 2, 3)
    obst = (build_obstacle_mask(preset_vortex_128().replace(size=N))
            if case == "self with mask" else None)
    assert ext_halo(1, 2, obst is not None) <= N // SHARDS

    t_vel = torch.from_numpy(vel)
    t_fields = t_vel if bs == (1, 2, 3) else torch.from_numpy(fields[:1])
    t_obst = None if obst is None else torch.from_numpy(obst)
    got = advect_multi_3d_sharded(bs, t_fields, t_vel, DT, make_mesh(["cpu"] * SHARDS),
                                  window=1, n_sub=2, obst=t_obst)

    j_vel = jnp.asarray(vel)
    j_fields = j_vel if bs == (1, 2, 3) else jnp.asarray(fields[:1])
    ref = np.asarray(j_advect_sharded(
        bs, j_fields, j_vel, DT, j_make_mesh(jax.devices()[:SHARDS]), window=1, n_sub=2,
        interpret=True, obst=None if obst is None else jnp.asarray(obst)))
    close(got.numpy(), ref, "vs the JAX sharded advection")

    whole = advect_multi_3d_plain(bs, t_fields, t_vel, DT, obst=t_obst, n_sub=2, window=1)
    close(got.numpy(), whole.numpy(), "vs the unsharded K1 twin")
    assert torch.equal(got, whole)


def test_advect_ext_plain_matches_pallas_interpret():
    """One middle shard's slab (shard 1 of 4), window K = 2, one substep: a
    halo of 2 planes, global z offset 6."""
    k_win, n_sub, lz, shard = 2, 1, 8, 1
    h = ext_halo(k_win, n_sub, False)
    vel, fields = inputs(4, 1)
    start = shard * lz - h
    v_ext = np.ascontiguousarray(vel[:, start:start + lz + 2 * h])
    f_ext = np.ascontiguousarray(fields[:, start:start + lz + 2 * h])
    got = advect_ext_plain((0,), torch.from_numpy(f_ext), torch.from_numpy(v_ext), N, DT,
                           start, window=k_win, n_sub=n_sub).numpy()
    ref = np.asarray(advect_ext_pallas((0,), jnp.asarray(f_ext), jnp.asarray(v_ext), N, DT,
                                       start, window=k_win, n_sub=n_sub, interpret=True))
    close(got[:, h:h + lz], ref[:, h:h + lz], "the kept planes")


def test_sharded_advection_errors():
    vel = torch.zeros(3, N, N, N)
    mesh = make_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="exceeds local slab depth"):
        advect_multi_3d_sharded((1, 2, 3), vel, vel, DT, mesh, window=3, n_sub=2)
    with pytest.raises(ValueError, match="obstacle mirror"):
        advect_multi_3d_sharded((1, 2, 3), vel, vel, DT, mesh, window=1, n_sub=3,
                                obst=torch.zeros(N, N, N, dtype=torch.bool))
    with pytest.raises(ValueError, match="transport"):
        advect_multi_3d_sharded((1, 2, 3), vel, vel, DT, mesh, transport="nccl")
    # transport="rdma" (ported: it raised before K13) is the ppermute result.
    vel = torch.from_numpy(inputs(5, 3)[0])
    assert torch.equal(advect_multi_3d_sharded((1, 2, 3), vel, vel, DT, mesh, transport="rdma"),
                       advect_multi_3d_sharded((1, 2, 3), vel, vel, DT, mesh))


def test_advect_ext_wrapper_checks():
    """K11's wrapper takes its twin for CPU tensors and refuses what the kernel
    does not take."""
    vel = torch.randn(3, 12, 16, 16) * 0.1
    assert torch.equal(advect_ext_kernel((1, 2, 3), vel, vel, 16, DT, 4, n_sub=2),
                       advect_ext_plain((1, 2, 3), vel, vel, 16, DT, 4, n_sub=2))
    with pytest.raises(ValueError, match="window"):
        advect_ext_kernel((1, 2, 3), vel, vel, 16, DT, 4, window=0)
    with pytest.raises(ValueError, match="slab too small"):
        advect_ext_kernel((1, 2, 3), vel[:, :4].contiguous(), vel[:, :4].contiguous(), 16,
                          DT, 4, window=2)
    with pytest.raises(TypeError):
        advect_ext_kernel((0,), vel[:1].double(), vel, 16, DT, 4)
    with pytest.raises(ValueError, match="unsupported fields"):
        advect_ext_kernel((0, 0), vel[:2].contiguous(), vel, 16, DT, 4)
