"""fluidsim_tpu_torch.ops.forces (vorticity confinement, obstacle enforcement
and their shift helpers) and ops.boundary.interior_mask against the JAX
package's XLA ops, on inputs made with NumPy from a seed.

Tolerances: the shifts and the interior mask are bitwise (copies and
zero fill).  Vorticity confinement and obstacle enforcement rtol 1e-5,
atol 1e-6·max|ref|: the port does the JAX float32 operations in the JAX
order, and XLA on the CPU may contract a multiply-add into one FMA (the
squared norms, the cross products), which PyTorch never does; ``exp`` in
the drag factor comes from two different libraries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.ops.forces as jf
from fluidsim_tpu.config import preset_vortex_128 as j_vortex128
from fluidsim_tpu.ops.boundary import interior_mask as j_interior_mask
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask

import fluidsim_tpu_torch.ops.forces as tf
from fluidsim_tpu_torch.ops.boundary import interior_mask

torch.set_num_threads(1)

N = 32


def smooth(n, rng, modes=6):
    """A sum of random low-wavenumber plane waves, unit amplitude."""
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def velocity(seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return (np.stack([smooth(N, rng) for _ in range(3)]) * scale).astype(np.float32)


def masks():
    """A scattered seeded mask and the vortex128 sphere cut to 32³."""
    scattered = np.random.default_rng(5).random((N, N, N)) < 0.15
    sphere = np.asarray(j_build_mask(j_vortex128().replace(size=N)))
    assert sphere.any()
    return {"scattered": scattered, "vortex128": sphere}


def assert_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.max(np.abs(ref)))
    diff = float(np.max(np.abs(got - ref)))
    np.testing.assert_allclose(
        got, ref, rtol=1e-5, atol=1e-6 * scale,
        err_msg=f"{what}: max abs diff {diff:.3e}, max |ref| {scale:.3e}")


@pytest.mark.parametrize("shape", [(N, N, N), (5, 6, 7), (9, 4)])
def test_interior_mask(shape):
    np.testing.assert_array_equal(interior_mask(shape).numpy(),
                                  np.asarray(j_interior_mask(shape)))


@pytest.mark.parametrize("delta", [-2, -1, 1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_shift_arr_and_no_wrap(axis, delta):
    f = velocity(axis)[0]
    np.testing.assert_array_equal(
        tf._shift_arr(torch.from_numpy(f), delta, axis).numpy(),
        np.asarray(jf._shift_arr(jnp.asarray(f), delta, axis)))
    m = masks()["scattered"]
    np.testing.assert_array_equal(
        tf._shift_no_wrap(torch.from_numpy(m), delta, axis).numpy(),
        np.asarray(jf._shift_no_wrap(jnp.asarray(m), delta, axis)))


@pytest.mark.parametrize("eps,dt", [(2.0, 0.03), (1.5, 0.02)])
def test_vorticity_confinement_3d(eps, dt):
    vel = velocity(11)
    ref = jf.vorticity_confinement_3d(jnp.asarray(vel), dt, eps)
    got = tf.vorticity_confinement_3d(torch.from_numpy(vel), dt, eps)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), ref, f"vorticity eps={eps}")
    # The force moved the field by more than the tolerance.
    assert float(np.max(np.abs(np.asarray(ref) - vel))) > 1e-3 * np.abs(vel).max()


@pytest.mark.parametrize("viscosity", [0.0, 1e-3])
@pytest.mark.parametrize("mask", ["scattered", "vortex128"])
def test_enforce_obstacle_boundaries_3d(mask, viscosity):
    vel = velocity(12)
    obst = masks()[mask]
    cell = 1.0 / N
    ref = jf.enforce_obstacle_boundaries_3d(jnp.asarray(vel), jnp.asarray(obst),
                                            cell, viscosity)
    got = tf.enforce_obstacle_boundaries_3d(torch.from_numpy(vel),
                                            torch.from_numpy(obst), cell,
                                            viscosity)
    assert_close(got.numpy(), ref, f"obstacle enforcement ({mask})")
    solid = obst & np.asarray(j_interior_mask(obst.shape))
    assert np.all(got.numpy()[:, solid] == 0.0)
    # The drag changed the fluid cells next to the obstacle.
    assert not np.array_equal(got.numpy()[:, ~obst], vel[:, ~obst])
