"""fluidsim_tpu_torch ops against the JAX package's XLA ops.

Inputs are made with NumPy from a seed and handed to both packages.
Tolerance classes:
* boundaries: bitwise (pure copies and negations);
* forces and emitters: rtol 1e-6, atol 1e-6·max|ref| (XLA on the CPU may
  contract a multiply-add into one FMA, PyTorch never does);
* advection and projection: rtol 3e-5, atol 3e-6, the JAX package's own
  class for its Pallas kernels against these XLA ops.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.config as jcfg
from fluidsim_tpu.ops.advect import advect_multi_3d as j_advect
from fluidsim_tpu.ops.advect import advect_substep_3d as j_substep
from fluidsim_tpu.ops.boundary import apply_faces_3d as j_faces
from fluidsim_tpu.ops.boundary import set_bnd_3d as j_set_bnd
from fluidsim_tpu.ops.forces import buoyancy_force as j_buoyancy
from fluidsim_tpu.ops.project import project_3d as j_project
from fluidsim_tpu.scene.sources import apply_custom_source as j_source
from fluidsim_tpu.scene.sources import source_params as j_source_params

import fluidsim_tpu_torch.config as tcfg
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.ops.advect import advect_multi_3d, advect_substep_3d
from fluidsim_tpu_torch.ops.boundary import apply_faces_3d, set_bnd_3d
from fluidsim_tpu_torch.ops.forces import buoyancy_force
from fluidsim_tpu_torch.ops.project import project_3d
from fluidsim_tpu_torch.scene.sources import apply_custom_source, source_params
from fluidsim_tpu_torch.state import zeros_state

torch.set_num_threads(1)

N = 32


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, ref, rtol, atol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    diff = float(np.max(np.abs(got - ref)))
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=atol,
        err_msg=f"{what}: max abs diff {diff:.3e}, max |ref| "
                f"{float(np.max(np.abs(ref))):.3e}")


def random_mask(n, seed):
    """A scattered obstacle mask covering about 15% of the cells."""
    return np.random.default_rng(seed).random((n, n, n)) < 0.15


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_set_bnd_3d_bitwise(b, masked):
    x = rand((N, N, N), 10 + b)
    obst = random_mask(N, 3) if masked else None
    ref = j_set_bnd(b, jnp.asarray(x), None if obst is None else jnp.asarray(obst))
    got = set_bnd_3d(b, t(x), None if obst is None else t(obst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(apply_faces_3d(b, t(x)).numpy(),
                                  np.asarray(j_faces(b, jnp.asarray(x))))


def test_buoyancy_force():
    vel = rand((3, N, N, N), 20, 0.3)
    dens = np.abs(rand((N, N, N), 21, 5.0))
    ref = np.asarray(j_buoyancy(jnp.asarray(vel), jnp.asarray(dens), 0.0008,
                                0.2, 0.1, 0.05))
    got = buoyancy_force(t(vel), t(dens), 0.0008, 0.2, 0.1, 0.05).numpy()
    assert_close(got, ref, 1e-6, 1e-6 * np.abs(ref).max(), "buoyancy_force")


@pytest.mark.parametrize("variant", ["bench128", "velocity_pulsing",
                                     "wall_clock"])
def test_apply_custom_source(variant):
    """bench128's emitter; the same emitter emitting velocity and pulsing
    (pulse phase from the sim time); and pulsing on the wall clock held in
    the emitter parameters."""
    kw = dict(size=N)
    if variant != "bench128":
        kw.update(source_emits_velocity=True, source_pulsing=True,
                  source_pulse_rate=2.0, source_velocity=7.0)
    if variant == "wall_clock":
        kw.update(pulse_clock="wall")
    jc = jcfg.preset_bench_128().replace(**kw)
    tc = tcfg.preset_bench_128().replace(**kw)
    jp = tp = None
    if variant == "wall_clock":
        jp = j_source_params(jc)._replace(pulse_t=jnp.float32(0.81))
        tp = source_params(tc)._replace(pulse_t=np.float32(0.81))
    dens = np.abs(rand((N, N, N), 30, 2.0))
    vel = rand((3, N, N, N), 31, 0.3)
    time = np.float32(0.37)
    rd, rv = j_source(jnp.asarray(dens), jnp.asarray(vel), jc,
                      jnp.asarray(time), params=jp)
    gd, gv = apply_custom_source(t(dens), t(vel), tc, torch.tensor(time),
                                 params=tp)
    rd, rv = np.asarray(rd), np.asarray(rv)
    assert not np.array_equal(rd, dens)
    assert_close(gd.numpy(), rd, 1e-6, 1e-6 * np.abs(rd).max(), "density")
    assert_close(gv.numpy(), rv, 1e-6, 1e-6 * np.abs(rv).max(), "velocity")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bs,n_fields", [((1, 2, 3), 3), ((0,), 1)])
def test_advect_multi_3d_window1(bs, n_fields, masked):
    vel = rand((3, N, N, N), 40, 0.5)
    fields = vel if n_fields == 3 else np.abs(rand((1, N, N, N), 41, 3.0))
    obst = random_mask(N, 5) if masked else None
    jo = None if obst is None else jnp.asarray(obst)
    to = None if obst is None else t(obst)
    dt = 0.03
    ref = np.asarray(j_advect(bs, jnp.asarray(fields), jnp.asarray(vel), dt,
                              jo, window=1))
    got = advect_multi_3d(bs, t(fields), t(vel), dt, to, window=1).numpy()
    assert_close(got, ref, 3e-5, 3e-6, "advect_multi_3d")
    # one substep of dt is the same call
    sub = advect_substep_3d(bs, t(fields), t(vel), dt, to, 1, n_sub=1)
    np.testing.assert_array_equal(sub.numpy(), got)
    ref2 = np.asarray(j_substep(bs, jnp.asarray(fields), jnp.asarray(vel), dt,
                                jo, 1, n_sub=2))
    got2 = advect_substep_3d(bs, t(fields), t(vel), dt, to, 1, n_sub=2)
    assert_close(got2.numpy(), ref2, 3e-5, 3e-6, "advect_substep_3d")


@pytest.mark.parametrize("masked", [False, True])
def test_project_3d(masked):
    vel = rand((3, N, N, N), 50, 1.0)
    obst = random_mask(N, 6) if masked else None
    rv, rp = j_project(jnp.asarray(vel), None if obst is None else jnp.asarray(obst),
                       iters=60)
    gv, gp = project_3d(t(vel), None if obst is None else t(obst), iters=60)
    assert_close(gv.numpy(), np.asarray(rv), 3e-5, 3e-6, "velocity")
    assert_close(gp.numpy(), np.asarray(rp), 3e-5, 3e-6, "pressure")


def test_state_round_trip():
    cfg = tcfg.preset_bench_128().replace(size=N)
    state = zeros_state(cfg, "cpu")
    arrays = state_to_numpy(state)
    arrays["density"] = rand((N, N, N), 60)
    back = state_to_numpy(state_from_numpy(arrays, "cpu"))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    assert back["step"].shape == () and back["time"].dtype == np.float32
    arrays["step"] = arrays["step"].astype(np.int64)
    with pytest.raises(ValueError, match="step"):
        state_from_numpy(arrays, "cpu")
