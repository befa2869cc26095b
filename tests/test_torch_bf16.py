"""bfloat16 field storage in fluidsim_tpu_torch against the JAX package.

Fields may be stored in bfloat16; the backtrace, the weights, the solve, the
divergence and the gradient accumulate in float32, in both packages.

* The kernels' bfloat16 twins against the interpret-mode Pallas kernels
  (as tests/test_pallas_interpret.py runs them) on the same seeded bfloat16
  inputs: K1 (F = 1, 3; substeps; the mask), K3 (with and without the
  mask), K2 and K2o, K8.  Both round the same float32 values to bfloat16 at
  the same points, so they agree exactly except where XLA on the CPU
  contracts a multiply-add of the interpreted kernel into an FMA and the
  float32 values straddle a bfloat16 rounding boundary: there they differ
  by one bfloat16 ulp.  The tests count those cells and hold them to under
  1% of the cells (``assert_ulp_class``).  Where the solve is bfloat16 too,
  such a flip inside the solve moves the pressure, so the projected
  velocity is held to K2's bfloat16-solve class of tests/test_torch_fused.py
  (atol 2e-2·max|ref|) instead.
* The plain bfloat16 ops and the bfloat16 step against the JAX XLA path at
  storage precision, as tests/test_bf16.py holds its bfloat16 kernels:
  rtol 3e-2, atol 3e-2·max|ref|.  XLA on the CPU may keep float32 between
  fused bfloat16 operations where PyTorch rounds after each, so bitwise is
  not the goal.
* The port's bfloat16 run against its float32 run over 10 steps, with
  tests/test_bf16.py's physics audit (mass, centre of mass, mean drift).
* The NumPy conversion carries bfloat16 state both ways.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.project as j_pp
from fluidsim_tpu import config as j_config
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.ops import advect as j_adv
from fluidsim_tpu.ops import forces as j_forces
from fluidsim_tpu.ops import linsolve as j_lin
from fluidsim_tpu.ops import project as j_proj
from fluidsim_tpu.pallas.advect import advect_multi_3d_pallas
from fluidsim_tpu.pallas.resident import (
    full_step_3d_resident,
    project_3d_resident,
    project_advect_density_3d_resident,
)
from fluidsim_tpu.render.raymarch import render_frame_3d as j_render
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.scene.sources import apply_custom_source as j_source
from fluidsim_tpu.state import FluidState as JState

from fluidsim_tpu_torch import config as t_config
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels import project as t_kp
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
from fluidsim_tpu_torch.kernels.resident import (
    full_step_3d,
    project_3d_resident_plain,
    project_advect_density_3d,
)
from fluidsim_tpu_torch.models import stable3d as t_s3
from fluidsim_tpu_torch.ops import advect as t_adv
from fluidsim_tpu_torch.ops import forces as t_forces
from fluidsim_tpu_torch.ops import linsolve as t_lin
from fluidsim_tpu_torch.ops import project as t_proj
from fluidsim_tpu_torch.render.raymarch import render_frame_3d
from fluidsim_tpu_torch.scene.sources import apply_custom_source
from fluidsim_tpu_torch.state import zeros_state

torch.set_num_threads(1)

BF16 = torch.bfloat16
N = 16
DT = 0.05
DAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(2.0)))
DDAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(0.5)))


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def bf16_inputs(seed, n=N, scale=0.5):
    """Seeded velocity (a backtrace of up to about a cell at DT) and a
    positive density, rounded to bfloat16: (torch, jax) pairs."""
    vel = torch.from_numpy(rand(seed, (3, n, n, n), scale * (n - 2) / 14)).to(BF16)
    dens = torch.from_numpy(np.abs(rand(seed + 1, (n, n, n), 4.0)) + 1.0).to(BF16)
    return vel, dens


def j(t):
    """A torch tensor as a JAX array of the same dtype."""
    if t is None:
        return None
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def box_mask(n=N):
    obst = np.zeros((n, n, n), bool)
    obst[6:10, 5:11, 6:9] = True
    return torch.from_numpy(obst)


def bf16_key(a):
    """The bfloat16 values of the float32 array ``a`` as ordered integers
    (one apart for neighbouring bfloat16 values; ±0 alike)."""
    bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.int64)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def assert_ulp_class(got, ref, what, max_share=0.01):
    """Equal but for cells one bfloat16 ulp apart, fewer than ``max_share``
    of them."""
    g, r = f32(got), f32(ref)
    ulps = np.abs(bf16_key(g) - bf16_key(r))
    flips = int((ulps > 0).sum())
    assert ulps.max() <= 1, f"{what}: {int(ulps.max())} bf16 ulps apart"
    assert flips <= max_share * g.size, f"{what}: {flips} of {g.size} cells one ulp apart"


def assert_storage_close(got, ref, what, tol=3e-2):
    """Storage precision: rtol and atol 3e-2·max|ref| (tests/test_bf16.py)."""
    g, r = f32(got), f32(ref)
    scale = max(float(np.abs(r).max()), 1e-6)
    np.testing.assert_allclose(g, r, rtol=tol, atol=tol * scale,
                               err_msg=f"{what}: max abs diff {float(np.abs(g - r).max()):.3e}"
                                       f" at scale {scale:.3e}")


# -- the kernels' twins against interpret-mode Pallas --------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 3])
@pytest.mark.parametrize("n_fields", [1, 3])
def test_k1_bf16_twin_matches_pallas(n_fields, n_sub, masked):
    vel, dens = bf16_inputs(10 + n_sub)
    fields, bs = (vel, (1, 2, 3)) if n_fields == 3 else (dens[None], (0,))
    obst = box_mask() if masked else None
    got = advect_multi_3d_kernel(bs, fields, vel, DT, obst=obst, n_sub=n_sub)
    jv = j(vel)
    jf = jv if n_fields == 3 else j(dens)[None]
    ref = advect_multi_3d_pallas(bs, jf, jv, DT, j(obst), window=1, n_sub=n_sub,
                                 interpret=True)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert_ulp_class(got, ref, f"K1 bf16 F={n_fields} n_sub={n_sub}")


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k3_bf16_twin_matches_pallas(solve_dtype, masked):
    vel, _ = bf16_inputs(20)
    obst = box_mask() if masked else None
    got_v, got_p = project_3d_resident_plain(vel, 8, obst=obst, solve_dtype=solve_dtype)
    ref_v, ref_p = project_3d_resident(j(vel), 8, obst=j(obst), solve_dtype=solve_dtype,
                                       interpret=True)
    assert got_v.dtype == BF16 and got_p.dtype == BF16 and ref_p.dtype == jnp.bfloat16
    if solve_dtype is None:
        assert_ulp_class(got_p, ref_p, "K3 bf16 pressure")
        assert_ulp_class(got_v, ref_v, "K3 bf16 velocity")
    else:
        assert_storage_close(got_v, ref_v, "K3 bf16 velocity (bf16 solve)", tol=2e-2)


@pytest.mark.parametrize("variant", ["K2", "K2o"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k2_bf16_twin_matches_pallas(variant, solve_dtype):
    vel, dens = bf16_inputs(30)
    kw = dict(n_sub=1) if variant == "K2" else dict(n_sub=3)
    obst = box_mask() if variant == "K2o" else None
    got = project_advect_density_3d(vel, dens, 8, DT, obst=obst, solve_dtype=solve_dtype,
                                    damp=DAMP, dens_damp=DDAMP, **kw)
    ref = project_advect_density_3d_resident(
        j(vel), j(dens), 8, DT, obst=j(obst), solve_dtype=solve_dtype, damp=DAMP,
        dens_damp=DDAMP, interpret=True, **kw)
    assert all(g.dtype == BF16 for g in got)
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        if solve_dtype is None:
            assert_ulp_class(g, r, f"{variant} bf16 {name}")
        else:
            assert_storage_close(g, r, f"{variant} bf16 {name} (bf16 solve)", tol=2e-2)


@pytest.mark.parametrize("n_sub", [1, 2])
def test_k8_bf16_twin_matches_pallas(n_sub):
    vel, dens = bf16_inputs(40 + n_sub)
    got = full_step_3d(vel, dens, 8, DT, n_sub=n_sub, damp=DAMP, dens_damp=DDAMP)
    ref = full_step_3d_resident(j(vel), j(dens), 8, DT, n_sub=n_sub, damp=DAMP,
                                dens_damp=DDAMP, interpret=True)
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        assert_ulp_class(g, r, f"K8 bf16 {name}")


def test_bf16_kernels_compose_like_the_unfused_step():
    """K8 is K1 then K2 and K2o is K3 then K1 on the density, bitwise, on
    bfloat16 fields too (the twins are the CPU wrappers)."""
    vel, dens = bf16_inputs(50)
    kw = dict(damp=DAMP, dens_damp=DDAMP)
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=2)
    for g, r in zip(full_step_3d(vel, dens, 8, DT, n_sub=2, **kw),
                    project_advect_density_3d(adv, dens, 8, DT, n_sub=2, **kw)):
        assert torch.equal(g, r)
    obst = box_mask()
    v, p, d = project_advect_density_3d(vel, dens, 8, DT, obst=obst, n_sub=3, damp=DAMP)
    v3, p3 = project_3d_resident_plain(vel, 8, obst=obst, damp=DAMP)
    d3 = advect_multi_3d_kernel((0,), dens[None], v3, DT, obst=obst, n_sub=3)[0]
    assert torch.equal(v, v3) and torch.equal(p, p3) and torch.equal(d, d3)


def test_slab_route_and_k4_upcast_at_the_edge(monkeypatch):
    """bfloat16 through the slab route and K4: the float32 solve on the
    widened fields, the results rounded back (the JAX wrappers' upcast)."""
    vel, _ = bf16_inputs(60)
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    got_v, got_p = t_kp.project_3d_kernel(vel, 8)
    ref_v, ref_p = t_kp.project_3d_slab_kernel(vel.float(), 8)
    assert got_v.dtype == BF16 and got_p.dtype == BF16
    assert torch.equal(got_v, ref_v.to(BF16)) and torch.equal(got_p, ref_p.to(BF16))
    x = vel[0].contiguous()
    got = t_kp.jacobi_3d_solve(0, x, x, 1.0, 6.0, 5)
    ref = t_kp.jacobi_3d_solve(0, x.float(), x.float(), 1.0, 6.0, 5)
    assert got.dtype == BF16 and torch.equal(got, ref.to(BF16))


# -- the plain bfloat16 ops against the JAX XLA path ----------------------------


@pytest.mark.parametrize("window", [0, 2])
def test_plain_advection_bf16_like_jax(window):
    vel, dens = bf16_inputs(70)
    obst = box_mask()
    got = t_adv.advect_multi_3d((1, 2, 3), vel, vel, DT, obst, window)
    # Under jit: the (2K+1)³ rolls compile once instead of op by op.
    ref = jax.jit(lambda v, o: j_adv.advect_multi_3d((1, 2, 3), v, v, DT, o, window))(
        j(vel), j(obst))
    assert got.dtype == BF16
    assert_storage_close(got, ref, f"advect_multi_3d window={window}")
    if window == 0:
        got = t_adv.advect_maccormack_3d((0,), dens[None], vel, DT, obst, window)
        ref = j_adv.advect_maccormack_3d((0,), j(dens)[None], j(vel), DT, j(obst), window)
        assert_storage_close(got, ref, "advect_maccormack_3d")
    else:
        got = t_adv.advect_substep_3d((0,), dens[None], vel, DT, obst, 1, n_sub=2)
        ref = j_adv.advect_substep_3d((0,), j(dens)[None], j(vel), DT, j(obst), 1, n_sub=2)
        assert_storage_close(got, ref, "advect_substep_3d")


def test_plain_projection_and_diffusion_bf16_like_jax():
    vel, dens = bf16_inputs(80)
    obst = box_mask()
    for mask in (None, obst):
        got_v, got_p = t_proj.project_3d(vel, mask, 10)
        ref_v, ref_p = j_proj.project_3d(j(vel), j(mask), 10)
        assert got_v.dtype == BF16 and got_p.dtype == BF16
        assert_storage_close(got_v, ref_v, "project_3d velocity")
        assert_storage_close(got_p, ref_p, "project_3d pressure")
    cfg = t_config.preset_plume_64().replace(size=N)
    got = t_lin.diffuse_3d(0, dens, 1e-3, DT, obst, cfg)
    ref = j_lin.diffuse_3d(0, j(dens), 1e-3, DT, j(obst), cfg)
    assert_storage_close(got, ref, "diffuse_3d")


def test_forces_bf16_like_jax():
    vel, dens = bf16_inputs(90)
    obst = box_mask()
    pairs = (
        ("buoyancy_force", t_forces.buoyancy_force(vel, dens, DT, 1.3, 0.1, 0.5),
         j_forces.buoyancy_force(j(vel), j(dens), DT, 1.3, 0.1, 0.5)),
        ("vorticity_confinement_3d", t_forces.vorticity_confinement_3d(vel, DT, 0.2),
         j_forces.vorticity_confinement_3d(j(vel), DT, 0.2)),
        ("enforce_obstacle_boundaries_3d",
         t_forces.enforce_obstacle_boundaries_3d(vel, obst, 1.0, 1e-4),
         j_forces.enforce_obstacle_boundaries_3d(j(vel), j(obst), 1.0, 1e-4)),
        ("apply_turbulent_noise_3d", t_forces.apply_turbulent_noise_3d(vel),
         j_forces.apply_turbulent_noise_3d(j(vel))),
    )
    for name, got, ref in pairs:
        assert got.dtype == BF16, name
        assert_storage_close(got, ref, name)


def test_sources_and_render_bf16_like_jax():
    cfg = t_config.preset_bench_128().replace(size=N, dtype="bfloat16",
                                              source_emits_velocity=True)
    jcfg = j_config.preset_bench_128().replace(size=N, dtype="bfloat16",
                                               source_emits_velocity=True)
    vel, dens = bf16_inputs(100)
    t = torch.tensor(DT, dtype=torch.float32)
    got = apply_custom_source(dens, vel, cfg, t)
    ref = j_source(j(dens), j(vel), jcfg, jnp.float32(DT))
    for name, g, r in zip(("density", "velocity"), got, ref):
        assert g.dtype == BF16
        assert_storage_close(g, r, f"emitter {name}")
    state = zeros_state(cfg, "cpu").replace(density=dens)
    jstate = JState(density=j(dens), velocity=j(vel), pressure=j(dens),
                    obstacles=jnp.zeros((N,) * 3, bool), step=jnp.int32(0),
                    time=jnp.float32(0.0))
    assert_storage_close(render_frame_3d(state, cfg), j_render(jstate, jcfg), "render")


def test_2d_ops_bf16_like_jax():
    from fluidsim_tpu.ops import advect as j_adv2
    from fluidsim_tpu.ops.project import project_2d as j_project_2d

    n = 32
    vx, vy = (torch.from_numpy(rand(110 + i, (n, n), 3.0)).to(BF16) for i in range(2))
    d = torch.from_numpy(np.abs(rand(112, (n, n), 4.0))).to(BF16)
    obst = torch.zeros((n, n), dtype=torch.bool)
    obst[12:18, 10:20] = True
    got = t_adv.advect_2d(0, d, vx, vy, DT, obst)
    assert got.dtype == BF16
    assert_storage_close(got, j_adv2.advect_2d(0, j(d), j(vx), j(vy), DT, j(obst)),
                         "advect_2d")
    got = t_proj.project_2d(vx, vy, obst, 20)
    ref = j_project_2d(j(vx), j(vy), j(obst), 20)
    for name, g, r in zip(("vx", "vy", "p"), got, ref):
        assert g.dtype == BF16
        assert_storage_close(g, r, f"project_2d {name}")
    got = t_lin.sweeps_2d(1, vx, vx, 0.2, 2.2, obst, 20, smooth=True)
    ref = j_lin.diffuse_smooth_2d(1, j(vx), 0.2, 2.2, j(obst), 20)
    assert_storage_close(got, ref, "the smoothing solve")


# -- the bfloat16 step -----------------------------------------------------------


def start_arrays(cfg, seed=2025):
    """A seeded float32 start state whose fields are bfloat16 values."""
    n = cfg.current_size
    shape = (cfg.ndim,) + (n,) * cfg.ndim
    vel = torch.from_numpy(rand(seed, shape, 0.3)).to(BF16).float().numpy()
    dens = np.abs(rand(seed + 1, shape[1:], 3.0))
    dens = torch.from_numpy(dens).to(BF16).float().numpy()
    obst = (j_build_mask(cfg) if cfg.enable_obstacle else np.zeros(shape[1:], bool))
    return {"density": dens, "velocity": vel, "pressure": np.zeros(shape[1:], np.float32),
            "obstacles": np.asarray(obst), "step": np.zeros((), np.int32),
            "time": np.zeros((), np.float32)}


def step_both(name, change, steps=2):
    """``steps`` steps of preset ``name`` with ``change`` in both packages
    from the same bfloat16 start: the JAX kernel path with interpret-mode
    Pallas against the port's kernel path on the twins."""
    jcfg = getattr(j_config, name)().replace(**change)
    tcfg = getattr(t_config, name)().replace(**change)
    arrays = start_arrays(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_s3, "_pallas_usable",
                   lambda cfg: cfg.kernel_backend != "xla" and cfg.advect_window > 0)
        for mod, fn in ((j_pa, "advect_multi_3d_pallas"), (j_pp, "project_3d_pallas"),
                        (j_pp, "project_advect_density_3d_pallas"),
                        (j_pp, "full_step_3d_pallas")):
            mp.setattr(mod, fn, functools.partial(getattr(mod, fn), interpret=True))
        mp.setattr(t_s3, "_kernels_usable",
                   lambda cfg, device: cfg.kernel_backend != "xla" and cfg.advect_window > 0)
        jeng = JEngine(jcfg)
        jeng.state = JState(**{k: jnp.asarray(v).astype(jnp.bfloat16)
                               if k in ("density", "velocity", "pressure")
                               else jnp.asarray(v) for k, v in arrays.items()})
        jeng.step(steps)
        teng = Engine(tcfg, "cpu")
        teng.state = state_from_numpy(arrays, "cpu", dtype="bfloat16")
        teng.step(steps)
    return jeng.state, teng.state


@pytest.mark.parametrize("name,change", [
    ("preset_bench_128", dict(size=32, dtype="bfloat16")),
    ("preset_bench_128", dict(size=32, dtype="bfloat16", fuse_project_advect=False)),
    ("preset_bench_128", dict(size=32, dtype="bfloat16", fuse_self_advect=True)),
    ("preset_vortex_128", dict(size=32, dtype="bfloat16")),
    ("preset_vortex_128", dict(size=32, dtype="bfloat16", fuse_project_advect=True)),
    ("preset_scene_b", dict(size=32, dtype="bfloat16", resolution_multiplier=1.0)),
], ids=["bench128", "bench128-unfused", "bench128-K8", "vortex128", "vortex128-K2o",
        "scene_b-2d"])
def test_bf16_step_like_jax(name, change):
    jst, tst = step_both(name, change)
    for field in ("density", "velocity", "pressure"):
        got = getattr(tst, field)
        assert got.dtype == BF16, field
        assert_storage_close(got, getattr(jst, field), f"{name} {field}")


def test_multi256_bf16_takes_the_slab_route_in_float32(monkeypatch):
    """multi256's bfloat16 step above the L2 gate: the slab route on the
    widened velocity, bitwise the twins' rollout and near the plain path."""
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    cfg = t_config.preset_multi_emitter_256().replace(size=32, dtype="bfloat16")
    seen = []
    real = t_kp.divergence_3d_kernel

    def spy(vel):
        seen.append(vel.dtype)
        return real(vel)

    monkeypatch.setattr(t_kp, "divergence_3d_kernel", spy)
    eng = Engine(cfg, "cpu")
    eng.state = state_from_numpy(start_arrays(cfg), "cpu", dtype="bfloat16")
    eng.step(3)
    assert seen == [torch.float32] * 3
    assert eng.state.velocity.dtype == BF16
    plain = Engine(cfg.replace(kernel_backend="xla"), "cpu")
    plain.state = state_from_numpy(start_arrays(cfg), "cpu", dtype="bfloat16")
    plain.step(3)
    for field in ("density", "velocity"):
        assert_storage_close(getattr(eng.state, field), getattr(plain.state, field).float(),
                             f"multi256 {field}")


def test_bf16_run_tracks_f32():
    """tests/test_bf16.py's audit on the port: 10 steps of a buoyant plume in
    bfloat16 against float32."""
    base = t_config.SimConfig(
        size=32, ndim=3, time_step=0.02, diffusion=0.0, viscosity=1e-4, jacobi_iters=20,
        buoyancy=1.0, advect_window=2, enable_custom_source=True, source_strength=12.0,
        source_radius=3.0, source_position=(0.5, 0.2, 0.5),
        obstacle_position=(0.5, 0.5, 0.5), enable_obstacle=False)
    states = {}
    for dtype in ("bfloat16", "float32"):
        eng = Engine(base.replace(dtype=dtype), "cpu")
        eng.step(10)
        states[dtype] = eng.state
    assert states["bfloat16"].density.dtype == BF16
    d16 = states["bfloat16"].density.double().numpy()
    d32 = states["float32"].density.double().numpy()
    assert not np.isnan(d16).any()
    mass16, mass32 = d16.sum(), d32.sum()
    assert abs(mass16 - mass32) < 3e-2 * abs(mass32)
    idx = np.indices(d32.shape).reshape(3, -1)
    com32 = (idx * d32.ravel()).sum(1) / d32.sum()
    com16 = (idx * d16.ravel()).sum(1) / d16.sum()
    assert np.abs(com16 - com32).max() < 0.5
    scale = max(1.0, float(np.abs(d32).max()))
    assert float(np.abs(d16 - d32).mean()) < 2e-2 * scale
    v16 = states["bfloat16"].velocity.double().numpy()
    v32 = states["float32"].velocity.double().numpy()
    vscale = max(1e-3, float(np.abs(v32).max()))
    assert float(np.abs(v16 - v32).mean()) < 2e-2 * vscale


def test_state_conversion_carries_bf16():
    """A JAX bfloat16 state through NumPy (``ml_dtypes`` arrays) into the port
    and back, and float32 arrays of bfloat16 values with the dtype named."""
    jcfg = j_config.preset_bench_128().replace(size=N, dtype="bfloat16")
    arrays = start_arrays(jcfg)
    jstate = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
              if k in ("density", "velocity", "pressure") else v
              for k, v in arrays.items()}
    assert jstate["density"].dtype.name == "bfloat16"
    state = state_from_numpy(jstate, "cpu")
    assert state.density.dtype == BF16 and state.time.dtype == torch.float32
    back = state_to_numpy(state)
    for k in ("density", "velocity", "pressure"):
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], arrays[k])
    again = state_from_numpy(back, "cpu", dtype="bfloat16")
    assert torch.equal(again.velocity, state.velocity)
    bad = dict(back, density=back["density"] + np.float32(1e-3))
    with pytest.raises(ValueError, match="does not hold"):
        state_from_numpy(bad, "cpu", dtype="bfloat16")
    with pytest.raises(ValueError, match="bfloat16 values"):
        state_from_numpy(jstate, "cpu", dtype="float32")
