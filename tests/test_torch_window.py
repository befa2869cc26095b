"""The advection and solve pieces of the plume64 slice of fluidsim_tpu_torch
against the JAX package, at 16³ on the CPU:

* the K1 twin with a window of K = 2 and 3 cells (F = 1 and 3, one and two
  substeps, with and without an obstacle mask, and with the buoyancy
  folded) against the XLA ``advect_multi_3d`` /
  ``advect_substep_3d`` and against ``advect_multi_3d_pallas`` run in
  interpret mode (as tests/test_pallas_interpret.py runs it);
* the exact 8-tap gather (``advect_3d``, ``advect_multi_3d`` with window 0),
  ``diffuse_3d`` and MacCormack against their JAX functions;
* the K4 twin against interpret-mode ``jacobi_3d_resident``, with and
  without a mask, and against the XLA ``jacobi_3d``;
* the solve's route between K4 and K6: K6 (its twin here) above the L2
  gate at 164³ against the XLA ``jacobi_3d``, and the step's
  ``double_project`` handing the projection's route to the solve;
* the kernel gate's window term and the K1 and K4 wrappers' checks.

Tolerances: K1 windowed rtol 2e-5, atol 2e-6·max|ref|, the JAX suite's own
class for its windowed kernel against XLA (tests/test_pallas_interpret.py,
rtol 2e-5, atol 2e-6 on fields of unit scale; here the atol scales with the
field, whose largest values are about 8, because the backtraces reach
three cells and sum up to 343 taps); the only difference is XLA-CPU
contracting a multiply-add into an FMA in the interpreted kernel (observed
up to 5.7e-6 against a largest value of about 8).  The
gather, ``diffuse_3d`` and MacCormack are XLA against plain PyTorch, the
same class: rtol 2e-5, atol 2e-6 (observed bitwise for the gather and
MacCormack).  The K4 twin is bitwise the interpret-mode kernel for the
projection's a = 1, c = 6 (no multiply-add to contract), from a start
whose faces are not ``set_bnd``-consistent too; against XLA's ``/ c`` it is
in the 1/c class, rtol 2e-5, atol 2e-6 on consistent starts.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsim_tpu.ops import advect as j_adv
from fluidsim_tpu.ops.boundary import set_bnd_3d as j_set_bnd
from fluidsim_tpu.ops.linsolve import diffuse_3d as j_diffuse, jacobi_3d as j_jacobi
from fluidsim_tpu.pallas.advect import advect_multi_3d_pallas
from fluidsim_tpu.pallas.resident import jacobi_3d_resident as j_jacobi_resident

from fluidsim_tpu_torch.config import preset_bench_128, preset_plume_64
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
from fluidsim_tpu_torch.kernels.jacobi import jacobi_3d_resident
from fluidsim_tpu_torch.kernels import project as t_kp
from fluidsim_tpu_torch.kernels.project import jacobi_3d_solve, jacobi_3d_solve_plain
from fluidsim_tpu_torch.models import stable3d as t_s3
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
from fluidsim_tpu_torch.ops import advect as t_adv
from fluidsim_tpu_torch.ops.linsolve import diffuse_3d
from fluidsim_tpu_torch.scene.sources import emitter_fold_operand
from fluidsim_tpu_torch.state import zeros_state

torch.set_num_threads(1)

N = 16
DT = 0.05
TOL = dict(rtol=2e-5, atol=2e-6)


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def box_mask():
    obst = np.zeros((N, N, N), bool)
    obst[6:9, 5:10, 6:9] = True
    return obst


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def fields_for(n_fields, seed):
    """F fields with their boundary codes, and a velocity whose backtrace
    reaches up to ~2.5 cells at DT (so K = 2 clamps and K = 3 mostly
    does not)."""
    bs = (1, 2, 3) if n_fields == 3 else (0,)
    fields = rand(seed, (n_fields, N, N, N), 2.0)
    vel = rand(seed + 1, (3, N, N, N), 1.2)
    return bs, fields, vel


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("n_fields", [1, 3])
@pytest.mark.parametrize("window", [2, 3])
def test_k1_window_twin_matches_jax(window, n_fields, n_sub, masked):
    bs, fields, vel = fields_for(n_fields, 10 * window + n_fields)
    obst = box_mask() if masked else None
    got = advect_multi_3d_kernel(bs, t(fields), t(vel), DT, obst=t(obst),
                                 window=window, n_sub=n_sub).numpy()
    pallas = np.asarray(advect_multi_3d_pallas(
        bs, j(fields), j(vel), DT, j(obst), window=window, n_sub=n_sub,
        interpret=True))
    if n_sub == 1:
        xla = j_adv.advect_multi_3d(bs, j(fields), j(vel), DT, j(obst), window)
    else:
        xla = j_adv.advect_substep_3d(bs, j(fields), j(vel), DT, j(obst), window,
                                      n_sub=n_sub)
    for what, ref in (("interpret-mode Pallas", pallas), ("XLA", np.asarray(xla))):
        np.testing.assert_allclose(
            got, ref, rtol=2e-5, atol=2e-6 * float(np.abs(ref).max()),
            err_msg=f"K1 window={window} vs {what}: max abs diff "
                    f"{float(np.abs(got - ref).max()):.3e}")
    if masked:
        solid = obst.copy()
        solid[[0, -1]] = solid[:, [0, -1]] = solid[:, :, [0, -1]] = False
        if bs == (0,):
            assert not got[0][solid].any()


@pytest.mark.parametrize("window", [2, 3])
def test_k1_window_folds_buoyancy_like_jax(window):
    """The self-advection with the buoyancy folded into the windowed kernel,
    against the interpret-mode Pallas kernel, without and with the emitter
    folded into the buoyancy's density."""
    _, _, vel = fields_for(3, 70 + window)
    dens = np.abs(rand(80 + window, (N, N, N), 4.0))
    buoy = (0.3, 0.1, 0.05)
    tv = t(vel)
    got = advect_multi_3d_kernel((1, 2, 3), tv, tv, DT, window=window, n_sub=2,
                                 buoy=(t(dens), *buoy)).numpy()
    jv = j(vel)
    ref = np.asarray(advect_multi_3d_pallas(
        (1, 2, 3), jv, jv, DT, None, window=window, n_sub=2, buoy=(j(dens), *buoy),
        interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6 * float(np.abs(ref).max()))
    src = emitter_fold_operand(preset_bench_128().replace(size=N), torch.full((), DT))
    got = advect_multi_3d_kernel((1, 2, 3), tv, tv, DT, window=window, n_sub=2,
                                 buoy=(t(dens), *buoy), src=src).numpy()
    ref = np.asarray(advect_multi_3d_pallas(
        (1, 2, 3), jv, jv, DT, None, window=window, n_sub=2, buoy=(j(dens), *buoy),
        src=jnp.asarray(src.numpy()), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_fields", [1, 3])
def test_exact_gather_matches_jax(n_fields, masked):
    bs, fields, vel = fields_for(n_fields, 40 + n_fields)
    obst = box_mask() if masked else None
    got = t_adv.advect_multi_3d(bs, t(fields), t(vel), DT, t(obst), window=0).numpy()
    ref = np.asarray(j_adv.advect_multi_3d(bs, j(fields), j(vel), DT, j(obst), 0))
    np.testing.assert_allclose(got, ref, **TOL)
    one = t_adv.advect_3d(bs[0], t(fields[0]), t(vel), DT, t(obst)).numpy()
    ref1 = np.asarray(j_adv.advect_3d(bs[0], j(fields[0]), j(vel), DT, j(obst)))
    np.testing.assert_allclose(one, ref1, **TOL)
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_diffuse_3d_matches_jax(b, masked):
    cfg = preset_plume_64().replace(size=N)
    x0 = np.asarray(j_set_bnd(b, j(rand(50 + b, (N, N, N))), None))
    obst = box_mask() if masked else None
    got = diffuse_3d(b, t(x0), 1e-3, DT, t(obst), cfg).numpy()
    ref = np.asarray(j_diffuse(b, j(x0), 1e-3, DT, j(obst), cfg))
    np.testing.assert_allclose(got, ref, **TOL)
    assert not np.array_equal(got, x0)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_fields", [1, 3])
def test_maccormack_matches_jax(n_fields, masked):
    bs, fields, vel = fields_for(n_fields, 60 + n_fields)
    obst = box_mask() if masked else None
    got = t_adv.advect_maccormack_3d(bs, t(fields), t(vel), DT, t(obst), 2).numpy()
    ref = np.asarray(j_adv.advect_maccormack_3d(bs, j(fields), j(vel), DT, j(obst), 2))
    np.testing.assert_allclose(got, ref, **TOL)
    # The kernel path's composition: K1 (its twin here) as the base step.
    base = functools.partial(advect_multi_3d_kernel, obst=t(obst), window=2)
    got_k = t_adv.advect_maccormack_3d(bs, t(fields), t(vel), DT, t(obst), 2,
                                       advect_fn=base).numpy()
    np.testing.assert_array_equal(got_k, got)


@pytest.mark.parametrize("case", ["b0", "b1", "b2", "b3", "b0-mask"])
def test_k4_twin_matches_interpret_pallas_bitwise(case):
    """From a non-zero start whose faces are not set_bnd-consistent (the
    first sweep reads them as each TPU variant does)."""
    b = int(case[1])
    obst = box_mask() if case.endswith("mask") else None
    x, x0 = rand(90 + b, (N, N, N)), rand(95 + b, (N, N, N))
    got = jacobi_3d_resident(b, t(x), t(x0), 1.0, 6.0, 7, obst=t(obst)).numpy()
    ref = np.asarray(j_jacobi_resident(b, j(x), j(x0), 1.0, 6.0, 7, obst=j(obst),
                                       interpret=True))
    assert np.array_equal(got, ref), float(np.abs(got - ref).max())


@pytest.mark.parametrize("coeffs", [(1.0, 6.0), (0.13, 1.0 + 6 * 0.13)],
                         ids=["projection", "diffusion"])
@pytest.mark.parametrize("b,masked", [(0, False), (3, False), (0, True)])
def test_k4_twin_matches_xla_jacobi(b, masked, coeffs):
    obst = box_mask() if masked else None
    x = np.asarray(j_set_bnd(b, j(rand(100 + b, (N, N, N))), None))
    x0 = rand(105 + b, (N, N, N))
    got = jacobi_3d_resident(b, t(x), t(x0), *coeffs, 8, obst=t(obst)).numpy()
    ref = np.asarray(j_jacobi(b, j(x), j(x0), *coeffs, j(obst), 8))
    np.testing.assert_allclose(got, ref, **TOL)
    # The solve route takes K4 (its twin on the CPU) at 16³, with a mask too.
    np.testing.assert_array_equal(
        jacobi_3d_solve(b, t(x), t(x0), *coeffs, 8, obst=t(obst)).numpy(), got)


@pytest.mark.parametrize("n,masked,resident,route", [
    (163, False, None, "K4"), (164, False, None, "K6"), (164, True, None, "K4"),
    (16, False, False, "K6"), (164, False, True, "K4")])
def test_solve_route_between_k4_and_k6(monkeypatch, n, masked, resident, route):
    """K4 where the float32 solve's three volumes fit the H100's L2 (up to
    163³) or there is a mask, else K6; a route the caller passes wins."""
    calls = []
    for name in ("jacobi_3d_plain", "jacobi_3d_resident_plain"):
        monkeypatch.setattr(t_kp, name, lambda *a, name=name: calls.append(name))
    x = torch.zeros((n, n, n))
    obst = torch.zeros((n, n, n), dtype=torch.bool) if masked else None
    jacobi_3d_solve_plain(0, x, x, 1.0, 6.0, 2, obst=obst, resident=resident)
    assert calls == [{"K4": "jacobi_3d_resident_plain", "K6": "jacobi_3d_plain"}[route]]


def test_solve_above_the_l2_gate_matches_xla_jacobi():
    """The K6 side of the solve (its twin on the CPU) at 164³, the smallest
    grid whose float32 solve does not fit the H100's L2, from zero as the
    pre-projection starts it."""
    n = 164
    x0 = rand(110, (n, n, n))
    got = jacobi_3d_solve(0, torch.zeros((n, n, n)), t(x0), 1.0, 6.0, 2).numpy()
    ref = np.asarray(j_jacobi(0, jnp.zeros((n, n, n)), j(x0), 1.0, 6.0, None, 2))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("solve_dtype,resident,passed", [
    ("float32", True, True), ("float32", False, False), ("bfloat16", True, None)])
def test_double_project_hands_the_route_to_the_solve(solve_dtype, resident, passed):
    """The pre-projection's solve takes the projection's route where that
    solves in float32 too; a bfloat16 projection's route says nothing of
    the float32 solve's, which is then decided by the solve."""
    cfg = preset_plume_64().replace(size=N, double_project=True, solve_dtype=solve_dtype)
    seen = []

    def jacobi(*a, **k):
        seen.append(k["resident"])
        return PLAIN_TWINS.jacobi(*a, **k)

    kernels = PLAIN_TWINS._replace(jacobi=jacobi)
    state = zeros_state(cfg, "cpu").replace(density=t(np.abs(rand(120, (N, N, N)))),
                                            velocity=t(rand(121, (3, N, N, N), 0.3)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_s3, "_kernels_usable", lambda c, device: True)
        t_s3.simulate_step_3d(state, cfg, kernels, resident=resident)
    assert seen == [passed]


def test_k4_wrapper_checks():
    x = torch.zeros((N, N, N))
    mask = torch.zeros((N, N, N), dtype=torch.bool)
    with pytest.raises(ValueError, match="b == 0"):
        jacobi_3d_resident(1, x, x, 1.0, 6.0, 2, obst=mask)
    with pytest.raises(ValueError, match="iters"):
        jacobi_3d_resident(0, x, x, 1.0, 6.0, 0)
    with pytest.raises(TypeError):
        jacobi_3d_resident(0, x.double(), x.double(), 1.0, 6.0, 2)
    with pytest.raises(ValueError, match="boundary code"):
        jacobi_3d_resident(4, x, x, 1.0, 6.0, 2)


def test_k1_wrapper_window_checks():
    """Any integer window K >= 1 on a grid of 2K+1 cells or more."""
    vel = torch.zeros((3, N, N, N))
    for window in (0, -1, 2.5):
        with pytest.raises(ValueError, match="window"):
            advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, window=window)
    small = torch.zeros((3, 6, 6, 6))
    with pytest.raises(ValueError, match="too small"):
        advect_multi_3d_kernel((1, 2, 3), small, small, DT, window=3)


@pytest.mark.parametrize("window,usable", [(0, False), (1, True), (3, True)])
def test_kernel_gate_needs_a_window(window, usable):
    """No kernel takes the exact gather: on a card, window 0 takes the plain
    path, as the JAX ``_pallas_usable`` sends it to XLA (the device is only
    named, not allocated on)."""
    cfg = preset_plume_64().replace(advect_window=window)
    assert t_s3._kernels_usable(cfg, torch.device("cuda")) is usable
    assert not t_s3._kernels_usable(cfg, torch.device("cpu"))
    if not usable:
        with pytest.raises(RuntimeError, match="advect_window > 0"):
            t_s3._kernels_usable(cfg.replace(kernel_backend="pallas"),
                                 torch.device("cuda"))
