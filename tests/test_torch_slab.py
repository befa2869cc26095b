"""K6 (the temporally blocked Jacobi solve) and K7 (the slab divergence and
gradient) of fluidsim_tpu_torch against the JAX package's slab kernels.

The JAX side runs ``jacobi_3d_pallas`` and ``project_3d_pallas`` in
interpret mode with ``resident_fits`` forced False, as
tests/test_pallas_interpret.py does, so it takes the slab kernels
(``_jacobi_kernel``, ``_div_kernel``, ``_grad_kernel``) at 16³ and 32³.  The
port's side is the kernels' plain twins (the wrappers' behaviour for CPU
tensors).  Inputs are made with numpy from a seed.

Observed: with the projection's coefficients (``a = 1``, ``c = 6``) the K6
twin equals the interpret-mode kernel bitwise for every ``b`` at
``block_iters = 2``; at ``block_iters = 4`` the interpret-mode kernel itself
moves by one ulp (5.96e-8, 16³, ``b = 2``, cells next to the y wall) from its
``block_iters = 2`` result, so there the twin is held to that spread.  With
the diffusion coefficients the twin is within 2.4e-7 (max |x| ≈ 2.7; the
JAX package's own rtol 2e-5, atol 2e-6): XLA-CPU contracts ``x0 + a·nbr``
into an FMA, which is exact only for ``a = 1``.  K7's divergence (interior
cells: the JAX kernel leaves garbage on the faces, which the solve never
reads), K7's gradient and the whole slab route, velocity and pressure, are
bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.pallas.project as j_pp
import fluidsim_tpu.pallas.resident as j_res
from fluidsim_tpu.pallas.jacobi import jacobi_3d_pallas, pick_blocking

from fluidsim_tpu_torch.kernels import project as t_kp
from fluidsim_tpu_torch.kernels.jacobi import jacobi_3d_kernel, jacobi_3d_plain
from fluidsim_tpu_torch.kernels.project import (
    divergence_3d_kernel,
    divergence_3d_plain,
    gradient_3d_kernel,
    project_3d_kernel,
    project_3d_slab_plain,
)
from fluidsim_tpu_torch.kernels.resident import project_3d_resident_plain, project_gradient

torch.set_num_threads(1)

INTERIOR = (slice(1, -1),) * 3


@pytest.fixture
def slab_only(monkeypatch):
    """The JAX package's slab route: no resident kernel fits."""
    monkeypatch.setattr(j_res, "resident_fits", lambda *a, **k: False)


def volumes(n, seed, count=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n, n)).astype(np.float32) for _ in range(count)]


def velocity(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, n, n, n)) * 3.0).astype(np.float32)


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


def jax_jacobi(b, x, x0, a, c, iters, block_iters):
    # jacobi_3d_pallas takes its XLA fallback when no blocking fits: make
    # sure the interpret-mode slab kernel runs.
    assert pick_blocking(x.shape[-1], block_iters)[0] is not None
    return np.asarray(jacobi_3d_pallas(b, jnp.asarray(x), jnp.asarray(x0), a, c,
                                       iters, block_iters=block_iters,
                                       interpret=True))


# -- K6 ------------------------------------------------------------------------


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("n,iters", [(16, 5), (32, 7)])
def test_k6_twin_matches_pallas_slab_kernel(slab_only, n, iters, b):
    x, x0 = volumes(n, 10 * n + b)
    got = jacobi_3d_plain(b, torch.from_numpy(x), torch.from_numpy(x0), 1.0, 6.0,
                          iters).numpy()
    ref2 = jax_jacobi(b, x, x0, 1.0, 6.0, iters, block_iters=2)
    ref4 = jax_jacobi(b, x, x0, 1.0, 6.0, iters, block_iters=4)
    np.testing.assert_array_equal(
        got, ref2, err_msg=f"block_iters=2: max abs diff {max_diff(got, ref2):.3e}")
    assert max_diff(got, ref4) <= max_diff(ref2, ref4), (
        f"block_iters=4: max abs diff {max_diff(got, ref4):.3e} beyond the "
        f"interpret-mode kernel's own spread {max_diff(ref2, ref4):.3e}")


@pytest.mark.parametrize("n,iters,block_iters", [(16, 7, 2), (32, 9, 4)])
def test_k6_twin_diffusion_coeffs(slab_only, n, iters, block_iters):
    """tests/test_pallas_interpret.py::test_jacobi_pallas_diffusion_coeffs's
    coefficients; observed max abs diff 2.4e-7."""
    a = np.float32(0.13)
    c = np.float32(1 + 6 * 0.13)
    x, x0 = volumes(n, 99 + n)
    ref = jax_jacobi(0, x, x0, float(a), float(c), iters, block_iters)
    got = jacobi_3d_plain(0, torch.from_numpy(x), torch.from_numpy(x0), float(a),
                          float(c), iters).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


# -- K7 and the slab route -------------------------------------------------------


@pytest.mark.parametrize("n,block_iters", [(16, 2), (32, 4)])
def test_k7_and_slab_route_match_project_3d_pallas(slab_only, monkeypatch, n,
                                                    block_iters):
    """The divergence and the pressure are taken from inside the JAX slab
    route, at its call of ``jacobi_3d_pallas``."""
    seen = {}
    jacobi = j_pp.jacobi_3d_pallas

    def spy(b, x, x0, a, c, iters, block_iters=10, interpret=False, **kw):
        out = jacobi(b, x, x0, a, c, iters, block_iters, interpret=interpret, **kw)
        seen["div"], seen["p"] = np.array(x0), np.array(out)
        return out

    monkeypatch.setattr(j_pp, "jacobi_3d_pallas", spy)
    vel = velocity(n, 7 + n)
    ref_vel, ref_p = j_pp.project_3d_pallas(jnp.asarray(vel), 20,
                                            block_iters=block_iters,
                                            interpret=True)
    ref_vel, ref_p = np.asarray(ref_vel), np.asarray(ref_p)
    tv = torch.from_numpy(vel)

    div = divergence_3d_plain(tv).numpy()
    np.testing.assert_array_equal(div[INTERIOR], seen["div"][INTERIOR])
    assert not div[0].any() and not div[:, :, -1].any()
    grad = project_gradient(tv, torch.from_numpy(seen["p"])).numpy()
    np.testing.assert_array_equal(grad, ref_vel)
    got_vel, got_p = project_3d_slab_plain(tv, 20)
    np.testing.assert_array_equal(got_p.numpy(), ref_p)
    np.testing.assert_array_equal(got_vel.numpy(), ref_vel)


# -- the wrappers on the CPU ------------------------------------------------------


def test_wrappers_on_cpu_run_the_twins():
    x, x0 = (torch.from_numpy(v) for v in volumes(16, 5))
    tv = torch.from_numpy(velocity(16, 6))
    counters = (jacobi_3d_kernel, divergence_3d_kernel, gradient_3d_kernel)
    for fn in counters:
        fn.launches = 0
    for b in (0, 2):
        assert torch.equal(jacobi_3d_kernel(b, x, x0, 0.5, 4.0, 6),
                           jacobi_3d_plain(b, x, x0, 0.5, 4.0, 6))
    assert torch.equal(divergence_3d_kernel(tv), divergence_3d_plain(tv))
    assert torch.equal(gradient_3d_kernel(tv, x), project_gradient(tv, x))
    assert all(fn.launches == 0 for fn in counters)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, x0 = (torch.from_numpy(v) for v in volumes(16, 9))
    tv = torch.from_numpy(velocity(16, 10))
    with pytest.raises(ValueError, match="boundary code"):
        jacobi_3d_kernel(4, x, x0, 1.0, 6.0, 5)
    with pytest.raises(ValueError, match="iters"):
        jacobi_3d_kernel(0, x, x0, 1.0, 6.0, 0)
    with pytest.raises(TypeError, match="x0"):
        jacobi_3d_kernel(0, x, x0.double(), 1.0, 6.0, 5)
    with pytest.raises(ValueError, match="x0"):
        jacobi_3d_kernel(0, x, x0[:8], 1.0, 6.0, 5)
    with pytest.raises(ValueError, match="vel"):
        divergence_3d_kernel(tv[:2])
    with pytest.raises(ValueError, match="p"):
        gradient_3d_kernel(tv, x[:8])
    with pytest.raises(ValueError, match="iters"):
        project_3d_kernel(tv, 0)


def test_project_3d_kernel_route_on_cpu(monkeypatch):
    """At 16³ the solve fits an H100's L2, so the route is K3's; with the
    gate closed it is the slab route; a mask keeps K3 whatever the gate."""
    tv = torch.from_numpy(velocity(16, 11))
    obst = torch.zeros((16, 16, 16), dtype=torch.bool)
    obst[5:9, 6:10, 4:8] = True
    for got, ref in zip(project_3d_kernel(tv, 8), project_3d_resident_plain(tv, 8)):
        assert torch.equal(got, ref)
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    for got, ref in zip(project_3d_kernel(tv, 8), project_3d_slab_plain(tv, 8)):
        assert torch.equal(got, ref)
    for got, ref in zip(project_3d_kernel(tv, 8, obst=obst),
                        project_3d_resident_plain(tv, 8, obst=obst)):
        assert torch.equal(got, ref)
