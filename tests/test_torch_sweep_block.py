"""K5, the sweep-blocked Jacobi solve, and K14, the fused self-advection +
projection, in fluidsim_tpu_torch against the JAX package.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas_interpret.py does); the port runs the CUDA kernels' plain
twins (the wrappers' behaviour for CPU tensors).  Inputs are made from a
seed with numpy and made face-consistent (``set_bnd_3d``), as the JAX
package's own sweep-block tests make theirs.

Tolerances, each with its reason:

* the K5 twin against JAX ``jacobi_3d_resident(sweep_block=T)`` and against
  the port's own sequential sweeps: ``1e-6·max|ref|``, the JAX package's own
  bound for its composite (tests/test_pallas_interpret.py): the composite
  reassociates the float32 sums of T sweeps.  Against JAX the residue
  measured up to 1.9e-7·max|ref| (XLA on the CPU also contracts some
  multiply-adds); planes 1..T−1 of each wall after one ``T ≥ 3`` block
  are bitwise the sequential sweeps (the shell recurrence runs their
  arithmetic);
* the projection at 60 iterations: ``1e-6`` relative on the velocity and
  the pressure, against JAX and against the port's ``sweep_block = 1``;
  with a bfloat16 solve the bf16 class, ``3e-2·max|v|``, as the JAX test of
  its bf16 composite;
* the gate: where ``_solve_loop`` runs sequential sweeps (``T = 3`` at
  ``n < 12``, ``iters < T``, bfloat16 fields, the slab route), bitwise the
  ``sweep_block = 1`` run;
* K14's twin: bitwise the port's K1 → K3 twins; against JAX's interpret-mode
  ``advect_project_3d_resident`` rtol 3e-5, atol 3e-6 (the float32-solve
  class of K2 in tests/test_torch_fused.py: XLA-CPU's FMA contraction in
  the interpreted backtrace).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsim_tpu.pallas.resident import advect_project_3d_resident as j_advect_project
from fluidsim_tpu.pallas.resident import jacobi_3d_resident as j_jacobi
from fluidsim_tpu.pallas.resident import project_3d_resident as j_project

import fluidsim_tpu_torch.kernels.project as t_kp
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_plain
from fluidsim_tpu_torch.kernels.jacobi import (
    composite_block,
    jacobi_3d_resident,
    jacobi_3d_resident_plain,
)
from fluidsim_tpu_torch.kernels.project import project_3d_kernel
from fluidsim_tpu_torch.kernels.resident import (
    advect_project_3d_resident,
    advect_project_3d_resident_plain,
    project_3d_resident,
    project_3d_resident_plain,
)
from fluidsim_tpu_torch.ops.boundary import set_bnd_3d

torch.set_num_threads(1)

N2 = 32
DT_ADV = 0.03


def consistent(b, seed, n=N2, scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((n, n, n)) * scale).astype(np.float32))
    return set_bnd_3d(b, x)


def velocity(seed, n=N2, scale=0.5):
    return torch.stack([consistent(b, seed + b, n, scale) for b in (1, 2, 3)])


def box_mask(n=N2):
    """tests/test_pallas_interpret.py's sweep-block obstacle."""
    obst = np.zeros((n, n, n), bool)
    obst[10:16, 9:15, 12:20] = True
    return torch.from_numpy(obst)


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def same(got, ref):
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# -- K5: the composite solve ---------------------------------------------------


@pytest.mark.parametrize("iters,block", [
    (2, 2), (3, 2), (8, 2), (20, 2),
    (3, 3), (7, 3),
    (4, 4), (8, 4), (20, 4),
])
def test_k5_twin_matches_jax_and_sequential(iters, block):
    x, x0 = consistent(0, 300), consistent(0, 301)
    assert composite_block(N2, iters, block) == block
    ref = np.asarray(j_jacobi(0, jnp.asarray(x.numpy()), jnp.asarray(x0.numpy()), 1.0,
                              6.0, iters, interpret=True, sweep_block=block))
    got = jacobi_3d_resident(0, x, x0, 1.0, 6.0, iters, sweep_block=block).numpy()
    seq = jacobi_3d_resident_plain(0, x, x0, 1.0, 6.0, iters).numpy()
    assert rel(got, ref) <= 1e-6
    assert rel(got, seq) <= 1e-6
    assert not np.array_equal(got, seq)  # the composite ran
    if block >= 3 and iters == block:
        for j in [*range(1, block), *(N2 - 1 - j for j in range(1, block))]:
            np.testing.assert_array_equal(got[j], seq[j], err_msg=f"z={j}")
            np.testing.assert_array_equal(got[:, j], seq[:, j], err_msg=f"y={j}")
            np.testing.assert_array_equal(got[:, :, j], seq[:, :, j], err_msg=f"x={j}")


def test_k5_twin_with_a_general_solve():
    """K4's general ``(a, c)`` (a diffusion-like solve): the float32 ``a^T``
    and ``(a·ic)²`` constants of the JAX kernel."""
    x, x0 = consistent(0, 310), consistent(0, 311)
    a, c = 0.21, 1.0 + 6 * 0.21
    for iters, block in ((5, 2), (9, 3)):
        ref = np.asarray(j_jacobi(0, jnp.asarray(x.numpy()), jnp.asarray(x0.numpy()), a,
                                  c, iters, interpret=True, sweep_block=block))
        got = jacobi_3d_resident(0, x, x0, a, c, iters, sweep_block=block).numpy()
        seq = jacobi_3d_resident_plain(0, x, x0, a, c, iters).numpy()
        assert rel(got, ref) <= 1e-6
        assert rel(got, seq) <= 1e-6


@pytest.mark.parametrize("block,masked", [(2, False), (4, False), (2, True), (4, True)])
def test_k3_sweep_block_matches_jax_and_sequential(block, masked):
    vel = velocity(310)
    obst = box_mask() if masked else None
    jo = None if obst is None else jnp.asarray(obst.numpy())
    rv, rp = j_project(jnp.asarray(vel.numpy()), 60, obst=jo, interpret=True,
                       sweep_block=block)
    gv, gp = project_3d_resident(vel, 60, obst=obst, sweep_block=block)
    sv, sp = project_3d_resident_plain(vel, 60, obst=obst)
    assert rel(gv, rv) <= 1e-6 and rel(gp, rp) <= 1e-6
    assert rel(gv, sv) <= 1e-6 and rel(gp, sp) <= 1e-6
    assert not torch.equal(gp, sp)  # the composite ran
    if masked:
        assert (gp[obst] == 0).all()


def test_k3_sweep_block_with_a_bfloat16_solve():
    """The delta form with bfloat16 solve buffers (bench128's solve): the bf16
    class against the sequential bf16 solve, the float32 solve and JAX."""
    vel = velocity(330)
    rv, _ = j_project(jnp.asarray(vel.numpy()), 60, interpret=True,
                      solve_dtype="bfloat16", sweep_block=2)
    gv, _ = project_3d_resident(vel, 60, solve_dtype="bfloat16", sweep_block=2)
    sv, _ = project_3d_resident(vel, 60, solve_dtype="bfloat16")
    fv, _ = project_3d_resident(vel, 60)
    scale = float(fv.abs().max())
    for ref in (np.asarray(rv), sv.numpy(), fv.numpy()):
        assert np.abs(gv.numpy() - ref).max() <= 3e-2 * scale
    assert not torch.equal(gv, sv)


# -- the gate ------------------------------------------------------------------


def test_gate_runs_sequential_sweeps_where_jax_does(monkeypatch):
    """T = 3 at n < 12, iters < T, bfloat16 fields and the slab route solve
    sequentially: bitwise the sweep_block = 1 run."""
    x, x0 = consistent(0, 340, n=8), consistent(0, 341, n=8)
    assert composite_block(8, 6, 3) == 1
    assert torch.equal(jacobi_3d_resident(0, x, x0, 1.0, 6.0, 6, sweep_block=3),
                       jacobi_3d_resident(0, x, x0, 1.0, 6.0, 6))
    vel = velocity(342, n=16)
    same(project_3d_resident(vel, 3, sweep_block=4), project_3d_resident(vel, 3))
    vb = vel.to(torch.bfloat16)
    same(project_3d_resident(vb, 10, sweep_block=2), project_3d_resident(vb, 10))
    xb, x0b = x.to(torch.bfloat16), x0.to(torch.bfloat16)
    assert torch.equal(jacobi_3d_resident(0, xb, x0b, 1.0, 6.0, 6, sweep_block=2),
                       jacobi_3d_resident(0, xb, x0b, 1.0, 6.0, 6))
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    same(project_3d_kernel(vel, 10, sweep_block=2), project_3d_kernel(vel, 10))
    # b != 0 and the mask (K4's frozen volume) solve sequentially too.
    assert composite_block(16, 10, 2, b=1) == 1
    assert composite_block(16, 10, 2, frozen=True) == 1
    obst = torch.zeros((8, 8, 8), dtype=torch.bool)
    obst[2:5, 3:6, 2:6] = True
    assert torch.equal(jacobi_3d_resident(0, x0, x, 1.0, 6.0, 4, obst=obst, sweep_block=2),
                       jacobi_3d_resident(0, x0, x, 1.0, 6.0, 4, obst=obst))


# -- K14 -----------------------------------------------------------------------


@pytest.mark.parametrize("window,n_sub", [(1, 1), (1, 2), (2, 1)])
def test_k14_twin_is_k1_then_k3_and_matches_jax(window, n_sub):
    vel = velocity(350, scale=0.5)
    got = advect_project_3d_resident(vel, 8, DT_ADV, window=window, n_sub=n_sub)
    adv = advect_multi_3d_plain((1, 2, 3), vel, vel, DT_ADV, n_sub=n_sub, window=window)
    same(got, project_3d_resident_plain(adv, 8))
    same(got, advect_project_3d_resident_plain(vel, 8, DT_ADV, window=window,
                                               n_sub=n_sub))
    ref = j_advect_project(jnp.asarray(vel.numpy()), 8, DT_ADV, window=window,
                           n_sub=n_sub, interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=3e-5, atol=3e-6)


def test_k14_wrapper_rejects_what_the_kernel_does_not_take():
    vel = velocity(351, n=16)
    with pytest.raises(TypeError):
        advect_project_3d_resident(vel.to(torch.bfloat16), 4, DT_ADV)
    with pytest.raises(ValueError, match="window"):
        advect_project_3d_resident(vel, 4, DT_ADV, window=0)
    with pytest.raises(ValueError):
        project_3d_resident(vel, 4, sweep_block=0)
