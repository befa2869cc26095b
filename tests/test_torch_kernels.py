"""fluidsim_tpu_torch kernel modules: the plain twins of the CUDA kernels
against the JAX package's Pallas kernels run in interpret mode, and the
wrappers' CPU behaviour.  tests/test_torch_cuda.py holds each kernel against
its twin on a card.

Tolerances: K1 rtol 1e-5, atol 1e-6 (the JAX package's own bound for its
folded-buoyancy kernel); K2 with a float32 solve rtol 3e-5, atol 3e-6; K2
with a bfloat16 solve atol 2e-2·max|ref| (the JAX package's bf16-solve
bound).  The twins do the kernels' float32 operations in the kernels' order;
what remains is XLA-CPU's contraction of multiply-adds into FMAs in the
interpreted Pallas kernels.  The largest such term is the backtrace
``coord − dt0·v``, rounded at the magnitude of the cell index, so the
fraction carries an error of about one ulp of ``n`` that multiplies the
difference between neighbouring cells: the inputs are smooth seeded fields,
as the simulation's are, not white noise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsim_tpu.pallas.advect import advect_multi_3d_pallas
from fluidsim_tpu.pallas.resident import project_advect_density_3d_resident

import fluidsim_tpu_torch.config as tcfg
from fluidsim_tpu_torch.kernels import _build
from fluidsim_tpu_torch.kernels.advect import (
    advect_multi_3d_kernel,
    advect_multi_3d_plain,
)
from fluidsim_tpu_torch.kernels.resident import (
    project_advect_density_3d,
    project_advect_density_3d_plain,
)

torch.set_num_threads(1)

CFG = tcfg.preset_bench_128()
DT = CFG.effective_params()[0]
DAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(CFG.velocity_damping)))
DDAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(CFG.density_dissipation)))
# A step long enough that backtraces reach past one cell and get clamped.
DT_ADV = 0.03


def smooth(n, rng, modes=6):
    """A sum of random low-wavenumber plane waves, unit amplitude."""
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def inputs(n, seed):
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(n, rng) for _ in range(3)]) * 0.5
    dens = 10.0 * (1.5 + smooth(n, rng))
    return vel.astype(np.float32), np.maximum(dens, 0.0).astype(np.float32)


def assert_close(got, ref, rtol, atol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    diff = float(np.max(np.abs(got - ref)))
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=atol,
        err_msg=f"{what}: max abs diff {diff:.3e}, max |ref| "
                f"{float(np.max(np.abs(ref))):.3e}")


@pytest.mark.parametrize("mode", ["self_buoy", "scalar"])
@pytest.mark.parametrize("n", [16, 32])
def test_k1_twin_matches_pallas_interpret(n, mode):
    vel, dens = inputs(n, n)
    jv, tv = jnp.asarray(vel), torch.from_numpy(vel)
    if mode == "self_buoy":
        buoy = (CFG.buoyancy, CFG.ambient_density, CFG.gravity)
        ref = advect_multi_3d_pallas(
            (1, 2, 3), jv, jv, DT_ADV, None, window=1, n_sub=1,
            interpret=True, buoy=(jnp.asarray(dens),) + buoy)
        got = advect_multi_3d_plain(
            (1, 2, 3), tv, tv, DT_ADV, buoy=(torch.from_numpy(dens),) + buoy)
    else:
        ref = advect_multi_3d_pallas(
            (0,), jnp.asarray(dens)[None], jv, DT_ADV, None, window=1,
            n_sub=1, interpret=True)
        got = advect_multi_3d_plain((0,), torch.from_numpy(dens)[None], tv,
                                    DT_ADV)
    assert_close(got.numpy(), ref, 1e-5, 1e-6, f"K1 {mode} n={n}")


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k2_twin_matches_pallas_interpret(solve_dtype):
    vel, dens = inputs(32, 7)
    ref = project_advect_density_3d_resident(
        jnp.asarray(vel), jnp.asarray(dens), 60, DT_ADV,
        solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP, interpret=True)
    got = project_advect_density_3d_plain(
        torch.from_numpy(vel), torch.from_numpy(dens), 60, DT_ADV,
        solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        r = np.asarray(r)
        if solve_dtype is None:
            assert_close(g.numpy(), r, 3e-5, 3e-6, f"K2 f32 {name}")
        else:
            assert_close(g.numpy(), r, 0.0, 2e-2 * np.abs(r).max(),
                         f"K2 bf16 {name}")
    # The projection itself does no multiply-add that XLA could contract.
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_wrappers_on_cpu_run_the_twins():
    vel, dens = inputs(16, 3)
    tv, td = torch.from_numpy(vel), torch.from_numpy(dens)
    advect_multi_3d_kernel.launches = 0
    project_advect_density_3d.launches = 0
    buoy = (td, 0.2, 0.0, 0.0)
    np.testing.assert_array_equal(
        advect_multi_3d_kernel((1, 2, 3), tv, tv, DT_ADV, buoy=buoy).numpy(),
        advect_multi_3d_plain((1, 2, 3), tv, tv, DT_ADV, buoy=buoy).numpy())
    got = project_advect_density_3d(tv, td, 5, DT_ADV, solve_dtype="bfloat16",
                                    damp=DAMP, dens_damp=DDAMP)
    ref = project_advect_density_3d_plain(tv, td, 5, DT_ADV,
                                          solve_dtype="bfloat16", damp=DAMP,
                                          dens_damp=DDAMP)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert advect_multi_3d_kernel.launches == 0
    assert project_advect_density_3d.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    vel, dens = inputs(16, 4)
    tv, td = torch.from_numpy(vel), torch.from_numpy(dens)
    with pytest.raises(ValueError, match="window"):
        advect_multi_3d_kernel((1, 2, 3), tv, tv, DT_ADV, window=0)
    with pytest.raises(NotImplementedError, match="buoyancy fold"):
        advect_multi_3d_kernel((1, 2, 3), tv, tv, DT_ADV,
                               obst=torch.zeros(td.shape, dtype=torch.bool),
                               buoy=(td, 0.2, 0.0, 0.0))
    with pytest.raises(ValueError, match="self-advect"):
        advect_multi_3d_kernel((1, 2, 3), tv.clone(), tv, DT_ADV,
                               buoy=(td, 0.2, 0.0, 0.0))
    with pytest.raises(TypeError):
        advect_multi_3d_kernel((1, 2, 3), tv.double(), tv.double(), DT_ADV)
    with pytest.raises(ValueError, match="contiguous"):
        tt = tv.transpose(1, 3)
        advect_multi_3d_kernel((1, 2, 3), tt, tt, DT_ADV)
    with pytest.raises(ValueError, match="window"):
        project_advect_density_3d(tv, td, 5, DT_ADV, window=1.5)
    with pytest.raises(ValueError, match="solve_dtype"):
        project_advect_density_3d(tv, td, 5, DT_ADV, solve_dtype="float16")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()
