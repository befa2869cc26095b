"""The 3D step with ``jacobi_sweep_block`` (K5 in K2, K3 and K8) in
fluidsim_tpu_torch against the JAX package: bench128 (float32 solve,
``jacobi_sweep_block = 4``, through K2 and through K8) and vortex128 (float32
solve, ``jacobi_sweep_block = 2``, K3 with the mask's coefficient volume),
cut to 32³, one step through ``Engine`` on the kernel path's twins against
the JAX step with its interpret-mode Pallas kernels.

Tolerance: ``1e-5·max|ref|`` per field, the JAX package's bound for its
composite against its sequential step
(tests/test_pallas_interpret.py::test_step_jacobi_sweep_block_wiring).  The
solve is pinned to float32, as in that test: a bfloat16 solve's roundings
would swamp the bound (its class, ``1e-3·max|v|``, is held by
tests/test_torch_step.py and tests/test_torch_vortex.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.project as j_pp
from fluidsim_tpu.config import preset_bench_128 as j_bench128
from fluidsim_tpu.config import preset_vortex_128 as j_vortex128
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.config import preset_bench_128 as t_bench128
from fluidsim_tpu_torch.config import preset_vortex_128 as t_vortex128
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy

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


def vortex_mask(n=N):
    return np.asarray(j_build_mask(j_vortex128().replace(size=n)))


def start_arrays(obst, seed=2024):
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(N, rng) for _ in range(3)]) * 0.3
    dens = np.maximum(5.0 * (1.0 + smooth(N, rng)), 0.0)
    return {
        "density": dens.astype(np.float32),
        "velocity": vel.astype(np.float32),
        "pressure": np.zeros((N, N, N), np.float32),
        "obstacles": obst,
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


@pytest.mark.parametrize("preset,change", [
    ("bench128", dict(solve_dtype="float32", jacobi_sweep_block=4)),
    ("vortex128", dict(solve_dtype="float32", jacobi_sweep_block=2)),
    ("bench128", dict(solve_dtype="float32", jacobi_sweep_block=4,
                      fuse_self_advect=True)),
], ids=["bench128 T=4", "vortex128 T=2", "bench128 K8 T=4"])
def test_step_with_sweep_block_matches_jax(monkeypatch, preset, change):
    """One step through ``Engine`` on the kernel path's twins against the JAX
    step with its interpret-mode kernels, and the port's step is not the
    ``jacobi_sweep_block = 1`` step (the composite ran)."""
    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    for mod, name in ((j_pa, "advect_multi_3d_pallas"), (j_pp, "project_3d_pallas"),
                      (j_pp, "project_advect_density_3d_pallas"),
                      (j_pp, "full_step_3d_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    j_pre, t_pre = {"bench128": (j_bench128, t_bench128),
                    "vortex128": (j_vortex128, t_vortex128)}[preset]
    jcfg = j_pre().replace(size=N, **change)
    tcfg = t_pre().replace(size=N, **change)
    obst = (vortex_mask() if tcfg.enable_obstacle
            else np.zeros((N, N, N), bool))
    arrays = start_arrays(obst)
    jeng = JEngine(jcfg)
    jeng.state = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jeng.step(1)
    got = {}
    for block in (tcfg.jacobi_sweep_block, 1):
        eng = Engine(tcfg.replace(jacobi_sweep_block=block), "cpu")
        eng.state = state_from_numpy(arrays, "cpu")
        eng.step(1)
        got[block] = state_to_numpy(eng.state)
    for field in ("density", "velocity", "pressure"):
        ref = np.asarray(getattr(jeng.state, field))
        bound = 1e-5 * max(float(np.abs(ref).max()), 1e-6)
        diff = float(np.abs(got[tcfg.jacobi_sweep_block][field] - ref).max())
        assert diff <= bound, f"{field}: {diff:.3e} > {bound:.3e}"
    assert not np.array_equal(got[1]["pressure"], got[tcfg.jacobi_sweep_block]["pressure"])
