"""The kernels that share K1's windowed body, at a window of K >= 4 cells, in
fluidsim_tpu_torch against the JAX package on the CPU: the density phase of
K2, K2s and K2o and the whole step of K8 against the interpret-mode
``project_advect_density_3d_resident`` and ``full_step_3d_resident``, K11's
twin against the interpret-mode ``advect_ext_pallas`` on one shard's slab,
and one bench128 step through ``Engine`` at K = 4 and 5 against the JAX
``Engine`` with its interpret-mode Pallas kernels.

Tolerances: the kernel twins rtol 3e-5, atol 3e-6·max|ref| with a float32
solve (the classes of the same kernels at K = 2, 3 in
tests/test_torch_options.py), K11's rtol 2e-5, atol 2e-6·max|ref| (the
windowed class of tests/test_torch_window.py), the step rtol 2e-5, atol
2e-6·max|ref| with a float32 solve; what remains is XLA-CPU's FMA
contraction in the interpreted backtrace.  Against the port's own unfused
composition (K3, then K1 on the density) the fused twins are bitwise.
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
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.pallas.halo_kernel import advect_ext_pallas
from fluidsim_tpu.pallas.resident import (
    full_step_3d_resident,
    project_advect_density_3d_resident,
)
from fluidsim_tpu.state import FluidState as JState

from fluidsim_tpu_torch.config import preset_bench_128 as t_bench128
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
from fluidsim_tpu_torch.kernels.halo import advect_ext_kernel, ext_halo
from fluidsim_tpu_torch.kernels.resident import (
    full_step_3d,
    project_3d_resident_plain,
    project_advect_density_3d,
)
from fluidsim_tpu_torch.models import stable3d as t_s3
from fluidsim_tpu_torch.scene.sources import emitter_fold_operand, src_field_add

torch.set_num_threads(1)

N = 16
DT = 0.05
DAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(2.0)))
DDAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(0.5)))


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def inputs(seed, window, n=N):
    """A velocity whose backtrace reaches up to about ``window + 1`` cells at
    DT, and a positive density (torch, float32)."""
    vel = rand(seed, (3, n, n, n), (window + 1) / (DT * (n - 2) * 3.0))
    dens = np.abs(rand(seed + 1, (n, n, n), 4.0)) + 1.0
    return torch.from_numpy(vel), torch.from_numpy(dens)


def j(t):
    return None if t is None else jnp.asarray(t.numpy())


def assert_close(got, ref, rtol, atol_rel, what):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol_rel * float(np.abs(r).max()),
                               err_msg=f"{what}: max abs diff {float(np.abs(g - r).max()):.3e}")


def box_mask():
    obst = np.zeros((N, N, N), bool)
    obst[6:10, 5:11, 6:9] = True
    return torch.from_numpy(obst)


@pytest.mark.parametrize("variant", ["K2", "K2s", "K2o"])
def test_k2_wide_density_phase_matches_pallas(variant):
    window = 4
    vel, dens = inputs(40 + len(variant), window)
    src = emitter_fold_operand(t_bench128().replace(size=N), torch.full((), DT))
    kw = {"K2": {}, "K2s": {"src": src}, "K2o": {"obst": box_mask()}}[variant]
    got = project_advect_density_3d(vel, dens, 8, DT, window=window, damp=DAMP,
                                    dens_damp=DDAMP, **kw)
    ref = project_advect_density_3d_resident(
        j(vel), j(dens), 8, DT, window=window, damp=DAMP, dens_damp=DDAMP,
        interpret=True, **{k: j(v) for k, v in kw.items()})
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        assert_close(g, r, 3e-5, 3e-6, f"{variant} K={window} {name}")
    v3, p3 = project_3d_resident_plain(vel, 8, obst=kw.get("obst"), damp=DAMP)
    d = src_field_add(dens, src) if variant == "K2s" else dens
    d3 = advect_multi_3d_kernel((0,), d[None], v3, DT, obst=kw.get("obst"), window=window)[0]
    for g, r in zip(got, (v3, p3, d3 * DDAMP)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("window", [4, 5])
def test_k8_wide_matches_pallas(window):
    """At 16³ for K = 4 and 24³ for K = 5, where the JAX kernel's slabs
    (at least the halo of K planes deep) fit the grid."""
    n = 16 if window == 4 else 24
    vel, dens = inputs(50 + window, window, n)
    got = full_step_3d(vel, dens, 8, DT, window=window, damp=DAMP, dens_damp=DDAMP)
    ref = full_step_3d_resident(j(vel), j(dens), 8, DT, window=window, damp=DAMP,
                                dens_damp=DDAMP, interpret=True)
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        assert_close(g, r, 3e-5, 3e-6, f"K8 K={window} {name}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, window=window)
    for g, r in zip(got, project_advect_density_3d(adv, dens, 8, DT, window=window,
                                                   damp=DAMP, dens_damp=DDAMP)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n_fields", [1, 3])
def test_k11_wide_matches_pallas(n_fields):
    """One middle shard's slab (shard 1 of 4 of a 32³ grid, 8 planes), K = 4,
    one substep: a halo of 4 planes; the planes the caller keeps."""
    n, lz, shard, window = 32, 8, 1, 4
    h = ext_halo(window, 1, False)
    vel, dens = inputs(60 + n_fields, window, n)
    start = shard * lz - h
    v_ext = vel[:, start:start + lz + 2 * h].contiguous()
    f_ext = v_ext if n_fields == 3 else dens[None, start:start + lz + 2 * h].contiguous()
    bs = (1, 2, 3) if n_fields == 3 else (0,)
    got = advect_ext_kernel(bs, f_ext, v_ext, n, DT, start, window=window)
    jv = j(v_ext)
    ref = advect_ext_pallas(bs, jv if n_fields == 3 else j(f_ext), jv, n, DT, start,
                            window=window, interpret=True)
    assert ref is not None, "advect_ext_pallas found no window"
    assert_close(got[:, h:h + lz], np.asarray(ref)[:, h:h + lz], 2e-5, 2e-6,
                 f"K11 F={n_fields} K={window}")


def start_arrays(n, seed=2024):
    vel, dens = inputs(seed, 3, n)
    return {
        "density": dens.numpy(),
        "velocity": vel.numpy(),
        "pressure": np.zeros((n, n, n), np.float32),
        "obstacles": np.zeros((n, n, n), bool),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


@pytest.mark.parametrize("window", [4, 5])
def test_engine_step_at_wide_window_like_jax(monkeypatch, window):
    """bench128 (cut to 32³, the smallest size the JAX config takes, with a
    float32 solve) at ``advect_window`` K: K1 with the buoyancy folded, then
    K2 with a K-cell density phase, one step on the kernel path's twins
    against the JAX step with its interpret-mode Pallas kernels."""
    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    for mod, name in ((j_pa, "advect_multi_3d_pallas"), (j_pp, "project_3d_pallas"),
                      (j_pp, "project_advect_density_3d_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    n = 32
    change = dict(size=n, advect_window=window, solve_dtype="float32")
    jeng = JEngine(j_bench128().replace(**change))
    jeng.state = JState(**{k: jnp.asarray(v) for k, v in start_arrays(n).items()})
    jeng.step(1)
    launches = {"K1": 0, "K2": 0}
    port = Engine(t_bench128().replace(**change), "cpu")
    port.kernels = port.kernels._replace(
        advect=lambda *a, **k: launches.update(K1=launches["K1"] + 1)
        or advect_multi_3d_kernel(*a, **k),
        project_advect=lambda *a, **k: launches.update(K2=launches["K2"] + 1)
        or project_advect_density_3d(*a, **k))
    port.state = state_from_numpy(start_arrays(n), "cpu")
    port.step(1)
    assert launches == {"K1": 1, "K2": 1}
    got = state_to_numpy(port.state)
    for field in ("density", "velocity", "pressure"):
        assert_close(got[field], np.asarray(getattr(jeng.state, field)), 2e-5, 2e-6,
                     f"K={window} step {field}")
