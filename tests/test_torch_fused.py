"""The fused-step variants of the 3D path in fluidsim_tpu_torch against the JAX
package: K1 with the folded emitter (``src``), K2s (the emitter folded into
the fused projection's density phase), K2o (the fused projection with the
obstacle mask and any substep count), K8 (the whole step in one kernel),
the emitter's folded add and descriptor, the ``emitter_folds`` gate, and the
three configs that run them, stepped by ``Engine``:

* bench128 + ``fuse_emitter`` (the JAX bench.py's ``src_fold``): K1 with
  ``src``, then K2s;
* bench128 + ``fuse_self_advect`` (bench.py's ``fuse_full_step``): K8;
* vortex128 + ``fuse_project_advect``: K1 with substeps and the mask, K2o.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas_interpret.py does); the port runs the CUDA kernels' plain
twins (the wrappers' behaviour for CPU tensors).

Tolerances, each with its reason:

* the emitter's add and descriptor: rtol 1e-6, atol 1e-6·max (XLA-CPU may
  contract ``vals + strength·falloff`` into an FMA; the port rounds the
  product first, as the kernels do);
* K1 with ``src``: rtol 1e-5, atol 1e-6 (the JAX package's own bound for its
  folded-buoyancy kernel, tests/test_pallas_interpret.py);
* K2s, K2o and K8: K2's classes (tests/test_torch_kernels.py), float32 solve
  rtol 3e-5, atol 3e-6, bfloat16 solve atol 2e-2·max|ref|; what remains is
  XLA-CPU's FMA contraction in the interpreted backtrace;
* the whole step after 3 steps, all three configs (each solves in
  bfloat16): density within 1e-5·max|ρ|, velocity within 1e-3·max|v| (the
  bf16-solve class of tests/test_torch_step.py and
  tests/test_torch_vortex.py) and pressure within 2⁻⁸·max|p|: a last-bit
  difference before a bfloat16 rounding of the pressure iterate moves it by
  one bf16 ulp.

On the port's own side the fused paths equal their unfused compositions
bitwise (K8 against bench128 with ``fuse_buoyancy=False``, vortex128 fused
against unfused), and the folded emitter stays within rtol 1e-5, atol 1e-6
of the composed one (the JAX package's bound,
tests/test_pallas_interpret.py::test_step_emitter_fold_wiring).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.project as j_pp
from fluidsim_tpu.config import SourceSpec as JSourceSpec
from fluidsim_tpu.config import preset_bench_128 as j_bench128
from fluidsim_tpu.config import preset_vortex_128 as j_vortex128
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.pallas.resident import (
    full_step_3d_resident,
    project_advect_density_3d_resident,
)
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.scene.sources import emitter_fold_operand as j_fold_operand
from fluidsim_tpu.scene.sources import src_field_add as j_src_field_add
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS, StepKernels
from fluidsim_tpu_torch.config import SourceSpec
from fluidsim_tpu_torch.config import preset_bench_128 as t_bench128
from fluidsim_tpu_torch.config import preset_vortex_128 as t_vortex128
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels.advect import (
    advect_multi_3d_kernel,
    advect_multi_3d_plain,
)
from fluidsim_tpu_torch.kernels.resident import (
    full_step_3d,
    full_step_3d_plain,
    project_3d_resident_plain,
    project_advect_density_3d,
    project_advect_density_3d_plain,
)
from fluidsim_tpu_torch.scene.sources import (
    emitter_fold_operand,
    emitter_fold_values,
    src_field_add,
)

torch.set_num_threads(1)

N = 32
STEPS = 3
BENCH = t_bench128()
DT = BENCH.effective_params()[0]
DAMP = t_s3.sink_factor(DT, BENCH.velocity_damping)
DDAMP = t_s3.sink_factor(DT, BENCH.density_dissipation)
# A step long enough that backtraces reach past one cell and get clamped.
DT_ADV = 0.03
ITERS = 20


def smooth(n, rng, modes=6):
    """A sum of random low-wavenumber plane waves, unit amplitude."""
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def inputs(n, seed, scale=0.5, base=1.5):
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(n, rng) for _ in range(3)]) * scale
    dens = 10.0 * (base + smooth(n, rng))
    return vel.astype(np.float32), np.maximum(dens, 0.0).astype(np.float32)


def descriptor(n):
    """An emitter ball inside the grid, off centre: ``[px, py, pz, strength,
    radius]``."""
    return np.array([0.45 * n, 0.2 * n, 0.55 * n, 7.0, 0.2 * n], np.float32)


def box_mask(n):
    """tests/test_pallas_interpret.py's ``_box_obst`` pattern."""
    obst = np.zeros((n, n, n), bool)
    obst[6:10, 5:9, 7:11] = True
    return obst


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


def assert_close(got, ref, rtol, atol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=atol,
        err_msg=f"{what}: max abs diff {max_diff(got, ref):.3e}, max |ref| "
                f"{float(np.max(np.abs(ref))):.3e}")


def assert_k2_class(got, ref, solve_dtype, what):
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        r = np.asarray(r)
        if solve_dtype is None:
            assert_close(g.numpy(), r, 3e-5, 3e-6, f"{what} f32 {name}")
        else:
            assert_close(g.numpy(), r, 0.0, 2e-2 * np.abs(r).max(),
                         f"{what} bf16 {name}")


# -- the emitter's folded add and its descriptor ------------------------------


@pytest.mark.parametrize("origin", [(0, 0, 0), (8, 3, 0)])
def test_src_field_add_matches_jax(origin):
    vals = inputs(16, 1)[1]
    src = descriptor(16)
    ref = np.asarray(j_src_field_add(jnp.asarray(vals), jnp.asarray(src), *origin))
    got = src_field_add(torch.from_numpy(vals), torch.from_numpy(src), *origin).numpy()
    assert_close(got, ref, 1e-6, 1e-6 * np.abs(ref).max(), "src_field_add")
    assert max_diff(got, vals) > 1.0  # the ball lies in the block


@pytest.mark.parametrize("change", [
    {}, {"source_pulsing": True, "source_pulse_rate": 0.7},
    {"source_position": (0.25, 0.6, 0.8), "source_radius": 3.5,
     "resolution_multiplier": 1.5},
], ids=["steady", "pulsing", "moved"])
def test_emitter_fold_operand_matches_jax(change):
    j_cfg = j_bench128().replace(size=N, **change)
    t_cfg = t_bench128().replace(size=N, **change)
    t = np.float32(0.37)
    ref = np.asarray(j_fold_operand(j_cfg, jnp.float32(t)))
    got = emitter_fold_operand(t_cfg, torch.tensor(t))
    assert got.shape == (5,) and got.dtype == torch.float32
    assert_close(got.numpy(), ref, 1e-6, 0.0, "emitter_fold_operand")
    if not change.get("source_pulsing"):
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(emitter_fold_values(t_cfg), ref)


# -- K1 with the folded emitter ------------------------------------------------


@pytest.mark.parametrize("n,n_sub", [(16, 1), (16, 2), (32, 1)])
def test_k1_src_twin_matches_pallas_interpret(n, n_sub):
    vel, dens = inputs(n, 10 + n + n_sub)
    src = descriptor(n)
    # advect_multi_3d_pallas takes its XLA fallback when no slab fits: make
    # sure the JAX side really runs the interpret-mode Pallas kernel.
    assert j_pa._pick_slab(n, 3, n_sub, False, True, has_buoy=True,
                           has_src=True) is not None
    buoy = (BENCH.buoyancy, BENCH.ambient_density, BENCH.gravity)
    jv = jnp.asarray(vel)
    ref = j_pa.advect_multi_3d_pallas(
        (1, 2, 3), jv, jv, DT_ADV, None, window=1, n_sub=n_sub, interpret=True,
        buoy=(jnp.asarray(dens),) + buoy, src=jnp.asarray(src))
    tv = torch.from_numpy(vel)
    got = advect_multi_3d_plain((1, 2, 3), tv, tv, DT_ADV, n_sub=n_sub,
                                buoy=(torch.from_numpy(dens),) + buoy,
                                src=torch.from_numpy(src))
    assert_close(got.numpy(), ref, 1e-5, 1e-6, f"K1 src n={n} n_sub={n_sub}")
    # The emitter moved the result.
    plain = advect_multi_3d_plain((1, 2, 3), tv, tv, DT_ADV, n_sub=n_sub,
                                  buoy=(torch.from_numpy(dens),) + buoy)
    assert not torch.equal(got, plain)


# -- K2s and K2o ---------------------------------------------------------------


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("variant", ["K2s", "K2o"])
def test_k2s_k2o_twins_match_pallas_interpret(variant, n_sub, solve_dtype):
    n = 16
    vel, dens = inputs(n, 20 + n_sub)
    kw = ({"src": descriptor(n)} if variant == "K2s" else {"obst": box_mask(n)})
    ref = project_advect_density_3d_resident(
        jnp.asarray(vel), jnp.asarray(dens), ITERS, DT_ADV, n_sub=n_sub,
        solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = project_advect_density_3d_plain(
        torch.from_numpy(vel), torch.from_numpy(dens), ITERS, DT_ADV,
        n_sub=n_sub, solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_k2_class(got, ref, solve_dtype, f"{variant} n_sub={n_sub}")
    # The projection itself does no multiply-add that XLA could contract.
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if variant == "K2o":
        solid = box_mask(n)
        assert np.all(got[2].numpy()[solid] == 0.0)


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k2o_twin_with_the_vortex128_mask_at_32(solve_dtype):
    """vortex128's sphere cut to 32³, three substeps, its sweeps."""
    vel, dens = inputs(N, 31)
    obst = np.asarray(j_build_mask(j_vortex128().replace(size=N)))
    ref = project_advect_density_3d_resident(
        jnp.asarray(vel), jnp.asarray(dens), ITERS, DT_ADV, n_sub=3,
        solve_dtype=solve_dtype, obst=jnp.asarray(obst), interpret=True)
    got = project_advect_density_3d_plain(
        torch.from_numpy(vel), torch.from_numpy(dens), ITERS, DT_ADV, n_sub=3,
        solve_dtype=solve_dtype, obst=torch.from_numpy(obst))
    assert_k2_class(got, ref, solve_dtype, "K2o vortex128 mask")


def test_k2_twins_are_their_compositions():
    """K2s is K2 on the density plus the emitter; K2o is K3 with the mask,
    then K1 on the density with the mask and the substeps: bitwise."""
    vel, dens = (torch.from_numpy(a) for a in inputs(16, 40))
    src, obst = torch.from_numpy(descriptor(16)), torch.from_numpy(box_mask(16))
    got = project_advect_density_3d_plain(vel, dens, ITERS, DT_ADV, src=src,
                                          damp=DAMP, dens_damp=DDAMP)
    ref = project_advect_density_3d_plain(vel, src_field_add(dens, src), ITERS,
                                          DT_ADV, damp=DAMP, dens_damp=DDAMP)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    got = project_advect_density_3d_plain(vel, dens, ITERS, DT_ADV, obst=obst,
                                          n_sub=3, solve_dtype="bfloat16",
                                          damp=DAMP, dens_damp=DDAMP)
    v, p = project_3d_resident_plain(vel, ITERS, obst, "bfloat16", DAMP)
    d = advect_multi_3d_plain((0,), dens[None], v, DT_ADV, obst=obst, n_sub=3)[0]
    for g, r in zip(got, (v, p, d * DDAMP)):
        assert torch.equal(g, r)


# -- K8 ------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_sub,damped,solve_dtype", [
    (16, 1, False, None), (16, 2, True, "bfloat16"),
    (32, 1, True, "bfloat16"), (32, 2, False, None)])
def test_k8_twin_matches_pallas_interpret(n, n_sub, damped, solve_dtype):
    vel, dens = inputs(n, 50 + n + n_sub)
    damp, ddamp = (DAMP, DDAMP) if damped else (1.0, 1.0)
    ref = full_step_3d_resident(
        jnp.asarray(vel), jnp.asarray(dens), ITERS, DT_ADV, n_sub=n_sub,
        solve_dtype=solve_dtype, damp=damp, dens_damp=ddamp, interpret=True)
    got = full_step_3d_plain(
        torch.from_numpy(vel), torch.from_numpy(dens), ITERS, DT_ADV,
        n_sub=n_sub, solve_dtype=solve_dtype, damp=damp, dens_damp=ddamp)
    assert_k2_class(got, ref, solve_dtype, f"K8 n={n} n_sub={n_sub}")


# -- the wrappers on the CPU ---------------------------------------------------


def test_wrappers_on_cpu_run_the_twins():
    vel, dens = (torch.from_numpy(a) for a in inputs(16, 3))
    src, obst = torch.from_numpy(descriptor(16)), torch.from_numpy(box_mask(16))
    for counter in (advect_multi_3d_kernel, project_advect_density_3d, full_step_3d):
        counter.launches = 0
    buoy = (dens, 0.2, 0.0, 0.0)
    assert torch.equal(
        advect_multi_3d_kernel((1, 2, 3), vel, vel, DT_ADV, buoy=buoy, src=src),
        advect_multi_3d_plain((1, 2, 3), vel, vel, DT_ADV, buoy=buoy, src=src))
    for kw in ({"src": src}, {"obst": obst, "n_sub": 3}, {"n_sub": 2}):
        got = project_advect_density_3d(vel, dens, 5, DT_ADV, solve_dtype="bfloat16",
                                        damp=DAMP, dens_damp=DDAMP, **kw)
        ref = project_advect_density_3d_plain(vel, dens, 5, DT_ADV,
                                              solve_dtype="bfloat16", damp=DAMP,
                                              dens_damp=DDAMP, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    got = full_step_3d(vel, dens, 5, DT_ADV, n_sub=2, solve_dtype="bfloat16",
                       damp=DAMP, dens_damp=DDAMP)
    ref = full_step_3d_plain(vel, dens, 5, DT_ADV, n_sub=2, solve_dtype="bfloat16",
                             damp=DAMP, dens_damp=DDAMP)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (advect_multi_3d_kernel.launches, project_advect_density_3d.launches,
            full_step_3d.launches) == (0, 0, 0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    vel, dens = (torch.from_numpy(a) for a in inputs(16, 4))
    src, obst = torch.from_numpy(descriptor(16)), torch.from_numpy(box_mask(16))
    with pytest.raises(ValueError, match="buoy"):
        advect_multi_3d_kernel((1, 2, 3), vel, vel, DT_ADV, src=src)
    with pytest.raises(ValueError, match="buoy"):
        advect_multi_3d_plain((1, 2, 3), vel, vel, DT_ADV, src=src)
    with pytest.raises(ValueError, match="src"):
        advect_multi_3d_kernel((1, 2, 3), vel, vel, DT_ADV, buoy=(dens, 0.2, 0.0, 0.0),
                               src=src[:4].contiguous())
    with pytest.raises(ValueError, match="obstacle-free"):
        project_advect_density_3d(vel, dens, 5, DT_ADV, src=src, obst=obst)
    with pytest.raises(TypeError, match="obst"):
        project_advect_density_3d(vel, dens, 5, DT_ADV, obst=obst.to(torch.uint8))
    with pytest.raises(ValueError, match="n_sub"):
        project_advect_density_3d(vel, dens, 5, DT_ADV, n_sub=0)
    with pytest.raises(ValueError, match="n_sub"):
        full_step_3d(vel, dens, 5, DT_ADV, n_sub=1.5)
    with pytest.raises(ValueError, match="window"):
        full_step_3d(vel, dens, 5, DT_ADV, window=0)
    with pytest.raises(ValueError, match="iters"):
        full_step_3d(vel, dens, 0, DT_ADV)


# -- the emitter_folds gate ----------------------------------------------------


@pytest.mark.parametrize("change", [
    {}, {"fuse_emitter": False}, {"fuse_self_advect": True},
    {"enable_obstacle": True}, {"vorticity_confinement": 1.0},
    {"fuse_buoyancy": False}, {"buoyancy": 0.0, "fuse_buoyancy": False},
    {"source_emits_velocity": True}, {"source_pulsing": True},
    {"fuse_project_advect": False}, {"enable_custom_source": False},
], ids=["as-asked", "not-asked", "full-step", "obstacle", "vorticity",
        "no-buoyancy-fold", "no-force", "emits-velocity", "pulsing",
        "unfused", "no-emitter"])
def test_emitter_folds_gate_matches_jax(monkeypatch, change):
    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    change = {"fuse_emitter": True, **change}
    j_cfg = j_bench128().replace(size=N, **change)
    t_cfg = t_bench128().replace(size=N, **change)
    assert t_s3.emitter_folds(t_cfg, True, True) == j_s3.emitter_folds(j_cfg)
    # The port's kernel test: the kernel path, and the solve in the card's L2.
    assert not t_s3.emitter_folds(t_cfg, False, True)
    assert not t_s3.emitter_folds(t_cfg, True, False)


def test_emitter_folds_gate_with_extra_sources(monkeypatch):
    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    extra = dict(position=(0.3, 0.1, 0.3), strength=5.0, radius=3.0)
    j_cfg = j_bench128().replace(size=N, fuse_emitter=True,
                                 extra_sources=(JSourceSpec(**extra),))
    t_cfg = t_bench128().replace(size=N, fuse_emitter=True,
                                 extra_sources=(SourceSpec(**extra),))
    assert not j_s3.emitter_folds(j_cfg)
    assert not t_s3.emitter_folds(t_cfg, True, True)


def test_step_refuses_src_where_the_emitter_does_not_fold(monkeypatch):
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    cfg = t_bench128().replace(size=N)  # fuse_emitter off
    state = state_from_numpy(start_arrays(cfg), "cpu")
    with pytest.raises(ValueError, match="emitter_folds"):
        t_s3.simulate_step_3d(state, cfg, PLAIN_TWINS,
                              src=emitter_fold_operand(cfg, state.time))


# -- the three configs through Engine -------------------------------------------


CONFIGS = {
    "bench128+fuse_emitter": (j_bench128, t_bench128, {"fuse_emitter": True}),
    "bench128+fuse_self_advect": (j_bench128, t_bench128, {"fuse_self_advect": True}),
    "vortex128+fuse_project_advect": (j_vortex128, t_vortex128,
                                      {"fuse_project_advect": True}),
}


def start_arrays(cfg):
    """tests/test_torch_vortex.py's start state."""
    vel, dens = inputs(N, 2026, scale=0.3, base=1.2)
    return {
        "density": dens,
        "velocity": vel,
        "pressure": np.zeros((N, N, N), np.float32),
        "obstacles": np.asarray(j_build_mask(j_vortex128().replace(size=N)))
        if cfg.enable_obstacle else np.zeros((N, N, N), bool),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


class Spy:
    """A ``StepKernels`` of the twins that records which calls a step made."""

    def __init__(self):
        self.calls = []
        self.kernels = StepKernels(*(self._wrap(name, fn) for name, fn in
                                          PLAIN_TWINS._asdict().items()))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.calls.append(name + ("+src" if k.get("src") is not None else ""))
            return fn(*a, **k)
        return call


def rollout_port(cfg, kernels=PLAIN_TWINS, steps=STEPS):
    eng = Engine(cfg, "cpu", kernels=kernels)
    eng.state = state_from_numpy(start_arrays(cfg), "cpu")
    eng.step(steps)
    return state_to_numpy(eng.state)


@pytest.fixture(scope="module")
def rollouts():
    with pytest.MonkeyPatch.context() as mp:
        # The JAX kernel path with interpret-mode Pallas kernels, and the
        # port's kernel path with its kernels' twins, both on the CPU.
        mp.setattr(j_s3, "_pallas_usable", lambda cfg: cfg.kernel_backend != "xla")
        for mod, name in ((j_pa, "advect_multi_3d_pallas"),
                          (j_pp, "project_3d_pallas"),
                          (j_pp, "project_advect_density_3d_pallas"),
                          (j_pp, "full_step_3d_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    interpret=True))
        mp.setattr(t_s3, "_kernels_usable",
                   lambda cfg, device: cfg.kernel_backend != "xla")
        out = {}
        for key, (j_pre, t_pre, change) in CONFIGS.items():
            j_cfg = j_pre().replace(size=N, **change)
            eng = JEngine(j_cfg)
            eng.state = JState(**{k: jnp.asarray(v)
                                  for k, v in start_arrays(j_cfg).items()})
            eng.step(STEPS)
            out[("jax", key)] = {k: np.asarray(getattr(eng.state, k))
                                 for k in ("density", "velocity", "pressure",
                                           "step", "time")}
            spy = Spy()
            t_cfg = t_pre().replace(size=N, **change)
            out[("port", key)] = rollout_port(t_cfg, spy.kernels)
            out[("calls", key)] = spy.calls
        # What the fused paths equal on the port's side.
        bench, vortex = t_bench128().replace(size=N), t_vortex128().replace(size=N)
        out["composed emitter"] = rollout_port(bench)
        out["no buoyancy fold"] = rollout_port(bench.replace(fuse_buoyancy=False))
        out["vortex128 unfused"] = rollout_port(vortex)
        return out


def test_the_configs_run_their_kernels(rollouts):
    assert rollouts[("calls", "bench128+fuse_emitter")] == ["advect+src", "project_advect+src"] * STEPS
    assert rollouts[("calls", "bench128+fuse_self_advect")] == ["full_step"] * STEPS
    assert rollouts[("calls", "vortex128+fuse_project_advect")] == ["advect", "project_advect"] * STEPS


# The bf16-solve class after 3 steps, per field: bound x max|ref|.  A last-bit
# difference before a bfloat16 rounding of the pressure iterate moves it by
# one bf16 ulp (2^-8 of its value), which the velocity and density inherit
# damped.
BF16_CLASS = (("density", 1e-5), ("velocity", 1e-3), ("pressure", 2.0 ** -8))


def assert_bf16_class(got, ref, what):
    for field, bound in BF16_CLASS:
        scale = float(np.abs(ref[field]).max())
        diff = max_diff(got[field], ref[field])
        assert diff <= bound * scale, (
            f"{what} {field}: max abs diff {diff:.3e} > {bound} x max {scale:.3e}")
    assert got["step"] == ref["step"] == STEPS
    assert got["time"] == ref["time"]


@pytest.mark.parametrize("key", list(CONFIGS))
def test_configs_match_jax(rollouts, key):
    assert_bf16_class(rollouts[("port", key)], rollouts[("jax", key)], key)


def test_vortex128_fused_keeps_the_obstacle_contract(rollouts):
    got = rollouts[("port", "vortex128+fuse_project_advect")]
    solid = start_arrays(t_vortex128())["obstacles"].copy()
    solid[[0, -1]] = solid[:, [0, -1]] = solid[:, :, [0, -1]] = False
    assert solid.any()
    assert np.all(got["velocity"][:, solid] == 0.0)
    assert np.all(got["density"][solid] == 0.0)


def test_fused_paths_equal_their_compositions(rollouts):
    """K8 is bench128 without the buoyancy fold (K8 does not fold it), and
    vortex128's K2o is its unfused K3 → K1 path: bitwise.  The folded
    emitter is the composed one within the JAX package's bound."""
    for fused, unfused in (("bench128+fuse_self_advect", "no buoyancy fold"),
                           ("vortex128+fuse_project_advect", "vortex128 unfused")):
        for field in ("density", "velocity", "pressure"):
            np.testing.assert_array_equal(rollouts[("port", fused)][field],
                                          rollouts[unfused][field], err_msg=fused)
    got, ref = rollouts[("port", "bench128+fuse_emitter")], rollouts["composed emitter"]
    for field in ("density", "velocity", "pressure"):
        assert_close(got[field], ref[field], 1e-5, 1e-6, f"folded emitter {field}")
