"""fluidsim_tpu_torch's CUDA kernels against their plain twins, on a card
(and K8 against K1 followed by K2, and the fused step paths against the
unfused ones), the 2D mode's kernel path (K9) against its twin path and
the CPU, the sweep-blocked solve (K5) in K2, K3, K4 and K8 and K14, K8 and K14 at
windows K >= 2 on the <= 8-tap sum (finite and non-finite fields, the cells
counted by sum), the
sharded step's kernels (K10, K11, and the "rdma" backend's K12 and K13)
and its paths, the mesh's streams (8 shards on 8 streams of one card
bitwise the unsharded step, with a shard held back, and a test that sees a
missing wait) and cards (2 and 4 where visible), the plain ops that
divide on the card against the CPU, and the program's ``kernel.*`` spans
against the launch counters.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:  python -m pytest tests/test_torch_cuda.py -q -m cuda

The kernels are built with -fmad=false and do the twins' float32 operations
in the twins' order, so they are held to bitwise equality.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.config import (
    preset_bench_128,
    preset_multi_emitter_256,
    preset_plume_64,
    preset_scene_a,
    preset_scene_b,
    preset_sharded_512,
    preset_smoke_box_32,
    preset_vortex_128,
)
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.kernels import _build
from fluidsim_tpu_torch.kernels import advect as kadvect
from fluidsim_tpu_torch.kernels import jacobi as kjacobi
from fluidsim_tpu_torch.kernels import project as kproject
from fluidsim_tpu_torch.kernels import resident as kresident
from fluidsim_tpu_torch.kernels import resident2d as kresident2d
from fluidsim_tpu_torch.kernels.advect import (
    advect_multi_3d_kernel,
    advect_multi_3d_plain,
)
from fluidsim_tpu_torch.kernels.jacobi import (
    jacobi_3d_kernel,
    jacobi_3d_plain,
    jacobi_3d_resident,
    jacobi_3d_resident_plain,
)
from fluidsim_tpu_torch.kernels.project import (
    divergence_3d_kernel,
    divergence_3d_plain,
    divergence_ext_kernel,
    divergence_ext_plain,
    gradient_3d_kernel,
    gradient_ext_kernel,
    gradient_ext_plain,
    project_3d_slab_kernel,
)
from fluidsim_tpu_torch.kernels.resident import (
    advect_project_3d_resident,
    advect_project_3d_resident_plain,
    full_step_3d,
    full_step_3d_plain,
    full_step_blocks,
    project_3d_resident,
    project_3d_resident_plain,
    project_gradient,
    project_advect_density_3d,
    project_advect_density_3d_plain,
)
from fluidsim_tpu_torch.kernels.resident2d import (
    lin_solve_2d_resident,
    lin_solve_2d_resident_plain,
)
from fluidsim_tpu_torch.ops.advect import advect_2d
from fluidsim_tpu_torch.ops.boundary import set_bnd_2d
from fluidsim_tpu_torch.ops.forces import (
    apply_turbulent_noise_2d,
    enforce_obstacle_boundaries_2d,
    enforce_obstacle_boundaries_3d,
)
from fluidsim_tpu_torch.ops.linsolve import jacobi_3d as jacobi_3d_xla
from fluidsim_tpu_torch.ops.linsolve import sweeps_2d
from fluidsim_tpu_torch.ops.project import project_2d
from fluidsim_tpu_torch.ops.project import project_3d as project_3d_xla
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
from fluidsim_tpu_torch.scene.sources import emitter_fold_operand
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
from fluidsim_tpu_torch.kernels.halo import (
    NO_WALL,
    advect_ext_kernel,
    advect_ext_plain,
    ext_halo,
    halo_exchange_rdma,
    halo_exchange_rdma_plain,
    jacobi_ext_kernel,
    jacobi_ext_plain,
    jacobi_ext_rdma,
    jacobi_ext_rdma_plain,
)
from fluidsim_tpu_torch.parallel import (
    gathered_ops,
    jacobi_3d_sharded,
    make_mesh,
    shard_state,
    sharded_step_fn,
    unshard_state,
)
from fluidsim_tpu_torch.parallel.halo import advect_multi_3d_sharded
from fluidsim_tpu_torch.parallel.streams import ShardOrder
from fluidsim_tpu_torch.state import zeros_state

pytestmark = pytest.mark.cuda

CFG = preset_bench_128()
DT = CFG.effective_params()[0]
DAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(CFG.velocity_damping)))
DDAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(CFG.density_dissipation)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def fields(n, seed, device):
    rng = np.random.default_rng(seed)
    vel = (rng.standard_normal((3, n, n, n)) * 5.0).astype(np.float32)
    dens = (np.abs(rng.standard_normal((n, n, n))) * 10.0).astype(np.float32)
    return torch.from_numpy(vel).to(device), torch.from_numpy(dens).to(device)


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("n", [17, 128])
def test_k1_matches_twin(cuda, n, n_sub):
    vel, dens = fields(n, n, cuda)
    for bs, f, buoy in (((1, 2, 3), vel, (dens, 0.2, 0.1, 0.05)),
                        ((1, 2, 3), vel, None),
                        ((0,), dens[None], None)):
        got = advect_multi_3d_kernel(bs, f, vel, DT, buoy=buoy, n_sub=n_sub)
        ref = advect_multi_3d_plain(bs, f, vel, DT, buoy=buoy, n_sub=n_sub)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (bs, buoy is None, float((got - ref).abs().max()))


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n", [17, 128])
def test_k2_matches_twin(cuda, n, solve_dtype):
    vel, dens = fields(n, 100 + n, cuda)
    got = project_advect_density_3d(vel, dens, 60, DT, solve_dtype=solve_dtype,
                                    damp=DAMP, dens_damp=DDAMP)
    ref = project_advect_density_3d_plain(vel, dens, 60, DT,
                                          solve_dtype=solve_dtype, damp=DAMP,
                                          dens_damp=DDAMP)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), float((g - r).abs().max())


def test_engine_kernel_path_matches_twin_path(cuda):
    cfg = CFG.replace(size=48)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    before = (advect_multi_3d_kernel.launches, project_advect_density_3d.launches)
    kern.step(5)
    twin.step(5)
    assert advect_multi_3d_kernel.launches == before[0] + 5
    assert project_advect_density_3d.launches == before[1] + 5
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name


def test_wrapper_raises_for_cuda_tensors_it_cannot_take(cuda):
    vel, dens = fields(16, 1, cuda)
    with pytest.raises(TypeError):
        advect_multi_3d_kernel((1, 2, 3), vel.double(), vel.double(), DT)
    with pytest.raises(ValueError, match="one device"):
        advect_multi_3d_kernel((1, 2, 3), vel, vel, DT,
                               buoy=(dens.cpu(), 0.2, 0.0, 0.0))


def vortex_mask(n, device):
    return torch.from_numpy(build_obstacle_mask(preset_vortex_128().replace(size=n))).to(device)


@pytest.mark.parametrize("n_sub", [1, 3])
def test_k1_substeps_and_mask_match_twin(cuda, n_sub):
    n = 64
    vel, dens = fields(n, 200 + n_sub, cuda)
    vel = vel * 0.1  # a backtrace of up to about a cell per substep
    obst = vortex_mask(n, cuda)
    for bs, f in (((1, 2, 3), vel), ((0,), dens[None])):
        for mask in (obst, None):
            got = advect_multi_3d_kernel(bs, f, vel, DT, obst=mask, n_sub=n_sub)
            ref = advect_multi_3d_plain(bs, f, vel, DT, obst=mask, n_sub=n_sub)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (bs, mask is None, float((got - ref).abs().max()))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k3_matches_twin(cuda, solve_dtype, masked):
    n = 64
    vel, _ = fields(n, 300, cuda)
    obst = vortex_mask(n, cuda) if masked else None
    for damp in (1.0, DAMP):
        got = project_3d_resident(vel, 20, obst=obst, solve_dtype=solve_dtype, damp=damp)
        ref = project_3d_resident_plain(vel, 20, obst=obst, solve_dtype=solve_dtype,
                                        damp=damp)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r), float((g - r).abs().max())


def test_k3_without_mask_equals_k2_projection(cuda):
    n = 64
    vel, dens = fields(n, 400, cuda)
    vel3, p3 = project_3d_resident(vel, 60, solve_dtype="bfloat16", damp=DAMP)
    vel2, p2, _ = project_advect_density_3d(vel, dens, 60, DT, solve_dtype="bfloat16",
                                            damp=DAMP, dens_damp=DDAMP)
    torch.cuda.synchronize()
    assert torch.equal(vel3, vel2) and torch.equal(p3, p2)


def test_vortex128_kernel_path_matches_twin_path(cuda):
    cfg = preset_vortex_128().replace(size=64)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    before = (advect_multi_3d_kernel.launches, project_3d_resident.launches,
              project_advect_density_3d.launches)
    kern.step(10)
    twin.step(10)
    assert advect_multi_3d_kernel.launches == before[0] + 20
    assert project_3d_resident.launches == before[1] + 10
    assert project_advect_density_3d.launches == before[2]
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name
    solid = kern.state.obstacles.clone()
    solid[[0, -1]] = False
    solid[:, [0, -1]] = False
    solid[:, :, [0, -1]] = False
    assert bool((kern.state.velocity[:, solid] == 0).all())
    kern.set_config(cfg.replace(obstacle_radius=0.12))
    assert kern.state.obstacles.device.type == "cuda"
    assert int(kern.state.obstacles.sum()) > int(solid.sum())


# -- the slab route: K6 and K7 -------------------------------------------------


@pytest.mark.parametrize("iters", [2, 4, 5, 20])
@pytest.mark.parametrize("n", [37, 64, 96])
def test_k6_matches_twin(cuda, n, iters):
    """The grids cut into 56 x (48 - 2T) x-y tiles, the last one partial, and
    into several z-ranges (as many as fill the card); at up to four sweeps
    a launch, 2 and 4 sweeps are one pass, 5 two (three and two) and 20
    five."""
    vel, _ = fields(n, 500 + n, cuda)
    x, x0 = vel[0], vel[1]
    for b, a, c in ((0, 1.0, 6.0), (1, 1.0, 6.0), (2, 1.0, 6.0), (3, 0.13, 1.0 + 6 * 0.13)):
        got = jacobi_3d_kernel(b, x, x0, a, c, iters)
        ref = jacobi_3d_plain(b, x, x0, a, c, iters)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (b, float((got - ref).abs().max()))


@pytest.mark.parametrize("n", [64, 97])
def test_k7_matches_twins(cuda, n):
    vel, dens = fields(n, 600 + n, cuda)
    got = divergence_3d_kernel(vel)
    torch.cuda.synchronize()
    assert torch.equal(got, divergence_3d_plain(vel))
    got = gradient_3d_kernel(vel, dens)
    torch.cuda.synchronize()
    assert torch.equal(got, project_gradient(vel, dens))


def test_slab_route_equals_k3(cuda):
    """The same adds in the same order, and a·Σ with a = 1 is exact."""
    vel, _ = fields(96, 700, cuda)
    got = project_3d_slab_kernel(vel, 20)
    ref = project_3d_resident(vel, 20)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), float((g - r).abs().max())


@pytest.mark.parametrize("preset", [preset_multi_emitter_256, preset_sharded_512])
def test_slab_step_kernel_path_matches_twin_path(cuda, monkeypatch, preset):
    """multi256 and sharded512 cut to 64³ with the L2 gate shut, so that
    they take the slab route as they do at full size."""
    monkeypatch.setattr(kproject, "resident_fits", lambda *a: False)
    cfg = preset().replace(size=64)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    counters = (advect_multi_3d_kernel, jacobi_3d_kernel, divergence_3d_kernel,
                gradient_3d_kernel, project_3d_resident, project_advect_density_3d)
    before = [fn.launches for fn in counters]
    kern.step(5)
    twin.step(5)
    added = [fn.launches - b for fn, b in zip(counters, before)]
    assert added == [10, 5, 5, 5, 0, 0]
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name


# -- the fused variants: K1 with the emitter, K2s, K2o, K8 ----------------------


def emitter(n, device):
    """bench128's emitter descriptor at n^3."""
    cfg = CFG.replace(size=n)
    return emitter_fold_operand(cfg, torch.zeros((), device=device))


def assert_equal(got, ref, what):
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (what, float((g - r).abs().max()))


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("n", [17, 128])
def test_k1_src_matches_twin(cuda, n, n_sub):
    vel, dens = fields(n, 800 + n, cuda)
    src = emitter(n, cuda)
    buoy = (dens, 0.2, 0.1, 0.05)
    got = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, buoy=buoy, src=src, n_sub=n_sub)
    ref = advect_multi_3d_plain((1, 2, 3), vel, vel, DT, buoy=buoy, src=src, n_sub=n_sub)
    assert_equal((got,), (ref,), "K1 src")
    plain = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, buoy=buoy, n_sub=n_sub)
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("case", ["K2s", "K2o", "K2 n_sub=2"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k2_variants_match_twin(cuda, case, solve_dtype):
    n = 64
    vel, dens = fields(n, 900, cuda)
    vel = vel * 0.1  # a backtrace of up to about a cell per substep
    kw = {"K2s": {"src": emitter(n, cuda)},
          "K2o": {"obst": vortex_mask(n, cuda), "n_sub": 3},
          "K2 n_sub=2": {"n_sub": 2}}[case]
    got = project_advect_density_3d(vel, dens, 20, DT, solve_dtype=solve_dtype, damp=DAMP,
                                    dens_damp=DDAMP, **kw)
    ref = project_advect_density_3d_plain(vel, dens, 20, DT, solve_dtype=solve_dtype,
                                          damp=DAMP, dens_damp=DDAMP, **kw)
    assert_equal(got, ref, case)


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n", [33, 128])
def test_k8_matches_twin_and_k1_then_k2(cuda, n, solve_dtype, n_sub):
    vel, dens = fields(n, 1000 + n, cuda)
    vel = vel * 0.1
    kw = dict(n_sub=n_sub, solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    got = full_step_3d(vel, dens, 60, DT, **kw)
    assert_equal(got, full_step_3d_plain(vel, dens, 60, DT, **kw), "K8 vs twin")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=n_sub)
    assert_equal(got, project_advect_density_3d(adv, dens, 60, DT, **kw), "K8 vs K1 -> K2")


def test_k8_grid_is_what_the_card_holds(cuda):
    """Each route's grid: the tiles at bench128 (the tiled route, one block
    a tile, all resident at once; K5's block too), the occupancy grid where
    no tiling fits, and with no size given."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for solve_dtype in (None, "bfloat16"):
        sdt = kresident.solve_torch_dtype(solve_dtype)
        tiles = kresident.solve_tiles(128, sdt, cuda)
        blocks = full_step_blocks(solve_dtype, cuda, n=128, iters=60)
        assert blocks == int(np.prod(tiles)) <= sms
        assert kresident.fused_step_route(128, 60, solve_dtype, sweep_block=4,
                                          device=cuda) == "tiled"
        k5 = kresident.projection_tiles(128, torch.float32, 60, 4, sdt, cuda)
        assert full_step_blocks(solve_dtype, cuda, n=128, iters=60,
                                sweep_block=4) == int(np.prod(k5)) <= sms
        for n, block in ((None, 1), (176, 1)):
            if n is not None:
                assert kresident.fused_step_route(n, 60, solve_dtype, sweep_block=block,
                                                  device=cuda) == "grid"
            blocks = full_step_blocks(solve_dtype, cuda, n=n, iters=60, sweep_block=block)
            assert blocks > 0 and blocks % sms == 0


@pytest.mark.parametrize("change,ran", [
    ({"fuse_self_advect": True}, {"K8": 5}),
    ({"fuse_emitter": True}, {"K1": 5, "K2": 5}),
])
def test_fused_bench_paths_match_twin_paths(cuda, change, ran):
    cfg = CFG.replace(size=48, **change)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    counters = {"K1": advect_multi_3d_kernel, "K2": project_advect_density_3d,
                "K3": project_3d_resident, "K8": full_step_3d}
    before = {k: fn.launches for k, fn in counters.items()}
    kern.step(5)
    twin.step(5)
    added = {k: fn.launches - before[k] for k, fn in counters.items()}
    assert added == {k: ran.get(k, 0) for k in counters}
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name


def test_vortex128_fused_path_equals_unfused(cuda):
    cfg = preset_vortex_128().replace(size=64)
    fused = Engine(cfg.replace(fuse_project_advect=True), cuda)
    before = (advect_multi_3d_kernel.launches, project_advect_density_3d.launches,
              project_3d_resident.launches)
    fused.step(5)
    assert (advect_multi_3d_kernel.launches - before[0],
            project_advect_density_3d.launches - before[1],
            project_3d_resident.launches - before[2]) == (5, 5, 0)
    unfused = Engine(cfg, cuda)
    unfused.step(5)
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(fused.state, name), getattr(unfused.state, name)), name


# -- K1 with a window of K = 2, 3 and K >= 4, K4, and the plume64 / smoke32 paths --


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [17, 64])
def test_k1_window_matches_twin(cuda, n, window, n_sub, masked):
    vel, dens = fields(n, 1100 + n + window, cuda)
    vel = vel * 0.3 * max(1, window - 2)  # a backtrace of up to about 3(K-2) cells
    obst = vortex_mask(n, cuda) if masked else None
    for bs, f in (((1, 2, 3), vel), ((0,), dens[None])):
        got = advect_multi_3d_kernel(bs, f, vel, DT, obst=obst, window=window, n_sub=n_sub)
        ref = advect_multi_3d_plain(bs, f, vel, DT, obst=obst, window=window, n_sub=n_sub)
        assert_equal((got,), (ref,), f"K1 window={window} {bs}")


@pytest.mark.parametrize("window", [2, 3, 4, 5])
def test_k1_window_buoyancy_fold_matches_twin(cuda, window):
    n = 33
    vel, dens = fields(n, 1200 + window, cuda)
    vel = vel * 0.3
    buoy = (dens, 0.2, 0.1, 0.05)
    for n_sub in (1, 2):
        got = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, window=window, buoy=buoy,
                                     n_sub=n_sub)
        ref = advect_multi_3d_plain((1, 2, 3), vel, vel, DT, window=window, buoy=buoy,
                                    n_sub=n_sub)
        assert_equal((got,), (ref,), f"K1 window={window} buoy n_sub={n_sub}")


@pytest.mark.parametrize("case", ["b0", "b1", "b3", "b0-mask", "b0-diffusion"])
@pytest.mark.parametrize("n", [17, 64])
def test_k4_matches_twin(cuda, n, case):
    """20 sweeps from a non-zero start whose faces are not set_bnd-consistent."""
    b = int(case[1])
    vel, dens = fields(n, 1300 + n, cuda)
    obst = vortex_mask(n, cuda) if case.endswith("mask") else None
    a, c = (0.13, 1.0 + 6 * 0.13) if case.endswith("diffusion") else (1.0, 6.0)
    got = jacobi_3d_resident(b, vel[0], vel[1], a, c, 20, obst=obst)
    ref = jacobi_3d_resident_plain(b, vel[0], vel[1], a, c, 20, obst=obst)
    assert_equal((got,), (ref,), f"K4 {case}")


def test_plain_ops_divide_as_on_the_cpu(cuda):
    """The plain ops the card runs divide by a 0-d tensor on the operand's
    device, so the card and the CPU give the same bits (PyTorch on CUDA
    divides by a Python scalar as a reciprocal multiply): the 3D ops, and
    the 2D solve (``/ c``), projection (``/ N``), obstacle mirror
    (``/ max(count, 1)``) and obstacle enforcement (``/ visc``)."""
    n = 33
    vel, dens = fields(n, 1400, cuda)
    obst = vortex_mask(n, cuda)
    m = 48
    vel2, _ = fields(m, 1401, cuda)
    v2, x2 = vel2[0, 0] * 3.0, vel2[1, 0]
    obst2 = scene_mask(preset_scene_a, m, cuda)
    cases = {
        "jacobi_3d": lambda v, d, o: jacobi_3d_xla(0, d, d, 0.13, 1.0 + 6 * 0.13, None, 5),
        "project_3d": lambda v, d, o: project_3d_xla(v, o, 5)[0],
        "obstacle enforcement": lambda v, d, o: enforce_obstacle_boundaries_3d(
            v, o, 0.1, 1e-4),
    }
    cases_2d = {
        "2D smoothing sweeps": lambda v, x, o: sweeps_2d(1, x, x, 0.21, 2.26, o, 5, True),
        "2D fixed-rhs sweeps": lambda v, x, o: sweeps_2d(2, v, x, 0.21, 2.26, o, 5, False),
        "set_bnd_2d mirror": lambda v, x, o: set_bnd_2d(1, v, o),
        "project_2d": lambda v, x, o: torch.stack(project_2d(v, x, o, 5)),
        "advect_2d": lambda v, x, o: advect_2d(0, x, v, x, 0.05, o),
        "2D obstacle enforcement": lambda v, x, o: torch.stack(
            enforce_obstacle_boundaries_2d(v, x, o, 1.0 / m, 1e-5)),
    }
    for name, fn in cases.items():
        got = fn(vel, dens, obst).cpu()
        ref = fn(vel.cpu(), dens.cpu(), obst.cpu())
        assert torch.equal(got, ref), (name, float((got - ref).abs().max()))
    for name, fn in cases_2d.items():
        got = fn(v2, x2, obst2).cpu()
        ref = fn(v2.cpu(), x2.cpu(), obst2.cpu())
        assert torch.equal(got, ref), (name, float((got - ref).abs().max()))
    # The turbulence divides nothing; the card's noise is an ulp from the
    # CPU's (observed 3.0e-8), inside the per-op class.
    got = torch.stack(apply_turbulent_noise_2d(v2, x2)).cpu()
    ref = torch.stack(apply_turbulent_noise_2d(v2.cpu(), x2.cpu()))
    assert torch.allclose(got, ref, rtol=2e-6, atol=1e-6), float((got - ref).abs().max())


def test_plume64_kernel_path_matches_twin_path(cuda):
    cfg = preset_plume_64().replace(size=48)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    before = (advect_multi_3d_kernel.launches, project_3d_resident.launches,
              project_advect_density_3d.launches, jacobi_3d_resident.launches)
    kern.step(3)
    twin.step(3)
    assert (advect_multi_3d_kernel.launches - before[0], project_3d_resident.launches - before[1],
            project_advect_density_3d.launches - before[2],
            jacobi_3d_resident.launches - before[3]) == (6, 3, 0, 0)
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name


@pytest.mark.parametrize("preset", [preset_plume_64, preset_vortex_128],
                         ids=["plume64-K4", "vortex128-K4-mask"])
def test_double_project_kernel_path_matches_twin_path(cuda, preset):
    cfg = preset().replace(size=48, double_project=True)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    before = jacobi_3d_resident.launches
    kern.step(3)
    twin.step(3)
    assert jacobi_3d_resident.launches - before == 3
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name


def test_smoke32_on_the_card_matches_the_cpu(cuda):
    """smoke32 takes no kernel (window 0) and steps on the card as on the
    CPU, bitwise."""
    cfg = preset_smoke_box_32()
    card, cpu = Engine(cfg, cuda), Engine(cfg, "cpu")
    counters = (advect_multi_3d_kernel, project_3d_resident, project_advect_density_3d,
                jacobi_3d_resident, jacobi_3d_kernel, full_step_3d)
    before = [fn.launches for fn in counters]
    card.step(5)
    cpu.step(5)
    assert [fn.launches for fn in counters] == before
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(card.state, name).cpu(), getattr(cpu.state, name)), name


def scene_mask(preset, n, device):
    """A 2D scene's obstacle at ``n``² (scene_a's airfoil, scene_b's circle)."""
    cfg = preset().replace(size=n, resolution_multiplier=1.0)
    return torch.from_numpy(build_obstacle_mask(cfg)).to(device)


@pytest.mark.parametrize("mask", ["none", "scene", "random"])
@pytest.mark.parametrize("n", [64, 128, 192])
def test_k9_matches_twin(cuda, n, mask):
    """K9 bitwise its twin, b 0/1/2 in both modes, 21 sweeps (odd) from
    seeded fields; the scene's mask (scene_b's circle at 128², scene_a's
    airfoil otherwise) or a random one with solid border cells."""
    rng = np.random.default_rng(900 + n)
    obst = {"none": None,
            "scene": scene_mask(preset_scene_b if n == 128 else preset_scene_a, n, cuda),
            "random": torch.from_numpy(rng.random((n, n)) < 0.2).to(cuda)}[mask]
    a = float(np.float32(2.5e-3 * (n - 2) ** 2))
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    for b in (0, 1, 2):
        x = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(cuda)
        x0 = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(cuda)
        for smooth in (True, False):
            start = x0 if smooth else x
            got = lin_solve_2d_resident(b, start, x0, a, c, obst, 21, smooth=smooth)
            ref = lin_solve_2d_resident_plain(b, start, x0, a, c, obst, 21, smooth=smooth)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (b, smooth, float((got - ref).abs().max()))
            assert torch.equal(torch.signbit(got), torch.signbit(ref)), (b, smooth)


@pytest.mark.parametrize("blocks", [1, 3])
def test_k9_cluster_size_leaves_the_result(cuda, blocks):
    """K9 on a cluster of ``blocks`` blocks (the step uses 16) bitwise its
    twin at 192² with scene_a's airfoil, b 0/1/2 in both modes, 21 sweeps."""
    n = 192
    rng = np.random.default_rng(960 + blocks)
    obst = scene_mask(preset_scene_a, n, cuda)
    a = float(np.float32(2.5e-3 * (n - 2) ** 2))
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    for b in (0, 1, 2):
        x = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(cuda)
        x0 = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(cuda)
        for smooth in (True, False):
            start = x0 if smooth else x
            got = lin_solve_2d_resident(b, start, x0, a, c, obst, 21, smooth=smooth,
                                        blocks=blocks)
            ref = lin_solve_2d_resident_plain(b, start, x0, a, c, obst, 21, smooth=smooth)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (b, smooth, float((got - ref).abs().max()))


def test_k9_wrapper_raises_for_cuda_tensors_it_cannot_take(cuda):
    x = torch.zeros((32, 32), device=cuda)
    with pytest.raises(TypeError):
        lin_solve_2d_resident(0, x.double(), x.double(), 1.0, 6.0, None, 4)
    with pytest.raises(ValueError, match="contiguous"):
        lin_solve_2d_resident(0, torch.zeros((32, 32), device=cuda).t(), x, 1.0, 6.0, None, 4)
    with pytest.raises(ValueError, match="square"):
        lin_solve_2d_resident(0, torch.zeros((32, 16), device=cuda),
                              torch.zeros((32, 16), device=cuda), 1.0, 6.0, None, 4)
    with pytest.raises(ValueError, match="one device"):
        lin_solve_2d_resident(0, x, x.cpu(), 1.0, 6.0, None, 4)
    for blocks in (0, 17):
        with pytest.raises(RuntimeError, match="CUDA error"):
            lin_solve_2d_resident(0, x, x, 1.0, 6.0, None, 4, blocks=blocks)


@pytest.mark.parametrize("preset", [preset_scene_a, preset_scene_b])
def test_2d_kernel_path_matches_twin_path(cuda, preset):
    """Eight K9 launches a step and no 3D kernel; bitwise the twin path
    after 3 steps (scene_b from a seeded velocity: it has no emitter)."""
    cfg = preset()
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    n = cfg.current_size
    rng = np.random.default_rng(950)
    vel = torch.from_numpy((rng.standard_normal((2, n, n)) * 0.5).astype(np.float32)).to(cuda)
    for eng in (kern, twin):
        eng.state = eng.state.replace(velocity=vel.clone())
    counters = (advect_multi_3d_kernel, project_3d_resident, project_advect_density_3d,
                jacobi_3d_resident, jacobi_3d_kernel, full_step_3d)
    before = [fn.launches for fn in counters]
    k9_before = (lin_solve_2d_resident.launches, lin_solve_2d_resident.smooth_launches)
    kern.step(3)
    twin.step(3)
    # Three smoothing solves a step (vx, vy, density), five fixed-rhs (the
    # double_diffuse solves and two pressure solves).
    assert lin_solve_2d_resident.launches - k9_before[0] == 8 * 3
    assert lin_solve_2d_resident.smooth_launches - k9_before[1] == 3 * 3
    assert [fn.launches for fn in counters] == before
    for name in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, name), getattr(twin.state, name)), name


def test_scene_a_on_the_card_matches_the_cpu(cuda):
    """scene_a cut to 64² (``resolution_multiplier=1``): 3 steps on the card's
    kernel path against the CPU port, in the re-synced step's class (rtol
    1e-5, atol 2e-6·scale; tests/test_parity_step.py)."""
    cfg = preset_scene_a().replace(resolution_multiplier=1.0)
    card, cpu = Engine(cfg, cuda), Engine(cfg, "cpu")
    card.step(3)
    cpu.step(3)
    for name in ("density", "velocity", "pressure"):
        got, ref = getattr(card.state, name).cpu(), getattr(cpu.state, name)
        scale = max(1.0, float(ref.abs().max()))
        assert torch.allclose(got, ref, rtol=1e-5, atol=2e-6 * scale), (
            name, float((got - ref).abs().max()))


# -- bfloat16 field storage and the fused kernels at K = 2, 3 ----------------

BF16 = torch.bfloat16


def bf16_fields(n, seed, device, scale=0.3):
    """Seeded fields rounded to bfloat16; |v| scaled for a backtrace of up
    to about ``scale``·17 cells at DT."""
    vel, dens = fields(n, seed, device)
    return (vel * scale).to(BF16), dens.to(BF16)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("window", [1, 2, 3, 4, 5])
def test_k1_bf16_matches_twin(cuda, window, n_sub, masked):
    n = 33
    vel, dens = bf16_fields(n, 1300 + window, cuda)
    obst = vortex_mask(n, cuda) if masked else None
    for bs, f in (((1, 2, 3), vel), ((0,), dens[None])):
        got = advect_multi_3d_kernel(bs, f, vel, DT, obst=obst, window=window, n_sub=n_sub)
        ref = advect_multi_3d_plain(bs, f, vel, DT, obst=obst, window=window, n_sub=n_sub)
        assert got.dtype == BF16
        assert_equal((got,), (ref,), f"K1 bf16 window={window} {bs}")


def test_k1_bf16_at_128_matches_twin(cuda):
    vel, dens = bf16_fields(128, 1310, cuda, scale=0.1)
    for bs, f in (((1, 2, 3), vel), ((0,), dens[None])):
        got = advect_multi_3d_kernel(bs, f, vel, DT)
        assert_equal((got,), (advect_multi_3d_plain(bs, f, vel, DT),), f"K1 bf16 {bs}")


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k3_bf16_matches_twin(cuda, solve_dtype, masked):
    vel, _ = bf16_fields(64, 1320, cuda, scale=1.0)
    obst = vortex_mask(64, cuda) if masked else None
    got = project_3d_resident(vel, 20, obst=obst, solve_dtype=solve_dtype, damp=DAMP)
    ref = project_3d_resident_plain(vel, 20, obst=obst, solve_dtype=solve_dtype, damp=DAMP)
    assert got[0].dtype == BF16 and got[1].dtype == BF16
    assert_equal(got, ref, "K3 bf16")


@pytest.mark.parametrize("case", ["K2", "K2o", "K2 n_sub=2"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k2_bf16_matches_twin(cuda, case, solve_dtype):
    n = 64
    vel, dens = bf16_fields(n, 1330, cuda, scale=0.1)
    kw = {"K2": {}, "K2o": {"obst": vortex_mask(n, cuda), "n_sub": 3},
          "K2 n_sub=2": {"n_sub": 2}}[case]
    got = project_advect_density_3d(vel, dens, 20, DT, solve_dtype=solve_dtype, damp=DAMP,
                                    dens_damp=DDAMP, **kw)
    ref = project_advect_density_3d_plain(vel, dens, 20, DT, solve_dtype=solve_dtype,
                                          damp=DAMP, dens_damp=DDAMP, **kw)
    assert all(t.dtype == BF16 for t in got)
    assert_equal(got, ref, case + " bf16")


@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k8_bf16_matches_twin_and_k1_then_k2(cuda, solve_dtype, n_sub):
    n = 33
    vel, dens = bf16_fields(n, 1340 + n_sub, cuda, scale=0.1)
    kw = dict(n_sub=n_sub, solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    got = full_step_3d(vel, dens, 20, DT, **kw)
    assert_equal(got, full_step_3d_plain(vel, dens, 20, DT, **kw), "K8 bf16 vs twin")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=n_sub)
    assert_equal(got, project_advect_density_3d(adv, dens, 20, DT, **kw),
                 "K8 bf16 vs K1 -> K2")


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
def test_fused_windows_match_twin(cuda, window, n_sub, dtype):
    """K2, K2o and K8 with a K = 2, 3, 4, 5 density phase (K8 in both
    phases), K2s at those windows in float32, each against its twin; K8 against K1 → K2."""
    n = 33
    vel, dens = fields(n, 1400 + window, cuda)
    vel, dens = (vel * 0.3).to(dtype), dens.to(dtype)
    kw = dict(window=window, n_sub=n_sub, damp=DAMP, dens_damp=DDAMP)
    cases = {"K2": {}, "K2o": {"obst": vortex_mask(n, cuda)}}
    if dtype == torch.float32:
        cases["K2s"] = {"src": emitter(n, cuda)}
    for case, extra in cases.items():
        got = project_advect_density_3d(vel, dens, 20, DT, **kw, **extra)
        ref = project_advect_density_3d_plain(vel, dens, 20, DT, **kw, **extra)
        assert_equal(got, ref, f"{case} window={window}")
    got = full_step_3d(vel, dens, 20, DT, **kw)
    assert_equal(got, full_step_3d_plain(vel, dens, 20, DT, **kw), "K8 vs twin")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=n_sub, window=window)
    assert_equal(got, project_advect_density_3d(adv, dens, 20, DT, **kw), "K8 vs K1 -> K2")


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
def test_k1_src_window_matches_twin(cuda, window, n_sub):
    n = 33
    vel, dens = fields(n, 1500 + window, cuda)
    vel = vel * 0.3
    src = emitter(n, cuda)
    buoy = (dens, 0.2, 0.1, 0.05)
    got = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, buoy=buoy, src=src, window=window,
                                 n_sub=n_sub)
    ref = advect_multi_3d_plain((1, 2, 3), vel, vel, DT, buoy=buoy, src=src, window=window,
                                n_sub=n_sub)
    assert_equal((got,), (ref,), f"K1 src window={window}")


def test_k8_grid_holds_for_every_variant(cuda):
    """Every instantiation's grid on both routes: the grid-stride one a
    whole number of blocks an SM, the tiled one its tiles at 64³ and 128³."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dtype in (torch.float32, BF16):
        for window in (1, 2, 3, 4, 5):
            for solve_dtype in (None, "bfloat16"):
                blocks = full_step_blocks(solve_dtype, cuda, dtype, window)
                assert blocks > 0 and blocks % sms == 0, (dtype, window, solve_dtype)
                sdt = kresident.solve_torch_dtype(solve_dtype)
                for n in (64, 128):
                    tiles = kresident.solve_tiles(n, sdt, cuda)
                    blocks = full_step_blocks(solve_dtype, cuda, dtype, window, n=n, iters=20)
                    assert blocks == int(np.prod(tiles)) <= sms, (dtype, window, solve_dtype, n)


def test_bf16_wrappers_raise_for_what_they_do_not_take(cuda):
    vel, dens = bf16_fields(16, 1600, cuda)
    with pytest.raises(TypeError):  # the folds take float32
        advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, buoy=(dens, 0.2, 0.0, 0.0))
    with pytest.raises(TypeError):  # one dtype for fields and velocity
        advect_multi_3d_kernel((0,), dens[None], vel.float(), DT)
    with pytest.raises(TypeError):
        project_advect_density_3d(vel, dens, 4, DT, src=emitter(16, cuda))
    with pytest.raises(TypeError):
        project_advect_density_3d(vel, dens.float(), 4, DT)
    with pytest.raises(TypeError):
        full_step_3d(vel.float(), dens, 4, DT)
    with pytest.raises(ValueError, match="window"):
        full_step_3d(vel, dens, 4, DT, window=0)


# -- the bfloat16 and windowed fused paths, FFT and noise, through Engine ------


def _counters():
    return {"K1": advect_multi_3d_kernel, "K2": project_advect_density_3d,
            "K3": project_3d_resident, "K8": full_step_3d}


@pytest.mark.parametrize("name,change,ran", [
    ("bench128", dict(dtype="bfloat16"), {"K1": 5, "K2": 5}),
    ("bench128", dict(dtype="bfloat16", fuse_project_advect=False), {"K1": 10, "K3": 5}),
    ("bench128", dict(dtype="bfloat16", fuse_self_advect=True), {"K8": 5}),
    ("vortex128", dict(dtype="bfloat16"), {"K1": 10, "K3": 5}),
    ("vortex128", dict(dtype="bfloat16", fuse_project_advect=True), {"K1": 5, "K2": 5}),
    ("plume64", dict(advection_scheme="substep", advect_substeps=1,
                     fuse_project_advect=True), {"K1": 5, "K2": 5}),
    ("plume64", dict(advection_scheme="substep", advect_substeps=1,
                     fuse_project_advect=True, fuse_self_advect=True), {"K8": 5}),
    ("bench128", dict(advect_window=2, fuse_emitter=True), {"K1": 5, "K2": 5}),
    ("plume64", dict(advect_window=4), {"K1": 10, "K3": 5}),
    ("bench128", dict(advect_window=4, fuse_emitter=True), {"K1": 5, "K2": 5}),
    ("bench128", dict(advect_window=4, fuse_self_advect=True), {"K8": 5}),
    ("vortex128", dict(advect_window=4, fuse_project_advect=True), {"K1": 5, "K2": 5}),
    ("bench128", dict(advect_window=5, dtype="bfloat16"), {"K1": 5, "K2": 5}),
])
def test_new_paths_match_twin_paths(cuda, name, change, ran):
    """Each new path at 48³ runs exactly its kernels and equals the twin
    path bitwise after 5 steps."""
    preset = {"bench128": CFG, "vortex128": preset_vortex_128(),
              "plume64": preset_plume_64()}[name]
    cfg = preset.replace(size=48, **change)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    before = {k: fn.launches for k, fn in _counters().items()}
    kern.step(5)
    twin.step(5)
    added = {k: fn.launches - before[k] for k, fn in _counters().items()}
    assert added == {k: ran.get(k, 0) for k in added}
    for field in ("density", "velocity", "pressure"):
        got, ref = getattr(kern.state, field), getattr(twin.state, field)
        assert got.dtype == (BF16 if cfg.dtype == "bfloat16" else torch.float32)
        assert torch.equal(got, ref), field


def test_plume64_fused_equals_the_preset(cuda):
    """plume64 with the substep scheme at one substep and the fused kernels
    (K2 with a K = 3 density phase) is the preset's step, bitwise."""
    cfg = preset_plume_64().replace(size=48)
    fused = Engine(cfg.replace(advection_scheme="substep", advect_substeps=1,
                               fuse_project_advect=True), cuda)
    plain = Engine(cfg, cuda)
    fused.step(5)
    plain.step(5)
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(fused.state, field), getattr(plain.state, field)), field


@pytest.mark.parametrize("change", [
    dict(pressure_solver="fft"), dict(apply_turbulent_noise=True)], ids=["fft", "noise"])
def test_fft_and_noise_on_the_card_match_the_cpu(cuda, change):
    """3 plume64 steps at 32³ on the card against the CPU port: rtol 1e-5,
    atol 1e-5·max|ref| (the FFT's reduction order and the card's
    transcendentals differ by float32 ulps)."""
    cfg = preset_plume_64().replace(size=32, **change)
    card, cpu = Engine(cfg, cuda), Engine(cfg, "cpu")
    card.step(3)
    cpu.step(3)
    for field in ("density", "velocity", "pressure"):
        got, ref = getattr(card.state, field).cpu(), getattr(cpu.state, field)
        scale = max(1.0, float(ref.abs().max()))
        assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale), (
            field, float((got - ref).abs().max()))


# -- K5, the sweep-blocked solve, and K14 -------------------------------------


def sweep_counters():
    return {"K1": advect_multi_3d_kernel, "K2": project_advect_density_3d,
            "K3": project_3d_resident, "K8": full_step_3d}


def stage_route(route, iters, block):
    """The (tiled, sweep) counts of one K5 solve of ``iters`` sweeps in
    blocks of ``block`` on ``route``: one tiled launch, or the per-stage
    route with its ``iters % block`` sweeps left to the per-sweep kernel."""
    return (1, 0) if route == "tiled" else (0, iters % block)


@pytest.mark.parametrize("general", [False, True], ids=["poisson", "diffusion"])
@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k5_in_k4_matches_twin(cuda, monkeypatch, route, n, block, general):
    """K4 without a mask in blocks of T, with sweeps left over (2T + 1), on
    the tile program and on the per-stage route ("grid": no tiling)."""
    force_route(monkeypatch, route)
    vel, _ = fields(n, 1700 + n + block, cuda)
    a, c = (0.13, 1.0 + 6 * 0.13) if general else (1.0, 6.0)
    for iters in (block, 2 * block + 1):
        before = k4_counts()
        got = jacobi_3d_resident(0, vel[0], vel[1], a, c, iters, sweep_block=block)
        ran_k4(before, *stage_route(route, iters, block))
        ref = jacobi_3d_resident_plain(0, vel[0], vel[1], a, c, iters, sweep_block=block)
        assert_equal((got,), (ref,), f"K4 T={block} iters={iters}")
    seq = jacobi_3d_resident(0, vel[0], vel[1], a, c, iters)
    assert not torch.equal(got, seq)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k5_in_k3_matches_twin(cuda, monkeypatch, route, n, block, solve_dtype, masked):
    """K3 with T = 2, 3, 4, float32 and bfloat16 solves, with and without
    the mask, at 60 sweeps and at 2T + 1 (sweeps left over), on the tile
    program and on the per-stage route ("grid": no tiling)."""
    force_route(monkeypatch, route)
    vel, _ = fields(n, 1800 + n + block, cuda)
    obst = vortex_mask(n, cuda) if masked else None
    for iters in (60, 2 * block + 1):
        before = solve_counts()
        got = project_3d_resident(vel, iters, obst=obst, solve_dtype=solve_dtype,
                                  damp=DAMP, sweep_block=block)
        ran_route(before, *stage_route(route, iters, block))
        ref = project_3d_resident_plain(vel, iters, obst=obst, solve_dtype=solve_dtype,
                                        damp=DAMP, sweep_block=block)
        assert_equal(got, ref, f"K3 T={block} iters={iters}")
        seq = project_3d_resident(vel, iters, obst=obst, solve_dtype=solve_dtype, damp=DAMP)
        assert not torch.equal(got[1], seq[1])  # the blocks ran


@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("case", ["K2", "K2s", "K2o"])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k5_in_k2_matches_twin(cuda, monkeypatch, route, case, block):
    """K2 with the bench128 preset's bfloat16 solve, K2s and K2o (vortex128's
    mask, three substeps), on the tile program and on the per-stage route
    ("grid": no tiling)."""
    force_route(monkeypatch, route)
    n = 32
    vel, dens = fields(n, 1900 + block, cuda)
    vel = vel * 0.3
    kw = {"K2": dict(solve_dtype="bfloat16"), "K2s": dict(src=emitter(n, cuda)),
          "K2o": dict(obst=vortex_mask(n, cuda), n_sub=3)}[case]
    before = solve_counts()
    got = project_advect_density_3d(vel, dens, 60, DT, damp=DAMP, dens_damp=DDAMP,
                                    sweep_block=block, **kw)
    ran_route(before, *stage_route(route, 60, block))
    ref = project_advect_density_3d_plain(vel, dens, 60, DT, damp=DAMP, dens_damp=DDAMP,
                                          sweep_block=block, **kw)
    assert_equal(got, ref, f"{case} T={block}")
    seq = project_advect_density_3d(vel, dens, 60, DT, damp=DAMP, dens_damp=DDAMP, **kw)
    assert not torch.equal(got[1], seq[1])  # the blocks ran


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k5_in_k8_matches_twin_and_k1_then_k2(cuda, monkeypatch, route, block, solve_dtype):
    """K8 with K5's blocks on its tiled route (the tile program) and on its
    grid-stride route (a grid barrier a stage)."""
    force_route(monkeypatch, route)
    n = 32
    vel, dens = fields(n, 2000 + block, cuda)
    vel = vel * 0.3
    before = dict(kresident.full_step_launches)
    got = full_step_3d(vel, dens, 60, DT, n_sub=2, solve_dtype=solve_dtype, damp=DAMP,
                       dens_damp=DDAMP, sweep_block=block)
    assert route_of(kresident.full_step_launches, before) == [route]
    ref = full_step_3d_plain(vel, dens, 60, DT, n_sub=2, solve_dtype=solve_dtype,
                             damp=DAMP, dens_damp=DDAMP, sweep_block=block)
    assert_equal(got, ref, f"K8 T={block}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=2)
    two = project_advect_density_3d(adv, dens, 60, DT, n_sub=2, solve_dtype=solve_dtype,
                                    damp=DAMP, dens_damp=DDAMP, sweep_block=block)
    assert_equal(got, two, f"K8 T={block} vs K1 + K2")
    seq = full_step_3d(vel, dens, 60, DT, n_sub=2, solve_dtype=solve_dtype, damp=DAMP,
                       dens_damp=DDAMP)
    assert not torch.equal(got[1], seq[1])  # the blocks ran


@pytest.mark.parametrize("window,n_sub", [(1, 1), (1, 2), (2, 1), (3, 2), (4, 1), (5, 2)])
def test_k14_matches_twin_and_k1_then_k3(cuda, window, n_sub):
    n = 32
    vel, _ = fields(n, 2100 + window + n_sub, cuda)
    vel = vel * 0.3
    got = advect_project_3d_resident(vel, 20, DT, window=window, n_sub=n_sub)
    ref = advect_project_3d_resident_plain(vel, 20, DT, window=window, n_sub=n_sub)
    assert_equal(got, ref, f"K14 window={window}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=n_sub, window=window)
    assert_equal(got, project_3d_resident(adv, 20), f"K14 window={window} vs K1 + K3")


@pytest.mark.parametrize("name,change,ran", [
    ("bench128", dict(jacobi_sweep_block=2), {"K1": 5, "K2": 5}),
    ("bench128", dict(jacobi_sweep_block=4), {"K1": 5, "K2": 5}),
    ("bench128", dict(jacobi_sweep_block=4, fuse_self_advect=True), {"K8": 5}),
    ("vortex128", dict(jacobi_sweep_block=2), {"K1": 10, "K3": 5}),
    ("vortex128", dict(jacobi_sweep_block=2, fuse_project_advect=True), {"K1": 5, "K2": 5}),
])
def test_sweep_block_paths_match_twin_paths(cuda, name, change, ran):
    """Each sweep-blocked path at 48³ runs exactly its kernels and equals the
    twin path bitwise after 5 steps."""
    preset = {"bench128": CFG, "vortex128": preset_vortex_128()}[name]
    cfg = preset.replace(size=48, **change)
    kern, twin = Engine(cfg, cuda), Engine(cfg, cuda, kernels=PLAIN_TWINS)
    before = {k: fn.launches for k, fn in sweep_counters().items()}
    kern.step(5)
    twin.step(5)
    added = {k: fn.launches - before[k] for k, fn in sweep_counters().items()}
    assert added == {k: ran.get(k, 0) for k in added}
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(kern.state, field), getattr(twin.state, field)), field


# -- K10 and K11, the per-shard kernels of the explicit halo-exchange step ----

def ext_slab(v, shard, lz, h):
    """Shard ``shard``'s halo-extended slab of the global ``v`` (z on axis -3):
    its lz planes between h planes of each neighbour, zeros past the ends."""
    pad = torch.zeros_like(v.narrow(-3, 0, h))
    return torch.cat([pad, v, pad], -3).narrow(-3, shard * lz, lz + 2 * h).contiguous()


RANKS = {"first": 0, "middle": 1, "last": 3}


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("rank", sorted(RANKS))
@pytest.mark.parametrize("t", [2, 3, 4])
def test_k10_matches_twin(cuda, t, rank, b):
    """A shard of 10 planes of a 40³ grid (x-y tiles of 26, the last
    partial), bitwise on every plane of the slab, erosion margin included."""
    n, lz = 40, 10
    vel, _ = fields(n, 2200 + t, cuda)
    x, x0 = ext_slab(vel[0], RANKS[rank], lz, t), ext_slab(vel[1], RANKS[rank], lz, t)
    wall_lo = t if rank == "first" else NO_WALL
    wall_hi = t + lz - 1 if rank == "last" else NO_WALL
    got = jacobi_ext_kernel(x, x0, 1.0, 6.0, t, wall_lo, wall_hi, b)
    ref = jacobi_ext_plain(x, x0, 1.0, 6.0, t, wall_lo, wall_hi, b)
    assert_equal([got], [ref], f"K10 T={t} {rank} b={b}")


@pytest.mark.parametrize("t", [2, 3, 4])
def test_k10_mask_and_chunks_match_twin(cuda, t):
    """With vortex128's sphere at 40³ on every rank kind, and on one slab of
    78 planes (a block owns 39: two chunks) with both walls."""
    n, lz = 40, 10
    vel, _ = fields(n, 2300 + t, cuda)
    obst = vortex_mask(n, cuda)
    for rank, shard in RANKS.items():
        x = ext_slab(torch.where(obst, 0.0, vel[0]), shard, lz, t)
        x0, m = ext_slab(vel[1], shard, lz, t), ext_slab(obst, shard, lz, t)
        walls = (t if rank == "first" else NO_WALL, t + lz - 1 if rank == "last" else NO_WALL)
        assert_equal([jacobi_ext_kernel(x, x0, 1.0, 6.0, t, *walls, 0, m)],
                     [jacobi_ext_plain(x, x0, 1.0, 6.0, t, *walls, 0, m)], f"K10 mask {rank}")
    deep, _ = fields(24, 2400 + t, cuda)
    x = torch.cat([deep[0], deep[1], deep[2], deep[0][:6]])
    x0 = x.flip(0).contiguous()
    assert_equal([jacobi_ext_kernel(x, x0, 0.13, 1.78, t, t, 77 - t, 3)],
                 [jacobi_ext_plain(x, x0, 0.13, 1.78, t, t, 77 - t, 3)], "K10 two chunks")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_fields", [1, 3])
def test_k11_matches_twin(cuda, n_fields, window, masked):
    """Two substeps on each rank kind's slab of a 40³ grid (10 planes a shard,
    a halo of 2K, or 2(K + 1) with vortex128's sphere), self-advection for
    F = 3, bitwise on every plane."""
    n, lz, n_sub = 40, 10, 2
    vel, dens = fields(n, 2500 + window, cuda)
    vel = vel * 0.3
    obst = vortex_mask(n, cuda) if masked else None
    h = ext_halo(window, n_sub, masked)
    for rank, shard in RANKS.items():
        v = ext_slab(vel, shard, lz, h)
        f = v if n_fields == 3 else ext_slab(dens[None], shard, lz, h)
        m = None if obst is None else ext_slab(obst, shard, lz, h)
        bs = (1, 2, 3) if n_fields == 3 else (0,)
        zoff = shard * lz - h
        got = advect_ext_kernel(bs, f, v, n, DT, zoff, window, n_sub, m)
        ref = advect_ext_plain(bs, f, v, n, DT, zoff, window, n_sub, m)
        assert_equal([got], [ref], f"K11 F={n_fields} K={window} {rank}")


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_solve_and_advection_equal_k6_and_k1(cuda, shards):
    """The per-shard kernels put together equal the whole-grid kernels bitwise
    at 64³: the K10 solve K6's (20 sweeps at T = 2 and 4), the K11 advection
    K1's (two substeps, with vortex128's sphere on 4 shards)."""
    n = 64
    vel, _ = fields(n, 2600 + shards, cuda)
    vel = vel * 0.3
    mesh = make_mesh(["cuda"] * shards)
    div = divergence_3d_plain(vel)
    zero = torch.zeros_like(div)
    k6 = jacobi_3d_kernel(0, zero, div, 1.0, 6.0, 20)
    for t in (2, 4):
        got = jacobi_3d_sharded(zero, div, 1.0, 6.0, 20, mesh, block_iters=t, backend="pallas")
        assert_equal([got], [k6], f"sharded solve T={t}")
    obst = vortex_mask(n, cuda) if shards == 4 else None
    got = advect_multi_3d_sharded((1, 2, 3), vel, vel, DT, mesh, window=1, n_sub=2, obst=obst)
    assert_equal([got], [advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, obst=obst, n_sub=2)],
                 "sharded advection")


@pytest.mark.parametrize("name,t", [("sharded512", 2), ("sharded512", 4), ("vortex128", 2)])
def test_sharded_step_kernel_path_matches_twin_path(cuda, name, t):
    """sharded512 (at 64³) and vortex128 (at 64³, its sphere and three
    substeps) on 4 shards of one card with K10 and K11: exactly iters/T K10
    and two K11 launches a shard and a step, no single-card kernel, and
    bitwise the same path on the twins after 3 steps."""
    preset = {"sharded512": preset_sharded_512, "vortex128": preset_vortex_128}[name]
    cfg = preset().replace(size=64)
    mesh = make_mesh(["cuda"] * 4)
    obst = vortex_mask(64, cuda) if cfg.enable_obstacle else None
    start = shard_state(zeros_state(cfg, cuda, obstacles=obst), mesh)
    kw = dict(halo="explicit", halo_block_iters=t, halo_backend="pallas")
    step, twin = sharded_step_fn(cfg, mesh, **kw), sharded_step_fn(cfg, mesh, kernels=PLAIN_TWINS, **kw)
    counters = dict(sweep_counters(), K10=jacobi_ext_kernel, K11=advect_ext_kernel,
                    K6=jacobi_3d_kernel, K4=jacobi_3d_resident)
    before = {k: fn.launches for k, fn in counters.items()}
    a = b = start
    for _ in range(3):
        a, b = step(a), twin(b)
    added = {k: fn.launches - before[k] for k, fn in counters.items()}
    want = {"K10": 3 * 4 * cfg.jacobi_iters // t, "K11": 3 * 4 * 2}
    assert added == {k: want.get(k, 0) for k in added}
    a, b = unshard_state(a), unshard_state(b)
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert float(a.density.sum()) > 0.0


def test_ext_wrappers_raise_for_cuda_tensors_they_cannot_take(cuda):
    """K10 and K11 on CUDA tensors launch or raise: a type, a shape or a
    device the kernel does not take never reaches the twin."""
    vel, _ = fields(16, 2700, cuda)
    with pytest.raises(TypeError):
        jacobi_ext_kernel(vel[0].double(), vel[1].double(), 1.0, 6.0, 2, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="wall_hi"):
        jacobi_ext_kernel(vel[0], vel[1], 1.0, 6.0, 2, NO_WALL, 16)
    with pytest.raises(ValueError, match="one device"):
        jacobi_ext_kernel(vel[0], vel[1], 1.0, 6.0, 2, NO_WALL, NO_WALL,
                          obst_ext=torch.zeros(16, 16, 16, dtype=torch.bool))
    with pytest.raises(ValueError, match="slab too small"):
        thin = vel[:, :4].contiguous()
        advect_ext_kernel((1, 2, 3), thin, thin, 16, DT, 0, window=2)
    with pytest.raises(ValueError, match="contiguous"):
        advect_ext_kernel((0,), vel[:1].transpose(2, 3), vel, 16, DT, 0)
    with pytest.raises(TypeError):
        advect_ext_kernel((0,), vel[:1].half(), vel, 16, DT, 0)


# -- K12, K13 and K11 on bfloat16: the "rdma" backend and bf16 fields --------

def shard_slabs(v, shards, h):
    """Every shard's halo-extended slab of the global (nz, n, n) ``v``."""
    lz = v.shape[0] // shards
    return [ext_slab(v, r, lz, h) for r in range(shards)]


@pytest.mark.parametrize("b,masked", [(0, False), (1, False), (2, False), (3, False),
                                      (0, True)])
@pytest.mark.parametrize("t", [2, 3, 4, 7])
def test_k12_matches_twin(cuda, t, b, masked):
    """Two chained rounds on 4 shards of a 40³ grid (10 planes a shard):
    every rank kind, bitwise on every plane of every shard's next slab, and
    the kept planes bitwise K10's.  T <= 4 is one pass, T = 7 two (four
    sweeps into the scratch, then three into the output)."""
    n, shards, lz = 40, 4, 10
    vel, _ = fields(n, 2800 + t + b, cuda)
    obst = vortex_mask(n, cuda) if masked else None
    x = vel[0] if obst is None else torch.where(obst, 0.0, vel[0])
    xps, x0s = shard_slabs(x, shards, t), shard_slabs(vel[1], shards, t)
    ms = None if obst is None else shard_slabs(obst, shards, t)
    for rnd in range(2):
        got = jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t, b, ms)
        ref = jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t, b, ms)
        assert_equal(got, ref, f"K12 T={t} b={b} round {rnd}")
        for r in range(shards):
            walls = (t if r == 0 else NO_WALL, t + lz - 1 if r == shards - 1 else NO_WALL)
            k10 = jacobi_ext_kernel(xps[r], x0s[r], 1.0, 6.0, t, *walls, b,
                                    None if ms is None else ms[r])
            assert_equal([got[r][t:t + lz]], [k10[t:t + lz]], f"K12 vs K10 shard {r}")
        xps = got


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_k13_matches_twin(cuda, shards, depth):
    """Several arrays a call: float32 channels as views of a global tensor,
    bfloat16 and the bool mask on 40² planes (16-byte moves), and a bool
    mask on 7² planes (49 bytes: the byte path); bitwise on every plane of
    every output."""
    n = 40
    vel, dens = fields(n, 2900 + shards + depth, cuda)
    calls = ([vel, dens[None].to(torch.bfloat16), vel[:1] > 0.0],
             [(dens[None, :, :7, :7] > 3.0).contiguous()])
    for arrays in calls:
        by_shard = [[torch.chunk(a, shards, 1)[r] for a in arrays] for r in range(shards)]
        got = halo_exchange_rdma(by_shard, depth)
        ref = halo_exchange_rdma_plain(by_shard, depth)
        for r in range(shards):
            assert [g.dtype for g in got[r]] == [a.dtype for a in arrays]
            assert_equal(got[r], ref[r], f"K13 {len(arrays)} arrays, shard {r}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_fields", [1, 3])
def test_k11_bf16_matches_twin(cuda, n_fields, window, masked):
    """K11 on bfloat16 slabs, as test_k11_matches_twin: two substeps on each
    rank kind's slab of a 40³ grid, bitwise on every plane."""
    n, lz, n_sub = 40, 10, 2
    vel, dens = fields(n, 3000 + window, cuda)
    vel, dens = (vel * 0.3).to(torch.bfloat16), dens.to(torch.bfloat16)
    obst = vortex_mask(n, cuda) if masked else None
    h = ext_halo(window, n_sub, masked)
    for rank, shard in RANKS.items():
        v = ext_slab(vel, shard, lz, h)
        f = v if n_fields == 3 else ext_slab(dens[None], shard, lz, h)
        m = None if obst is None else ext_slab(obst, shard, lz, h)
        bs = (1, 2, 3) if n_fields == 3 else (0,)
        zoff = shard * lz - h
        got = advect_ext_kernel(bs, f, v, n, DT, zoff, window, n_sub, m)
        ref = advect_ext_plain(bs, f, v, n, DT, zoff, window, n_sub, m)
        assert got.dtype == torch.bfloat16
        assert_equal([got], [ref], f"K11 bf16 F={n_fields} K={window} {rank}")


@pytest.mark.parametrize("shards", [4, 8])
def test_rdma_solve_and_advection_equal_pallas(cuda, shards):
    """At 64³ the rdma solve (K13, then K12 rounds) equals the pallas solve
    and K6 bitwise, with and without the mask; the rdma advection (K13, then
    K11) equals the ppermute advection, float32 and bfloat16."""
    n = 64
    vel, dens = fields(n, 3100 + shards, cuda)
    vel = vel * 0.3
    mesh = make_mesh(["cuda"] * shards)
    div = divergence_3d_plain(vel)
    zero = torch.zeros_like(div)
    k6 = jacobi_3d_kernel(0, zero, div, 1.0, 6.0, 20)
    obst = vortex_mask(n, cuda)
    for t in (2, 4):
        got = jacobi_3d_sharded(zero, div, 1.0, 6.0, 20, mesh, block_iters=t, backend="rdma")
        assert_equal([got], [k6], f"rdma solve T={t}")
        kw = dict(block_iters=t, obst=obst)
        assert_equal([jacobi_3d_sharded(zero, div, 1.0, 6.0, 20, mesh, backend="rdma", **kw)],
                     [jacobi_3d_sharded(zero, div, 1.0, 6.0, 20, mesh, backend="pallas", **kw)],
                     f"rdma solve with the mask T={t}")
    for dtype in (torch.float32, torch.bfloat16):
        v, d = vel.to(dtype), dens[None].to(dtype)
        for bs, f, m in (((1, 2, 3), v, None), ((0,), d, None), ((1, 2, 3), v, obst)):
            kw = dict(window=1, n_sub=2, obst=m)
            if m is not None and shards == 8:
                continue  # a 4-plane halo on 8-plane shards
            assert_equal([advect_multi_3d_sharded(bs, f, v, DT, mesh, transport="rdma", **kw)],
                         [advect_multi_3d_sharded(bs, f, v, DT, mesh, **kw)],
                         f"rdma advection {dtype} {bs}")


RDMA_COUNTERS = dict(K10=jacobi_ext_kernel, K11=advect_ext_kernel, K12=jacobi_ext_rdma,
                     K13=halo_exchange_rdma, K6=jacobi_3d_kernel, K4=jacobi_3d_resident)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,t", [("sharded512", 2), ("sharded512", 4), ("vortex128", 2)])
def test_rdma_step_matches_pallas_step_and_twin_path(cuda, name, t, dtype):
    """sharded512 and vortex128 at 64³ on 4 shards with halo_backend="rdma":
    exactly iters/T K12, three K13 (the solve's priming and the two
    advections' slabs; six with vortex128's mask, whose gradient takes the
    velocity's and the pressure's halos for the obstacle mirror, and its
    confinement, whose velocity takes a two-plane halo) and two K11
    launches a shard and a step and no K10;
    bitwise the "pallas" step and the rdma path on the twins after 3 steps;
    the "pallas" bf16 step bitwise its twin path too."""
    preset = {"sharded512": preset_sharded_512, "vortex128": preset_vortex_128}[name]
    cfg = preset().replace(size=64, dtype=dtype)
    mesh = make_mesh(["cuda"] * 4)
    obst = vortex_mask(64, cuda) if cfg.enable_obstacle else None
    start = shard_state(zeros_state(cfg, cuda, obstacles=obst), mesh)
    kw = dict(halo="explicit", halo_block_iters=t)
    rdma = sharded_step_fn(cfg, mesh, halo_backend="rdma", **kw)
    pallas = sharded_step_fn(cfg, mesh, halo_backend="pallas", **kw)
    twins = {backend: sharded_step_fn(cfg, mesh, halo_backend=backend, kernels=PLAIN_TWINS, **kw)
             for backend in ("rdma", "pallas")}
    counters = dict(sweep_counters(), **RDMA_COUNTERS)
    before = {k: fn.launches for k, fn in counters.items()}
    a = start
    for _ in range(3):
        a = rdma(a)
    added = {k: fn.launches - before[k] for k, fn in counters.items()}
    k13 = 3 + 2 * cfg.enable_obstacle + (cfg.vorticity_confinement != 0.0)
    want = {"K12": 3 * 4 * cfg.jacobi_iters // t, "K13": 3 * 4 * k13, "K11": 3 * 4 * 2}
    assert added == {k: want.get(k, 0) for k in added}
    p = tr = tp = start
    for _ in range(3):
        p, tr, tp = pallas(p), twins["rdma"](tr), twins["pallas"](tp)
    a, p, tr, tp, start = (unshard_state(x) for x in (a, p, tr, tp, start))
    for field in ("density", "velocity", "pressure"):
        got = getattr(a, field)
        assert got.dtype == getattr(start, field).dtype
        for what, ref in (("pallas", p), ("twin path", tr), ("pallas twin path", tp)):
            assert torch.equal(got, getattr(ref, field)), (field, what)
    assert float(a.density.float().sum()) > 0.0


def shard_planes(v, shards, shard):
    """Shard ``shard``'s planes of the global ``(..., n, n, n)`` field ``v``,
    the halo planes ``(below, above)`` of its last component (None past the
    global ends), and its walls."""
    lz = v.shape[-3] // shards
    own = v.narrow(-3, shard * lz, lz).contiguous()
    last = v.reshape(-1, *v.shape[-3:])[-1]
    halo = (last[shard * lz - 1].contiguous() if shard > 0 else None,
            last[(shard + 1) * lz].contiguous() if shard < shards - 1 else None)
    return own, halo, (0 if shard == 0 else NO_WALL, lz - 1 if shard == shards - 1 else NO_WALL)


@pytest.mark.parametrize("n,shards,shard", [(512, 8, 0), (512, 8, 3), (512, 8, 7),
                                            (128, 4, 0), (128, 4, 1), (128, 4, 2),
                                            (128, 4, 3)])
def test_k7e_matches_twin(cuda, n, shards, shard):
    """K7e's divergence and gradient bitwise their twins on sharded512's
    first, a middle and the last slab at 512³ and on every shard of a
    4-shard split of 128³, the velocity contiguous and a view with a wider
    component stride; each launch counted once."""
    g = torch.Generator(device=cuda).manual_seed(3300 + n + shard)
    vel = torch.randn((3, n, n, n), device=cuda, generator=g)
    p = torch.randn((n, n, n), device=cuda, generator=g)
    v, vz_halo, walls = shard_planes(vel, shards, shard)
    q, p_halo, _ = shard_planes(p, shards, shard)
    # The velocity as contiguous planes and as the step passes it: K11's kept
    # planes, a view of a wider slab.
    wide = torch.zeros((3, n // shards + 4, n, n), device=cuda)
    wide[:, 2:-2] = v
    before = divergence_ext_kernel.launches, gradient_ext_kernel.launches
    for vel_in in (v, wide[:, 2:-2]):
        assert_equal([divergence_ext_kernel(vel_in, *vz_halo, *walls),
                      gradient_ext_kernel(vel_in, q, *p_halo, *walls)],
                     [divergence_ext_plain(v, *vz_halo, *walls),
                      gradient_ext_plain(v, q, *p_halo, *walls)],
                     f"K7e {n} shard {shard}")
    assert (divergence_ext_kernel.launches, gradient_ext_kernel.launches) == (
        before[0] + 2, before[1] + 2)
    with pytest.raises(ValueError, match="wall_lo"):
        divergence_ext_kernel(v, *vz_halo, 2, NO_WALL)
    with pytest.raises(TypeError):
        gradient_ext_kernel(v.double(), q.double(), *p_halo, *walls)


@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_8_shard_step_launches_per_shard(cuda, backend):
    """sharded512 (at 128³) on 8 shards at T = 4: each step launches, per
    shard, iters/T K10 (pallas) or K12 (rdma) rounds, two K11, one K7e
    divergence and one K7e gradient, and on rdma three K13; no single-card
    kernel; no op gathers a whole volume; bitwise the twin path after 2
    steps."""
    cfg = preset_sharded_512().replace(size=128)
    mesh = make_mesh(["cuda"] * 8)
    start = shard_state(zeros_state(cfg, cuda), mesh)
    kw = dict(halo="explicit", halo_block_iters=4, halo_backend=backend)
    counters = dict(sweep_counters(), **RDMA_COUNTERS, K7d=divergence_ext_kernel,
                    K7g=gradient_ext_kernel)
    before = {k: fn.launches for k, fn in counters.items()}
    gathered_ops.clear()
    step = sharded_step_fn(cfg, mesh, **kw)
    a = step(step(start))
    added = {k: fn.launches - before[k] for k, fn in counters.items()}
    rounds = 2 * 8 * cfg.jacobi_iters // 4
    want = {"K11": 2 * 8 * 2, "K7d": 2 * 8, "K7g": 2 * 8}
    want.update({"K12": rounds, "K13": 2 * 8 * 3} if backend == "rdma" else {"K10": rounds})
    assert added == {k: want.get(k, 0) for k in added}
    assert sum(gathered_ops.values()) == 0
    assert all(s.density.device == d for s, d in zip(a.slabs, mesh.devices))
    twin = sharded_step_fn(cfg, mesh, kernels=PLAIN_TWINS, **kw)
    b = twin(twin(start))
    a, b = unshard_state(a), unshard_state(b)
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_rdma_wrappers_raise_for_cuda_tensors_they_cannot_take(cuda):
    """K12 and K13 on CUDA tensors launch or raise: a type, a layout, a shape
    or a device the kernel does not take never reaches the twin."""
    vel, _ = fields(16, 3200, cuda)
    xps = shard_slabs(vel[0], 2, 2)
    with pytest.raises(TypeError):
        jacobi_ext_rdma([x.double() for x in xps], [x.double() for x in xps], 1.0, 6.0, 2)
    with pytest.raises(ValueError, match="lz >= T"):
        jacobi_ext_rdma(xps, xps, 1.0, 6.0, 5)
    with pytest.raises(ValueError, match="one device"):
        jacobi_ext_rdma(xps, [x.cpu() for x in xps], 1.0, 6.0, 2)
    with pytest.raises(ValueError, match="one slab per shard"):
        jacobi_ext_rdma(xps, xps[:1], 1.0, 6.0, 2)
    halves = [[h] for h in torch.chunk(vel, 2, 1)]
    with pytest.raises(TypeError):
        halo_exchange_rdma([[h[0].double()] for h in halves], 2)
    with pytest.raises(ValueError, match="contiguous"):
        halo_exchange_rdma([[h[0].transpose(2, 3)] for h in halves], 2)
    with pytest.raises(RuntimeError, match="halo exchange kernel launch"):
        halo_exchange_rdma([h * 5 for h in halves], 2)
    with pytest.raises(ValueError, match="local slab depth"):
        halo_exchange_rdma(halves, 9)
    with pytest.raises(ValueError, match="geometry"):
        halo_exchange_rdma([h + [h[0][:, :4]] for h in halves], 2)
    with pytest.raises(ValueError, match="one device"):
        halo_exchange_rdma([halves[0], [halves[1][0].cpu()]], 2)


# -- the tiled solve of K2 and K3 (csrc/solve_tiled.cuh) ------------------------


def solve_counts():
    return dict(kresident.solve_launches)


def ran_route(before, tiled, sweeps):
    after = solve_counts()
    assert {k: after[k] - before[k] for k in after} == {"tiled": tiled, "sweep": sweeps}


@pytest.mark.parametrize("iters", [1, 2, 59, 60])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n", [8, 31, 64, 97, 128])
def test_tiled_k3_matches_twin(cuda, n, solve_dtype, masked, iters):
    vel, _ = fields(n, 1300 + n, cuda)
    obst = vortex_mask(n, cuda) if masked else None
    for v in (vel, vel.to(BF16)):
        before = solve_counts()
        got = project_3d_resident(v, iters, obst=obst, solve_dtype=solve_dtype, damp=DAMP)
        ran_route(before, 1, 0)
        ref = project_3d_resident_plain(v, iters, obst=obst, solve_dtype=solve_dtype,
                                        damp=DAMP)
        assert_equal(got, ref, f"K3 {v.dtype}")


@pytest.mark.parametrize("iters", [1, 2, 59, 60])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n", [8, 31, 64, 97, 128])
@pytest.mark.parametrize("case", ["K2", "K2s", "K2o"])
def test_tiled_k2_variants_match_twin(cuda, case, n, solve_dtype, iters):
    vel, dens = fields(n, 1400 + n, cuda)
    vel = vel * 0.1
    kw = {"K2": {}, "K2s": {"src": emitter(n, cuda)},
          "K2o": {"obst": vortex_mask(n, cuda), "n_sub": 3}}[case]
    before = solve_counts()
    got = project_advect_density_3d(vel, dens, iters, DT, solve_dtype=solve_dtype, damp=DAMP,
                                    dens_damp=DDAMP, **kw)
    ran_route(before, 1, 0)
    ref = project_advect_density_3d_plain(vel, dens, iters, DT, solve_dtype=solve_dtype,
                                          damp=DAMP, dens_damp=DDAMP, **kw)
    assert_equal(got, ref, case)


@pytest.mark.parametrize("n,tiles", [(40, (2, 2, 2)), (64, (3, 4, 5)), (29, (2, 9, 2)),
                                     (33, (7, 2, 3))])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_tiled_solve_at_forced_coarse_tilings(cuda, monkeypatch, n, tiles, solve_dtype):
    """Multi-tile waits and ragged tiles: a tiling the gate would not pick."""
    monkeypatch.setattr(kresident, "solve_tiles", lambda *args: tiles)
    vel, dens = fields(n, 1500 + n, cuda)
    obst = vortex_mask(n, cuda)
    for mask in (None, obst):
        got = project_3d_resident(vel, 23, obst=mask, solve_dtype=solve_dtype, damp=DAMP)
        ref = project_3d_resident_plain(vel, 23, obst=mask, solve_dtype=solve_dtype, damp=DAMP)
        assert_equal(got, ref, f"K3 {tiles} mask={mask is not None}")
    got = project_advect_density_3d(vel * 0.1, dens, 23, DT, solve_dtype=solve_dtype)
    ref = project_advect_density_3d_plain(vel * 0.1, dens, 23, DT, solve_dtype=solve_dtype)
    assert_equal(got, ref, f"K2 {tiles}")


def test_tiled_solve_repeats_bitwise(cuda):
    """A race between a block and its neighbours' face slots would flip a
    bit now and then: 100 calls on one input, each the first's."""
    vel, dens = fields(128, 1600, cuda)
    vel = vel * 0.1
    first = project_advect_density_3d(vel, dens, 60, DT, solve_dtype="bfloat16",
                                      damp=DAMP, dens_damp=DDAMP)
    torch.cuda.synchronize()
    for call in range(100):
        again = project_advect_density_3d(vel, dens, 60, DT, solve_dtype="bfloat16",
                                          damp=DAMP, dens_damp=DDAMP)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), call


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_tiled_k2_is_k3_then_k1(cuda, solve_dtype):
    vel, dens = fields(128, 1700, cuda)
    vel = vel * 0.1
    v2, p2, d2 = project_advect_density_3d(vel, dens, 60, DT, solve_dtype=solve_dtype,
                                           damp=DAMP)
    v3, p3 = project_3d_resident(vel, 60, solve_dtype=solve_dtype, damp=DAMP)
    d1 = advect_multi_3d_kernel((0,), dens[None], v3, DT)[0]
    assert_equal((v2, p2, d2), (v3, p3, d1), "K2 vs K3 -> K1")


@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_gate_refusal_takes_the_per_sweep_route(cuda, solve_dtype):
    """176³ needs more than a tile an SM: the per-sweep kernel runs, decided
    before the launch, and the counts say so; K5 (sweep_block 2) where its
    tile program does not fit (144³ float32, 160³ bfloat16: the iterate and
    the chain buffer over the opt-in) takes the per-stage route and leaves
    iters % 2 sweeps to the per-sweep kernel."""
    n = 176
    sdt = kresident.solve_torch_dtype(solve_dtype)
    assert kresident.solve_tiles(n, sdt, cuda) is None
    vel, _ = fields(n, 1800, cuda)
    before = solve_counts()
    got = project_3d_resident(vel, 20, solve_dtype=solve_dtype)
    ran_route(before, 0, 20)
    assert_equal(got, project_3d_resident_plain(vel, 20, solve_dtype=solve_dtype), "K3 176")
    n = 144 if solve_dtype is None else 160
    assert kresident.projection_tiles(n, torch.float32, 21, 2, sdt, cuda) is None
    vel, _ = fields(n, 1801, cuda)
    before = solve_counts()
    got = project_3d_resident(vel, 21, solve_dtype=solve_dtype, sweep_block=2)
    ran_route(before, 0, 1)
    assert_equal(got, project_3d_resident_plain(vel, 21, solve_dtype=solve_dtype,
                                                sweep_block=2), "K5 in K3")


def test_tiled_solve_refuses_a_tiling_it_cannot_take(cuda, monkeypatch):
    """A tiling of more columns than a block holds is refused by the C entry
    and raises: no fallback."""
    monkeypatch.setattr(kresident, "solve_tiles", lambda *args: (1, 1, 1))
    vel, _ = fields(64, 1900, cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        project_3d_resident(vel, 20)


# -- K1 and K11 at K = 1 on tiles (csrc/advect_tiled.cuh) ----------------------


def advect_counts():
    return dict(kadvect.advect_launches)


def ran_advect(before, tiled, cell, window=0):
    after = advect_counts()
    assert {k: after[k] - before[k] for k in after} == {"tiled": tiled, "window": window,
                                                        "cell": cell}


# Ragged sizes (a tile's last columns, rows and planes partial; n = 3 and 5
# inside one tile) and the presets' 128³ and 256³.
TILED_SIZES = [3, 5, 37, 130, 128, 256]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["F3", "F1", "F3-mask", "F1-mask"])
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("n", TILED_SIZES)
def test_tiled_k1_matches_twin(cuda, n, n_sub, case, dtype):
    """Every unfolded K = 1 instantiation: F = 3 and 1, with and without
    vortex128's mask, float32 and the four bfloat16 roles."""
    vel, dens = fields(n, 4000 + n + n_sub, cuda)
    vel, dens = (vel * 0.3).to(dtype), dens.to(dtype)
    obst = vortex_mask(n, cuda) if case.endswith("mask") else None
    bs, f = ((1, 2, 3), vel) if case.startswith("F3") else ((0,), dens[None])
    before = advect_counts()
    got = advect_multi_3d_kernel(bs, f, vel, DT, obst=obst, n_sub=n_sub)
    ran_advect(before, n_sub, 0)
    ref = advect_multi_3d_plain(bs, f, vel, DT, obst=obst, n_sub=n_sub)
    assert got.dtype == dtype
    assert_equal([got], [ref], f"K1 {case} {dtype}")


@pytest.mark.parametrize("src", [False, True], ids=["buoy", "buoy-src"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("n", TILED_SIZES)
def test_tiled_k1_buoyancy_matches_twin(cuda, n, n_sub, src):
    """The buoyancy on the staged y component (and the emitter on its
    density) in the first substep, at the cell in every substep."""
    vel, dens = fields(n, 4100 + n + n_sub, cuda)
    buoy = (dens, 0.2, 0.1, 0.05)
    e = emitter(n, cuda) if src else None
    before = advect_counts()
    got = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, buoy=buoy, n_sub=n_sub, src=e)
    ran_advect(before, n_sub, 0)
    ref = advect_multi_3d_plain((1, 2, 3), vel, vel, DT, buoy=buoy, n_sub=n_sub, src=e)
    assert_equal([got], [ref], f"K1 buoyancy src={src}")


@pytest.mark.parametrize("case", ["K2", "K2s", "K2o"])
@pytest.mark.parametrize("n", [5, 37, 130, 128])
def test_tiled_density_phase_matches_twin(cuda, n, case):
    """K2's density phase launches K1's entry: on tiles at K = 1, with the
    emitter on the staged density (K2s), the mask and three substeps (K2o),
    and the damping as the last substep's scale."""
    vel, dens = fields(n, 4200 + n, cuda)
    vel = vel * 0.1
    kw = {"K2": {}, "K2s": {"src": emitter(n, cuda)},
          "K2o": {"obst": vortex_mask(n, cuda), "n_sub": 3}}[case]
    before = advect_counts()
    got = project_advect_density_3d(vel, dens, 20, DT, solve_dtype="bfloat16", damp=DAMP,
                                    dens_damp=DDAMP, **kw)
    ran_advect(before, kw.get("n_sub", 1), 0)
    ref = project_advect_density_3d_plain(vel, dens, 20, DT, solve_dtype="bfloat16",
                                          damp=DAMP, dens_damp=DDAMP, **kw)
    assert_equal(got, ref, case)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("n,lz", [(37, 9), (130, 32)])
def test_tiled_k11_matches_twin(cuda, n, lz, n_sub, masked, dtype):
    """K11 at K = 1 on each rank kind's slab (the global walls inside slabs
    with zoff != 0), bitwise on every plane, erosion margin included."""
    vel, dens = fields(n, 4300 + n + n_sub, cuda)
    vel, dens = (vel * 0.3).to(dtype), dens.to(dtype)
    obst = vortex_mask(n, cuda) if masked else None
    h = ext_halo(1, n_sub, masked)
    for rank, shard in RANKS.items():
        v = ext_slab(vel, shard, lz, h)
        m = None if obst is None else ext_slab(obst, shard, lz, h)
        zoff = shard * lz - h
        for bs, f in (((1, 2, 3), v), ((0,), ext_slab(dens[None], shard, lz, h))):
            before = advect_counts()
            got = advect_ext_kernel(bs, f, v, n, DT, zoff, 1, n_sub, m)
            ran_advect(before, n_sub, 0)
            ref = advect_ext_plain(bs, f, v, n, DT, zoff, 1, n_sub, m)
            assert_equal([got], [ref], f"K11 F={len(bs)} {rank}")


def test_advect_route_counter_by_window(cuda):
    """K = 1 takes the tiled kernel, K = 2 the windowed tiles, in K1, K11 and
    K2's density phase, a count a substep; past the gate's edge (F = 3 above
    K = 6, F = 1 above K = 11 in the H100's 227 KB) one thread a cell."""
    n = 32
    vel, dens = fields(n, 4400, cuda)
    vel = vel * 0.2
    for window, route in ((1, (2, 0, 0)), (2, (0, 0, 2))):
        before = advect_counts()
        advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, window=window, n_sub=2)
        ran_advect(before, *route)
        before = advect_counts()
        advect_ext_kernel((0,), dens[None], vel, n, DT, 0, window, 2)
        ran_advect(before, *route)
        before = advect_counts()
        project_advect_density_3d(vel, dens, 4, DT, window=window, n_sub=2)
        ran_advect(before, *route)
    for window, n_fields, route in ((6, 3, (0, 0, 1)), (7, 3, (0, 1, 0)), (11, 1, (0, 0, 1)),
                                    (12, 1, (0, 1, 0))):
        assert kadvect.advect_route(window, n_fields) == ("window" if route[2] else "cell")
        bs, f = ((1, 2, 3), vel) if n_fields == 3 else ((0,), dens[None])
        before = advect_counts()
        got = advect_multi_3d_kernel(bs, f, vel, DT, window=window)
        ran_advect(before, *route)
        ref = advect_multi_3d_plain(bs, f, vel, DT, window=window)
        assert_equal([got], [ref], f"K1 F={n_fields} K={window} at the gate's edge")


# -- K1, K2's density phase and K11 at K >= 2 on windowed tiles
# (csrc/advect_window.cuh) ----------------------------------------------------------


def assert_equal_nan(got, ref, what):
    """Bitwise but for NaN payloads: NaN in the same cells, equal elsewhere."""
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.isnan(), r.isnan()), (what, "NaN cells differ")
        g, r = torch.where(g.isnan(), 0.0, g), torch.where(r.isnan(), 0.0, r)
        assert torch.equal(g, r), (what, float((g - r).abs().nan_to_num().max()))


def reach(n, seed, device, cells, n_sub=1):
    """Seeded fields whose velocity backtraces about ``cells`` cells a
    substep."""
    vel, dens = fields(n, seed, device)
    return vel * (cells * n_sub / (5.0 * DT * (n - 2))), dens


# Ragged sizes (a tile's last columns, rows and planes partial; a staged
# region wider than the grid at 11) and the presets' 64³ and 128³.
WIN_SIZES = [11, 37, 64, 130]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["F3", "F1", "F3-mask", "F1-mask"])
@pytest.mark.parametrize("n_sub", [1, 3])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n", WIN_SIZES)
def test_window_tiles_k1_matches_twin(cuda, n, window, n_sub, case, dtype):
    """Every unfolded K >= 2 instantiation on the windowed tiles: F = 3 and
    1, with and without vortex128's mask, float32 and the bfloat16 roles."""
    vel, dens = reach(n, 5000 + n + window, cuda, window + 1, n_sub)
    vel, dens = vel.to(dtype), dens.to(dtype)
    obst = vortex_mask(n, cuda) if case.endswith("mask") else None
    bs, f = ((1, 2, 3), vel) if case.startswith("F3") else ((0,), dens[None])
    before = advect_counts()
    got = advect_multi_3d_kernel(bs, f, vel, DT, obst=obst, window=window, n_sub=n_sub)
    ran_advect(before, 0, 0, n_sub)
    ref = advect_multi_3d_plain(bs, f, vel, DT, obst=obst, window=window, n_sub=n_sub)
    assert got.dtype == dtype
    assert_equal([got], [ref], f"K1 K={window} {case} {dtype}")


@pytest.mark.parametrize("src", [False, True], ids=["buoy", "buoy-src"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [11, 37, 130])
def test_window_tiles_k1_buoyancy_matches_twin(cuda, n, window, n_sub, src):
    """The buoyancy on the staged y component (and the emitter on its
    density) in the first substep, at the cell in every substep."""
    vel, dens = reach(n, 5100 + n + window, cuda, window + 1, n_sub)
    buoy = (dens, 0.2, 0.1, 0.05)
    e = emitter(n, cuda) if src else None
    before = advect_counts()
    got = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, buoy=buoy, n_sub=n_sub, src=e,
                                 window=window)
    ran_advect(before, 0, 0, n_sub)
    ref = advect_multi_3d_plain((1, 2, 3), vel, vel, DT, buoy=buoy, n_sub=n_sub, src=e,
                                window=window)
    assert_equal([got], [ref], f"K1 K={window} buoyancy src={src}")


@pytest.mark.parametrize("case", ["K2", "K2s", "K2o", "K2 bf16"])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [11, 37, 128])
def test_window_tiles_density_phase_matches_twin(cuda, n, window, case):
    """K2's density phase through K1's entry on the windowed tiles: the
    emitter on the staged density (K2s), the mask and three substeps (K2o),
    bfloat16 fields, and the damping as the last substep's scale."""
    n_sub = 3 if case == "K2o" else 1
    vel, dens = reach(n, 5200 + n + window, cuda, window + 1, n_sub)
    if case == "K2 bf16":
        vel, dens = vel.to(BF16), dens.to(BF16)
    kw = {"K2": {}, "K2 bf16": {}, "K2s": {"src": emitter(n, cuda)},
          "K2o": {"obst": vortex_mask(n, cuda), "n_sub": 3}}[case]
    before = advect_counts()
    got = project_advect_density_3d(vel, dens, 20, DT, solve_dtype="bfloat16", damp=DAMP,
                                    dens_damp=DDAMP, window=window, **kw)
    ran_advect(before, 0, 0, n_sub)
    ref = project_advect_density_3d_plain(vel, dens, 20, DT, solve_dtype="bfloat16",
                                          damp=DAMP, dens_damp=DDAMP, window=window, **kw)
    assert_equal(got, ref, f"{case} K={window}")


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n,lz", [(37, 9), (130, 32)])
def test_window_tiles_k11_matches_twin(cuda, n, lz, window, n_sub, masked, dtype):
    """K11 at K >= 2 on each rank kind's slab (z wrapped modulo the slab, the
    global walls inside slabs with zoff != 0), bitwise on every plane."""
    vel, dens = reach(n, 5300 + n + window, cuda, window + 1, n_sub)
    vel, dens = vel.to(dtype), dens.to(dtype)
    obst = vortex_mask(n, cuda) if masked else None
    h = ext_halo(window, n_sub, masked)
    for rank, shard in RANKS.items():
        v = ext_slab(vel, shard, lz, h)
        m = None if obst is None else ext_slab(obst, shard, lz, h)
        zoff = shard * lz - h
        for bs, f in (((1, 2, 3), v), ((0,), ext_slab(dens[None], shard, lz, h))):
            before = advect_counts()
            got = advect_ext_kernel(bs, f, v, n, DT, zoff, window, n_sub, m)
            ran_advect(before, 0, 0, n_sub)
            ref = advect_ext_plain(bs, f, v, n, DT, zoff, window, n_sub, m)
            assert_equal([got], [ref], f"K11 F={len(bs)} K={window} {rank}")


def plant_taps(f, window):
    """NaN and inf at taps the clamp leaves at zero weight for some cells:
    on the far wall columns, rows and planes (read wrapped, past the
    opposite wall) and beyond the window of a still cell (plant_velocity)."""
    f = f.clone()
    n = f.shape[-1]
    c = n // 2
    f[:, c, c - 1, n - 1] = float("inf")
    f[:, c + 1, n - 1, 2] = float("-inf")
    f[:, n - 1, 3, c] = float("nan")
    f[:, c + window, c, c] = float("nan")
    f[:, c, c - window, c + 1] = float("inf")
    return f


def plant_velocity(vel):
    """A still cell (only its own tap has weight) and a NaN backtrace."""
    vel = vel.clone()
    c = vel.shape[-1] // 2
    vel[:, c, c, c] = 0.0
    vel[1, c - 3, c + 2, c] = float("nan")
    return vel


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [33, 64])
def test_window_tiles_non_finite_match_twin(cuda, n, window, n_sub, dtype):
    """Non-finite values at zero-weight taps, inside the grid and at wrapped
    positions, and a NaN velocity: the full sum from the staged planes gives
    the twin's NaN and inf cells and its values elsewhere (K1, K11, and K2's
    density phase)."""
    vel, dens = reach(n, 5400 + n + window, cuda, window + 1, n_sub)
    vel, dens = vel.to(dtype), dens.to(dtype)
    v3 = plant_velocity(plant_taps(vel, window))
    v1, d1 = plant_velocity(vel), plant_taps(dens[None], window)
    for bs, f, v in (((1, 2, 3), v3, v3), ((0,), d1, v1)):
        before = advect_counts()
        got = advect_multi_3d_kernel(bs, f, v, DT, window=window, n_sub=n_sub)
        ran_advect(before, 0, 0, n_sub)
        ref = advect_multi_3d_plain(bs, f, v, DT, window=window, n_sub=n_sub)
        assert bool(ref.isnan().any()) and bool(torch.isfinite(ref).any())
        assert_equal_nan([got], [ref], f"K1 F={len(bs)} K={window} non-finite")
        fe, ve = f[:, 2:n - 2].contiguous(), v[:, 2:n - 2].contiguous()
        before = advect_counts()
        got = advect_ext_kernel(bs, fe, ve, n, DT, 2, window, n_sub)
        ran_advect(before, 0, 0, n_sub)
        ref = advect_ext_plain(bs, fe, ve, n, DT, 2, window, n_sub)
        assert_equal_nan([got], [ref], f"K11 F={len(bs)} K={window} non-finite")
    got = project_advect_density_3d(vel, d1[0], 4, DT, window=window, n_sub=n_sub)
    ref = project_advect_density_3d_plain(vel, d1[0], 4, DT, window=window, n_sub=n_sub)
    assert_equal_nan(got, ref, f"K2 K={window} non-finite")


# -- the Jacobi round of K6, K10 and K12 (csrc/jacobi_pass.cuh) -------------------

ROUND_N = [3, 5, 33, 130, 256]


def round_launches(fn):
    """The kernels ``fn()`` launched, by name, from ``torch.profiler``'s
    kernel events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = "round" if "jacobi_round_kernel" in evt.name else evt.name
            names[key] = names.get(key, 0) + 1
    return names


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5, 6, 7, 8, 9, 20])
@pytest.mark.parametrize("n", ROUND_N)
def test_round_k6_matches_twin(cuda, n, iters):
    """K6 at every sweep count up to two and a bit passes and at the
    projection's 20 (five passes of four), b = 0 and 3, bitwise."""
    vel, _ = fields(n, 4500 + n + iters, cuda)
    for b, a, c in ((0, 1.0, 6.0), (3, 0.13, 1.0 + 6 * 0.13)):
        got = jacobi_3d_kernel(b, vel[0], vel[1], a, c, iters)
        ref = jacobi_3d_plain(b, vel[0], vel[1], a, c, iters)
        assert_equal([got], [ref], f"K6 n={n} iters={iters} b={b}")


# n, lz: the slabs' z-chunks (launch_round's, on 132 SMs) run from one (n = 3)
# through two to four (n = 33, 256) to ten and more (n = 5, 130: few x-y tiles,
# chunks of 8 planes or more).
ROUND_SLABS = [(3, 6), (5, 160), (33, 20), (130, 80), (256, 16)]


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n,lz", ROUND_SLABS)
def test_round_k10_matches_twin(cuda, n, lz, t, masked):
    """K10 on (lz + 2T, n, n) slabs cut into one or several z-chunks, every
    rank kind's walls, b = 0 (with the mask) and b = 1..3, bitwise."""
    nz = lz + 2 * t
    rng = np.random.default_rng(4600 + n + lz + t)
    x = torch.from_numpy(rng.standard_normal((nz, n, n)).astype(np.float32)).to(cuda)
    x0 = torch.from_numpy(rng.standard_normal((nz, n, n)).astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.random((nz, n, n)) < 0.2).to(cuda) if masked else None
    cases = ((0, t, t + lz - 1), (1, t, NO_WALL), (2, NO_WALL, t + lz - 1),
             (3, NO_WALL, NO_WALL))
    for b, wall_lo, wall_hi in cases[:1] if masked else cases:
        args = (x, x0, 1.0, 6.0, t, wall_lo, wall_hi, b, m)
        assert_equal([jacobi_ext_kernel(*args)], [jacobi_ext_plain(*args)],
                     f"K10 n={n} nz={nz} T={t} b={b}")


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n,shards,lz", [(3, 2, 8), (5, 3, 160), (33, 4, 10), (130, 2, 70),
                                          (256, 2, 16)])
def test_round_k12_pushes_match_twin(cuda, n, shards, lz, t, masked):
    """One K12 round on every shard: each shard's halos are written only by
    its neighbours' folded pushes (or zeroed at a global end), each output
    starting as NaN so an unwritten cell shows; bitwise the twin on every
    plane, the kept planes bitwise K10's."""
    nz = lz + 2 * t
    rng = np.random.default_rng(4700 + n + lz + t)
    xps = [torch.from_numpy(rng.standard_normal((nz, n, n)).astype(np.float32)).to(cuda)
           for _ in range(shards)]
    x0s = [torch.from_numpy(rng.standard_normal((nz, n, n)).astype(np.float32)).to(cuda)
           for _ in range(shards)]
    ms = ([torch.from_numpy(rng.random((nz, n, n)) < 0.2).to(cuda) for _ in range(shards)]
          if masked else None)
    orig_empty_like = torch.empty_like

    def poisoned(v, *args, **kw):
        return orig_empty_like(v, *args, **kw).fill_(float("nan"))

    torch.empty_like = poisoned
    try:
        got = jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t, 0, ms)
    finally:
        torch.empty_like = orig_empty_like
    ref = jacobi_ext_rdma_plain(xps, x0s, 1.0, 6.0, t, 0, ms)
    assert_equal(got, ref, f"K12 n={n} T={t}")
    for r in range(shards):
        walls = (t if r == 0 else NO_WALL, t + lz - 1 if r == shards - 1 else NO_WALL)
        k10 = jacobi_ext_kernel(xps[r], x0s[r], 1.0, 6.0, t, *walls, 0,
                                None if ms is None else ms[r])
        assert_equal([got[r][t:t + lz]], [k10[t:t + lz]], f"K12 vs K10 shard {r}")


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_round_is_one_launch(cuda, t):
    """A K10 round at T <= 4 is one launch and nothing else; a K12 round one
    launch a shard, no faces or exchange launch; K6's 20 sweeps five."""
    n, lz, shards = 64, 16, 4
    vel, _ = fields(n, 4800 + t, cuda)
    x, x0 = ext_slab(vel[0], 1, lz, t), ext_slab(vel[1], 1, lz, t)
    assert round_launches(lambda: jacobi_ext_kernel(x, x0, 1.0, 6.0, t, NO_WALL,
                                                    NO_WALL)) == {"round": 1}
    xps, x0s = shard_slabs(vel[0], shards, t), shard_slabs(vel[1], shards, t)
    assert round_launches(lambda: jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t)) == {"round": shards}
    assert round_launches(lambda: jacobi_3d_kernel(0, vel[0], vel[1], 1.0, 6.0, 20)) == {
        "round": 5}
    assert round_launches(lambda: jacobi_3d_kernel(0, vel[0], vel[1], 1.0, 6.0, t)) == {
        "round": 1}


def test_round_wrappers_raise_past_32_bit_offsets(cuda):
    """nz·n² ≥ 2³¹ cells: K6, K10 and K12 raise before any launch (views of
    one value stand in for the 8 GiB volumes)."""
    one = torch.zeros(1, device=cuda)
    big = one.expand(1291, 1291, 1291)  # 1291³ > 2³¹
    with pytest.raises(ValueError, match="32-bit"):
        jacobi_3d_kernel(0, big, big, 1.0, 6.0, 4)
    slab = one.expand(2 ** 31 // (2048 * 2048), 2048, 2048)  # exactly 2³¹ cells
    with pytest.raises(ValueError, match="32-bit"):
        jacobi_ext_kernel(slab, slab, 1.0, 6.0, 2, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="32-bit"):
        jacobi_ext_rdma([slab, slab], [slab, slab], 1.0, 6.0, 2)
    fits = one.expand(511, 2048, 2048)  # below 2³¹: the next check speaks
    with pytest.raises(ValueError, match="contiguous"):
        jacobi_ext_kernel(fits, fits, 1.0, 6.0, 2, NO_WALL, NO_WALL)


# -- K8 and K14 on both routes; K9 on both routes (the tiled step and the 2D
# solve's strips) ----------------------------------------------------------------


def force_route(monkeypatch, route):
    """K8/K14 (and K2/K3) on ``route``: "grid" takes no tiling."""
    if route == "grid":
        monkeypatch.setattr(kresident, "solve_tiles", lambda *args: None)


def route_of(counters, before):
    return [k for k, v in counters.items() if v != before[k]]


@pytest.mark.parametrize("n_sub,window", [(1, 1), (2, 2), (3, 3)])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k8_routes_match_twin_and_k1_then_k2(cuda, monkeypatch, route, n, dtype, solve_dtype,
                                            n_sub, window):
    """K8 on each route bitwise its twin and K1 → K2 on the same inputs."""
    force_route(monkeypatch, route)
    vel, dens = fields(n, 2300 + n + n_sub, cuda)
    vel, dens = (vel * 0.06).to(dtype), dens.to(dtype)
    kw = dict(window=window, n_sub=n_sub, solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    before = dict(kresident.full_step_launches)
    got = full_step_3d(vel, dens, 20, DT, **kw)
    assert route_of(kresident.full_step_launches, before) == [route]
    assert_equal(got, full_step_3d_plain(vel, dens, 20, DT, **kw), f"K8 {route}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=n_sub, window=window)
    assert_equal(got, project_advect_density_3d(adv, dens, 20, DT, **kw),
                 f"K8 {route} vs K1 -> K2")


@pytest.mark.parametrize("n_sub,window", [(1, 1), (2, 2), (3, 3)])
@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k14_routes_match_twin_and_k1_then_k3(cuda, monkeypatch, route, n, n_sub, window):
    force_route(monkeypatch, route)
    vel, _ = fields(n, 2400 + n + window, cuda)
    vel = vel * 0.06
    before = dict(kresident.advect_project_launches)
    got = advect_project_3d_resident(vel, 60, DT, window=window, n_sub=n_sub)
    assert route_of(kresident.advect_project_launches, before) == [route]
    assert_equal(got, advect_project_3d_resident_plain(vel, 60, DT, window=window, n_sub=n_sub),
                 f"K14 {route}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=n_sub, window=window)
    assert_equal(got, project_3d_resident(adv, 60), f"K14 {route} vs K1 -> K3")


def test_k8_tiled_route_at_bench128_is_one_launch(cuda):
    """bench128's fused step (bf16 solve, 60 sweeps) on the tiled route: one
    launch, counted by route; sweep_block 4 takes it too (K5's tile
    program)."""
    vel, dens = fields(128, 2500, cuda)
    vel = vel * 0.06
    before = dict(kresident.full_step_launches)
    full_step_3d(vel, dens, 60, DT, solve_dtype="bfloat16", damp=DAMP, dens_damp=DDAMP)
    full_step_3d(vel, dens, 60, DT, solve_dtype="bfloat16", damp=DAMP, dens_damp=DDAMP,
                 sweep_block=4)
    assert {k: v - before[k] for k, v in kresident.full_step_launches.items()} == \
        {"tiled": 2, "grid": 0}


def k9_inputs(n, mask, seed, device):
    rng = np.random.default_rng(seed)
    obst = {"none": None,
            "scene": scene_mask(preset_scene_b if n == 128 else preset_scene_a, n, device),
            "random": torch.from_numpy(rng.random((n, n)) < 0.2).to(device)}[mask]
    a = float(np.float32(2.5e-3 * (n - 2) ** 2))
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    x = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(device)
    x0 = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(device)
    return obst, a, c, x, x0


@pytest.mark.parametrize("mask", ["none", "scene", "random"])
@pytest.mark.parametrize("n", [33, 64, 128, 192])
@pytest.mark.parametrize("route", ["strips", "l2"])
def test_k9_routes_match_twin(cuda, monkeypatch, route, n, mask):
    """K9 on each route bitwise its twin: b 0/1/2, both modes, 1, 2 and 20
    sweeps."""
    monkeypatch.setattr(kresident2d, "solve2d_route", lambda *args: route)
    obst, a, c, x, x0 = k9_inputs(n, mask, 2600 + n, cuda)
    before = dict(kresident2d.solve2d_launches)
    for b in (0, 1, 2):
        for smooth in (True, False):
            for iters in (1, 2, 20):
                start = x0 if smooth else x
                got = lin_solve_2d_resident(b, start, x0, a, c, obst, iters, smooth=smooth)
                ref = lin_solve_2d_resident_plain(b, start, x0, a, c, obst, iters,
                                                  smooth=smooth)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (b, smooth, iters,
                                               float((got - ref).abs().max()))
                assert torch.equal(torch.signbit(got), torch.signbit(ref)), (b, smooth, iters)
    assert kresident2d.solve2d_launches[route] - before[route] == 18


@pytest.mark.parametrize("blocks", [1, 2, 3, 4, 5, 6, 7, 8, 12, 16])
@pytest.mark.parametrize("n", [5, 17, 128, 600])
def test_k9_gate_routes_match_twin(cuda, n, blocks):
    """K9 on the route its gate picks for n and the cluster's size (600²:
    above the strips' gate at every size), bitwise its twin."""
    route = kresident2d.solve2d_route(n, blocks, cuda)
    assert route == ("l2" if n == 600 else "strips")
    obst, a, c, x, x0 = k9_inputs(n, "random", 2700 + n + blocks, cuda)
    before = dict(kresident2d.solve2d_launches)
    for b in (0, 1, 2):
        for smooth in (True, False):
            start = x0 if smooth else x
            got = lin_solve_2d_resident(b, start, x0, a, c, obst, 21, smooth=smooth,
                                        blocks=blocks)
            ref = lin_solve_2d_resident_plain(b, start, x0, a, c, obst, 21, smooth=smooth)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (b, smooth, float((got - ref).abs().max()))
    assert kresident2d.solve2d_launches[route] - before[route] == 6


def test_k9_floor_launches(cuda):
    """The cluster-barrier launch that chip_smoke.py times as K9's floor."""
    for blocks in (1, 8, 16):
        for syncs in (0, 20):
            kresident2d.cluster_barriers(syncs, blocks, cuda)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kresident2d.cluster_barriers(20, 17, cuda)


# -- K5 and K4 on the tiled solve's tiles (csrc/solve_tiled.cuh: block_tile) ----


def k4_counts():
    return dict(kjacobi.k4_launches)


def ran_k4(before, tiled, sweeps):
    after = k4_counts()
    assert {k: after[k] - before[k] for k in after} == {"tiled": tiled, "sweep": sweeps}


@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n", [32, 64, 128])
def test_tiled_k5_in_k3_matches_twin(cuda, n, solve_dtype, masked, block):
    """K5 in K3 on the tiles: one launch by the counter, bitwise its twin, at
    2T + 1 sweeps (one left over) and 20."""
    vel, _ = fields(n, 3000 + n + block, cuda)
    obst = vortex_mask(n, cuda) if masked else None
    for iters in (2 * block + 1, 20):
        before = solve_counts()
        got = project_3d_resident(vel, iters, obst=obst, solve_dtype=solve_dtype, damp=DAMP,
                                  sweep_block=block)
        ran_route(before, 1, 0)
        ref = project_3d_resident_plain(vel, iters, obst=obst, solve_dtype=solve_dtype,
                                        damp=DAMP, sweep_block=block)
        assert_equal(got, ref, f"K5 T={block} in K3, {iters} sweeps")


@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("case", ["K2", "K2s", "K2o"])
def test_tiled_k5_in_k2_matches_twin(cuda, case, n, block):
    vel, dens = fields(n, 3100 + n + block, cuda)
    vel = vel * 0.1
    kw = {"K2": dict(solve_dtype="bfloat16"), "K2s": dict(src=emitter(n, cuda)),
          "K2o": dict(obst=vortex_mask(n, cuda), n_sub=3, solve_dtype="bfloat16")}[case]
    before = solve_counts()
    got = project_advect_density_3d(vel, dens, 60, DT, damp=DAMP, dens_damp=DDAMP,
                                    sweep_block=block, **kw)
    ran_route(before, 1, 0)
    ref = project_advect_density_3d_plain(vel, dens, 60, DT, damp=DAMP, dens_damp=DDAMP,
                                          sweep_block=block, **kw)
    assert_equal(got, ref, f"K5 T={block} in {case}")


@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n", [32, 128])
def test_tiled_k5_in_k8_matches_twin_and_k1_then_k2(cuda, n, solve_dtype, block):
    vel, dens = fields(n, 3200 + n + block, cuda)
    vel = vel * 0.06
    kw = dict(n_sub=2, solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP, sweep_block=block)
    before = dict(kresident.full_step_launches)
    got = full_step_3d(vel, dens, 60, DT, **kw)
    assert route_of(kresident.full_step_launches, before) == ["tiled"]
    assert_equal(got, full_step_3d_plain(vel, dens, 60, DT, **kw), f"K8 T={block}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, n_sub=2)
    assert_equal(got, project_advect_density_3d(adv, dens, 60, DT, **kw),
                 f"K8 T={block} vs K1 -> K2")


@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("n", [32, 64, 128])
def test_tiled_k5_in_k4_matches_twin(cuda, n, block):
    """K4 without a mask in blocks of T from a start whose faces break the
    face rule, a != 1, with sweeps left over."""
    vel, _ = fields(n, 3300 + n + block, cuda)
    for iters in (2 * block + 1, 60):
        before = k4_counts()
        got = jacobi_3d_resident(0, vel[0], vel[1], 0.13, 1.78, iters, sweep_block=block)
        ran_k4(before, 1, 0)
        ref = jacobi_3d_resident_plain(0, vel[0], vel[1], 0.13, 1.78, iters, sweep_block=block)
        assert_equal((got,), (ref,), f"K4 T={block}, {iters} sweeps")


@pytest.mark.parametrize("iters", [20, 21])
@pytest.mark.parametrize("case", ["b0", "b1", "b2", "b3", "b0-a1", "mask", "mask-diffusion"])
@pytest.mark.parametrize("n", [32, 64, 128])
def test_tiled_k4_matches_twin(cuda, n, case, iters):
    """K4's sequential sweeps on the tiles: b = 0..3 with a != 1 from a start
    whose faces break the face rule, a = 1, and the mask's frozen start with
    a box of negative zeros."""
    vel, _ = fields(n, 3400 + n + iters, cuda)
    x, x0 = vel[0].clone(), vel[1].clone()
    b = int(case[1]) if case.startswith("b") else 0
    a, c = (1.0, 6.0) if case in ("b0-a1", "mask") else (0.13, 1.0 + 6 * 0.13)
    obst = None
    if case.startswith("mask"):
        obst = vortex_mask(n, cuda)
        x[2:7, 2:7, 2:7] = -0.0
        x0[2:7, 2:7, 2:7] = -0.0
    before = k4_counts()
    got = jacobi_3d_resident(b, x, x0, a, c, iters, obst=obst)
    ran_k4(before, 1, 0)
    ref = jacobi_3d_resident_plain(b, x, x0, a, c, iters, obst=obst)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
        (case, float((got - ref).abs().max()))


def test_tiled_k4_per_sweep_route_where_no_tiling_fits(cuda):
    """176³ takes one launch a sweep, counted as sweeps."""
    vel, _ = fields(176, 3500, cuda)
    before = k4_counts()
    got = jacobi_3d_resident(0, vel[0], vel[1], 1.0, 6.0, 3)
    ran_k4(before, 0, 3)
    assert_equal((got,), (jacobi_3d_resident_plain(0, vel[0], vel[1], 1.0, 6.0, 3),), "K4 176")


@pytest.mark.parametrize("block", [2, 4])
def test_tiled_k5_repeats_bitwise(cuda, block):
    """A race between a tile and its neighbours' slots or shell levels would
    flip a bit now and then: 30 calls at 128³, each the first's."""
    vel, dens = fields(128, 3600 + block, cuda)
    vel = vel * 0.1
    kw = dict(solve_dtype="bfloat16", damp=DAMP, dens_damp=DDAMP, sweep_block=block)
    first = project_advect_density_3d(vel, dens, 60, DT, **kw)
    torch.cuda.synchronize()
    for call in range(30):
        again = project_advect_density_3d(vel, dens, 60, DT, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), call


# -- the mesh over streams and cards (parallel/streams.ShardOrder) -------------------

def seeded_sharded(cuda, dtype, seed, n=128):
    """sharded512 cut to n³ and a seeded state in its dtype."""
    cfg = preset_sharded_512().replace(size=n, dtype=dtype)
    vel, dens = fields(n, seed, cuda)
    st = zeros_state(cfg, cuda)
    return cfg, st.replace(density=dens.to(st.density.dtype),
                           velocity=(vel * 0.3).to(st.velocity.dtype))


def held_back(monkeypatch, shard=3, cycles=2_000_000):
    """Shard ``shard``'s stream sleeps ~1 ms of cycles before each of its ops
    (every launch among them), so its neighbours run ahead of it."""
    orig = ShardOrder.on

    @contextlib.contextmanager
    def on(order, r, count=True):
        with orig(order, r, count):
            if count and r == shard and order.cuda:
                torch.cuda._sleep(cycles)
            yield

    monkeypatch.setattr(ShardOrder, "on", on)


def explicit_step(cfg, mesh, backend, t=4):
    return sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=t, halo_backend=backend)


@pytest.mark.parametrize("held", [False, True], ids=["ordered", "held"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_8_streams_step_is_the_unsharded_engine_step(cuda, monkeypatch, backend, t, dtype,
                                                     held):
    """sharded512 at 128³ on 8 shards of one card, each on its own stream: one
    step from a seeded state bitwise the unsharded ``Engine`` step (on the
    slab route K7 → K6 → K7 that 512³ takes), also with shard 3 held back by
    a sleep before each of its ops."""
    cfg, start = seeded_sharded(cuda, dtype, 3700 + t)
    monkeypatch.setattr(kproject, "resident_fits", lambda *a: False)
    eng = Engine(cfg, device="cuda")
    eng.state = start
    eng.step(1)
    mesh = make_mesh(["cuda"] * 8)
    assert len({s.cuda_stream for s in mesh.streams}) == 8
    if held:
        held_back(monkeypatch)
    got = unshard_state(explicit_step(cfg, mesh, backend, t)(shard_state(start, mesh)))
    for f in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(got, f), getattr(eng.state, f)), f


@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_the_held_back_step_shows_a_missing_wait(cuda, monkeypatch, backend):
    """With shard 3 held back and the waits between the shards' streams
    patched away, the step differs from the ordered step: the held-back test
    can see a race."""
    cfg, start = seeded_sharded(cuda, "float32", 3710)
    mesh = make_mesh(["cuda"] * 8)
    ref = unshard_state(explicit_step(cfg, mesh, backend)(shard_state(start, mesh)))
    held_back(monkeypatch)
    monkeypatch.setattr(ShardOrder, "_wait", lambda *a: None)
    got = unshard_state(explicit_step(cfg, mesh, backend)(shard_state(start, mesh)))
    torch.cuda.synchronize()
    assert not all(torch.equal(getattr(got, f), getattr(ref, f))
                   for f in ("density", "velocity", "pressure"))


def stream_launches(monkeypatch, names):
    """Launches of the library's entries ``names`` by the stream they were
    given (each entry's last argument)."""
    lib = _build.load_library()
    counts = collections.Counter()
    for name in names:
        def counted(*args, fn=getattr(lib, name), name=name):
            counts[(name, args[-1])] += 1
            return fn(*args)
        monkeypatch.setattr(lib, name, counted)
    return counts


SHARD_ENTRIES = ("fs_jacobi_ext", "fs_jacobi_ext_rdma", "fs_halo_exchange", "fs_advect_ext",
                 "fs_divergence_ext", "fs_gradient_ext")


@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_each_shard_launches_on_its_own_stream(cuda, monkeypatch, backend):
    """One 8-shard step at 128³: every launch of K10–K13 and K7e goes on its
    shard's stream, each stream its share (iters/T rounds, two K11, one K7e
    of each kind, three K13 on rdma), none on another stream."""
    cfg, start = seeded_sharded(cuda, "float32", 3720)
    mesh = make_mesh(["cuda"] * 8)
    counts = stream_launches(monkeypatch, SHARD_ENTRIES)
    explicit_step(cfg, mesh, backend)(shard_state(start, mesh))
    torch.cuda.synchronize()
    rounds = cfg.jacobi_iters // 4
    per_shard = {"fs_advect_ext": 2, "fs_divergence_ext": 1, "fs_gradient_ext": 1}
    per_shard.update({"fs_jacobi_ext_rdma": rounds, "fs_halo_exchange": 3}
                     if backend == "rdma" else {"fs_jacobi_ext": rounds})
    want = collections.Counter({(name, s.cuda_stream): n for name, n in per_shard.items()
                                for s in mesh.streams})
    assert counts == want


def test_copy_rows_and_the_libraries_current_device(cuda):
    """The library's runtime sees the device PyTorch makes current, on every
    card; ``fs_copy_rows`` moves a strided view's rows bitwise."""
    lib = _build.load_library()
    for d in range(torch.cuda.device_count()):
        with torch.cuda.device(d):
            assert lib.fs_current_device() == d
    src = torch.arange(3 * 10 * 16 * 16, dtype=torch.float32, device=cuda).reshape(3, 10, 16, 16)
    view = src[:, 2:6]
    out = torch.empty(view.shape, device=cuda)
    width = 4 * 16 * 16 * 4
    err = lib.fs_copy_rows(out.data_ptr(), width, view.data_ptr(), view.stride(0) * 4, width,
                           3, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, view)


@pytest.mark.parametrize("cards", [2, 4])
def test_8_shards_over_cards_are_the_one_card_mesh(cuda, cards):
    """The 8-shard mesh over 2 and 4 cards (``cli.mesh_devices``): peer access
    on between neighbouring cards, and two steps on both backends bitwise the
    one-card mesh's."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"fewer than {cards} CUDA devices")
    from fluidsim_tpu_torch.cli import mesh_devices
    from fluidsim_tpu_torch.parallel import streams

    cfg, start = seeded_sharded(cuda, "float32", 3730)
    one = make_mesh(["cuda:0"] * 8)
    over = make_mesh([torch.device("cuda", i) for i in mesh_devices(8, cards)])
    assert len(set(over.devices)) == cards
    for d in range(cards - 1):
        a, b = torch.device("cuda", d), torch.device("cuda", d + 1)
        assert (a, b) in streams._peers and (b, a) in streams._peers
    for backend in ("pallas", "rdma"):
        got = {}
        for name, mesh in (("one", one), ("over", over)):
            step = explicit_step(cfg, mesh, backend)
            got[name] = unshard_state(step(step(shard_state(start, mesh))))
        for f in ("density", "velocity", "pressure"):
            assert got["over"].density.device == torch.device("cuda", 0)
            assert torch.equal(getattr(got["over"], f), getattr(got["one"], f)), (backend, f)


# -- K8 and K14 at windows K >= 2: the vote and the <= 8-tap sum -------------------


def tap_counts(fn):
    """The cells ``fn``'s last launch summed by 8 taps and by the full
    window (``kernels/resident.tap_routes``)."""
    torch.cuda.synchronize()
    return kresident.tap_routes(fn.votes)


def plant(vel, dens, where):
    """``"tap"``: inf in the density at a cell some cells' windows hold at
    zero weight; ``"source"``: a NaN velocity, in the self-advection's
    source, which the projection carries into the density phase's velocity
    (a NaN displacement there; the intermediate the density's substep 1
    reads is then not finite either); None: nothing."""
    vel, dens = vel.clone(), dens.clone()
    c = vel.shape[-1] // 2
    if where == "tap":
        dens[c, c - 1, c] = float("inf")
    elif where == "source":
        vel[1, c, c, c] = float("nan")
    return vel, dens


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [37, 128])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k8_eight_taps_match_twin(cuda, monkeypatch, route, n, window, dtype, solve_dtype,
                                  n_sub):
    """K8 at K >= 2 on finite fields: every cell of every substep on the 8
    taps (the route counts), bitwise the twin's (2K+1)³ sums."""
    force_route(monkeypatch, route)
    vel, dens = reach(n, 6000 + n + window, cuda, window + 1, n_sub)
    vel, dens = vel.to(dtype), dens.to(dtype)
    kw = dict(window=window, n_sub=n_sub, solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    before = dict(kresident.full_step_launches)
    got = full_step_3d(vel, dens, 20, DT, **kw)
    assert route_of(kresident.full_step_launches, before) == [route]
    assert tap_counts(full_step_3d) == {"eight": 2 * n_sub * n ** 3, "full": 0}
    assert_equal(got, full_step_3d_plain(vel, dens, 20, DT, **kw), f"K8 K={window} {route}")


@pytest.mark.parametrize("where", ["tap", "source"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k8_non_finite_fields_match_twin(cuda, monkeypatch, route, window, dtype, where):
    """A non-finite value in a substep's source fails its vote: that
    substep's cells take the full sum (the route counts), and K8 is the
    twin, NaN and inf included."""
    force_route(monkeypatch, route)
    n, n_sub = 64, 2
    vel, dens = reach(n, 6100 + window, cuda, window + 1, n_sub)
    vel, dens = plant(vel.to(dtype), dens.to(dtype), where)
    kw = dict(window=window, n_sub=n_sub, solve_dtype="bfloat16", damp=DAMP, dens_damp=DDAMP)
    got = full_step_3d(vel, dens, 4, DT, **kw)
    counts = tap_counts(full_step_3d)
    ref = full_step_3d_plain(vel, dens, 4, DT, **kw)
    assert bool(ref[2].isnan().any()) and bool(torch.isfinite(ref[2]).any())
    assert_equal_nan(got, ref, f"K8 K={window} {where} {route}")
    assert sum(counts.values()) == 2 * n_sub * n ** 3
    if where == "tap":  # the self-advection on 8 taps, the density's full
        assert counts == {"eight": 2 * n ** 3, "full": 2 * n ** 3}
    else:  # the density's substep 0 on 8 taps but at its NaN displacements
        assert 0 < counts["eight"] < n ** 3


@pytest.mark.parametrize("order", [("tap", None), (None, "tap"), ("source", None),
                                   (None, "source")])
def test_k8_votes_do_not_outlive_a_launch(cuda, order):
    """Two launches in a row, non-finite then finite and the reverse: each
    the twin, each launch's counts its own (no vote carries over)."""
    n, window, n_sub = 64, 4, 2
    vel, dens = reach(n, 6200, cuda, window + 1, n_sub)
    kw = dict(window=window, n_sub=n_sub, solve_dtype="bfloat16", damp=DAMP, dens_damp=DDAMP)
    for where in order:
        v, d = plant(vel, dens, where)
        got = full_step_3d(v, d, 4, DT, **kw)
        counts = tap_counts(full_step_3d)
        assert_equal_nan(got, full_step_3d_plain(v, d, 4, DT, **kw), f"K8 {where}")
        if where is None:
            assert counts == {"eight": 2 * n_sub * n ** 3, "full": 0}
        else:
            assert counts["full"] >= n ** 3


@pytest.mark.parametrize("where", [None, "source"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("route", ["tiled", "grid"])
def test_k14_eight_taps_match_twin(cuda, monkeypatch, route, window, n_sub, where):
    force_route(monkeypatch, route)
    n = 64
    vel, dens = reach(n, 6300 + window, cuda, window + 1, n_sub)
    vel, _ = plant(vel, dens, where)
    before = dict(kresident.advect_project_launches)
    got = advect_project_3d_resident(vel, 60, DT, window=window, n_sub=n_sub)
    assert route_of(kresident.advect_project_launches, before) == [route]
    counts = tap_counts(advect_project_3d_resident)
    assert_equal_nan(got, advect_project_3d_resident_plain(vel, 60, DT, window=window,
                                                           n_sub=n_sub), f"K14 K={window}")
    cells = n_sub * n ** 3
    assert counts == ({"eight": cells, "full": 0} if where is None
                      else {"eight": 0, "full": cells})


# -- K13 on any layout of the shards' streams --------------------------------------


@pytest.mark.parametrize("streams", ["shards", "one"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("shards", [3, 5])
def test_k13_matches_twin_on_any_stream_layout(cuda, shards, depth, streams):
    """Float32 channels as views of a global tensor on 72² planes, bfloat16
    and the bool mask (16-byte moves), and a 7² bool mask (49 bytes: the
    byte path), on shard counts that do not divide a power of two, each call
    bitwise its twin: on the shards' streams, where the shares run at once,
    and with every share on one stream (``tools/torch_k13_priming.py``'s
    layout for a share alone)."""
    n, lz = 72, 4
    vel, dens = fields(n, 3100 + shards + depth, cuda)
    vel, dens = vel[:, :shards * lz], dens[:shards * lz]
    calls = ([vel, dens[None].to(BF16), vel[:1] > 0.0],
             [(dens[None, :, :7, :7] > 3.0).contiguous()])
    for arrays in calls:
        by_shard = [[torch.chunk(a, shards, 1)[r] for a in arrays] for r in range(shards)]
        order = ShardOrder([torch.device("cuda", torch.cuda.current_device())] * shards)
        if streams == "one":
            order.streams = (torch.cuda.current_stream(),) * shards
        with mock_order(order):
            got = halo_exchange_rdma(by_shard, depth)
        ref = halo_exchange_rdma_plain(by_shard, depth)
        for r in range(shards):
            assert_equal(got[r], ref[r], f"K13 {len(arrays)} arrays, shard {r}, {streams}")


@contextlib.contextmanager
def mock_order(order):
    """``order_of`` giving ``order`` (its streams) for K13's call."""
    from fluidsim_tpu_torch.parallel import streams as pstreams

    saved = pstreams.order_of
    pstreams.order_of = lambda xs: order
    try:
        yield
    finally:
        pstreams.order_of = saved


# -- the program's kernel spans against the launch counters ------------------------

# The launch counters behind each ``kernel.*`` span.
SPAN_COUNTERS = {
    "K1": (advect_multi_3d_kernel,), "K2": (project_advect_density_3d,),
    "K3": (project_3d_resident,), "K4": (jacobi_3d_resident,), "K6": (jacobi_3d_kernel,),
    "K7": (divergence_3d_kernel, gradient_3d_kernel),
    "K7e": (divergence_ext_kernel, gradient_ext_kernel), "K8": (full_step_3d,),
    "K9": (lin_solve_2d_resident,), "K10": (jacobi_ext_kernel,), "K11": (advect_ext_kernel,),
    "K12": (jacobi_ext_rdma,), "K13": (halo_exchange_rdma,),
}


def span_path(path, device, monkeypatch):
    """A step of ``path`` as a function, and the kernels it must launch."""
    if path in ("mesh rdma", "mesh pallas"):
        cfg = preset_sharded_512().replace(size=128)
        mesh = make_mesh([device] * 8)
        step = sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=4,
                               halo_backend=path.split()[1])
        state = [shard_state(zeros_state(cfg, device), mesh)]

        def run():
            state[0] = step(state[0])

        want = {"K7e", "K11"} | ({"K12", "K13"} if path == "mesh rdma" else {"K10"})
        return run, want
    if path == "slab":
        monkeypatch.setattr(kproject, "resident_fits", lambda *a: False)
    cfg, want = {
        "bench128": (CFG, {"K1", "K2"}),
        "fused": (CFG.replace(fuse_project_advect=True, fuse_self_advect=True), {"K8"}),
        "vortex128": (preset_vortex_128(), {"K1", "K3"}),
        "slab": (preset_sharded_512().replace(size=64), {"K1", "K6", "K7"}),
        "double_project": (preset_plume_64().replace(double_project=True), {"K1", "K4"}),
        "scene_a": (preset_scene_a().replace(resolution_multiplier=1.0), {"K9"}),
    }[path]
    eng = Engine(cfg, device)
    return (lambda: eng.step(2, substeps_per_dispatch=2)), want


@pytest.mark.parametrize("path", ["bench128", "fused", "vortex128", "slab", "double_project",
                                  "scene_a", "mesh rdma", "mesh pallas"])
def test_each_kernel_span_opens_once_a_counted_launch(cuda, monkeypatch, path):
    """Under ``tracing()`` every ``kernel.K*`` span opens once for each launch
    its wrappers' counters count (K12 and K13 once a shard), on each path;
    the model step's phases read the allocator's memory."""
    from fluidsim_tpu_torch.utils.profiling import tracing

    run, want = span_path(path, cuda, monkeypatch)
    run()
    torch.cuda.synchronize()
    before = {k: sum(fn.launches for fn in fns) for k, fns in SPAN_COUNTERS.items()}
    with tracing() as rec:
        run()
    torch.cuda.synchronize()
    added = {k: sum(fn.launches for fn in fns) - before[k] for k, fns in SPAN_COUNTERS.items()}
    spans = collections.Counter(s.name.split(".", 1)[1] for s in rec.spans
                                if s.name.startswith("kernel."))
    assert {k: spans.get(k, 0) for k in added} == added
    assert set(spans) <= set(SPAN_COUNTERS)
    assert want <= {k for k, v in added.items() if v}, added
    if path != "scene_a":
        assert rec.peak is not None and rec.peak[1].startswith("phase.")
