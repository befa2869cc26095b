"""The sharded step of fluidsim_tpu_torch on real shards
(``parallel.sharding.ShardedState``, ``parallel/step.py``): each op on the
shards' own slabs against the whole-volume op it stands for, and the step
against the composition it replaces.

Everything runs at 32³ on ``make_mesh(["cpu"] * 4)`` (shards of 8 planes:
the first, two middle and the last, so both global z walls and every kind
of shard edge), from seeded smooth fields (tests/test_torch_multi256.py's
``start_arrays``).  Each per-shard op, joined, is bitwise the whole-volume
op; the step is bitwise the unsharded composition that the sharded step ran
before its state was split: ``simulate_step_3d`` on the global state with
the global ``jacobi_3d_sharded``/``advect_multi_3d_sharded`` hooks (the
explicit path) or without them (``halo="auto"``), for sharded512, vortex128
and plume64 cut to 32³, the ``xla``, ``pallas`` and ``rdma`` backends at T =
1, 2, 4 and float32 and bfloat16 fields.  That composition is held against
the JAX package's ``sharded_step_fn`` on 4 host devices (rtol 1e-5, atol
1e-6·max per field) in tests/test_torch_sharded_step.py and, in bfloat16,
tests/test_torch_rdma.py; here the plain backend at T = 4 is compared with
it directly in the same class.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fluidsim_tpu.config as j_config
from fluidsim_tpu.parallel.sharding import make_mesh as j_make_mesh
from fluidsim_tpu.parallel.sharding import shard_state as j_shard_state
from fluidsim_tpu.parallel.sharding import sharded_step_fn as j_sharded_step_fn
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.config as t_config
from fluidsim_tpu_torch.config import SourceSpec
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels.halo import NO_WALL, ext_halo, rank_walls
from fluidsim_tpu_torch.kernels.project import (
    divergence_3d_plain,
    divergence_ext_kernel,
    divergence_ext_plain,
    gradient_ext_kernel,
    gradient_ext_plain,
)
from fluidsim_tpu_torch.kernels.resident import project_gradient
from fluidsim_tpu_torch.models.stable3d import simulate_step_3d
from fluidsim_tpu_torch.models.step_kernels import HAND_KERNELS, PLAIN_TWINS
from fluidsim_tpu_torch.ops.advect import (
    advect_maccormack_3d,
    advect_multi_3d,
    advect_substep_3d,
)
from fluidsim_tpu_torch.ops.forces import (
    apply_turbulent_noise_3d,
    enforce_obstacle_boundaries_3d,
    enforce_obstacle_boundaries_slab,
    vorticity_confinement_3d,
    vorticity_confinement_slab,
)
from fluidsim_tpu_torch.ops.linsolve import diffuse_3d
from fluidsim_tpu_torch.ops.project import project_3d
from fluidsim_tpu_torch.parallel import (
    ShardedState,
    gathered_ops,
    make_mesh,
    shard_state,
    sharded_step_fn,
    unshard_state,
)
from fluidsim_tpu_torch.parallel.halo import (
    advect_multi_3d_sharded,
    advect_shards_plain,
    exchange,
    extend,
    jacobi_3d_sharded,
    neighbour_planes,
)
from fluidsim_tpu_torch.parallel.step import ShardStep
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
from fluidsim_tpu_torch.scene.sources import apply_custom_source

from test_torch_multi256 import start_arrays

torch.set_num_threads(1)

N = 32
K = 4
LZ = N // K
SHARDS = list(range(K))
CUT = dict(size=N, source_radius=2.0, jacobi_iters=4)
FIELDS = ("density", "velocity", "pressure")


def preset(name, **change):
    """The port's preset cut to 32³ (sharded512 also with its radius and
    solve cut, as tests/test_torch_sharded_step.py's)."""
    base = dict(CUT) if name == "sharded_512" else dict(size=N)
    return getattr(t_config, f"preset_{name}")().replace(**base, **change)


def arrays(cfg):
    """Seeded start arrays with the config's mask, in its dtype's values."""
    a = start_arrays()
    if cfg.enable_obstacle:
        a["obstacles"] = np.asarray(build_obstacle_mask(cfg))
    if cfg.dtype == "bfloat16":
        for key in FIELDS:
            a[key] = torch.from_numpy(a[key]).to(torch.bfloat16).float().numpy()
    return a


def start(cfg):
    return state_from_numpy(arrays(cfg), "cpu", dtype=cfg.dtype)


def mesh():
    return make_mesh(["cpu"] * K)


def split(x, axis=0):
    return [t.contiguous() for t in torch.chunk(x, K, dim=axis)]


def rand(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * scale


def mask_crossing_shards():
    """A mask with solids on both global z walls and across every shard
    edge."""
    m = torch.zeros(N, N, N, dtype=torch.bool)
    m[:3, 10:20, 5:15] = True
    m[6:11, 12:18, 12:18] = True
    m[14:18, 4:9, 20:28] = True
    m[-3:, 20:26, 8:12] = True
    return m


def ext1(mask):
    """Each shard's mask between one plane of each neighbour's (the state's
    own halo)."""
    return extend(split(mask), 1)


# -- the state ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sharded_512", "vortex_128"])
def test_shard_then_unshard_is_the_identity(name):
    cfg = preset(name)
    state = start(cfg)
    sharded = shard_state(state, mesh())
    assert isinstance(sharded, ShardedState) and len(sharded.slabs) == K
    back = unshard_state(sharded)
    for f in FIELDS + ("obstacles", "step", "time"):
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    for r, slab in enumerate(sharded.slabs):
        assert (slab.rank, slab.z0) == (r, r * LZ)
        assert slab.density.shape == (LZ, N, N) and slab.velocity.shape == (3, LZ, N, N)
        want = torch.nn.functional.pad(state.obstacles, (0, 0, 0, 0, 1, 1))[r * LZ:r * LZ + LZ + 2]
        assert torch.equal(slab.obstacles, want)


def test_slabs_own_their_storage_on_their_devices():
    """Each slab is on ``mesh.devices[r]``, contiguous, and no two slabs (nor
    a slab and the global state) share a storage, before and after a
    step."""
    cfg = preset("sharded_512")
    state = start(cfg)
    m = mesh()
    sharded = shard_state(state, m)
    stepped = sharded_step_fn(cfg, m, halo="explicit", halo_block_iters=2,
                              halo_backend="pallas")(sharded)

    def storage(t):
        return t.untyped_storage().data_ptr()

    for st in (sharded, stepped):
        seen = {storage(getattr(state, f)) for f in FIELDS + ("obstacles",)}
        for r, slab in enumerate(st.slabs):
            for f in FIELDS + ("obstacles", "step", "time"):
                t = getattr(slab, f)
                assert t.device == m.devices[r], (r, f)
                ptr = storage(t)
                assert ptr not in seen, (r, f)
                seen.add(ptr)
    for slab in sharded.slabs:
        for f in FIELDS + ("obstacles",):
            assert getattr(slab, f).is_contiguous()


def test_step_refuses_a_state_not_on_the_mesh():
    cfg = preset("sharded_512")
    step = sharded_step_fn(cfg, mesh())
    with pytest.raises(ValueError, match="slabs"):
        step(shard_state(start(cfg), make_mesh(["cpu"] * 2)))


# -- K7e's twins -----------------------------------------------------------------


@pytest.mark.parametrize("shards", [4, 8])
def test_k7e_twins_are_k7_restricted_to_each_shard(shards):
    """``divergence_ext_plain``/``gradient_ext_plain`` on each shard's planes
    and its neighbours' halo planes (``neighbour_planes``) are bitwise
    ``divergence_3d_plain`` and ``project_gradient`` (K7's twins) on the
    shard's planes; the wrappers take the twins for CPU tensors."""
    vel = rand(3, N, N, N, seed=1)
    p = rand(N, N, N, seed=2)
    lz = N // shards
    div = divergence_3d_plain(vel)
    grad = project_gradient(vel, p)
    vs = [v.contiguous() for v in torch.chunk(vel, shards, 1)]
    ps = [q.contiguous() for q in torch.chunk(p, shards)]
    vz_halos = neighbour_planes([v[2] for v in vs])
    p_halos = neighbour_planes(ps)
    for r in range(shards):
        walls = rank_walls(r, shards, 0, lz)
        sl = slice(r * lz, (r + 1) * lz)
        v, q, vz_h, p_h = vs[r], ps[r], vz_halos[r], p_halos[r]
        assert torch.equal(divergence_ext_plain(v, *vz_h, *walls), div[sl]), r
        assert torch.equal(gradient_ext_plain(v, q, *p_h, *walls), grad[:, sl]), r
        assert torch.equal(divergence_ext_kernel(v, *vz_h, *walls), div[sl]), r
        assert torch.equal(gradient_ext_kernel(v, q, *p_h, *walls), grad[:, sl]), r


def test_neighbour_planes_are_views_of_the_neighbours():
    """The halo planes K7e reads are the neighbours' edge planes in place
    (no copy on one device), None past the global ends."""
    xs = [rand(4, N, N, seed=s) for s in range(4)]
    halos = neighbour_planes(xs)
    assert halos[0][0] is None and halos[-1][1] is None
    for r in range(1, 4):
        assert halos[r][0].data_ptr() == xs[r - 1][-1].data_ptr()
        assert halos[r - 1][1].data_ptr() == xs[r][0].data_ptr()


def test_k7e_wrapper_checks():
    v = rand(3, 6, N, N)
    p = rand(6, N, N)
    plane = rand(N, N)
    with pytest.raises(ValueError, match="wall_lo"):
        divergence_ext_kernel(v, plane, plane, 2, NO_WALL)
    with pytest.raises(ValueError, match="wall_hi"):
        gradient_ext_kernel(v, p, plane, plane, NO_WALL, 4)
    with pytest.raises(ValueError, match="lz >= 2"):
        divergence_ext_kernel(v[:, :1].contiguous(), plane, plane, NO_WALL, NO_WALL)
    with pytest.raises(TypeError):
        divergence_ext_kernel(v.double(), plane, plane, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="contiguous"):
        gradient_ext_kernel(v, p.transpose(1, 2), plane, plane, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="halo plane below"):
        divergence_ext_kernel(v, None, plane, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="halo plane above"):
        gradient_ext_kernel(v, p, plane, plane, NO_WALL, 5)
    with pytest.raises(ValueError, match="halo plane below"):
        divergence_ext_kernel(v, plane[:-1], plane, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="contiguous"):
        divergence_ext_kernel(v.transpose(2, 3), plane, plane, NO_WALL, NO_WALL)
    with pytest.raises(ValueError, match="between components"):
        overlapping = rand(8, N, N).as_strided((3, 6, N, N), (N * N, N * N, N, 1))
        gradient_ext_kernel(overlapping, p, plane, plane, NO_WALL, NO_WALL)


def test_k7e_takes_the_kept_planes_of_an_extended_slab():
    """K7e's velocity may be a view with a component stride of its own (K11's
    kept planes of its extended result): the same result as on a copy."""
    ext = rand(3, 10, N, N, seed=4)
    v = ext[:, 2:8]
    plane = rand(N, N, seed=5)
    p = rand(6, N, N, seed=6)
    assert not v.is_contiguous()
    assert torch.equal(divergence_ext_kernel(v, plane, plane, NO_WALL, NO_WALL),
                       divergence_ext_plain(v.contiguous(), plane, plane, NO_WALL, NO_WALL))
    assert torch.equal(gradient_ext_kernel(v, p, plane, plane, NO_WALL, NO_WALL),
                       gradient_ext_plain(v.contiguous(), p, plane, plane, NO_WALL, NO_WALL))


# -- the per-shard ops, each against its whole-volume op -------------------------


def slabs_of(fn, *parts):
    return [fn(r, *(part[r] for part in parts)) for r in SHARDS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emitters_per_shard(dtype):
    """The main emitter (pulsing, emitting velocity) and an extra source,
    on each shard's slab at its z origin."""
    cfg = preset("plume_64", dtype=dtype, source_emits_velocity=True, source_pulsing=True,
                 source_position=(0.5, 0.3, 0.24),
                 extra_sources=(SourceSpec(position=(0.3, 0.6, 0.75), radius=5.0,
                                           emits_velocity=True, pulsing=True),))
    state = start(cfg)
    t = torch.tensor(0.37)
    d, v = apply_custom_source(state.density, state.velocity, cfg, t)
    got = slabs_of(lambda r, dd, vv: apply_custom_source(dd, vv, cfg, t, z0=r * LZ),
                   split(state.density), split(state.velocity, 1))
    assert torch.equal(torch.cat([g[0] for g in got]), d)
    assert torch.equal(torch.cat([g[1] for g in got], 1), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vorticity_per_shard_keeps_the_walls_zero_pad(dtype):
    """Vorticity confinement on each shard's two-plane extended slab: the
    whole grid zero-pads ``|ω|`` past its z walls, not the ``|ω|`` of the
    zero-padded velocity."""
    vel = rand(3, N, N, N, seed=3).to(dtype)
    ref = vorticity_confinement_3d(vel, 0.03, 2.0)
    ext = extend(split(vel, 1), 2, 1)
    got = slabs_of(lambda r, e: vorticity_confinement_slab(e, 0.03, 2.0, r * LZ, N), ext)
    assert torch.equal(torch.cat(got, 1), ref)


@pytest.mark.parametrize("mask", ["sphere", "crossing"])
def test_obstacle_enforcement_per_shard(mask):
    """Obstacle enforcement on each slab with the mask's one-plane halo and
    the global interior (z faces on the first and last shard only)."""
    obst = (torch.as_tensor(np.asarray(build_obstacle_mask(preset("vortex_128"))))
            if mask == "sphere" else mask_crossing_shards())
    vel = rand(3, N, N, N, seed=4)
    ref = enforce_obstacle_boundaries_3d(vel, obst, 1.0, 1e-4)
    got = slabs_of(lambda r, v, m: enforce_obstacle_boundaries_slab(v, m, 1.0, 1e-4,
                                                                     r * LZ, N),
                   split(vel, 1), ext1(obst))
    assert torch.equal(torch.cat(got, 1), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_per_shard(dtype):
    """Turbulent noise on each shard's z range, the coordinates from the
    global index in the velocity's dtype."""
    vel = rand(3, N, N, N, seed=5).to(dtype)
    ref = apply_turbulent_noise_3d(vel)
    got = slabs_of(lambda r, v: apply_turbulent_noise_3d(v, z0=r * LZ, n=N), split(vel, 1))
    assert torch.equal(torch.cat(got, 1), ref)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("masked", [False, True], ids=["open", "mask"])
def test_diffusion_per_shard(b, masked):
    """``diffuse_3d`` per shard: the plain sweeps one plane a sweep, and
    with a mask on a velocity code the obstacle mirror (two planes a
    sweep)."""
    cfg = preset("plume_64", dtype="float32", jacobi_iters=6)
    obst = mask_crossing_shards() if masked else None
    x = rand(N, N, N, seed=6 + b)
    ref = diffuse_3d(b, x, 1e-3, 0.04, obst, cfg)
    step = ShardStep(cfg, mesh(), True, "auto", 1, "auto", False, PLAIN_TWINS)
    got = step.diffuse(b, split(x), 1e-3, 0.04, None if obst is None else ext1(obst))
    assert torch.equal(torch.cat(got), ref)


@pytest.mark.parametrize("backend,t", [("xla", 1), ("pallas", 2), ("rdma", 4)])
@pytest.mark.parametrize("masked", [False, True], ids=["open", "mask"])
def test_projection_per_shard(backend, t, masked):
    """The projection per shard (the divergence on the velocity's one-plane
    halo, K7e's twins without a mask, the plain forms with one; the solve
    per shard; the gradient on the pressure's halo) against ``project_3d``
    with the global ``jacobi_3d_sharded`` hook, and ``halo="auto"``'s
    against the plain ``project_3d``."""
    cfg = preset("sharded_512", enable_obstacle=masked)
    obst = mask_crossing_shards() if masked else None
    vel = rand(3, N, N, N, seed=7, scale=0.5)
    masks = None if obst is None else ext1(obst)

    def hook(p, div, iters, o=None):
        return jacobi_3d_sharded(p, div, 1.0, 6.0, iters, mesh(), block_iters=t, backend=backend,
                                 obst=o)

    for halo, jac in (("explicit", hook), ("auto", None)):
        ref_v, ref_p = project_3d(vel, obst, cfg.jacobi_iters, jacobi_fn=jac)
        step = ShardStep(cfg, mesh(), True, halo, t, backend, False, PLAIN_TWINS)
        got_v, got_p = step.project(split(vel, 1), masks)
        assert torch.equal(torch.cat(got_v, 1), ref_v), halo
        assert torch.equal(torch.cat(got_p), ref_p), halo


@pytest.mark.parametrize("scheme,window,n_sub", [("semi_lagrangian", 1, 1),
                                                 ("semi_lagrangian", 3, 1),
                                                 ("substep", 1, 3), ("substep", 2, 2),
                                                 ("substep", 3, 2), ("substep", 3, 3)])
@pytest.mark.parametrize("masked", [False, True], ids=["open", "mask"])
def test_plain_advection_per_shard(scheme, window, n_sub, masked):
    """``advect_shards_plain`` against the whole-grid ``advect_multi_3d`` /
    ``advect_substep_3d``, self-advection and the density; a halo as deep
    as a shard (K = 3, two substeps with the mask: 8 planes) or deeper
    (three substeps: 9, 12 with the mask) takes planes from two shards."""
    obst = mask_crossing_shards() if masked else None
    vel = rand(3, N, N, N, seed=8, scale=2.0)
    dens = rand(1, N, N, N, seed=9).abs()
    dt = 0.04

    def whole(bs, f):
        if scheme == "substep":
            return advect_substep_3d(bs, f, vel, dt, obst, window, n_sub=n_sub)
        return advect_multi_3d(bs, f, vel, dt, obst, window)

    vs = split(vel, 1)
    masks = None if obst is None else split(obst)
    for bs, f, fs in (((1, 2, 3), vel, vs), ((0,), dens, split(dens, 1))):
        got = advect_shards_plain(bs, fs, vs, dt, N, scheme, window, n_sub, masks)
        assert torch.equal(torch.cat(got, 1), whole(bs, f)), bs


@pytest.mark.parametrize("depth,axis", [(1, 0), (2, 1), (3, 0)])
def test_exchange_backends_agree(depth, axis):
    """The exchange both backends share: ``torch.cat`` and K13's twin give
    the same slabs."""
    x = rand(*((N, N, N) if axis == 0 else (3, N, N, N)), seed=10)
    xs = split(x, axis)
    for a, b in zip(exchange(xs, depth, axis, "pallas"),
                    exchange(xs, depth, axis, "rdma", HAND_KERNELS)):
        assert torch.equal(a, b)


# -- the step -----------------------------------------------------------------------


def parent_step(cfg, halo, t, backend):
    """The composition the sharded step ran on the global state before its
    state was split: ``simulate_step_3d`` with the emitter, and on the
    explicit path the global hooks."""
    m = mesh()
    cfg = cfg.replace(kernel_backend="xla")
    jacobi_fn = advect_fn = None
    if halo == "explicit":
        n_sub = cfg.advect_substeps if cfg.advection_scheme == "substep" else 1

        def jacobi_fn(p, div, iters, obst=None):
            return jacobi_3d_sharded(p, div, 1.0, 6.0, iters, m, block_iters=t,
                                     backend=backend, obst=obst)

        h = ext_halo(cfg.advect_window, n_sub, cfg.enable_obstacle)
        if (backend in ("pallas", "rdma") and cfg.advect_window >= 1 and h <= LZ
                and cfg.advection_scheme in ("semi_lagrangian", "substep")):
            def advect_fn(bs, f, v, dt, obst=None):
                return advect_multi_3d_sharded(
                    bs, f, v, float(dt), m, window=cfg.advect_window, n_sub=n_sub,
                    transport="rdma" if backend == "rdma" else "ppermute", obst=obst)
    dt = cfg.effective_params()[0]

    def step(state):
        d, v = apply_custom_source(state.density, state.velocity, cfg, state.time + dt)
        return simulate_step_3d(state.replace(density=d, velocity=v), cfg,
                                jacobi_fn=jacobi_fn, advect_fn=advect_fn)

    return step


def run_sharded(cfg, steps, **kw):
    m = mesh()
    step = sharded_step_fn(cfg, m, **kw)
    state = shard_state(start(cfg), m)
    for _ in range(steps):
        state = step(state)
    return unshard_state(state)


CASES = [("auto", 1, "auto"), ("explicit", 1, "xla"), ("explicit", 4, "xla"),
         ("explicit", 2, "pallas"), ("explicit", 4, "rdma")]
MORE = [("explicit", 2, "xla"), ("explicit", 4, "pallas"), ("explicit", 2, "rdma")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,halo,t,backend",
    [(name,) + c for name in ("sharded_512", "vortex_128", "plume_64") for c in CASES]
    + [("sharded_512",) + c for c in MORE],
    ids=lambda v: str(v))
def test_step_is_the_unsplit_composition(name, halo, t, backend, dtype):
    """Two sharded steps, unsharded, bitwise the global composition, with
    the same step and time; no op gathered."""
    cfg = preset(name, dtype=dtype)
    gathered_ops.clear()
    kw = dict(halo=halo, halo_backend=backend)
    if halo == "explicit":
        kw["halo_block_iters"] = t
    got = run_sharded(cfg, 2, **kw)
    assert sum(gathered_ops.values()) == 0
    step = parent_step(cfg, halo, t, backend)
    ref = start(cfg)
    for _ in range(2):
        ref = step(ref)
    for f in FIELDS + ("step", "time"):
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("change,name", [(dict(advection_scheme="maccormack", advect_window=2),
                                          "maccormack"),
                                         (dict(advect_window=0), "window0"),
                                         (dict(advection_scheme="semi_lagrangian",
                                               advect_window=0), "window0"),
                                         (dict(pressure_solver="fft"), "fft")])
def test_gathered_route_counts_its_ops(change, name):
    """Only the exact gather of window 0 takes ``gathered``, once per call
    (two advections a step), bitwise the global composition; MacCormack
    (per shard, bitwise) and the FFT projection (z-pencils, within rtol
    1e-5, atol 1e-6·max per field) gather nothing."""
    cfg = preset("sharded_512", **change)
    gathered_ops.clear()
    got = run_sharded(cfg, 1, halo="auto")
    assert dict(gathered_ops) == ({"window0": 2} if name == "window0" else {})
    ref = parent_step(cfg, "auto", 1, "auto")(start(cfg))
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        if name == "fft":
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(r.abs().max()), err_msg=f)
        else:
            assert torch.equal(g, r), f


def test_maccormack_gathered_matches_the_whole_grid():
    """The sharded step's MacCormack advection, with a mask, on every shard:
    per shard (nothing gathered), bitwise the whole-grid op."""
    cfg = preset("vortex_128", advection_scheme="maccormack", advect_window=2)
    obst = torch.as_tensor(np.asarray(build_obstacle_mask(cfg)))
    vel = rand(3, N, N, N, seed=11)
    step = ShardStep(cfg.replace(kernel_backend="xla"), mesh(), True, "auto", 1, "auto", False,
                     PLAIN_TWINS)
    gathered_ops.clear()
    got = step.advect((1, 2, 3), split(vel, 1), split(vel, 1), 0.03, ext1(obst))
    assert dict(gathered_ops) == {}
    assert torch.equal(torch.cat(got, 1), advect_maccormack_3d((1, 2, 3), vel, vel, 0.03,
                                                               obst, 2))


def run_jax(cfg, steps, **kw):
    m = j_make_mesh(jax.devices()[:K])
    state = j_shard_state(JState(**{k: jnp.asarray(v) for k, v in arrays(cfg).items()}), m)
    step = j_sharded_step_fn(cfg, m, **kw)
    for _ in range(steps):
        state = step(state)
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


@pytest.mark.parametrize("name", ["sharded_512", "vortex_128"])
def test_step_within_the_class_of_the_jax_step(name):
    """The plain backend at T = 4 for 2 steps against the JAX
    ``sharded_step_fn`` (rtol 1e-5, atol 1e-6·max per field)."""
    base = dict(CUT) if name == "sharded_512" else dict(size=N)
    j_cfg = getattr(j_config, f"preset_{name}")().replace(**base)
    kw = dict(halo="explicit", halo_block_iters=4, halo_backend="xla")
    ref = run_jax(j_cfg, 2, **kw)
    got = state_to_numpy(run_sharded(preset(name), 2, **kw))
    for f, r in ref.items():
        np.testing.assert_allclose(got[f], r, rtol=1e-5, atol=1e-6 * float(np.abs(r).max()),
                                   err_msg=f)
