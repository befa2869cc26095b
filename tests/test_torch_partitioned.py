"""The ops of the sharded step that no longer assemble a whole volume on a
shard: MacCormack per shard (``parallel/halo.advect_maccormack_shards``),
the FFT projection on z-pencils (``ops/fft_poisson.project_3d_fft_shards``),
and the step factories ``make_step`` and ``make_step_2d``.

Everything at 32³ (16³ for the shapes the FFT route allocates) on
``make_mesh(["cpu"] * k)``, k = 2 and 4, from seeded inputs:

* MacCormack per shard is bitwise the port's whole-grid
  ``advect_maccormack_3d`` (window 1 and 2, float32 and bfloat16, with and
  without a mask that crosses every shard edge and both global walls), on
  the plain advection and on K11's twin (the ``"ppermute"`` and ``"rdma"``
  transports, against the whole-grid op on K1's twin);
* the sharded step with MacCormack and with ``pressure_solver="fft"``
  (``halo="auto"``) is within rtol 1e-5, atol 1e-6·max|ref| per field of
  the JAX ``sharded_step_fn`` on 4 host devices over 2 steps (its Pallas
  kernels in interpret mode on the explicit path), and gathers nothing;
  window 0 still gathers, twice a step;
* ``project_3d_fft_shards`` is within that class of the JAX
  ``project_3d_fft`` and of the port's own, allocates no tensor larger than
  1/k of the whole-volume route's largest, and each shard's eigenvalue rows
  are the table's;
* the all-to-alls and MacCormack's exchanges wait on their writers (the
  recorder of tests/test_torch_multicard.py);
* ``make_step`` (bench128 cut to 32³, the plain path) and ``make_step_2d``
  (scene_a and scene_b cut to 64²) against the JAX factories over 2 steps,
  at tests/test_torch_step.py's class (rtol 1e-5, atol 1e-6·max|ref|) and
  tests/test_torch_2d.py's rollout class (rtol 1e-3, atol 5e-4·scale).
"""

import itertools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import fluidsim_tpu.config as j_config
from fluidsim_tpu.models.stable2d import make_step_2d as j_make_step_2d
from fluidsim_tpu.models.stable3d import make_step as j_make_step
from fluidsim_tpu.ops.fft_poisson import project_3d_fft as j_project_3d_fft
from fluidsim_tpu.parallel.sharding import make_mesh as j_make_mesh
from fluidsim_tpu.parallel.sharding import shard_state as j_shard_state
from fluidsim_tpu.parallel.sharding import sharded_step_fn as j_sharded_step_fn
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.config as t_config
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.models.stable2d import make_step_2d
from fluidsim_tpu_torch.models.stable3d import make_step, make_step_3d
from fluidsim_tpu_torch.models.step_kernels import HAND_KERNELS, PLAIN_TWINS
from fluidsim_tpu_torch.ops import fft_poisson as t_fft
from fluidsim_tpu_torch.ops.advect import advect_maccormack_3d
from fluidsim_tpu_torch.parallel import (
    gathered_ops,
    make_mesh,
    shard_state,
    sharded_step_fn,
    unshard_state,
)
from fluidsim_tpu_torch.parallel.halo import advect_maccormack_shards
from fluidsim_tpu_torch.parallel.streams import ShardOrder

from test_torch_multicard import Recorder
from test_torch_shards import FIELDS, N, arrays, mask_crossing_shards, preset, rand, start

torch.set_num_threads(1)

DT = 0.03


def chunks(x, k, axis):
    return [t.contiguous() for t in torch.chunk(x, k, dim=axis)]


def close(got, ref, what):
    """rtol 1e-5, atol 1e-6·max|ref|: the sharded step's class."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()),
                               err_msg=f"{what}: max abs diff {np.abs(got - ref).max():.3e}")


# -- MacCormack per shard ----------------------------------------------------------


@pytest.mark.parametrize(
    "k,window,dtype,masked,transport",
    list(itertools.product((2, 4), (1, 2), ("float32", "bfloat16"), (False, True),
                           ("plain", "ppermute", "rdma"))),
    ids=lambda v: str(v))
def test_maccormack_per_shard_is_the_whole_grid_op(k, window, dtype, masked, transport):
    """The velocity's self-advection and a density's, per shard and joined,
    bitwise the whole-grid op (on K1's twin for K11's transports)."""
    fdt = getattr(torch, dtype)
    vel = rand(3, N, N, N, seed=5, scale=3.0).to(fdt)
    dens = rand(1, N, N, N, seed=6).abs().to(fdt)
    mask = mask_crossing_shards() if masked else None
    vs = chunks(vel, k, 1)
    masks = None if mask is None else chunks(mask, k, 0)
    base = None
    if transport != "plain":
        def base(b_, f_, v_, d_):
            return HAND_KERNELS.advect(b_, f_, v_, d_, obst=mask, window=window)
    for bs, f, fs in (((1, 2, 3), vel, vs), ((0,), dens, chunks(dens, k, 1))):
        ref = advect_maccormack_3d(bs, f, vel, DT, mask, window, advect_fn=base)
        got = advect_maccormack_shards(bs, vs if f is vel else fs, vs, DT, N, window, masks,
                                       transport)
        assert all(g.shape == (len(bs), N // k, N, N) for g in got)
        assert torch.equal(torch.cat(got, 1), ref), bs


def test_maccormack_kernel_transports_launch_k11(monkeypatch):
    """On K11's transports each MacCormack call runs two K11 launches a
    shard (forward and backward) and nothing else advects."""
    seen = []

    def counted(*args, **kw):
        seen.append(args[6])  # the window
        return HAND_KERNELS.advect_ext(*args, **kw)

    kernels = HAND_KERNELS._replace(advect_ext=counted)
    vel = rand(3, N, N, N, seed=7)
    vs = chunks(vel, 4, 1)
    for transport in ("ppermute", "rdma"):
        seen.clear()
        advect_maccormack_shards((1, 2, 3), vs, vs, DT, N, 2, None, transport, kernels)
        assert seen == [2] * 8


def test_maccormack_per_shard_refuses_a_deep_kernel_halo():
    vs = chunks(rand(3, N, N, N), 8, 1)
    with pytest.raises(ValueError, match="halo"):
        advect_maccormack_shards((1, 2, 3), vs, vs, DT, N, 5, None, "ppermute")


# -- the FFT projection on z-pencils -----------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fft_shards_match_the_whole_volume(k, dtype):
    """Within the class of the JAX ``project_3d_fft`` and of the port's own.
    On bfloat16 fields the projection runs on their float32 values and
    rounds once: bitwise the float32 route's result rounded to bfloat16."""
    vel = rand(3, N, N, N, seed=8).to(getattr(torch, dtype))
    res = t_fft.project_3d_fft_shards(chunks(vel, k, 1))
    got_v = torch.cat([r[0] for r in res], 1)
    got_p = torch.cat([r[1] for r in res], 0)
    assert got_v.dtype == vel.dtype and got_p.dtype == vel.dtype
    if dtype == "bfloat16":
        wide = t_fft.project_3d_fft_shards(chunks(vel.float(), k, 1))
        assert torch.equal(got_v, torch.cat([r[0] for r in wide], 1).to(vel.dtype))
        assert torch.equal(got_p, torch.cat([r[1] for r in wide], 0).to(vel.dtype))
        return
    own_v, own_p = t_fft.project_3d_fft(vel)
    ref_v, ref_p = j_project_3d_fft(jnp.asarray(vel.numpy()))
    for g, o, r, what in ((got_v, own_v, ref_v, "velocity"), (got_p, own_p, ref_p, "p")):
        close(g.numpy(), np.asarray(r), f"{what} against JAX")
        close(g.numpy(), o.numpy(), f"{what} against the port's whole-volume op")


class LargestTensor(TorchDispatchMode):
    """The bytes of the largest tensor any op made."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.bytes = max(self.bytes, t.numel() * t.element_size())
        return out


@pytest.mark.parametrize("k", [2, 4])
def test_fft_shards_hold_no_whole_volume(k):
    """No tensor the sharded route makes is larger than 1/k of the largest
    the whole-volume route makes (its (2N)³ mirror and spectrum), so no shard
    holds an N-deep volume or the 2N mirror; the z-pencils are (2N, 2N/k,
    N + 1)."""
    n = 16
    vel = rand(3, n, n, n, seed=9)
    with LargestTensor() as whole:
        t_fft.project_3d_fft(vel)
    vs = chunks(vel, k, 1)
    with LargestTensor() as shards:
        t_fft.project_3d_fft_shards(vs)
    assert whole.bytes >= 4 * (2 * n) ** 3
    assert shards.bytes <= whole.bytes // k
    shapes = []
    fft = torch.fft.fft

    def spy(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return fft(x, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.fft, "fft", spy)
        t_fft.project_3d_fft_shards(vs)
    assert shapes == [(n // k, 2 * n, n + 1)] * k + [(2 * n, 2 * n // k, n + 1)] * k


@pytest.mark.parametrize("k", [2, 4, 8])
def test_eigenvalue_rows_are_the_table_rows(k):
    """Each shard's rows of the inverse-eigenvalue table are bitwise the
    whole table's rows, and only they are built."""
    n = 16
    shape = (2 * n,) * 3
    table = t_fft._wide_inv_eigenvalues(shape, n + 1)
    rows = 2 * n // k
    for r in range(k):
        part = t_fft._inv_rows(shape, n + 1, r * rows, (r + 1) * rows, torch.device("cpu"))
        assert part.shape == (2 * n, rows, n + 1)
        assert np.array_equal(part.numpy(), table[:, r * rows:(r + 1) * rows])


def test_fft_all_to_alls_wait_on_every_shard(monkeypatch):
    """Every read of another shard's block in the two all-to-alls (and of
    the halo planes) comes after the reading stream waited on that shard's
    mark covering the block's transform; with the waits patched away the
    check sees the reads unordered."""
    vs = chunks(rand(3, N, N, N, seed=10), 4, 1)
    for waits in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            rec = Recorder(mp, waits=waits)
            reads = []
            orig_fetch = ShardOrder.fetch
            made = {}

            def fetch(self, x, r, orig_fetch=orig_fetch):
                owner = made.get(x.untyped_storage().data_ptr())
                if owner is not None and owner[0] != r:
                    reads.append((r, owner, dict(rec.clock_of(self, r))))
                return orig_fetch(self, x, r)

            orig_each = ShardOrder.each

            def each(self, fn, orig_each=orig_each):
                def tagged(r):
                    out = fn(r)
                    for t in (out if isinstance(out, tuple) else (out,)):
                        if isinstance(t, torch.Tensor):
                            made[t.untyped_storage().data_ptr()] = (r, self._ops[r] + 1)
                    return out
                return orig_each(self, tagged)

            mp.setattr(ShardOrder, "fetch", fetch)
            mp.setattr(ShardOrder, "each", each)
            t_fft.project_3d_fft_shards(vs)
        late = [(r, s) for r, (s, ops), clock in reads if clock.get(s, 0) < ops]
        assert len(reads) >= 2 * 4 * 3
        assert (late == []) == waits


@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_maccormack_exchanges_wait_on_their_writers(monkeypatch, backend):
    """The 4-shard explicit step with MacCormack: each K11 launch after its
    stream waited on the neighbours' marks before the exchange that built
    its slabs (the forward field's for the backward advection); with the
    waits patched away the check finds K11 unordered."""
    cfg = preset("sharded_512", advection_scheme="maccormack")
    for waits in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            rec = Recorder(mp, waits=waits)
            m = make_mesh(["cpu"] * 4)
            sharded_step_fn(cfg, m, halo="explicit", halo_block_iters=4, halo_backend=backend,
                            kernels=rec.kernels)(shard_state(start(cfg), m))
        k11 = [e for e in rec.log if e["kind"] == "launch" and e["name"] == "K11"]
        assert len(k11) == 4 * 4
        bad = {name for name, *_ in rec.unordered()}
        assert ("K11" in bad) != waits


# -- the sharded step against the JAX step ----------------------------------------


def run_port(cfg, k, steps, **kw):
    m = make_mesh(["cpu"] * k)
    step = sharded_step_fn(cfg, m, **kw)
    state = shard_state(start(cfg), m)
    for _ in range(steps):
        state = step(state)
    return unshard_state(state)


_JAX = {}


def run_jax(name, change, **kw):
    """The JAX ``sharded_step_fn`` on 4 host devices, 2 steps (cached)."""
    key = (name, tuple(sorted(change.items())), tuple(sorted(kw.items())))
    if key not in _JAX:
        base = dict(size=N, source_radius=2.0, jacobi_iters=4) if name == "sharded_512" \
            else dict(size=N)
        cfg = getattr(j_config, f"preset_{name}")().replace(**base, **change)
        m = j_make_mesh(jax.devices()[:4])
        state = j_shard_state(JState(**{f: jnp.asarray(v) for f, v in
                                        arrays(preset(name, **change)).items()}), m)
        step = j_sharded_step_fn(cfg, m, **kw)
        for _ in range(2):
            state = step(state)
        _JAX[key] = {f: np.asarray(getattr(state, f)) for f in FIELDS}
    return _JAX[key]


MACCORMACK = dict(advection_scheme="maccormack")


@pytest.mark.parametrize("name", ["sharded_512", "vortex_128"])
@pytest.mark.parametrize("halo,backend", [("auto", "auto"), ("explicit", "xla"),
                                          ("explicit", "pallas"), ("explicit", "rdma")])
def test_maccormack_step_within_the_jax_step(name, halo, backend):
    """MacCormack's sharded step (sharded512: no mask; vortex128: its
    sphere) on 4 shards, 2 steps, against the JAX step (``halo="auto"``, or
    explicit at T = 4 with its K10 in interpret mode): within class, and
    nothing gathered."""
    kw = {} if halo == "auto" else dict(halo="explicit", halo_block_iters=4)
    jkw = dict(kw, halo_backend="pallas", pallas_interpret=True) if kw else {}
    ref = run_jax(name, MACCORMACK, **jkw)
    gathered_ops.clear()
    got = state_to_numpy(run_port(preset(name, **MACCORMACK), 4, 2,
                                  halo_backend=backend, **kw))
    assert dict(gathered_ops) == {}
    for f in FIELDS:
        close(got[f], ref[f], f)


def test_fft_step_within_the_jax_step():
    """The FFT projection's sharded step (``halo="auto"``) on 4 and 2
    shards, 2 steps, against the JAX step on 4 host devices: within class,
    nothing gathered."""
    fft = dict(pressure_solver="fft")
    ref = run_jax("sharded_512", fft)
    for k in (4, 2):
        gathered_ops.clear()
        got = state_to_numpy(run_port(preset("sharded_512", **fft), k, 2))
        assert dict(gathered_ops) == {}
        for f in FIELDS:
            close(got[f], ref[f], f"{k} shards: {f}")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("change,halo", [
    (dict(advection_scheme="maccormack"), "explicit"),
    (dict(advection_scheme="maccormack", advect_window=2), "auto"),
    (dict(pressure_solver="fft"), "auto"),
    (dict(advect_window=0), "auto"),
    (dict(advection_scheme="maccormack", advect_window=0), "explicit")],
    ids=["maccormack-explicit", "maccormack-k2-auto", "fft", "window0", "maccormack-window0"])
def test_only_window0_gathers(k, change, halo):
    """On 2 and 4 shards: MacCormack at windows >= 1 and the FFT projection
    gather nothing; window 0 (any scheme) gathers twice a step."""
    cfg = preset("sharded_512", **change)
    kw = dict(halo="explicit", halo_block_iters=4, halo_backend="rdma") \
        if halo == "explicit" else {}
    gathered_ops.clear()
    run_port(cfg, k, 1, **kw)
    want = {"window0": 2} if cfg.advect_window == 0 else {}
    assert dict(gathered_ops) == want


# -- the step factories ------------------------------------------------------------


def test_make_step_matches_the_jax_factory():
    """``make_step`` on bench128 cut to 32³ (the plain path), 2 steps in one
    call, against the JAX ``make_step``: tests/test_torch_step.py's class;
    bitwise two calls of ``make_step_3d``."""
    from test_torch_step import start_arrays as step_start

    t_cfg = t_config.preset_bench_128().replace(size=N, kernel_backend="xla")
    j_cfg = j_config.preset_bench_128().replace(size=N, kernel_backend="xla")
    a = step_start()
    got = state_to_numpy(make_step(t_cfg, 2)(state_from_numpy(a, "cpu")))
    ref = j_make_step(j_cfg, 2)(JState(**{k: jnp.asarray(v) for k, v in a.items()}))
    for f in FIELDS:
        close(got[f], np.asarray(getattr(ref, f)), f)
    assert got["step"] == 2 and got["time"] == np.asarray(ref.time)
    one = make_step_3d(t_cfg)
    twice = state_to_numpy(one(one(state_from_numpy(a, "cpu"))))
    for f in FIELDS:
        assert np.array_equal(twice[f], got[f]), f


@pytest.mark.parametrize("name", ["scene_a", "scene_b"])
def test_make_step_2d_matches_the_jax_factory(name):
    """``make_step_2d`` (and ``make_step`` on a 2D config) on scene_a and
    scene_b cut to 64², 2 steps, against the JAX ``make_step_2d``:
    tests/test_torch_2d.py's rollout class."""
    from test_torch_2d import VMAX, scene, seeded_state

    cfg, jc = scene(name)
    a = seeded_state(cfg, 13, VMAX[name])
    got = state_to_numpy(make_step_2d(cfg, 2)(state_from_numpy(a, "cpu")))
    ref = j_make_step_2d(jc, 2)(JState(**{k: jnp.asarray(v) for k, v in a.items()}))
    for f in FIELDS:
        r = np.asarray(getattr(ref, f))
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[f], r, rtol=1e-3, atol=5e-4 * scale, err_msg=f)
    assert got["step"] == 2
    again = state_to_numpy(make_step(cfg, 2, PLAIN_TWINS)(state_from_numpy(a, "cpu")))
    for f in FIELDS:
        assert np.array_equal(again[f], got[f]), f
