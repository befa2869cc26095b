"""The ``"rdma"`` backend of fluidsim_tpu_torch's explicit sharded step
(K12 and K13 in ``kernels/halo.py``, their use in ``parallel/halo.py``) and
K11 on bfloat16 slabs, against the JAX package's ``halo_exchange_rdma``,
``jacobi_3d_sharded(backend="rdma")``, ``advect_multi_3d_sharded(
transport="rdma")``, ``advect_ext_pallas`` and ``sharded_step_fn`` with the
Pallas kernels in interpret mode (whose emulator carries the remote DMAs
between the host devices), and against the port's own other backends.

The JAX side runs under ``shard_map`` on 2 or 4 of tests/conftest.py's host
devices; the port on ``make_mesh(["cpu"] * k)``, where every wrapper takes
its plain twin.  32³ grids at most, as the interpret-mode emulator is slow.

Tolerances, with what was observed:

* K13's twin against ``halo_exchange_rdma``: bitwise (copies), on float32,
  bfloat16 and the mask (the port's bool against JAX's int8: the same 0/1).
* The rdma solve against the JAX rdma solve: rtol = atol = 2e-6
  (tests/test_torch_halo.py's class for K10); observed bitwise.  It is
  bitwise the port's ``"pallas"`` solve.
* The rdma advection against the JAX rdma advection: rtol 5e-4, atol 5e-5
  (tests/test_torch_halo_advect.py's class); observed at most 7.0e-6 on
  fields of unit scale, about 35-39% of cells bitwise.  It is bitwise the
  port's ppermute advection.
* K11's bfloat16 twin against ``advect_ext_pallas`` on bfloat16 slabs: equal
  but for cells one bfloat16 ulp apart, under 1% of them
  (tests/test_torch_bf16.py's class: XLA on the CPU contracts the
  interpreted kernel's multiply-adds into FMAs, which can move a float32
  value across a bfloat16 rounding boundary); observed bitwise in all four
  cases.
* The bfloat16 explicit step on 4 shards against the JAX one: storage
  precision, rtol 3e-2, atol 3e-2·max|ref| (tests/test_torch_bf16.py's step
  class); the port's ``"rdma"`` bf16 step is bitwise its ``"pallas"`` one.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import fluidsim_tpu.config as j_config
from fluidsim_tpu.pallas.halo_kernel import advect_ext_pallas
from fluidsim_tpu.pallas.halo_kernel import halo_exchange_rdma as j_exchange
from fluidsim_tpu.parallel.halo import advect_multi_3d_sharded as j_advect_sharded
from fluidsim_tpu.parallel.sharding import make_mesh as j_make_mesh
from fluidsim_tpu.parallel.sharding import shard_state as j_shard_state
from fluidsim_tpu.parallel.sharding import sharded_step_fn as j_sharded_step_fn
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.config as t_config
from fluidsim_tpu_torch.io.convert import state_from_numpy
from fluidsim_tpu_torch.kernels.halo import (
    advect_ext_plain,
    ext_halo,
    halo_exchange_rdma,
    halo_exchange_rdma_plain,
)
from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn, unshard_state
from fluidsim_tpu_torch.parallel.halo import advect_multi_3d_sharded

from test_torch_bf16 import assert_storage_close, assert_ulp_class
from test_torch_halo import jax_solve, mask32, port_solve, solve_inputs
from test_torch_halo_advect import close, inputs
from test_torch_multi256 import start_arrays

torch.set_num_threads(1)

N = 32
SHARDS = 4
DT = 0.05
BF16 = torch.bfloat16


def to_jax(t):
    """A torch tensor as a JAX array of the same values (the mask as int8)."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype == torch.bool:
        return jnp.asarray(t.numpy().astype(np.int8))
    return jnp.asarray(t.numpy())


def as_numpy(t):
    if t.dtype == BF16:
        return t.float().numpy()
    if t.dtype == torch.bool:
        return t.numpy().astype(np.int8)
    return t.numpy()


# -- K13 ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("shards", [2, 4])
def test_k13_twin_matches_jax(shards, depth):
    """Three arrays in one call: two float32 channels, a bfloat16 field and
    the mask, every shard's extended arrays bitwise."""
    rng = np.random.default_rng(shards * 10 + depth)
    arrays = [torch.from_numpy(rng.standard_normal((2, N, 16, 16)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((1, N, 16, 16)).astype(np.float32)).to(BF16),
              torch.from_numpy(rng.standard_normal((1, N, 16, 16)) > 0.5)]
    spec = P(None, "z", None, None)
    run = functools.partial(
        jax.shard_map, mesh=j_make_mesh(jax.devices()[:shards]), in_specs=(spec,) * 3,
        out_specs=(spec,) * 3, check_vma=False,
    )(lambda *xs: tuple(j_exchange(list(xs), depth, "z", interpret=True,
                                   vma=frozenset({"z"}))))
    ref = run(*(to_jax(a) for a in arrays))
    by_shard = [[torch.chunk(a, shards, 1)[r] for a in arrays] for r in range(shards)]
    got = halo_exchange_rdma(by_shard, depth)
    for j, (a, r) in enumerate(zip(arrays, ref)):
        ext = torch.cat([got[s][j] for s in range(shards)], 1)
        assert ext.dtype == a.dtype
        np.testing.assert_array_equal(as_numpy(ext), np.asarray(r).astype(as_numpy(ext).dtype),
                                      err_msg=f"array {j}")


def test_k13_errors():
    """The JAX package's errors, on the twin's path too."""
    x = torch.zeros(1, N, 8, 8)
    halves = [[h] for h in torch.chunk(x, 2, 1)]
    with pytest.raises(ValueError, match="local slab depth"):
        halo_exchange_rdma(halves, N // 2 + 1)
    with pytest.raises(ValueError, match="geometry"):
        halo_exchange_rdma([h + [h[0][:, :4]] for h in halves], 2)
    with pytest.raises(ValueError, match="dtype"):
        halo_exchange_rdma_plain([halves[0], [halves[1][0].double()]], 2)


# -- the rdma solve: K13's priming, then K12 rounds ---------------------------------

@pytest.mark.parametrize("b,masked", [(0, False), (3, False), (0, True)])
def test_rdma_solve_matches_jax(b, masked):
    """4 shards of 8 planes, 4 sweeps at T = 2 (two K12 rounds)."""
    x, x0 = solve_inputs(b, 140 + b + masked)
    obst = mask32() if masked else None
    if masked:
        x = np.where(obst, 0.0, x).astype(np.float32)  # the solve's zero in solids
    got = port_solve(x, x0, SHARDS, b=b, block_iters=2, backend="rdma", obst=obst)
    ref = jax_solve(x, x0, SHARDS, b=b, block_iters=2, backend="rdma", interpret=True,
                    obst=obst)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)
    pallas = port_solve(x, x0, SHARDS, b=b, block_iters=2, backend="pallas", obst=obst)
    np.testing.assert_array_equal(got, pallas)


# -- the rdma advection: one K13 a call, then K11 -----------------------------------

@pytest.mark.parametrize("case", ["self", "density", "self with mask"])
def test_rdma_advection_matches_jax(case):
    """Window 1, two substeps: the fields, the velocity and the mask ride one
    exchange (a halo of 2 planes, 4 with the mask)."""
    vel, fields = inputs({"self": 11, "density": 12, "self with mask": 13}[case], 3)
    bs = (0,) if case == "density" else (1, 2, 3)
    obst = mask32() if case == "self with mask" else None
    t_vel = torch.from_numpy(vel)
    t_fields = t_vel if bs == (1, 2, 3) else torch.from_numpy(fields[:1])
    t_obst = None if obst is None else torch.from_numpy(obst)
    mesh = make_mesh(["cpu"] * SHARDS)
    got = advect_multi_3d_sharded(bs, t_fields, t_vel, DT, mesh, window=1, n_sub=2,
                                  transport="rdma", obst=t_obst)
    j_vel = jnp.asarray(vel)
    j_fields = j_vel if bs == (1, 2, 3) else jnp.asarray(fields[:1])
    ref = j_advect_sharded(bs, j_fields, j_vel, DT, j_make_mesh(jax.devices()[:SHARDS]),
                           window=1, n_sub=2, interpret=True, transport="rdma",
                           obst=None if obst is None else jnp.asarray(obst))
    close(got.numpy(), np.asarray(ref), case)
    ppermute = advect_multi_3d_sharded(bs, t_fields, t_vel, DT, mesh, window=1, n_sub=2,
                                       obst=t_obst)
    assert torch.equal(got, ppermute)


# -- K11 on bfloat16 slabs ----------------------------------------------------------

@pytest.mark.parametrize("n_fields,window,masked", [(3, 1, False), (1, 1, False), (3, 1, True),
                                                    (1, 2, False)])
def test_k11_bf16_twin_matches_pallas(n_fields, window, masked):
    """One middle shard's bfloat16 slab (8 planes and the halo), two
    substeps, on the planes the caller keeps."""
    n_sub, lz, shard = 2, 8, 1
    vel, fields = inputs(20 + n_fields + window + masked, 3)
    h = ext_halo(window, n_sub, masked)
    start = shard * lz - h
    obst = mask32() if masked else None

    def slab(a):
        return torch.from_numpy(np.ascontiguousarray(a[..., start:start + lz + 2 * h, :, :]))

    v = slab(vel).to(BF16)
    f = v if n_fields == 3 else slab(fields[:1]).to(BF16)
    m = None if obst is None else slab(obst)
    bs = (1, 2, 3) if n_fields == 3 else (0,)
    got = advect_ext_plain(bs, f, v, N, DT, start, window, n_sub, m)
    assert got.dtype == BF16
    j_v = to_jax(v)
    j_f = j_v if n_fields == 3 else to_jax(f)
    ref = advect_ext_pallas(bs, j_f, j_v, N, DT, start, window=window, n_sub=n_sub,
                            obst_ext=None if m is None else to_jax(m), interpret=True)
    assert ref.dtype == jnp.bfloat16
    assert_ulp_class(got[:, h:h + lz], np.asarray(ref.astype(jnp.float32))[:, h:h + lz],
                     f"K11 bf16 F={n_fields} K={window}")


# -- the bfloat16 explicit step ---------------------------------------------------

def bf16_start():
    arrays = start_arrays()
    return {k: torch.from_numpy(v).to(BF16).float().numpy()
            if k in ("density", "velocity", "pressure") else v for k, v in arrays.items()}


@pytest.mark.parametrize("backend", ["pallas", "rdma"])
def test_bf16_explicit_step_matches_jax(backend):
    """sharded512 cut to 32³ in bfloat16 on 4 shards, T = 2, 2 steps: K11 on
    bfloat16 slabs (and on ``"rdma"`` K13 carrying them), the solve in
    float32; the ``"rdma"`` step bitwise the ``"pallas"`` one."""
    change = dict(size=N, source_radius=2.0, jacobi_iters=4, dtype="bfloat16")
    j_cfg = j_config.preset_sharded_512().replace(**change)
    t_cfg = t_config.preset_sharded_512().replace(**change)
    arrays = bf16_start()
    kw = dict(halo="explicit", halo_block_iters=2, halo_backend=backend)
    j_mesh = j_make_mesh(jax.devices()[:SHARDS])
    jst = j_shard_state(JState(**{
        k: jnp.asarray(v).astype(jnp.bfloat16) if k in ("density", "velocity", "pressure")
        else jnp.asarray(v) for k, v in arrays.items()}), j_mesh)
    j_step = j_sharded_step_fn(j_cfg, j_mesh, pallas_interpret=True, **kw)
    mesh = make_mesh(["cpu"] * SHARDS)
    t_start = shard_state(state_from_numpy(arrays, "cpu", dtype="bfloat16"), mesh)
    tst = t_start
    step = sharded_step_fn(t_cfg, mesh, **kw)
    for _ in range(2):
        jst, tst = j_step(jst), step(tst)
    tst = unshard_state(tst)
    for field in ("density", "velocity", "pressure"):
        got = getattr(tst, field)
        assert got.dtype == BF16, field
        assert_storage_close(got, np.asarray(getattr(jst, field).astype(jnp.float32)), field)
    if backend == "rdma":
        other = t_start
        pallas = sharded_step_fn(t_cfg, mesh, **dict(kw, halo_backend="pallas"))
        for _ in range(2):
            other = pallas(other)
        other = unshard_state(other)
        for field in ("density", "velocity", "pressure"):
            assert torch.equal(getattr(tst, field), getattr(other, field)), field
