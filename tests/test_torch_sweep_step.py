"""The fused kernels with the sweep-blocked solve (K2, K2s, K2o and K8 with
``sweep_block`` 2 and 4) in fluidsim_tpu_torch against the JAX package (the
3D step with ``jacobi_sweep_block``: tests/test_torch_sweep_engine.py).

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas_interpret.py does); the port runs the CUDA kernels' plain
twins (the wrappers' behaviour for CPU tensors).

Tolerances, each with its reason:

* the twins against their own composition (K3 with the same
  ``sweep_block``, then K1): bitwise, as every fused kernel of the port;
* the twins against JAX: K2's classes of tests/test_torch_fused.py, float32
  solve rtol 3e-5, atol 3e-6 (XLA-CPU's FMA contraction in the interpreted
  backtrace; the composite's own residue against JAX is below 2e-7 of the
  scale, tests/test_torch_sweep_block.py), bfloat16 solve atol
  2e-2·max|ref|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsim_tpu.config import preset_vortex_128 as j_vortex128
from fluidsim_tpu.pallas.resident import (
    full_step_3d_resident,
    project_advect_density_3d_resident,
)
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask

from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_plain
from fluidsim_tpu_torch.kernels.resident import (
    full_step_3d,
    project_3d_resident_plain,
    project_advect_density_3d,
)
from fluidsim_tpu_torch.scene.sources import src_field_add

torch.set_num_threads(1)

N = 32
DT_ADV = 0.03
ITERS = 20
DAMP, DDAMP = 0.99, 0.995


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
    return np.array([0.45 * n, 0.2 * n, 0.55 * n, 7.0, 0.2 * n], np.float32)


def vortex_mask(n=N):
    return np.asarray(j_build_mask(j_vortex128().replace(size=n)))


def assert_k2_class(got, ref, solve_dtype, what):
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        r = np.asarray(r)
        atol = 3e-6 if solve_dtype is None else 2e-2 * np.abs(r).max()
        rtol = 3e-5 if solve_dtype is None else 0.0
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


VARIANTS = {
    "K2": dict(),
    "K2s": dict(src=True),
    "K2o": dict(obst=True, n_sub=3),
}


@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k2_variants_are_k3_then_k1(variant, block):
    """K2, K2s and K2o with the sweep-blocked solve: bitwise K3 with the same
    ``sweep_block``, then K1 on the density (with the emitter, the mask)."""
    kw = VARIANTS[variant]
    vel, dens = (torch.from_numpy(a) for a in inputs(N, 60 + block))
    obst = torch.from_numpy(vortex_mask()) if kw.get("obst") else None
    src = torch.from_numpy(descriptor(N)) if kw.get("src") else None
    n_sub = kw.get("n_sub", 1)
    got = project_advect_density_3d(vel, dens, ITERS, DT_ADV, obst=obst, src=src,
                                    n_sub=n_sub, damp=DAMP, dens_damp=DDAMP,
                                    sweep_block=block)
    v, p = project_3d_resident_plain(vel, ITERS, obst, None, DAMP, block)
    d = dens if src is None else src_field_add(dens, src)
    d = advect_multi_3d_plain((0,), d[None], v, DT_ADV, obst=obst, n_sub=n_sub)[0]
    for g, r in zip(got, (v, p, d * DDAMP)):
        assert torch.equal(g, r)
    seq = project_3d_resident_plain(vel, ITERS, obst, None, DAMP)
    assert not torch.equal(p, seq[1])  # the composite ran


@pytest.mark.parametrize("variant,block,solve_dtype", [
    ("K2", 2, None), ("K2s", 4, None), ("K2o", 2, None), ("K2o", 4, "bfloat16"),
])
def test_k2_variants_match_pallas_interpret(variant, block, solve_dtype):
    kw = VARIANTS[variant]
    vel, dens = inputs(N, 70 + block)
    obst = vortex_mask() if kw.get("obst") else None
    src = descriptor(N) if kw.get("src") else None
    n_sub = kw.get("n_sub", 1)
    ref = project_advect_density_3d_resident(
        jnp.asarray(vel), jnp.asarray(dens), ITERS, DT_ADV, n_sub=n_sub,
        solve_dtype=solve_dtype, obst=None if obst is None else jnp.asarray(obst),
        src=None if src is None else jnp.asarray(src), sweep_block=block,
        interpret=True)
    got = project_advect_density_3d(
        torch.from_numpy(vel), torch.from_numpy(dens), ITERS, DT_ADV, n_sub=n_sub,
        solve_dtype=solve_dtype, obst=None if obst is None else torch.from_numpy(obst),
        src=None if src is None else torch.from_numpy(src), sweep_block=block)
    assert_k2_class(got, ref, solve_dtype, f"{variant} T={block}")


@pytest.mark.parametrize("block,n_sub", [(2, 1), (4, 2)])
def test_k8_is_k1_then_k2_and_matches_pallas_interpret(block, n_sub):
    vel, dens = inputs(N, 80 + block)
    tv, td = torch.from_numpy(vel), torch.from_numpy(dens)
    got = full_step_3d(tv, td, ITERS, DT_ADV, n_sub=n_sub, damp=DAMP, dens_damp=DDAMP,
                       sweep_block=block)
    adv = advect_multi_3d_plain((1, 2, 3), tv, tv, DT_ADV, n_sub=n_sub)
    ref = project_advect_density_3d(adv, td, ITERS, DT_ADV, n_sub=n_sub, damp=DAMP,
                                    dens_damp=DDAMP, sweep_block=block)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    jref = full_step_3d_resident(jnp.asarray(vel), jnp.asarray(dens), ITERS, DT_ADV,
                                 n_sub=n_sub, damp=DAMP, dens_damp=DDAMP,
                                 sweep_block=block, interpret=True)
    assert_k2_class(got, jref, None, f"K8 T={block}")
