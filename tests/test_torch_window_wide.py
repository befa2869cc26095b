"""K1's windowed body at a window of K >= 4 cells in fluidsim_tpu_torch
against the JAX package on the CPU: the K1 twin (F = 1 and 3, one and two
substeps, with and without an obstacle mask, the buoyancy folded with and
without the emitter) against ``advect_multi_3d_pallas`` run in interpret
mode (as tests/test_pallas_interpret.py runs it).  Each case asserts that
the JAX call took its Pallas kernel and not its XLA fallback: its slab
picker (``_pick_slab``) found a slab.

One substep runs at 16³; two substeps at 24³, or 32³ for a halo of more
than 10 planes, where the halo of ``n_sub·K`` planes (``n_sub·(K+1)`` with
the in-kernel mask) leaves the picker a slab.  The velocity's backtrace
reaches up to about K + 2 cells at DT, so the window clamp is exercised.

Tolerance: rtol 2e-5, atol 2e-6·max|ref|, the windowed class of
tests/test_torch_window.py; what remains is XLA-CPU contracting a
multiply-add into an FMA in the interpreted kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.pallas.advect as j_pa
from fluidsim_tpu.pallas.advect import advect_multi_3d_pallas

from fluidsim_tpu_torch.config import preset_bench_128
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
from fluidsim_tpu_torch.scene.sources import emitter_fold_operand

torch.set_num_threads(1)

DT = 0.05


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def box_mask(n):
    obst = np.zeros((n, n, n), bool)
    obst[6:9, 5:10, 6:9] = True
    return obst


def velocity(seed, n, window):
    """A velocity whose backtrace reaches up to about ``window + 2`` cells."""
    return rand(seed, (3, n, n, n), (window + 2) / (DT * (n - 2) * 3.0))


def pallas_route(monkeypatch):
    """Record what the JAX slab picker returns (None: the XLA fallback)."""
    picks = []
    pick = j_pa._pick_slab

    def spy(*a, **k):
        picks.append(pick(*a, **k))
        return picks[-1]

    monkeypatch.setattr(j_pa, "_pick_slab", spy)
    return picks


def assert_close(got, ref, what):
    np.testing.assert_allclose(
        got, ref, rtol=2e-5, atol=2e-6 * float(np.abs(ref).max()),
        err_msg=f"{what}: max abs diff {float(np.abs(got - ref).max()):.3e}")


CASES = [(4, f, s, m) for f in (1, 3) for s in (1, 2) for m in (False, True)] + [
    (5, 3, 1, False), (5, 1, 1, True), (5, 3, 2, True), (5, 1, 2, False)]


@pytest.mark.parametrize("window,n_fields,n_sub,masked", CASES,
                         ids=[f"K{w}-F{f}-sub{s}-{'mask' if m else 'no-mask'}"
                              for w, f, s, m in CASES])
def test_k1_wide_twin_matches_pallas(monkeypatch, window, n_fields, n_sub, masked):
    halo = n_sub * (window + 1) if masked and n_sub > 1 else n_sub * window
    n = 16 if n_sub == 1 else 24 if halo <= 10 else 32
    bs = (1, 2, 3) if n_fields == 3 else (0,)
    vel = velocity(10 * window + n_fields + n_sub, n, window)
    fields = vel if n_fields == 3 else rand(window + n_sub, (1, n, n, n), 2.0)
    obst = box_mask(n) if masked else None
    tv = torch.from_numpy(vel)
    tf = tv if n_fields == 3 else torch.from_numpy(fields)
    got = advect_multi_3d_kernel(bs, tf, tv, DT, obst=None if obst is None else
                                 torch.from_numpy(obst), window=window, n_sub=n_sub).numpy()
    picks = pallas_route(monkeypatch)
    jv = jnp.asarray(vel)
    jf = jv if n_fields == 3 else jnp.asarray(fields)
    ref = np.asarray(advect_multi_3d_pallas(
        bs, jf, jv, DT, None if obst is None else jnp.asarray(obst), window=window,
        n_sub=n_sub, interpret=True))
    assert picks and picks[-1] is not None, "the JAX call fell back to XLA"
    assert_close(got, ref, f"K1 K={window} F={n_fields} n_sub={n_sub}")
    if masked and n_fields == 1:
        solid = obst.copy()
        solid[[0, -1]] = solid[:, [0, -1]] = solid[:, :, [0, -1]] = False
        assert not got[0][solid].any()


@pytest.mark.parametrize("window", [4, 5])
def test_k1_wide_folds_buoyancy_like_pallas(monkeypatch, window):
    """The self-advection with the buoyancy folded into the K >= 4 body,
    without and with the emitter folded into the buoyancy's density, two
    substeps at 24³."""
    n = 24
    vel = velocity(70 + window, n, window)
    dens = np.abs(rand(80 + window, (n, n, n), 4.0))
    buoy = (0.3, 0.1, 0.05)
    tv, jv = torch.from_numpy(vel), jnp.asarray(vel)
    src = emitter_fold_operand(preset_bench_128().replace(size=n), torch.full((), DT))
    picks = pallas_route(monkeypatch)
    for src_t, src_j in ((None, None), (src, jnp.asarray(src.numpy()))):
        got = advect_multi_3d_kernel((1, 2, 3), tv, tv, DT, window=window, n_sub=2,
                                     buoy=(torch.from_numpy(dens), *buoy), src=src_t).numpy()
        ref = np.asarray(advect_multi_3d_pallas(
            (1, 2, 3), jv, jv, DT, None, window=window, n_sub=2,
            buoy=(jnp.asarray(dens), *buoy), src=src_j, interpret=True))
        assert picks[-1] is not None, "the JAX call fell back to XLA"
        assert_close(got, ref, f"K1 K={window} buoyancy, src={src_t is not None}")
