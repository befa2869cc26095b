"""The least time each measured kernel could take on one NVIDIA H100, from
the work its shapes call for: each input byte read once and each output
byte written once at the card's HBM bandwidth, or its float32 operations at
the card's rate outside the tensor cores, whichever bounds it.

The peaks are the published ones of the H100 SXM at its full 700 W limit;
the counts are those of ``chip_smoke.bound`` and the bound notes of the
kernel table in ``PERF.md``, frozen here so that a kernel that a later
change fuses or replaces is read against the same work.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float32 operations a cell.
FRAC_OPS = 3 * 9      # per axis: dt0*v, sub, 2 bounds, 2 clip bounds (+2 adds), sub
RELU_OPS = 3 * 3      # per axis: negate, two max
COMB_OPS = 13 * 6     # per field: 9 x-, 3 y-, 1 z-combination of 6 operations
DIV_OPS = 7
SWEEP_OPS = 7         # 5 neighbour adds, the rhs add, the coefficient multiply
JACOBI_OPS = 8        # K6, K12: 5 neighbour adds, a*nbr, the x0 add, the inv_c multiply
GRAD_OPS = 3 * 5      # per component: sub, 2 mul, sub, damp
F32 = 4


def bound_ms(nbytes: float, nops: float) -> float:
    """The least milliseconds for ``nbytes`` moved and ``nops`` float32
    operations: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3


def k2_ms(n: int, iters: int, field_bytes: int = F32) -> float:
    """K2 (the projection and the density's advection at a window of one
    cell) on an ``n³`` grid: the velocity and the density in, the velocity,
    the pressure and the density out (9 volumes); the divergence, ``iters``
    sweeps, the gradient and one backtrace of one field a cell."""
    interior = (n - 2) ** 3
    return bound_ms(9 * n ** 3 * field_bytes,
                    interior * (DIV_OPS + iters * SWEEP_OPS + GRAD_OPS + FRAC_OPS
                                + RELU_OPS + COMB_OPS + 1))


def k6_ms(n: int, iters: int) -> float:
    """K6, ``iters`` Jacobi sweeps on an ``n³`` grid: the start and the rhs in,
    the result out."""
    return bound_ms(3 * n ** 3 * F32, iters * (n - 2) ** 3 * JACOBI_OPS)


def k12_round_ms(n: int, lz: int, t: int) -> float:
    """One shard's round of K12: ``t`` sweeps on the ``(lz + 2t, n, n)``
    extended slab, the start and the rhs in, the result out."""
    planes = lz + 2 * t
    return bound_ms(3 * planes * n * n * F32, t * planes * (n - 2) ** 2 * JACOBI_OPS)
