"""K2's share of its roofline: its bound at the cell's grid (the projection
and the density's advection: 9 volumes once at 3.35 TB/s, ``roofline.k2_ms``)
times its calls, over the device time of K2's kernels in the traced window:
the projection's (the tiled solve or the per-sweep route, the gradient) and
the density's backtrace (K1's entry with one field)."""

from portbench import roofline
from portbench.fields import grid_size
from portbench.trace import matcher

K2 = matcher(r"solve_tiled_kernel", r"divergence_kernel<", r"jacobi_sweep_kernel",
             r"stage_kernel", r"gradient_kernel<", r"mirror_obstacles_kernel",
             r"scale_kernel", r"advect_(tiled_|window_)?kernel<1,")
CALLS = matcher(r"gradient_kernel<")


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = len(t.select(CALLS))
    ops = t.select(K2)
    if not calls or not ops:
        return None
    device_ms = sum(b - a for _, a, b in ops) / 1e3
    n = grid_size(run.sim)
    fb = 2 if run.sim["dtype"] == "bfloat16" else 4
    return 100.0 * calls * roofline.k2_ms(n, int(run.sim["jacobi_iters"]), fb) / device_ms
