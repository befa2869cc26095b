"""K6's share of its roofline: its bound for the cell's solve
(``roofline.k6_ms``: the start, the rhs and the result once at 3.35 TB/s)
times its calls, over the device time of its rounds (``jacobi_round_kernel``,
``⌈iters/4⌉`` a call) in the traced window."""

from portbench import roofline
from portbench.fields import grid_size
from portbench.trace import matcher

ROUND = matcher(r"jacobi_round_kernel")
SWEEPS_A_ROUND = 4


def read(run):
    t = run.trace
    if t is None:
        return None
    ops = t.select(ROUND)
    if not ops:
        return None
    iters = int(run.sim["jacobi_iters"])
    calls = len(ops) / -(-iters // SWEEPS_A_ROUND)
    n = grid_size(run.sim)
    device_ms = sum(b - a for _, a, b in ops) / 1e3
    return 100.0 * calls * roofline.k6_ms(n, iters) / device_ms
