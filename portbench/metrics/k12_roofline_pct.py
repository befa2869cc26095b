"""K12's share of its roofline on the mesh: the bound of one shard's round
(``roofline.k12_round_ms``: the ``(lz + 2T, n, n)`` start, rhs and result
once at 3.35 TB/s) times the rounds launched, over the union of the rounds'
intervals on the shards' streams in the traced window: the time the card
spent with a round running, which is the time the rounds of all shards
together could take at best."""

from portbench import roofline
from portbench.fields import grid_size
from portbench.trace import matcher

ROUND = matcher(r"jacobi_round_kernel")


def read(run):
    t = run.trace
    if t is None or "shards" not in run.cell:
        return None
    launches = len(t.select(ROUND))
    if not launches:
        return None
    n = grid_size(run.sim)
    lz = n // int(run.cell["shards"])
    bound = roofline.k12_round_ms(n, lz, int(run.cell["halo_block_iters"]))
    return 100.0 * launches * bound / (t.busy_us(ROUND) / 1e3)
