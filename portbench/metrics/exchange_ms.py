"""The milliseconds a step in which the sharded step's exchange ran on the
card: the union of the intervals of K13, ``torch.cat`` and the copies (the
parts of ``utils/profiling.SHARDED_STEP_PARTS`` that move planes between
shards) over the traced window's steps."""

from portbench.trace import matcher

EXCHANGE = matcher(r"exchange_kernel", r"CatArrayBatchedCopy", r"(?i)copy", r"Memcpy")


def read(run):
    t = run.trace
    if t is None or not run.trace_steps or not t.select(EXCHANGE):
        return None
    return t.busy_us(EXCHANGE) / 1e3 / run.trace_steps
