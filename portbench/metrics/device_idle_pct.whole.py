"""The share of the traced window in which no operation ran on the device:
``100·(1 − busy/window)``, busy the union of every device operation's
interval on every stream."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
