"""``idle_share``: the share of the traced window in which no kernel,
copy or set ran on the card, 100 · (1 − busy / window), from the
profiler's trace; on several cards the mean of their shares."""


def read(ctx):
    if ctx.trace is None:
        return None
    window = ctx.trace.window_s()
    busy = [ctx.trace.busy_s(d) for d in ctx.devices]
    if window <= 0 or not any(busy):
        return None
    return 100.0 * (1.0 - sum(busy) / len(busy) / window)
