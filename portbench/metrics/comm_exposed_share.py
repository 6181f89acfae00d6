"""``comm_exposed_share``: the share of the traced window in which NCCL
kernels run on a card and no other kernel does, in percent, on the card
where it is largest. Nothing to read where no NCCL kernel ran."""


def _minus(spans, cover):
    """The length of ``spans`` not covered by ``cover`` (both sorted
    unions of intervals)."""
    out, j = 0.0, 0
    for a, b in spans:
        at = a
        while j < len(cover) and cover[j][1] <= at:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            c0, c1 = cover[k]
            if c0 > at:
                out += c0 - at
            at = max(at, c1)
            k += 1
        if b > at:
            out += b - at
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    window = ctx.trace.window_s()
    shares = []
    for d in ctx.devices:
        nccl = ctx.trace.busy_intervals(d, lambda n: "nccl" in n.lower())
        if not nccl:
            continue
        other = ctx.trace.busy_intervals(
            d, lambda n: "nccl" not in n.lower())
        shares.append(_minus(nccl, other) * 1e-6 / window)
    if not shares or window <= 0:
        return None
    return 100.0 * max(shares)
