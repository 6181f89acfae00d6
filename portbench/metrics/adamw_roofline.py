"""``adamw_roofline``: AdamW's least time, 28 bytes a parameter over the
HBM bandwidth (``counts.adamw_work``), over the device time of the
kernels launched inside the benchmark's span around the optimizer's
``update``, in percent."""
from portbench import counts

SPAN = "portbench::optimizer_update"


def read(ctx):
    if ctx.trace is None:
        return None
    calls, seconds = ctx.trace.count(SPAN), ctx.trace.under({SPAN})
    if not calls or seconds <= 0:
        return None
    least = counts.min_seconds(counts.adamw_work(ctx.n_params // ctx.chips))
    return 100.0 * calls * least / seconds
