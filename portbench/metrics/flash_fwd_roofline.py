"""``flash_fwd_roofline``: the causal attention forward's least time at
the cell's shapes (``counts.flash_fwd_work``: FLOPs over the bf16 peak or
bytes over the HBM bandwidth, the larger) over the device time of the
kernels launched under the ``repro_torch::flash_attention_fwd`` op, in
percent; each call of the op is one layer's forward or its remat
replay."""
from portbench import counts

OP = "repro_torch::flash_attention_fwd"


def read(ctx):
    if ctx.trace is None:
        return None
    calls, seconds = ctx.trace.count(OP), ctx.trace.under({OP})
    if not calls or seconds <= 0:
        return None
    least = counts.min_seconds(counts.flash_fwd_work(
        ctx.model, ctx.batch // ctx.chips, ctx.seq))
    return 100.0 * calls * least / seconds
