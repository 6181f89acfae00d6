"""``attn_bwd_roofline``: the causal attention backward's least time
(``counts.attn_bwd_work``, whatever implements it) over the device time of
the kernels launched while autograd ran the flash op's backward node, in
percent."""
from portbench import counts

NODE = "autograd::engine::evaluate_function: _FlashAttentionBackward"


def read(ctx):
    if ctx.trace is None:
        return None
    calls, seconds = ctx.trace.count(NODE), ctx.trace.under({NODE})
    if not calls or seconds <= 0:
        return None
    least = counts.min_seconds(counts.attn_bwd_work(
        ctx.model, ctx.batch // ctx.chips, ctx.seq))
    return 100.0 * calls * least / seconds
