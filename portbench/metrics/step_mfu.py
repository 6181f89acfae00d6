"""``step_mfu``: the model FLOPs of the traced steps over their time
times the cards' bf16 peak, in percent. The FLOPs are ``counts
.model_flops_train``'s (6·N_mm per token and causal attention; remat's
recompute not counted); the time is the traced window's."""
from portbench import counts


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s() <= 0:
        return None
    flops = counts.model_flops_train(ctx.model, ctx.batch, ctx.seq)
    flops *= ctx.trace.steps()
    return 100.0 * flops / (ctx.trace.window_s() * ctx.chips
                            * counts.PEAK_BF16_FLOPS)
