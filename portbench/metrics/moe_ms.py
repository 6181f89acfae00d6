"""``moe_ms``: the device time of the kernels launched inside the
program's ``repro_torch::moe`` spans on any thread (``repro_torch.obs
.spans``: the MoE block's forward, its remat replay and its backward
range), each kernel once, a traced step, in ms. Nothing to read where
the program has no such span."""
from portbench.program_spans import device_ms_under


def read(ctx):
    return device_ms_under(ctx, "repro_torch::moe")
