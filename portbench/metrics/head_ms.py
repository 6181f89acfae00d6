"""``head_ms``: the device time of the kernels launched inside the
program's ``repro_torch::head`` spans on any thread (``repro_torch.obs
.spans``: the final norm, the head product, the vocab mask and the loss,
forward and backward), each kernel once, a traced step, in ms. Nothing to
read where the program has no such span."""
from portbench.program_spans import device_ms_under


def read(ctx):
    return device_ms_under(ctx, "repro_torch::head")
