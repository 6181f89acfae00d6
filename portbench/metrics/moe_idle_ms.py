"""``moe_idle_ms``: the card's idle time within the traced window while
some thread is inside the program's ``repro_torch::moe`` spans
(``repro_torch.obs.spans``; the union over threads, each instant once), a
traced step, in ms; on several cards the mean of theirs. The host's share
of the MoE: what its launches leave the card waiting. Nothing to read
where the program has no such span."""
from portbench.program_spans import idle_ms_inside


def read(ctx):
    return idle_ms_inside(ctx, "repro_torch::moe")
