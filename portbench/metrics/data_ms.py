"""``data_ms``: the mean host time a traced step spends in the data layer,
``repro_torch.data.SyntheticLM.next_batch`` and the batch's copy to the
card, from the benchmark's own span around the two."""


def read(ctx):
    if not ctx.data_s:
        return None
    return 1e3 * sum(ctx.data_s) / len(ctx.data_s)
