"""``moe_dropped_pct``: the share of the MoE's routed assignments that
found no slot in their expert's capacity, 100 · ``moe.dropped`` /
``moe.routed``, the program's device counters (``repro_torch.obs
.metrics``), which count while the profiler records: read after the
traced window. A remat replay counts its forward again, in both. Nothing
to read where the program keeps no such counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    from repro_torch.obs import metrics
    counters = metrics.snapshot().get("counters", {})
    routed, dropped = counters.get("moe.routed"), counters.get("moe.dropped")
    if not routed or dropped is None:
        return None
    return 100.0 * dropped / routed
