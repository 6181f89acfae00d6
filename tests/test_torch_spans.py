"""The training step's spans and routing counters (``repro_torch.obs.spans``,
``obs.metrics.add``) on a two-layer MoE whose groups and capacity are small
enough that assignments drop, with remat on and off: untraced, no
``record_function`` is entered and the graph gains no node; under a CPU
profiler the loss and every gradient are bit-equal to the untraced step,
every span is in the trace, the backward ranges open and close on one
thread around the MoE's and the head's backward nodes, and the counters
give the share of dropped assignments that the slots give."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import _loss_and_grads, make_train_step
from repro_torch.models import init_params
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.obs import metrics, spans
from repro_torch.optim import make_optimizer
from repro_torch.tree import leaves, tree_map

NAMES = {spans.FORWARD, spans.BACKWARD, spans.OPTIMIZER_UPDATE, spans.HEAD,
         spans.MOE, spans.MOE_ROUTE, spans.MOE_DISPATCH, spans.MOE_EXPERTS,
         spans.MOE_COMBINE, spans.DATA}
# backward nodes of ops that only the MoE block runs
MOE_NODES = ("SiluBackward0", "ScatterAddBackward0", "_ProductsBackward",
             "LogsumexpBackward0", "GatherBackward0")
MARKERS = ("_OpenBackward", "_CloseBackward")


def config(remat: bool):
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(remat=remat)
    moe = {**vars(cfg.moe), "capacity_factor": 0.5, "group_size": 32}
    return cfg.replace(moe=cfg.moe.__class__(**moe))


def setup(remat: bool, seed: int = 0):
    cfg = config(remat)
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    for p in leaves(params):
        p.requires_grad_(True)
    batch = SyntheticLM(cfg, 2, 64, seed=seed).next_batch()
    return cfg, params, batch


def graph_names(t: torch.Tensor):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


@pytest.fixture
def entered(monkeypatch):
    """How many times a ``record_function`` was entered."""
    calls = []
    real = record_function.__enter__

    def enter(self):
        calls.append(self.name)
        return real(self)
    monkeypatch.setattr(record_function, "__enter__", enter)
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_untraced_step_enters_no_range_and_adds_no_node(remat, entered):
    cfg, params, batch = setup(remat)
    loss, _ = tt.loss_fn(params, batch, cfg)
    names = graph_names(loss)
    assert "_ProductsBackward" in names           # the MoE is in the graph
    assert not any(n in MARKERS for n in names)
    step = make_train_step(cfg, make_optimizer("adamw", lr=1e-3))
    step(params, step_state(params), batch)
    SyntheticLM(cfg, 2, 64).next_batch()
    assert entered == []


def step_state(params):
    return make_optimizer("adamw", lr=1e-3).init(
        tree_map(lambda p: p.detach(), params))


def test_grad_span_is_the_identity_untraced():
    x = torch.ones(3, requires_grad=True)
    y, at_output = spans.grad_span(spans.MOE, x)
    assert y is x and at_output(x) is x


@pytest.mark.parametrize("remat", [False, True])
def test_traced_loss_and_grads_are_bit_equal(remat):
    cfg, params, batch = setup(remat)
    want, wm = _loss_and_grads(params, batch, cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        loss, _ = tt.loss_fn(params, batch, cfg)
        assert any(n in MARKERS for n in graph_names(loss))
        got, gm = _loss_and_grads(params, batch, cfg)
    assert torch.equal(gm["loss"], wm["loss"])
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


def traced_step(remat: bool, tmp_path):
    cfg, params, _ = setup(remat)
    data = SyntheticLM(cfg, 2, 64)
    opt = make_optimizer("adamw", lr=1e-3)
    step = make_train_step(cfg, opt)
    state = step_state(params)
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, data.next_batch())
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
            for e in events]


def backward_ranges(events, name):
    """The backward ranges ``name``: (start, end, thread) of each range
    that opens inside an ``_Open`` node and closes inside a ``_Close``
    node on the same thread (a span that ends inside the ``_Open`` node
    is a remat replay's forward)."""
    def node(kind):
        return [(a, b, t) for a, b, n, t in events
                if n == f"autograd::engine::evaluate_function: {kind}"]
    opens, closes = node("_OpenBackward"), node("_CloseBackward")
    out = []
    for a, b, n, t in events:
        if n != name:
            continue
        at = [(o0, o1) for o0, o1, ot in opens if o0 <= a <= o1 and ot == t]
        if at and not at[0][0] <= b <= at[0][1]:
            assert any(c0 <= b <= c1 and ct == t for c0, c1, ct in closes)
            out.append((a, b, t))
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_every_span_and_the_backward_ranges(remat, tmp_path):
    events = traced_step(remat, tmp_path)
    assert NAMES <= {n for _, _, n, _ in events}
    moe = backward_ranges(events, spans.MOE)
    head = backward_ranges(events, spans.HEAD)
    assert len(moe) == 2 and len(head) == 1     # two MoE layers, one head
    for a, b, n, t in events:
        kind = n.rpartition(": ")[2]
        if not n.startswith("autograd::engine::evaluate_function"):
            continue
        if kind in MOE_NODES:
            assert any(r0 <= a and b <= r1 and rt == t
                       for r0, r1, rt in moe), kind
        if kind == "_CrossEntropyBackward":
            assert any(r0 <= a and b <= r1 for r0, r1, _ in head)
    # the head's range holds no MoE node, the MoE's no head node
    for r0, r1, _ in head:
        assert not any(r0 <= a <= r1 and n.endswith(MOE_NODES)
                       for a, _, n, _ in events)
    # a remat replay runs the MoE's forward spans on the backward's side,
    # before its range opens
    forwards = [a for a, _, n, _ in events if n == spans.MOE_ROUTE]
    assert len(forwards) == (4 if remat else 2)
    assert not any(r0 <= a <= r1 for a in forwards for r0, r1, _ in moe)


@pytest.mark.parametrize("remat", [False, True])
def test_dropped_share_is_the_slots(remat, monkeypatch):
    calls = []
    real = tm.assign_slots

    def assign_slots(gate_idx, gate_vals, num_experts, cap):
        dispatch, combine = real(gate_idx, gate_vals, num_experts, cap)
        calls.append((gate_idx.numel(), int(dispatch.sum())))
        return dispatch, combine
    monkeypatch.setattr(tm, "assign_slots", assign_slots)
    cfg, params, batch = setup(remat)
    metrics.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _loss_and_grads(params, batch, cfg)
        counters = metrics.snapshot()["counters"]
    finally:
        metrics.reset()
    # the forward's two layers, and with remat their replays
    assert len(calls) == (4 if remat else 2)
    routed = sum(n for n, _ in calls)
    dropped = sum(n - kept for n, kept in calls)
    assert counters["moe.routed"] == routed
    assert counters["moe.dropped"] == dropped
    first = calls[:2]
    share = sum(n - kept for n, kept in first) / sum(n for n, _ in first)
    assert 0 < dropped / routed == share < 1


def test_device_counters_record_only_when_on():
    metrics.reset()
    try:
        metrics.add("c", torch.tensor(3))
        assert "counters" not in metrics.snapshot()
        with metrics.collecting():
            metrics.add("c", torch.tensor(3))
            metrics.add("c", torch.tensor(4))
        with profile(activities=[ProfilerActivity.CPU]):
            metrics.add("c", torch.tensor(5))
        assert metrics.snapshot()["counters"] == {"c": 12}
    finally:
        metrics.reset()
    assert metrics.snapshot() == {}
