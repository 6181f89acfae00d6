"""One run of one training cell: set-up, the measured or traced window,
the check against the reference, and the result line.

The window drives the port's training step as ``repro_torch.launch.train
.run``'s loop does: ``SyntheticLM.next_batch()``, the batch to the card,
``make_train_step(cfg, opt)``'s step, ``float(loss)``. Set-up builds that
one step object with the benchmark's weights (``weights.py``), runs the
first ``check_steps`` steps through it, reads from them what the check
compares (each step's loss, the first gradient from the optimizer's
moment, each leaf's change), and hands the same object to the window.
After the window the program's state is freed and the reference
(``reference/``) follows the same steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from portbench import check, reference, spec, trace as trace_mod, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DATA_SPAN = "portbench::data"
UPDATE_SPAN = "portbench::optimizer_update"
# the traced window: whole steps filling about this many seconds (at least
# two, at most twelve), after one profiled step that is not counted
TRACE_SECONDS = 8.0
OUT_DIR = spec.ROOT / "build" / "portbench"


def process_start() -> float:
    """The wall-clock time this process started (from ``/proc``), or now
    where that cannot be read."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def model_config(model: Dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    fields = dict(model)
    moe = fields.pop("moe", None)
    fields["pattern"] = tuple(fields["pattern"])
    return ModelConfig(**fields, moe=MoEConfig(**moe) if moe else None)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: the port's training step with its weights,
    optimizer state and data pipeline. ``fault`` breaks it on purpose for
    the tests of the check: ``"unchanged"`` (the update leaves the state
    as it was) or ``"half"`` (each step sees the first half of its
    batch's rows, the mean over them)."""

    def __init__(self, cell: spec.Cell, seed: int, device,
                 fault: Optional[str] = None):
        from repro_torch.data import SyntheticLM
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import Optimizer, make_optimizer
        self.started = time.time()
        model, t = cell.config["model"], cell.traffic
        cfg = model_config(model)
        opt = make_optimizer(t["optimizer"], lr=t["lr"], b1=t["b1"],
                             b2=t["b2"], eps=t["eps"],
                             weight_decay=t["weight_decay"])

        def update(grads, state, params):
            with record_function(UPDATE_SPAN):
                if fault == "unchanged":
                    return params, state
                return opt.update(grads, state, params)

        self.opt = Optimizer(opt.name, opt.init, update)
        self.device, self.fault = device, fault
        t0 = time.perf_counter()
        self.params = weights.make(model, seed, device)
        self.state = self.opt.init(self.params)
        _sync(device)
        self.init_s = time.perf_counter() - t0
        self.step_fn = make_train_step(cfg, self.opt)
        self.data = SyntheticLM(cfg, t["batch"], t["seq"],
                                seed=seed % (1 << 63))
        self.data_s: List[float] = []

    def step(self):
        """One step as the training loop runs it: (loss, the batch as the
        pipeline made it)."""
        t0 = time.perf_counter()
        with record_function(DATA_SPAN):
            made = self.data.next_batch()
            batch = {k: v.to(self.device) for k, v in made.items()}
        self.data_s.append(time.perf_counter() - t0)
        if self.fault == "half":
            batch = {k: v[:len(v) // 2] for k, v in batch.items()}
        self.params, self.state, metrics = self.step_fn(
            self.params, self.state, batch)
        return float(metrics["loss"]), made


def first_grad_norms(state: Dict, b1: float) -> Dict[str, float]:
    """Each leaf's first gradient norm as the optimizer got it: its first
    moment after one step is (1 − b1)·g."""
    return {"/".join(k): float(torch.linalg.vector_norm(m.float())) / (1 - b1)
            for k, m in weights.flat(state["mu"]).items()}


@dataclass
class Context:
    """What a per-layer reader reads."""
    model: Dict
    batch: int
    seq: int
    chips: int
    n_params: int
    devices: List[int]
    trace: Optional[trace_mod.Trace] = None
    data_s: List[float] = field(default_factory=list)


def _card() -> Dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return {"nvidia_smi": out[0] if out else ""}
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "not read"}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def setup(cell: spec.Cell, seed: int, device, fault: Optional[str] = None):
    """The program with the steps the check follows run through the
    window's own call: (program, its readings, the batches it was fed,
    each step's seconds, the seconds spent reading)."""
    model, t = cell.config["model"], cell.traffic
    prog = Program(cell, seed, device, fault)
    got = {"losses": [], "grad_norms": {}, "change_norms": {}}
    batches, step_s, check_s = [], [], 0.0
    for i in range(t["check_steps"]):
        t0 = time.perf_counter()
        loss, made = prog.step()
        step_s.append(time.perf_counter() - t0)
        got["losses"].append(loss)
        batches.append((made["tokens"], made["labels"]))
        if i == 0:
            t0 = time.perf_counter()
            got["grad_norms"] = first_grad_norms(prog.state, t["b1"])
            check_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    got["change_norms"] = weights.change_norms(model, seed, prog.params,
                                               device)
    _sync(device)
    check_s += time.perf_counter() - t0
    return prog, got, batches, step_s, check_s


def hyper(traffic: Dict) -> Dict:
    return {k: traffic[k] for k in ("lr", "b1", "b2", "eps", "weight_decay")}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device="cuda", fault: Optional[str] = None,
        started: Optional[float] = None) -> Dict:
    """One run; returns the result line's dict (``check`` its last key)
    and the lines to print last on standard error (``"stderr"``)."""
    started = time.time() if started is None else started
    if cell.chips != 1:
        raise NotImplementedError("the harness runs one-chip cells")
    model, t = cell.config["model"], cell.traffic
    on_card = torch.device(device).type == "cuda"
    prog, got, batches, step_s, check_s = setup(cell, seed, device, fault)
    setup_s = time.time() - started - check_s
    print(f"set-up {setup_s:.2f} s (to the program's start "
          f"{prog.started - started:.2f} s, weights and optimizer state "
          f"{prog.init_s:.2f} s); steps " + " ".join(
        f"{s:.3f}" for s in step_s) + " s; losses " + " ".join(
        f"{x:.6f}" for x in got["losses"]), flush=True)

    attempted = failed = 0
    metrics: Dict = {}
    ctx = Context(model, t["batch"], t["seq"], cell.chips,
                  weights.total(model),
                  [torch.device(device).index or 0])
    breakdown = None
    if traced:
        steady = statistics.median(step_s[1:] or step_s)
        k = min(max(math.ceil(min(seconds, TRACE_SECONDS) / steady), 2), 12)
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"trace.{cell.name}.json"
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=k),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            for _ in range(k + 1):
                loss, _ = prog.step()
                attempted += 1
                failed += not math.isfinite(loss)
                prof.step()
        ctx.trace = trace_mod.load(path)
        ctx.data_s = prog.data_s[-k:]
        window_s = ctx.trace.window_s()
        busy_s = statistics.mean(ctx.trace.busy_s(d) for d in ctx.devices)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": ctx.trace.top_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    else:
        t0 = time.perf_counter()
        steps = 0
        while True:
            try:
                loss, _ = prog.step()
            except Exception as exc:  # a step that raises fails the run
                attempted += 1
                failed += 1
                print(f"step {attempted} raised: {exc!r}", file=sys.stderr)
                break
            attempted += 1
            steps += 1
            failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        tokens = steps * t["batch"] * t["seq"]
        print(f"window {window:.3f} s, {steps} steps, "
              f"{tokens / window:.1f} tokens/s", flush=True)
        metrics["tokens_per_s"] = {"value": tokens / window,
                                   "unit": "tokens/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if not traced:
        metrics["peak_mem_gb"] = {"value": peak / 1e9, "unit": "GB"}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}

    # the check: the program's state freed, the reference from the same
    # weights and batches
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference.follow(model, seed, batches, hyper(t), device,
                            rows=t["reference_rows"])
    ref_s = time.perf_counter() - t0
    nums = check.numbers(got, want)
    correct, shown = check.judge(nums, cell.limits)
    correct = correct and failed == 0
    print(f"reference {ref_s:.2f} s; losses " + " ".join(
        f"{x:.6f}" for x in want["losses"]) + f"; worst leaves: gradient "
        f"{nums['grad_leaf']}, change {nums['change_leaf']}; left out of "
        f"the change: {nums['left_out']}", flush=True)

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if traced:
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = breakdown
    if on_card:
        result["card"] = _card()
    result["check"] = shown
    result["stderr"] = [f"check {name} {v['value']!r} limit {v['limit']!r}"
                        for name, v in shown.items()]
    return result


def emit(result: Dict) -> int:
    """Print the result: the check's lines last on standard error, the
    JSON line last on standard output. Refuses (no result, exit 3) where a
    JAX module was loaded."""
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    lines = result.pop("stderr")
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
