"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is a configuration under a traffic mix.
Its pieces are files of their own, so that a new cell, mix or metric is
new files and new entries, never an edit:

* ``configs/<config>.json`` (the path is the config entry's ``file``):
  the port's ``ModelConfig`` fields as run, with ``source``, ``reduced``,
  ``assumed`` and the published values;
* ``traffic/<traffic>.json``: batch, sequence length, the steps of set-up
  that the check follows, the optimizer's settings;
* ``limits/<workload>.json``: the numbers ``correct`` compares, each with
  its limit and the readings it was set from;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns a number or None.

Nothing here imports torch.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    limits: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: where it lists its
    cells, in those; else an end-to-end metric in every cell, a per-layer
    one in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(workload: str, root: Path = ROOT,
              bench: Optional[Dict] = None) -> Cell:
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    here = root / "portbench"
    traffic = json.loads(
        (here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, config, traffic, int(w["chips"]), limits, e2e,
                per_layer)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py``, loaded from its file."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
