"""The shape ``BENCHMARK.json`` must have, every name resolved to
its file, and a new cell and metric found from new files alone."""
import json
import re
import shutil

import pytest

from portbench import spec, weights

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_units_and_text():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "tokens_per_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_metrics():
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "tokens_per_s", "peak_mem_gb", "setup_s"]
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("workload", CELLS)
def test_every_name_resolves(workload):
    cell = spec.load_cell(workload)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "tokens_per_s", "peak_mem_gb", "setup_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert 0 < cell.limits[name]["limit"] < 1
    assert cell.traffic["batch"] * cell.traffic["seq"] >= 16384


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    assert body["assumed"] and body["chips"] == 1
    assert "n_layers" in body["reduced"]
    assert config["file"] == f"portbench/configs/{config['name']}.json"


def test_layout_is_the_ports():
    """The benchmark's weights take the port's parameter tree, leaf for
    leaf, shape for shape, and the counts the configs state."""
    from portbench.harness import model_config
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import leaves
    want = {"phi4-mini-3.8b-16l": 2_840_693_760,
            "deepseek-moe-16b-4l": 2_770_880_512}
    for name, count in want.items():
        model = json.loads(
            (ROOT / "portbench" / "configs" / f"{name}.json").read_text()
        )["model"]
        shapes = param_shapes(model_config(model))
        ours = weights.nest({p: s for p, (s, _) in
                             weights.layout(model).items()})

        def flat(tree, prefix=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from flat(v, prefix + (k,))
                else:
                    yield prefix + (k,), tuple(v)
        assert dict(flat(shapes)) == dict(flat(ours))
        assert weights.total(model) == count
        assert sum(1 for _ in leaves(shapes)) == len(weights.layout(model))


def test_new_cell_and_metric_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell by new files and new entries: nothing
    that was there is edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "phi4-mini-3.8b-16l.json").read_text())
    cfg["name"] = "phi4-mini-3.8b-8l"
    cfg["model"]["n_layers"] = 8
    (pb / "configs" / "phi4-mini-3.8b-8l.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "train-4k.json").read_text())
    (pb / "traffic" / "train-2k.json").write_text(
        json.dumps(dict(traffic, batch=8, seq=2048)))
    (pb / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return 41.5\n")
    (pb / "limits" / "phi4-mini-3.8b-8l.train-2k.json").write_text(
        (pb / "limits" / "phi4-mini-3.8b-16l.train-4k.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="phi4-mini-3.8b-8l",
                                 file="portbench/configs/"
                                      "phi4-mini-3.8b-8l.json"))
    bench["workloads"].append({"name": "phi4-mini-3.8b-8l.train-2k",
                               "config": "phi4-mini-3.8b-8l",
                               "traffic": "train-2k", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "tokens_per_s",
                               "workloads": ["phi4-mini-3.8b-8l.train-2k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("phi4-mini-3.8b-8l.train-2k", root=tmp_path)
    assert cell.config["model"]["n_layers"] == 8
    assert cell.traffic["seq"] == 2048
    assert [m["name"] for m in cell.per_layer] == ["steps_traced"]
    assert spec.metric_reader("steps_traced", root=tmp_path)(None) == 41.5
    old = spec.load_cell(CELLS[0], root=tmp_path)
    assert "steps_traced" not in [m["name"] for m in old.per_layer]
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
