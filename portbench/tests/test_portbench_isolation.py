"""What a run and the reference import, and how a run ends where it cannot
measure: no module whose top-level name is ``jax``, ``jaxlib``, ``flax``
or ``repro`` (the JAX package; ``repro_torch`` is another name) in a run,
nothing of the port in the reference, exit codes other than 0 and no
result without a card or without the port beside the benchmark."""
import json
import os
import shutil
import subprocess
import sys

from portbench import spec

ROOT = spec.ROOT
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
sys.path.insert(0, {tests!r})
from test_portbench_reference import tiny
from portbench import harness
cell = tiny({cell!r})
harness.run(cell, 5, 0.1, {traced}, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from portbench import reference, weights
model = json.load(open({config!r}))["model"]
model.update(n_layers=1, d_model=64, n_heads=4, n_kv=2, head_dim=16,
             d_ff=128, vocab=300)
tokens = torch.randint(0, 300, (2, 256))
reference.follow(model, 3, [(tokens, tokens)], dict(lr=1e-3, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1), "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    for traced in (False, True):
        names = _modules(RUN_TINY.format(
            root=str(ROOT), src=str(ROOT / "src"),
            tests=str(ROOT / "portbench" / "tests"),
            cell="deepseek-moe-16b-4l.train-4k", traced=traced))
        assert "repro_torch" in names and "portbench" in names
        assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_port():
    names = _modules(REFERENCE_ONLY.format(
        root=str(ROOT),
        config=str(ROOT / "portbench" / "configs"
                   / "phi4-mini-3.8b-16l.json")))
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_harness_refuses_a_loaded_jax_package(capsys):
    from portbench import harness
    sys.modules["repro"] = sys.modules.get("repro") or type(sys)("repro")
    try:
        code = harness.emit({"correct": True, "stderr": []})
    finally:
        del sys.modules["repro"]
    assert code != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "repro" in captured.err


def _run(cwd, workload="phi4-mini-3.8b-16l.train-4k"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=ENV, cwd=cwd, timeout=600)


def test_no_card_no_result(card_absent):
    out = _run(ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()
