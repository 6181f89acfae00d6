"""On the card only (``python -m pytest -m card portbench/tests``): one
short run of the smallest cell through the command, as the benchmark runs
it. Without a card the ``card`` fixture skips it."""
import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.card
def test_a_short_run_of_a_cell_is_correct(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "deepseek-moe-16b-4l.train-4k", "--seed", str(2**31 + 101),
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"tokens_per_s", "peak_mem_gb",
                                      "setup_s"}
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
