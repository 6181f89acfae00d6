"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor any module of the JAX package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
"""

SHARDING_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")}
for name in names:
    importlib.import_module(name)
print(sorted({"repro_torch.parallel", "repro_torch.parallel.sharding",
              "repro_torch.launch.mesh"} - names),
      "torch.testing._internal.distributed.fake_pg" in sys.modules)
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


def test_the_sharding_modules_are_probed_and_fake_pg_is_not_loaded():
    """The walk above reaches the sharding layer and the mesh; importing
    the port never loads the fake process group, which only tests use."""
    out = subprocess.run([sys.executable, "-c", SHARDING_PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False", out.stdout


def test_no_import_statement_names_jax_or_repro():
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, m)


DRYRUN_PROBE = """
import importlib, pkgutil, sys
import torch
import torch.distributed as dist
import repro_torch
names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")}
import repro_torch.core.comm_count, repro_torch.launch.dryrun
print(sorted({"repro_torch.launch.dryrun", "repro_torch.core.comm_count"}
             - names), dist.is_initialized(), torch.cuda.is_initialized(),
      "torch.testing._internal.distributed.fake_pg" in sys.modules,
      sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
"""


def test_importing_the_dry_run_touches_no_device_and_no_process_group():
    """The dry-run and the collective counter are in the walk above (so
    they load no JAX), and importing them initialises no process group,
    no CUDA and no fake process group."""
    out = subprocess.run([sys.executable, "-c", DRYRUN_PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False False False []", out.stdout
