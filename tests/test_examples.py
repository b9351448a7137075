"""Smoke coverage for the runnable examples (reference parity:
`/root/reference/examples/` ships notebooks exercised by CI smoke runs).

Three tiers, cheapest first:

* every script byte-compiles (syntax / tab damage);
* the ``main()``-guarded scripts import cleanly (catches API drift in
  the example surface without executing the demo);
* the two cheapest top-level scripts — the SCF expansion demo and the
  8-device sharded demo — run end-to-end at tiny N in a subprocess on
  the forced-CPU 8-device mesh.
"""
import os
import py_compile
import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

# Scripts with an `if __name__ == "__main__"` guard: importable without
# running the demo.  The rest execute at import and are exercised either
# by the subprocess runs below or (the heavy fixed-size ones) only by
# the byte-compile check.
GUARDED = [
    "density_methods.py",
    "dynamical_friction_tutorial.py",
    "mw_lmc_stream.py",
    "run_simulation_multispecies.py",
    "stream_nbody.py",
]


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["MPLBACKEND"] = "Agg"
    env.pop("NBODY_TEST_GPU", None)
    return env


def test_all_examples_byte_compile():
    scripts = sorted(EXAMPLES.glob("*.py"))
    assert len(scripts) >= 10
    for f in scripts:
        py_compile.compile(str(f), doraise=True)


@pytest.mark.parametrize("name", GUARDED)
def test_guarded_example_imports(name, monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_example_{name[:-3]}", EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)


def _run_example(tmp_path, script, *args, timeout=900):
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args],
        cwd=tmp_path, env=_cpu_env(), timeout=timeout,
        capture_output=True, text=True)
    assert proc.returncode == 0, (
        f"{script} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


def test_scf_expansion_example_tiny(tmp_path):
    out = _run_example(tmp_path, "scf_expansion.py", "512", "4")
    assert "scf run: 4 steps" in out
    assert "rel force err" in out  # the accuracy-ladder table printed


def test_sharded_million_example_tiny(tmp_path):
    out = _run_example(tmp_path, "sharded_million.py", "1024")
    assert "8 device(s)" in out
    assert "10 steps at N=1,024 on 8 devices" in out
