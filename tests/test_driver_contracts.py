"""Contract tests for the entry points run outside the library.

``bench.py``, ``chip_smoke.py`` and ``__graft_entry__.py`` are run as
scripts, so an import-time break (a renamed helper, a moved module) would
otherwise surface only on the card.  These tests also pin the device
rules: nothing that claims to measure or smoke-test the GPU carries on
on the CPU, ``architecture='gpu'`` never falls back, and ``'tpu'`` is no
longer an architecture.

(The suite is invoked from the repo root — ``python -m pytest tests/``
— so the repo root is on ``sys.path`` and the top-level files import
directly.)
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def test_bench_refuses_non_gpu_platform(capsys):
    """On the forced-CPU test backend bench.py exits 1 before measuring
    and prints no JSON line."""
    import bench

    assert bench.BASELINE_GINT == 124.0
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "not a GPU" in err


def test_chip_smoke_refuses_non_gpu_platform(capsys):
    """chip_smoke.main on the CPU: non-zero exit, no result line."""
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "compile cache" in out


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory holding nothing else of the repo
    exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_graft_entry_single_step_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    pos = np.asarray(out.pos)
    assert pos.shape == args[0].pos.shape
    assert np.isfinite(pos).all()
    # one KDK step at dt=2e-5 must actually move the system
    assert not np.array_equal(pos, np.asarray(args[0].pos))


def test_resolve_device_gpu_raises_without_gpu():
    """architecture='gpu' never falls back to the CPU."""
    from nbody_streams_tpu.run import _resolve_device

    with pytest.raises(RuntimeError, match="no GPU"):
        _resolve_device("gpu")


@pytest.mark.parametrize("arch,want", [("auto", None), (None, None),
                                       ("cpu", "cpu")])
def test_resolve_device_accepted(arch, want):
    from nbody_streams_tpu.run import _resolve_device

    dev = _resolve_device(arch)
    assert (dev if dev is None else dev.platform) == want


def test_tpu_architecture_rejected():
    """'tpu' is not an architecture any more; the error names 'gpu'."""
    from nbody_streams_tpu import Species, run_simulation
    from nbody_streams_tpu.run import _resolve_device

    with pytest.raises(ValueError, match="'gpu'"):
        _resolve_device("tpu")
    with pytest.raises(ValueError, match="'gpu'"):
        run_simulation(np.zeros((4, 6)), [Species.dark(4, 1.0)], 0.0, 1.0,
                       0.5, architecture="tpu")


def test_run_nbody_gpu_pins_gpu(tmp_path):
    """run_nbody_gpu (and its historical alias run_nbody_tpu) pins
    architecture='gpu': on a CPU-only host it raises, not falls back."""
    import nbody_streams_tpu as nst

    assert nst.run_nbody_tpu is nst.run_nbody_gpu
    xv, m = nst.make_plummer_sphere(8, M_total=1e6, a=1.0, seed=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        nst.run_nbody_gpu(xv, m, 0.0, 1e-4, 1e-4, output_dir=str(tmp_path),
                          save_snapshots=False, verbose=False)


@pytest.mark.parametrize("platform,devices,want", [
    ("gpu", None, "pallas"),
    ("gpu", 1, "pallas"),
    ("gpu", 4, "sharded"),
    ("cpu", None, "jnp"),
    ("cpu", 8, "sharded"),
])
def test_auto_impl_resolution(monkeypatch, platform, devices, want):
    """impl='auto' resolves from what the call can observe: device count
    and platform, the same for every N and kernel; no session probe."""
    from nbody_streams_tpu.ops import dispatch

    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: platform)
    devs = None if devices is None else jax.devices()[:devices]
    for n, kernel in ((1000, "spline"), (4096, "plummer")):
        solver = dispatch.DirectGravity(np.ones(n), 0.05, kernel=kernel,
                                        devices=devs)
        assert solver.impl == want


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/where"}, "/some/where"),
    ({}, str(ROOT / ".jax_cache")),
], ids=["env-set", "env-unset"])
def test_compile_cache_dir(env, want):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache."""
    from nbody_streams_tpu import _compile_cache_dir

    assert _compile_cache_dir(env) == want


def test_compile_cache_configured_at_import():
    """Importing the package leaves JAX with a cache directory: the
    environment's when set, else the checkout's."""
    import nbody_streams_tpu as nst

    assert jax.config.jax_compilation_cache_dir == nst._compile_cache_dir()


@pytest.mark.parametrize("arch", ["auto", "cpu", "gpu"])
def test_cli_architecture_choices(arch):
    from nbody_streams_tpu.cli import _build_parser

    assert _build_parser().parse_args(
        ["--architecture", arch]).architecture == arch


def test_cli_rejects_tpu_architecture():
    from nbody_streams_tpu.cli import _build_parser

    with pytest.raises(SystemExit):
        _build_parser().parse_args(["--architecture", "tpu"])
