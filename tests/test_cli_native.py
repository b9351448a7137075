"""CLI entry point and native host-ops library."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nbody_streams_tpu.cli import main as cli_main
from nbody_streams_tpu.native import (
    knn_radius,
    morton_argsort,
    native_available,
)

REPO = Path(__file__).resolve().parent.parent


def test_cli_runs_simulation(tmp_path, capsys):
    rc = cli_main([
        "--n", "64", "--t-end", "0.001", "--dt", "1e-4",
        "--architecture", "cpu", "--output-dir", str(tmp_path),
        "--snapshots", "2", "--quiet",
    ])
    assert rc == 0
    assert (tmp_path / "snapshot.h5").exists()
    assert (tmp_path / "restart.npz").exists()


def test_cli_config_file(tmp_path):
    cfg = {"n": 32, "t_end": 0.0005, "dt": 1e-4, "architecture": "cpu",
           "output_dir": str(tmp_path / "out"), "quiet": True,
           "snapshots": 2}
    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps(cfg))
    rc = cli_main(["--config", str(cfg_path)])
    assert rc == 0
    assert (tmp_path / "out/snapshot.h5").exists()


def test_cli_bad_flag():
    with pytest.raises(SystemExit):
        cli_main(["--kernel", "bogus"])


def test_cli_unknown_config_key_rejected(tmp_path, capsys):
    """A typo'd config key must error out (matching run_simulation's
    strict kwargs), not be silently dropped."""
    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps({"n": 32, "presicion": "float64"}))
    with pytest.raises(SystemExit):
        cli_main(["--config", str(cfg_path)])
    assert "presicion" in capsys.readouterr().err


def test_morton_sort_is_permutation_and_local(rng):
    pos = rng.normal(0, 1, (5000, 3))
    idx = morton_argsort(pos)
    assert np.array_equal(np.sort(idx), np.arange(5000))
    d_sorted = np.linalg.norm(np.diff(pos[idx], axis=0), axis=1).mean()
    d_orig = np.linalg.norm(np.diff(pos, axis=0), axis=1).mean()
    assert d_sorted < 0.3 * d_orig


def test_knn_matches_kdtree(rng):
    from scipy.spatial import cKDTree

    pos = rng.normal(0, 1, (3000, 3))
    h = knn_radius(pos, 16)
    d, _ = cKDTree(pos).query(pos, k=17)
    np.testing.assert_allclose(h, d[:, -1], rtol=1e-10)


def test_native_lib_builds_and_loads():
    """The host-ops library must BUILD on any container with a C++
    toolchain (the r4 verdict: two tests silently skipped on fresh
    checkouts, so the N>=500k kNN fast path never fired for pip users).
    native._load() now lazily makes the library; this asserts the full
    build+load cycle works here rather than skipping."""
    import shutil

    from nbody_streams_tpu import native

    if not (shutil.which("g++") and shutil.which("make")):
        pytest.skip("no C++ toolchain on this machine")
    assert native.build(verbose=True), "native host-ops build failed"
    assert native_available()


def test_native_lazy_autobuild(tmp_path, monkeypatch):
    """A missing .so triggers exactly one make attempt per process; the
    NBODY_NO_NATIVE_BUILD gate suppresses it."""
    from nbody_streams_tpu import native

    calls = []
    monkeypatch.setattr(native, "_autobuild_tried", False)
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "nope.so")
    assert native._load() is None
    assert len(calls) == 1          # tried the build
    assert native._load() is None
    assert len(calls) == 1          # one-shot: no retry storm
    monkeypatch.setattr(native, "_autobuild_tried", False)
    monkeypatch.setenv("NBODY_NO_NATIVE_BUILD", "1")
    assert native._load() is None
    assert len(calls) == 1          # gated off


def test_sph_smoothing_lengths_native_wiring():
    """viz.get_smoothing_lengths routes through the native grid-hash kNN
    (r1 review: the native layer was orphaned — no product path called
    it)."""
    import numpy as np

    from nbody_streams_tpu import native
    from nbody_streams_tpu.viz.sph import get_smoothing_lengths

    rng = np.random.default_rng(3)
    pos = rng.normal(0, 1, (3000, 3))
    h_ck = get_smoothing_lengths(pos, 16, method="ckdtree")
    if native.native_available():
        h_nat = get_smoothing_lengths(pos, 16, method="native")
        np.testing.assert_allclose(h_nat, h_ck, rtol=1e-12)
    import pytest

    with pytest.raises(ValueError):
        get_smoothing_lengths(pos, 16, method="nope")


def test_default_impl_respects_default_device(monkeypatch):
    """architecture='cpu' pins jax.default_device; impl='auto' must not
    pick the Pallas kernel there even when the process default backend
    is a GPU (the compiled kernel cannot run on the CPU backend)."""
    import jax

    from nbody_streams_tpu.ops import dispatch

    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "gpu")
    # no override: the fake GPU backend selects pallas
    assert dispatch._default_impl(None) == "pallas"
    # pinned to a CPU device: must fall back to jnp
    with jax.default_device(jax.devices("cpu")[0]):
        assert dispatch._default_impl(None) == "jnp"


def test_knn_degenerate_geometries_match_ckdtree():
    """Coplanar / collinear / thin-disc inputs: the grid-hash kNN used
    to hit a UB int cast (single-cell O(n^2) grids), a never-firing ring
    bound (~hang), and outlier excess-ring scans; all must now match
    cKDTree exactly at interactive speed."""
    pytest.importorskip("scipy")
    from scipy.spatial import cKDTree

    from nbody_streams_tpu import native

    if not native.native_available():
        pytest.skip("native host-ops not built")
    rng = np.random.default_rng(0)
    cases = [
        (np.column_stack([rng.normal(0, 1, (4000, 2)),
                          np.full(4000, 5.0)]), 16),          # coplanar
        (np.column_stack([np.linspace(0, 1, 2000),
                          np.zeros(2000), np.zeros(2000)]), 8),  # line
        (np.column_stack([rng.normal(0, 10, (5000, 2)),
                          rng.normal(0, 0.01, 5000)]), 16),   # thin disc
        (rng.normal(0, 1, (4000, 3)), 16),                    # 3-D cloud
    ]
    for pos, k in cases:
        h = native.knn_radius(pos, k=k)
        d, _ = cKDTree(pos).query(pos, k=k + 1)
        np.testing.assert_allclose(h, d[:, -1], rtol=1e-10)
