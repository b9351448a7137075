"""Potential fitting from particles, device info, FIRE helpers,
watchdog/profiling plumbing."""
import numpy as np
import pytest

from nbody_streams_tpu import (
    Species,
    device_alive,
    get_device_info,
    make_plummer_sphere,
    run_simulation,
)
from nbody_streams_tpu.potentials import (
    CylSplinePotential,
    MultipolePotential,
    PlummerPotential,
    create_evolving_ini,
    fit_cylspline_from_particles,
    fit_multipole_from_particles,
    fit_potential,
    load_potential_ini,
    read_snapshot_times,
)


@pytest.fixture(scope="module")
def plummer_cluster():
    xv, m = make_plummer_sphere(50000, M_total=1e9, a=1.0, seed=11)
    return xv, m, PlummerPotential(mass=1e9, scaleRadius=1.0)


def test_fit_multipole_accuracy(plummer_cluster, rng):
    xv, m, pl = plummer_cluster
    coefs = fit_multipole_from_particles(xv[:, :3], m, lmax=4)
    mp = MultipolePotential(coefs)
    pts = rng.normal(0, 3, (200, 3))
    p_ref = np.asarray(pl.potential(pts))
    assert np.abs(np.asarray(mp.potential(pts)) - p_ref).max() \
        / np.abs(p_ref).max() < 0.02
    # dPhi/dr tables present and force sane (shot-noise limited)
    assert coefs.dphi_dr is not None
    f_ref = np.asarray(pl.force(pts))
    assert np.abs(np.asarray(mp.force(pts)) - f_ref).max() \
        / np.abs(f_ref).max() < 0.1


def test_fit_multipole_symmetry_filter(plummer_cluster):
    xv, m, _ = plummer_cluster
    coefs = fit_multipole_from_particles(xv[:5000, :3], m[:5000], lmax=4,
                                         symmetry="spherical")
    assert coefs.lm_labels == [(0, 0)]
    coefs_ax = fit_multipole_from_particles(xv[:5000, :3], m[:5000],
                                            lmax=4, symmetry="axisym")
    assert all(mm == 0 for _, mm in coefs_ax.lm_labels)


def test_fit_cylspline_accuracy(plummer_cluster, rng):
    xv, m, pl = plummer_cluster
    coefs = fit_cylspline_from_particles(xv[:, :3], m, mmax=2)
    cs = CylSplinePotential(coefs)
    pts = rng.normal(0, 2, (100, 3))
    p_ref = np.asarray(pl.potential(pts))
    assert np.abs(np.asarray(cs.potential(pts)) - p_ref).max() \
        / np.abs(p_ref).max() < 0.02


def test_fit_potential_driver(plummer_cluster):
    xv, m, pl = plummer_cluster
    res = fit_potential(
        {"dark": (xv[:20000, :3], m[:20000]),
         "star": (xv[20000:40000, :3], m[20000:40000])},
        lmax=2, mmax_cyl=2,
    )
    assert res["multipole"] is not None and res["cylspline"] is not None
    test_pt = np.array([2.0, 0.0, 0.0])
    got = float(res["potential"].potential(test_pt))
    want = float(pl.potential(test_pt)) * (40000 / 50000)
    assert abs(got - want) / abs(want) < 0.05


def test_device_info_and_alive():
    info = get_device_info()
    assert info["platform"] in ("cpu", "gpu")
    assert info["n_devices"] >= 1
    assert device_alive()


def test_snapshot_times_and_evolving_ini(tmp_path):
    listing = tmp_path / "snapshot_times.txt"
    listing.write_text(
        "# i scale z time lookback\n"
        "0 0.1 9.0 0.5 13.3\n"
        "300 0.5 1.0 5.9 7.9\n"
        "600 1.0 0.0 13.8 0.0\n"
    )
    st = read_snapshot_times(listing)
    assert list(st["index"]) == [0, 300, 600]
    assert st["time"][2] == pytest.approx(13.8)

    # evolving ini referencing two generated coef files
    from nbody_streams_tpu.potentials import PlummerPotential

    for i, mass in enumerate([1e9, 2e9]):
        pl = PlummerPotential(mass=mass, scaleRadius=1.0)
        r = np.geomspace(0.05, 100, 25)
        ptsr = np.column_stack([r, 0 * r, 0 * r])
        from nbody_streams_tpu.potentials import MultipoleCoefs

        coefs = MultipoleCoefs(
            R_grid=r, lm_labels=[(0, 0)],
            phi=np.asarray(pl.potential(ptsr))[:, None],
            dphi_dr=(-np.asarray(pl.force(ptsr))[:, 0])[:, None])
        (tmp_path / f"snap{i}.coef_mult").write_text(
            coefs.to_coef_string())
    ini = create_evolving_ini(
        tmp_path / "ev.ini",
        ["snap0.coef_mult", "snap1.coef_mult"], [0.0, 1.0])
    pot = load_potential_ini(ini)
    mid = float(pot.potential(np.array([3.0, 0, 0]), t=0.5))
    a = float(PlummerPotential(mass=1e9, scaleRadius=1.0)
              .potential(np.array([3.0, 0, 0])))
    b = float(PlummerPotential(mass=2e9, scaleRadius=1.0)
              .potential(np.array([3.0, 0, 0])))
    assert abs(mid - 0.5 * (a + b)) / abs(mid) < 1e-4


def test_watchdog_plumbing(tmp_path):
    """step_timeout_s threads through without tripping on a fast run."""
    xv, m = make_plummer_sphere(32, M_total=1e4, a=0.01, seed=1)
    sp = [Species.dark(N=32, mass=float(m[0]), softening=0.003)]
    res = run_simulation(xv, sp, 0.0, 5e-4, 1e-4, architecture="cpu",
                         output_dir=str(tmp_path), verbose=False,
                         save_snapshots=False, step_timeout_s=30.0)
    assert np.isfinite(res["dark"]).all()


def test_watchdog_hang_saves_post_progress_restart(tmp_path):
    """A hang mid-run must save an emergency restart containing the
    work completed up to the last finished 50-step sub-chunk — not the
    pre-chunk state (VERDICT r1 weak #4; reference per-step interrupt:
    run_gpu_tree.py:79-135)."""
    import time as _time

    from nbody_streams_tpu.nbody_io import _load_restart
    from nbody_streams_tpu.run import run_nbody

    xv, m = make_plummer_sphere(32, M_total=1e4, a=0.01, seed=1)
    calls = {"n": 0}

    def hanging_force(pos, vel, mass, t):
        calls["n"] += 1
        if calls["n"] > 60:          # hang inside the second sub-chunk
            _time.sleep(30.0)
        return np.zeros_like(pos)

    # the interrupt lands inside the sleeping host callback, which JAX
    # surfaces as a JaxRuntimeError wrapping the KeyboardInterrupt
    import jax

    with pytest.raises((KeyboardInterrupt, jax.errors.JaxRuntimeError)):
        run_nbody(xv, m, 0.0, 120e-4, 1e-4, softening=0.003,
                  architecture="cpu", output_dir=str(tmp_path),
                  verbose=False, save_snapshots=False,
                  step_timeout_s=0.05, force_extra=hanging_force)
    loaded = _load_restart(str(tmp_path))
    assert loaded is not None
    xv_saved, _t, step = loaded[0], loaded[1], loaded[2]
    # the first 50-step sub-chunk completed before the hang
    assert step >= 50
    assert np.isfinite(xv_saved).all()


def test_fit_potential_rotation_and_subsample():
    """rotation= frame transform and subsample_factor reweighting match
    the reference's fit workflow options (reference: _fit.py:146-149)."""
    from nbody_streams_tpu.potentials.fit import fit_potential

    xv, m = make_plummer_sphere(8000, M_total=1e9, a=1.0, seed=0)
    full = fit_potential({"dark": (xv[:, :3], m)}, lmax=2,
                         symmetry="spherical")
    rot = np.array([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    sub = fit_potential({"dark": (xv[:, :3], m)}, lmax=2,
                        symmetry="spherical", rotation=rot,
                        subsample_factor=0.25)
    pts = np.array([[3.0, 0, 0], [10.0, 0, 0]])
    p1 = np.asarray(full["potential"].potential(pts))
    p2 = np.asarray(sub["potential"].potential(pts))
    # spherical: rotation is a no-op; 25% subsample -> ~percent noise
    np.testing.assert_allclose(p2, p1, rtol=0.05)
    with pytest.raises(ValueError):
        fit_potential({"dark": (xv[:, :3], m)}, subsample_factor=0.0)
    with pytest.raises(ValueError):
        fit_potential({"dark": (xv[:, :3], m)}, rotation=np.eye(2))


class TestLoadFirePot:
    """One-call FIRE loader against a synthetic FIRE directory layout
    built from the shipped coefficient fixtures
    (reference parity: agama_helper/_fire.py:267-429)."""

    @pytest.fixture()
    def fire_dir(self, tmp_path):
        import shutil
        from pathlib import Path

        fixtures = Path(__file__).parent / "data"
        pot = tmp_path / "sim" / "potential" / "10kpc"
        pot.mkdir(parents=True)
        shutil.copy(fixtures / "600.dark.none_8.coef_mul_DR",
                    pot / "600.dark.none_8.coef_mul_DR")
        shutil.copy(fixtures / "600.bar.none_8.coef_cylsp_DR",
                    pot / "600.bar.none_8.coef_cylsp_DR")
        return tmp_path / "sim"

    def test_whole_builds_composite(self, fire_dir):
        from nbody_streams_tpu.potentials import (
            CompositePotential, load_fire_pot)

        pot = load_fire_pot(fire_dir, 600, sym="n", lmax=8, verbose=False)
        assert isinstance(pot, CompositePotential)
        assert len(pot.components) == 2
        xyz = np.array([[8.0, 0.5, 0.2], [30.0, -5.0, 3.0]])
        phi = np.asarray(pot.potential(xyz))
        assert np.all(np.isfinite(phi)) and np.all(phi < 0)

    def test_dark_and_bar_kinds(self, fire_dir):
        from nbody_streams_tpu.potentials import (
            CylSplinePotential, MultipolePotential, load_fire_pot)

        dark = load_fire_pot(fire_dir, 600, lmax=8, kind="dark",
                             verbose=False)
        bar = load_fire_pot(fire_dir, 600, lmax=8, kind="bar",
                            verbose=False)
        assert isinstance(dark, MultipolePotential)
        assert isinstance(bar, CylSplinePotential)
        whole = load_fire_pot(fire_dir, 600, lmax=8, verbose=False)
        xyz = np.array([[10.0, 1.0, 0.5]])
        np.testing.assert_allclose(
            np.asarray(whole.potential(xyz)),
            np.asarray(dark.potential(xyz)) + np.asarray(bar.potential(xyz)),
            rtol=1e-12)

    def test_return_coefs(self, fire_dir):
        from nbody_streams_tpu.potentials import load_fire_pot
        from nbody_streams_tpu.potentials.coefs import (
            CylSplineCoefs, MultipoleCoefs)

        mult, cyl = load_fire_pot(fire_dir, 600, lmax=8,
                                  return_coefs=True, verbose=False)
        assert isinstance(mult, MultipoleCoefs)
        assert isinstance(cyl, CylSplineCoefs)
        assert load_fire_pot(fire_dir, 600, lmax=8, kind="dark",
                             return_coefs=True,
                             verbose=False).lmax == mult.lmax

    def test_keep_lm_filtering_monopole_only(self, fire_dir):
        """keep_lm_mult=[(0,0)] zeroes all l>0 harmonics: the potential
        must become exactly spherically symmetric."""
        from nbody_streams_tpu.potentials import load_fire_pot

        pot = load_fire_pot(fire_dir, 600, lmax=8, kind="dark",
                            keep_lm_mult=[(0, 0)], verbose=False)
        r = 15.0
        xyz = np.array([[r, 0, 0], [0, r, 0], [0, 0, r],
                        [r / np.sqrt(3)] * 3])
        phi = np.asarray(pot.potential(xyz))
        np.testing.assert_allclose(phi, phi[0], rtol=1e-10)

    def test_keep_m_cylspl_negative_expansion(self, fire_dir):
        from nbody_streams_tpu.potentials import load_fire_pot

        coefs = load_fire_pot(fire_dir, 600, lmax=8, kind="bar",
                              keep_m_cylspl=[2], return_coefs=True,
                              verbose=False)
        for i, m in enumerate(coefs.m_values):
            if abs(m) != 2 and np.any(coefs.phi[i] != 0):
                raise AssertionError(f"m={m} not zeroed")

    def test_missing_file_raises(self, fire_dir):
        from nbody_streams_tpu.potentials import load_fire_pot

        with pytest.raises(FileNotFoundError, match="coefficient file"):
            load_fire_pot(fire_dir, 601, lmax=8, verbose=False)
        with pytest.raises(ValueError, match="sym"):
            load_fire_pot(fire_dir, 600, sym="x", verbose=False)
        with pytest.raises(ValueError, match="kind"):
            load_fire_pot(fire_dir, 600, lmax=8, kind="stars",
                          verbose=False)

    def test_save_modified(self, fire_dir, tmp_path):
        from nbody_streams_tpu.potentials import load_fire_pot
        from nbody_streams_tpu.potentials.coefs import read_mult_coefs

        out = tmp_path / "mod"
        load_fire_pot(fire_dir, 600, lmax=8, kind="dark",
                      keep_lm_mult=[(0, 0)], save_modified=True,
                      save_dir=str(out), verbose=False)
        saved = out / "600.dark.none_8.coef_mul_DR.modified"
        assert saved.exists()
        coefs = read_mult_coefs(saved.read_text())
        for i, (l, m) in enumerate(coefs.lm_labels):
            if (l, m) != (0, 0):
                assert np.all(coefs.phi[:, i] == 0)

    def test_save_modified_without_filter_warns(self, fire_dir, tmp_path):
        from nbody_streams_tpu.potentials import load_fire_pot

        out = tmp_path / "mod"
        with pytest.warns(UserWarning, match="save_modified"):
            load_fire_pot(fire_dir, 600, lmax=8, kind="dark",
                          save_modified=True, save_dir=str(out),
                          verbose=False)
        assert not out.exists()  # nothing filtered -> nothing written


def test_fit_cylspline_razor_thin_disk():
    """All-z=0 particle sets must auto-build a finite vertical grid
    instead of crashing in geomspace(0, 0) (r3 review)."""
    from nbody_streams_tpu.potentials.fit import fit_cylspline_from_particles

    rng = np.random.default_rng(5)
    R = rng.exponential(3.0, 4000)
    th = rng.uniform(0, 2 * np.pi, 4000)
    pos = np.column_stack([R * np.cos(th), R * np.sin(th),
                           np.zeros_like(R)])
    coefs = fit_cylspline_from_particles(pos, np.full(4000, 2.5e6),
                                         mmax=0, softening=0.05)
    assert np.isfinite(np.asarray(coefs.phi)).all()
    assert np.asarray(coefs.z_grid).max() > 0
    # axis-only particles cannot produce an R grid: explicit error
    posz = np.column_stack([np.zeros(100), np.zeros(100),
                            np.linspace(-1, 1, 100)])
    with pytest.raises(ValueError, match="R_grid"):
        fit_cylspline_from_particles(posz, np.ones(100), mmax=0)


def test_watchdog_guards_boundary_device_work(tmp_path, monkeypatch):
    """Device calls at chunk boundaries (payload fetch, debug-energy
    eval) must sit under their own watchdog: a device call can hang
    there just as it can mid-chunk, and without the guard the run hangs
    forever with step_timeout_s armed."""
    import time as _time

    import jax

    from nbody_streams_tpu import run as run_mod
    from nbody_streams_tpu.nbody_io import _load_restart
    from nbody_streams_tpu.run import run_nbody

    monkeypatch.setattr(run_mod, "_BOUNDARY_GRACE_S", 0.2)

    real_device_get = jax.device_get
    calls = {"tuples": 0}

    def hanging_device_get(x):
        # fetch_xv fetches (pos, vel) tuples; the first in-loop fetch
        # lands at step 50, so hanging the second (step 100) must leave
        # a step-50 restart.  A blocking call cannot be cancelled by
        # the watchdog (interrupt_main lands when it returns) — the
        # contract is: restart saved promptly by the timer thread, run
        # aborted on return.  Without the boundary guard this run would
        # simply complete successfully and no mid-run restart would
        # exist.
        if isinstance(x, tuple):
            calls["tuples"] += 1
            if calls["tuples"] == 2:
                _time.sleep(3.0)
        return real_device_get(x)

    monkeypatch.setattr(run_mod.jax, "device_get", hanging_device_get)

    xv, m = make_plummer_sphere(32, M_total=1e4, a=0.01, seed=1)
    with pytest.raises(KeyboardInterrupt):
        run_nbody(xv, m, 0.0, 120e-4, 1e-4, softening=0.003,
                  architecture="cpu", output_dir=str(tmp_path),
                  verbose=False, save_snapshots=False,
                  step_timeout_s=0.05)
    loaded = _load_restart(str(tmp_path))
    assert loaded is not None
    xv_saved, _t, step = loaded[0], loaded[1], loaded[2]
    # the guard saved the 50 completed steps during the boundary hang
    assert step >= 50
    assert np.isfinite(xv_saved).all()
