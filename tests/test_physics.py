"""Physics integration tests: conservation laws against the independent
NumPy oracle, multi-species runs, IO round-trip, restart resume.

Mirrors the reference's backbone physics suite (reference:
tests/test_physics.py:51-715).
"""
import os

import numpy as np
import pytest

from nbody_streams_tpu import (
    G_DEFAULT,
    ParticleReader,
    Species,
    make_plummer_sphere,
    run_simulation,
)

from numpy_oracle import total_energy

DT = 2e-5
SOFT = 0.003


def small_plummer(n=80, seed=1):
    xv, m = make_plummer_sphere(n, M_total=1e4, a=0.01, seed=seed)
    return xv, m


@pytest.mark.parametrize("precision", ["float64", "float32_kahan"])
def test_energy_momentum_conservation(tmp_path, precision):
    xv, m = small_plummer()
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    E0 = total_energy(xv, m, SOFT, G_DEFAULT)
    p0 = (m[:, None] * xv[:, 3:]).sum(0)

    res = run_simulation(
        xv, sp, 0.0, 50 * DT, DT, architecture="cpu", method="direct",
        output_dir=str(tmp_path), snapshots=3, verbose=False,
        precision=precision,
    )
    xv1 = res["dark"]
    E1 = total_energy(xv1, m, SOFT, G_DEFAULT)
    p1 = (m[:, None] * xv1[:, 3:]).sum(0)

    assert abs(E1 - E0) / abs(E0) < 1e-2
    # Momentum: exactly conserved up to round-off
    pscale = np.abs(m[:, None] * xv1[:, 3:]).sum()
    tol = 1e-10 if precision == "float64" else 1e-5
    assert np.abs(p1 - p0).max() < tol * pscale


def test_com_drift_prediction(tmp_path):
    """A system given a bulk velocity drifts ballistically."""
    xv, m = small_plummer()
    v_bulk = np.array([10.0, -5.0, 2.0])
    xv[:, 3:] += v_bulk
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    t_end = 50 * DT
    res = run_simulation(
        xv, sp, 0.0, t_end, DT, architecture="cpu", output_dir=str(tmp_path),
        save_snapshots=False, verbose=False, precision="float64",
    )
    com0 = xv[:, :3].mean(0)
    com1 = res["dark"][:, :3].mean(0)
    np.testing.assert_allclose(com1 - com0, v_bulk * t_end, rtol=1e-6,
                               atol=1e-9)


def test_multi_species_conservation(tmp_path):
    """dark + star + BH combined system conserves E and P."""
    rng = np.random.default_rng(3)
    xv_d, m_d = make_plummer_sphere(60, M_total=1e4, a=0.01, seed=2)
    xv_s, m_s = make_plummer_sphere(30, M_total=1e3, a=0.005, seed=3)
    xv_b = np.zeros((1, 6))
    xv = np.vstack([xv_d, xv_s, xv_b])
    species = [
        Species.dark(60, float(m_d[0]), 0.004),
        Species.star(30, float(m_s[0]), 0.002),
        Species(name="bh", N=1, mass=500.0, softening=0.001),
    ]
    mass = np.concatenate([m_d, m_s, [500.0]])
    soft = np.concatenate([np.full(60, 0.004), np.full(30, 0.002), [0.001]])

    E0 = total_energy(xv, mass, soft, G_DEFAULT)
    res = run_simulation(
        xv, species, 0.0, 30 * DT, DT, architecture="cpu",
        output_dir=str(tmp_path), save_snapshots=False, verbose=False,
        precision="float64",
    )
    assert set(res) == {"dark", "star", "bh"}
    assert res["dark"].shape == (60, 6)
    assert res["bh"].shape == (1, 6)
    xv1 = np.vstack([res["dark"], res["star"], res["bh"]])
    E1 = total_energy(xv1, mass, soft, G_DEFAULT)
    assert abs(E1 - E0) / abs(E0) < 1e-2


def test_io_roundtrip_final_state_is_last_snapshot(tmp_path):
    xv, m = small_plummer()
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    res = run_simulation(
        xv, sp, 0.0, 20 * DT, DT, architecture="cpu",
        output_dir=str(tmp_path), snapshots=5, verbose=False,
        precision="float64",
    )
    reader = ParticleReader(str(tmp_path / "snapshot.h5"))
    assert reader.Snapshots.size == 5
    last = reader.read_snapshot(int(reader.Snapshots[-1]))
    np.testing.assert_allclose(last.species["dark"]["posvel"], res["dark"],
                               rtol=0, atol=0)
    # time lookup by float
    part_t = reader.read_snapshot(float(last.time))
    assert part_t.snap == last.snap


def test_restart_resume_matches_continuous(tmp_path):
    xv, m = small_plummer()
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    common = dict(architecture="cpu", verbose=False, precision="float64",
                  snapshots=2, restart_interval=10)

    d1 = tmp_path / "full"
    res_full = run_simulation(xv, sp, 0.0, 40 * DT, DT,
                              output_dir=str(d1), **common)

    # Run 20 steps, then resume to 40
    d2 = tmp_path / "split"
    run_simulation(xv, sp, 0.0, 20 * DT, DT, output_dir=str(d2), **common)
    res_resumed = run_simulation(xv, sp, 0.0, 40 * DT, DT,
                                 output_dir=str(d2), continue_run=True,
                                 **common)
    np.testing.assert_allclose(res_resumed["dark"], res_full["dark"],
                               rtol=1e-12, atol=1e-14)


def test_legacy_restart_resume_preserves_snapshot_times(tmp_path):
    """A reference-format restart.npz (no snapshot_counter field) must
    not make the resume rewrite snapshot.times rows of already-written
    snapshots (the counter is reconstructed from the resume step)."""
    xv, m = small_plummer()
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    common = dict(architecture="cpu", verbose=False, precision="float64",
                  snapshots=4, restart_interval=10)
    run_simulation(xv, sp, 0.0, 40 * DT, DT, output_dir=str(tmp_path),
                   **common)
    times_before = (tmp_path / "snapshot.times").read_text().strip()
    rows_before = times_before.splitlines()

    # emulate the reference writing a mid-run restart at step 20: same
    # fields (no snapshot_counter), same snapshot schedule on resume
    with np.load(tmp_path / "restart.npz") as data:
        legacy = {"phase_space": data["phase_space"],
                  "time": np.float64(20 * DT), "step": np.int64(20)}
    np.savez(tmp_path / "restart.npz", **legacy)

    run_simulation(xv, sp, 0.0, 40 * DT, DT, output_dir=str(tmp_path),
                   continue_run=True, **common)
    rows_after = (tmp_path / "snapshot.times").read_text().strip().splitlines()
    # rows for snapshots taken before step 20 must be byte-identical;
    # with the old counter=0 fallback the catch-up loop rewrote them
    # with late-time state
    total_steps = 40
    snap_steps = np.unique(np.round(
        np.linspace(0, total_steps, 4)).astype(int))
    n_keep = int(np.searchsorted(snap_steps, 20, "left"))
    assert n_keep >= 1
    assert rows_after[:n_keep] == rows_before[:n_keep]
    assert len(rows_after) == len(rows_before)


def test_debug_energy_zero_energy_states(tmp_path, capsys):
    """pe == 0 (massless tracers in an external field) must not crash
    the debug_energy progress report with a ZeroDivisionError."""
    from nbody_streams_tpu.potentials import NFWPotential

    xv, _ = small_plummer(n=16)
    sp = [Species.dark(N=16, mass=0.0, softening=SOFT)]
    run_simulation(
        xv, sp, 0.0, 10 * DT, DT, architecture="cpu", verbose=True,
        precision="float64", save_snapshots=False, debug_energy=True,
        external_potential=NFWPotential(mass=1e4, scaleRadius=0.01),
        output_dir=str(tmp_path),
    )
    out = capsys.readouterr().out
    assert "dE/E" in out      # report ran, with guarded ratios


def test_finished_run_resume_restart_label(tmp_path):
    """Resuming past a shorter time_end must not relabel the restart
    with the new (smaller) total step count: the saved step must match
    the phase space actually stored."""
    xv, m = small_plummer(n=20)
    sp = [Species.dark(N=20, mass=float(m[0]), softening=SOFT)]
    common = dict(architecture="cpu", verbose=False, precision="float64",
                  save_snapshots=False, restart_interval=10)
    run_simulation(xv, sp, 0.0, 20 * DT, DT, output_dir=str(tmp_path),
                   **common)
    res = run_simulation(xv, sp, 0.0, 10 * DT, DT,
                         output_dir=str(tmp_path), continue_run=True,
                         **common)
    with np.load(tmp_path / "restart.npz") as data:
        assert int(data["step"]) == 20       # not the new total of 10
        np.testing.assert_allclose(data["phase_space"], res["dark"],
                                   rtol=0, atol=0)


def test_overwrite_guard(tmp_path):
    xv, m = small_plummer(n=20)
    sp = [Species.dark(N=20, mass=float(m[0]), softening=SOFT)]
    kw = dict(architecture="cpu", verbose=False, snapshots=2,
              output_dir=str(tmp_path))
    run_simulation(xv, sp, 0.0, 5 * DT, DT, **kw)
    with pytest.raises(FileExistsError):
        run_simulation(xv, sp, 0.0, 5 * DT, DT, **kw)
    run_simulation(xv, sp, 0.0, 5 * DT, DT, overwrite=True, **kw)


def test_force_extra_callable(tmp_path):
    """Reference-style plain-callable force_extra: uniform extra
    acceleration produces the expected CoM displacement."""
    xv, m = small_plummer(n=30)
    sp = [Species.dark(N=30, mass=float(m[0]), softening=SOFT)]
    a_ext = np.array([1.0e3, 0.0, 0.0])
    calls = []

    def extra(pos, vel, masses, t):
        calls.append(t)
        return np.tile(a_ext, (pos.shape[0], 1))

    t_end = 20 * DT
    # force_extra is a run_nbody-level kwarg; call the driver directly
    from nbody_streams_tpu import run_nbody

    out = run_nbody(
        xv, m, 0.0, t_end, DT, softening=SOFT, architecture="cpu",
        save_snapshots=False, verbose=False, precision="float64",
        force_extra=extra, output_dir=str(tmp_path),
    )
    assert len(calls) > 0
    com_shift = out[:, :3].mean(0) - xv[:, :3].mean(0)
    # Ballistic: 0.5 a t^2 (plus self-gravity CoM ~ 0)
    np.testing.assert_allclose(com_shift[0], 0.5 * a_ext[0] * t_end**2,
                               rtol=1e-3)


def test_unknown_kwarg_rejected(tmp_path):
    xv, m = small_plummer(n=20)
    sp = [Species.dark(N=20, mass=float(m[0]), softening=SOFT)]
    with pytest.raises(TypeError, match="Unknown keyword"):
        run_simulation(xv, sp, 0.0, DT, DT, architecture="cpu",
                       output_dir=str(tmp_path), verbose=False,
                       bogus_option=1)


def test_multifile_snapshots(tmp_path):
    """num_files_to_write > 1 shards snapshots; ParticleReader globs."""
    xv, m = small_plummer(n=40)
    sp = [Species.dark(N=40, mass=float(m[0]), softening=SOFT)]
    run_simulation(xv, sp, 0.0, 20 * DT, DT, architecture="cpu",
                   output_dir=str(tmp_path), snapshots=6,
                   num_files_to_write=3, verbose=False,
                   precision="float64")
    files = sorted(tmp_path.glob("snapshot.*.h5"))
    assert len(files) == 3
    reader = ParticleReader(str(tmp_path / "snapshot.*.h5"))
    assert reader.Snapshots.size == 6
    orbits = reader.extract_orbits("dark")
    assert orbits.posvel.shape == (6, 40, 6)


def test_evolving_external_potential_in_scan(tmp_path):
    """Time-evolving external potential (the MW-LMC workflow pattern)
    evaluated inside the scanned KDK step: a particle in a growing
    potential gains binding energy monotonically."""
    from nbody_streams_tpu.potentials import (EvolvingPotential,
                                              PlummerPotential)

    a = PlummerPotential(mass=1e11, scaleRadius=5.0)
    b = PlummerPotential(mass=2e11, scaleRadius=5.0)
    ev = EvolvingPotential([a, b], [0.0, 0.1])

    xv, m = small_plummer(n=16)
    xv[:, :3] += np.array([30.0, 0, 0])
    sp = [Species.dark(N=16, mass=float(m[0]), softening=SOFT)]
    res = run_simulation(
        xv, sp, 0.0, 0.02, 1e-3, architecture="cpu",
        external_potential=ev, external_update_interval=2,
        output_dir=str(tmp_path), save_snapshots=False, verbose=False,
        precision="float64",
    )
    assert np.isfinite(res["dark"]).all()
    # the deepening potential accelerates the infall: net inward motion
    r0 = np.linalg.norm(xv[:, :3].mean(0))
    r1 = np.linalg.norm(res["dark"][:, :3].mean(0))
    assert r1 < r0


def test_resume_with_time_dependent_potential_matches_continuous(tmp_path):
    """A resumed run must evaluate its first force at the RESUME time,
    not time_start (r2 review: init_state used t0 + start_step*0.0).
    A strongly time-dependent external field makes the difference
    visible immediately."""
    from nbody_streams_tpu.potentials import (EvolvingPotential,
                                              UniformAcceleration)

    # uniform acceleration whose direction flips sign over the run
    ext = EvolvingPotential(
        [UniformAcceleration(ax=50.0), UniformAcceleration(ax=-50.0)],
        [0.0, 40 * DT])

    xv, m = small_plummer()
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    common = dict(architecture="cpu", verbose=False, precision="float64",
                  snapshots=2, restart_interval=10,
                  external_potential=ext)

    d1 = tmp_path / "full"
    res_full = run_simulation(xv, sp, 0.0, 40 * DT, DT,
                              output_dir=str(d1), **common)
    d2 = tmp_path / "split"
    run_simulation(xv, sp, 0.0, 20 * DT, DT, output_dir=str(d2), **common)
    res_resumed = run_simulation(xv, sp, 0.0, 40 * DT, DT,
                                 output_dir=str(d2), continue_run=True,
                                 **common)
    np.testing.assert_allclose(res_resumed["dark"], res_full["dark"],
                               rtol=1e-10, atol=1e-12)


def test_overwrite_clears_stale_restart(tmp_path):
    """overwrite=True must remove restart.npz along with the snapshots:
    a later continue_run would otherwise resume the OLD run (r2 review)."""
    xv, m = small_plummer(n=20)
    sp = [Species.dark(N=20, mass=float(m[0]), softening=SOFT)]
    kw = dict(architecture="cpu", verbose=False, snapshots=2,
              restart_interval=2, output_dir=str(tmp_path),
              precision="float64")
    run_simulation(xv, sp, 0.0, 6 * DT, DT, **kw)
    assert (tmp_path / "restart.npz").exists()
    run_simulation(xv, sp, 0.0, 6 * DT, DT, overwrite=True, **kw)
    # resume continues the NEW run; with the stale restart it would
    # have started from the old run's step-6 state
    res = run_simulation(xv, sp, 0.0, 8 * DT, DT, continue_run=True, **kw)
    assert np.isfinite(res["dark"]).all()


def test_unequal_mass_metadata_roundtrip(tmp_path):
    """Species-free unequal-mass runs must store the full mass array in
    the legacy layout, not masses[0] for everyone (r2 review)."""
    from nbody_streams_tpu import run_nbody

    xv, _ = small_plummer(n=30)
    masses = np.linspace(1.0, 3.0, 30) * 1e5
    run_nbody(xv, masses, 0.0, 3 * DT, DT, softening=SOFT,
              architecture="cpu", impl="jnp", precision="float64",
              output_dir=str(tmp_path), snapshots=2, verbose=False)
    reader = ParticleReader(str(tmp_path / "snapshot.h5"))
    snap = reader.read_snapshot(0)
    np.testing.assert_allclose(snap.species["dark"]["mass"], masses)


def test_resume_with_cached_external_interval_matches_continuous(tmp_path):
    """Resume at a step that is NOT a multiple of external_update_interval:
    the cached external force must be refreshed at init, not left at its
    zero initializer for up to k-1 steps (r2 review)."""
    from nbody_streams_tpu.potentials import UniformAcceleration

    ext = UniformAcceleration(ax=80.0)
    xv, m = small_plummer()
    sp = [Species.dark(N=80, mass=float(m[0]), softening=SOFT)]
    common = dict(architecture="cpu", verbose=False, precision="float64",
                  snapshots=2, restart_interval=10,
                  external_potential=ext, external_update_interval=3)

    d1 = tmp_path / "full"
    res_full = run_simulation(xv, sp, 0.0, 40 * DT, DT,
                              output_dir=str(d1), **common)
    d2 = tmp_path / "split"
    run_simulation(xv, sp, 0.0, 20 * DT, DT, output_dir=str(d2), **common)
    res_resumed = run_simulation(xv, sp, 0.0, 40 * DT, DT,
                                 output_dir=str(d2), continue_run=True,
                                 **common)
    np.testing.assert_allclose(res_resumed["dark"], res_full["dark"],
                               rtol=1e-10, atol=1e-12)


def test_extract_orbits_process_pool_matches_serial(tmp_path):
    """Forced process-pool extraction (shared-memory workers) must match
    the serial read exactly; 'auto' on a single-core host stays serial."""
    xv, m = small_plummer(n=32)
    sp = [Species.dark(N=32, mass=float(m[0]), softening=SOFT)]
    run_simulation(xv, sp, 0.0, 20 * DT, DT, architecture="cpu",
                   output_dir=str(tmp_path), snapshots=10,
                   verbose=False, precision="float64")
    reader = ParticleReader(str(tmp_path / "snapshot.h5"))
    serial = reader.extract_orbits("dark", max_workers=1)
    parallel = reader.extract_orbits("dark", max_workers=2)
    np.testing.assert_array_equal(parallel.posvel, serial.posvel)
    np.testing.assert_array_equal(parallel.snaps, serial.snaps)


def test_extract_orbits_empty_selection_parallel(tmp_path):
    """snap_indices=[] with a forced process pool must return an empty
    (0, N, 6) array like the serial path, not crash on a zero-size
    shared-memory segment (ValueError, not OSError)."""
    xv, m = small_plummer(n=32)
    sp = [Species.dark(N=32, mass=float(m[0]), softening=SOFT)]
    run_simulation(xv, sp, 0.0, 10 * DT, DT, architecture="cpu",
                   output_dir=str(tmp_path), snapshots=5,
                   verbose=False, precision="float64")
    reader = ParticleReader(str(tmp_path / "snapshot.h5"))
    out = reader.extract_orbits("dark", max_workers=2, snap_indices=[])
    assert out.posvel.shape == (0, 32, 6)


def test_nan_abort_preserves_last_good_restart(tmp_path):
    """A NaN abort must write the offending state to a SEPARATE
    diagnostic file and leave the last good restart.npz untouched —
    overwriting it would destroy the only recoverable checkpoint."""
    from nbody_streams_tpu.potentials.base import Potential

    class NaNBeyond(Potential):
        """sqrt(x0 - x): finite (tiny) force inside x < x0, NaN beyond.
        No `where`: grad through where would 0*nan-contaminate the
        finite branch too."""

        def __init__(self, x0):
            self.x0 = x0

        def phi_point(self, xyz, t):
            import jax.numpy as jnp

            return 1e-6 * jnp.sqrt(self.x0 - xyz[0])

    # one massless tracer moving +x at v=1: crosses x0 between the
    # step-10 restart and the step-20 boundary
    xv = np.array([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0]])
    sp = [Species.dark(N=1, mass=0.0, softening=SOFT)]
    with pytest.raises(FloatingPointError, match="nanabort"):
        run_simulation(
            xv, sp, 0.0, 20 * DT, DT, architecture="cpu", verbose=False,
            precision="float64", save_snapshots=False, restart_interval=10,
            external_potential=NaNBeyond(14.5 * DT),
            output_dir=str(tmp_path))
    with np.load(tmp_path / "restart.npz") as d:
        assert int(d["step"]) == 10
        assert np.isfinite(d["phase_space"]).all()
    with np.load(tmp_path / "restart_nanabort.npz") as d:
        assert int(d["step"]) > 10        # detected after the good restart
        assert not np.isfinite(d["phase_space"]).all()


def test_extract_orbits_ram_warning(tmp_path, monkeypatch):
    """A (default-filter-visible) warning fires before a
    larger-than-threshold allocation (reference parity:
    nbody_io.py:632-640)."""
    from nbody_streams_tpu import nbody_io

    xv, m = small_plummer(n=32)
    sp = [Species.dark(N=32, mass=float(m[0]), softening=SOFT)]
    run_simulation(xv, sp, 0.0, 10 * DT, DT, architecture="cpu",
                   output_dir=str(tmp_path), snapshots=5,
                   verbose=False, precision="float64")
    reader = ParticleReader(str(tmp_path / "snapshot.h5"))
    monkeypatch.setattr(nbody_io, "_RAM_WARN_GB", 1e-9)
    with pytest.warns(UserWarning, match="GB of RAM"):
        reader.extract_orbits("dark", max_workers=1)
