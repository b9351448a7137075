"""Card-only tier: the main paths compiled and run on a GPU.

Every test here carries the ``gpu`` marker and takes the ``gpu_device``
fixture, which skips unless JAX's first device is a GPU (decided when
the fixture runs, never at import).  Run it on a GPU host with

    NBODY_TEST_GPU=1 python -m pytest tests/test_gpu_smoke.py -m gpu

or through ``python chip_smoke.py``, whose last phase runs this file.
Small N and few steps: the CPU suites pin accuracy; this tier proves
that the compiled kernels, the driver and the device-resident pieces
run on the card and agree with the jnp oracle there.  Snapshots stay
off (h5py is optional); restart files are numpy.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"first device is {dev.platform}, not a GPU")
    return dev


@pytest.fixture(scope="module")
def plummer_small():
    from nbody_streams_tpu import make_plummer_sphere

    xv, m = make_plummer_sphere(512, M_total=1e9, a=1.0, seed=3)
    return xv, m


def test_run_simulation_direct_on_card(gpu_device, plummer_small, tmp_path):
    """Main path: run_simulation -> Pallas kernel inside the scanned KDK
    step, restart file and energy diagnostics on."""
    from nbody_streams_tpu import Species, run_simulation
    from nbody_streams_tpu.nbody_io import _load_restart

    xv, m = plummer_small
    sp = [Species.dark(N=512, mass=float(m[0]), softening=0.05)]
    res = run_simulation(xv, sp, 0.0, 5e-3, 5e-4, architecture="gpu",
                         method="direct", output_dir=str(tmp_path),
                         save_snapshots=False, restart_interval=5,
                         verbose=False, debug_energy=True)
    out = res["dark"]
    assert out.shape == (512, 6) and np.all(np.isfinite(out))
    restart = _load_restart(tmp_path)
    assert restart is not None and int(restart[2]) == 10


def test_evolving_mwlmc_potential_in_scan_on_card(gpu_device, tmp_path):
    """The MW+LMC evolving potential evaluated inside the scanned step."""
    from nbody_streams_tpu import Species, run_simulation
    from nbody_streams_tpu.potentials.mwlmc import load_mw_lmc_potential

    pot, _traj = load_mw_lmc_potential()
    rng = np.random.default_rng(0)
    n = 128
    xv = np.zeros((n, 6))
    xv[:, :3] = rng.normal(0, 1, (n, 3)) + np.array([-8.0, 0, 20.0])
    xv[:, 3:] = rng.normal(0, 30.0, (n, 3))
    sp = [Species.star(N=n, mass=1.0, softening=0.01)]
    res = run_simulation(xv, sp, 0.0, 2e-3, 2e-4, architecture="gpu",
                         external_potential=pot, save_snapshots=False,
                         output_dir=str(tmp_path), verbose=False)
    assert np.all(np.isfinite(res["star"]))


def test_dynamical_friction_run_on_card(gpu_device, tmp_path):
    """DF force_extra (sigma spline + CoM tracking) inside the step."""
    from nbody_streams_tpu import Species, run_simulation
    from nbody_streams_tpu.potentials import NFWPotential

    host = NFWPotential(mass=1e12, scaleRadius=15.0)
    rng = np.random.default_rng(1)
    n = 256
    xv = np.zeros((n, 6))
    xv[:, :3] = rng.normal(0, 0.5, (n, 3)) + np.array([40.0, 0, 0])
    xv[:, 4] = 120.0
    sp = [Species.dark(N=n, mass=1e7, softening=0.1)]
    res = run_simulation(xv, sp, 0.0, 2e-3, 2e-4, architecture="gpu",
                         external_potential=host, dynamical_friction=True,
                         df_sigma_method="local_circular",
                         save_snapshots=False, output_dir=str(tmp_path),
                         verbose=False)
    assert np.all(np.isfinite(res["dark"]))


def test_tree_shim_on_card(gpu_device, plummer_small):
    """tree_gravity_gpu compat shim (cached exact solver)."""
    from nbody_streams_tpu.tree import TreeGPU, tree_gravity_gpu

    xv, m = plummer_small
    acc, phi = tree_gravity_gpu(xv[:, :3], m, eps=0.05)
    assert np.all(np.isfinite(np.asarray(acc)))
    assert np.all(np.asarray(phi) <= 0)
    handle = TreeGPU(512, eps=0.05)
    acc2, phi2 = tree_gravity_gpu(xv[:, :3], m, eps=0.05, tree=handle)
    np.testing.assert_allclose(np.asarray(acc2), np.asarray(acc),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("kind", ["newtonian", "plummer", "dehnen_k1",
                                  "dehnen_k2", "spline"])
def test_pallas_kernel_matches_oracle_on_card(gpu_device, kind):
    """The compiled Triton kernel, every softening kernel, acceleration
    and potential, against the float64 jnp oracle."""
    import jax.numpy as jnp

    from nbody_streams_tpu.ops import (compute_forces_direct,
                                       compute_potential_direct)
    from nbody_streams_tpu.ops.pallas_direct import (pallas_accel,
                                                     pallas_potential)

    rng = np.random.default_rng(5)
    n = 3000                     # pads in both target and source dims
    # float32-representable inputs: the oracle then sees exactly what
    # the kernel sees (input rounding alone costs ~1e-3 relative on the
    # closest unsoftened pairs)
    pos = rng.normal(0, 1, (n, 3)).astype(np.float32).astype(np.float64)
    mass = (rng.uniform(0.5, 2.0, n) * 1e5).astype(np.float32).astype(
        np.float64)
    soft = rng.uniform(0.05, 0.3, n).astype(np.float32).astype(np.float64)
    soft[:40] = 0.0              # unsoftened particles, in-kernel mask
    args = (jnp.asarray(pos, jnp.float32), jnp.asarray(mass, jnp.float32),
            jnp.asarray(soft, jnp.float32), 4.3e-6, kind, True)
    a = np.asarray(pallas_accel(*args), np.float64)
    p = np.asarray(pallas_potential(*args), np.float64)
    a_ref = np.asarray(compute_forces_direct(pos, mass, soft, G=4.3e-6,
                                             kernel=kind,
                                             precision="float64"))
    p_ref = np.asarray(compute_potential_direct(pos, mass, soft, G=4.3e-6,
                                                kernel=kind,
                                                precision="float64"))
    assert np.abs(a - a_ref).max() < 3e-6 * np.abs(a_ref).max()
    assert np.abs(p - p_ref).max() < 3e-6 * np.abs(p_ref).max()


def test_sorted_presort_path_on_card(gpu_device):
    """The slab-sorted kernel with a chunk-reused sort order, stepped on
    the card; its potential against the jnp oracle."""
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.integrate import (
        init_state,
        make_accel_fn,
        make_kdk_step,
        run_chunk,
    )
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    n = 16384
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=4)
    solver = DirectGravity(m, np.full(n, 0.05), impl="pallas")
    assert solver.spatial_sort_active
    accel_fn = make_accel_fn(solver, solver.mass)
    step_fn = make_kdk_step(accel_fn, 2e-5, 0.0)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                       sort_fn=solver.sort_key)
    state = run_chunk(step_fn, state, 5, presort=True)
    pos = np.asarray(jax.device_get(state.pos))
    assert np.all(np.isfinite(pos))
    order = np.asarray(jax.device_get(state.sort_order))
    assert np.array_equal(np.sort(order), np.arange(n))
    phi = np.asarray(solver.potential(state.pos, order=jnp.asarray(order)))
    oracle = DirectGravity(m, np.full(n, 0.05), impl="jnp")
    phi_o = np.asarray(oracle.potential(state.pos))
    np.testing.assert_allclose(phi, phi_o, atol=3e-6 * np.abs(phi_o).max())


def test_scf_tier_on_card(gpu_device, tmp_path):
    """method='scf' on the card: the solver against the CPU result (the
    Precision.HIGHEST matmuls must not drop to TF32), then through the
    driver."""
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation
    from nbody_streams_tpu.ops.scf import SCFGravity

    n = 8192
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=5)
    pos32 = np.asarray(xv[:, :3], np.float32)
    scf = SCFGravity(m, nmax=8, lmax=4, a=1.0)
    a_gpu = np.asarray(scf.accel(jnp.asarray(pos32)))
    with jax.default_device(jax.devices("cpu")[0]):
        scf_cpu = SCFGravity(np.asarray(m), nmax=8, lmax=4, a=1.0)
        a_cpu = np.asarray(scf_cpu.accel(jnp.asarray(pos32)))
    assert np.all(np.isfinite(a_gpu))
    assert np.max(np.abs(a_gpu - a_cpu)) < 3e-5 * np.abs(a_cpu).max()

    sp = [Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    res = run_simulation(xv, sp, 0.0, 1e-3, 1e-4, architecture="gpu",
                         method="scf", scf_nmax=6, scf_lmax=2,
                         save_snapshots=False, output_dir=str(tmp_path),
                         verbose=False, debug_energy=True)
    assert np.all(np.isfinite(res["dark"]))


def test_sharded_on_one_device_gpu_mesh(gpu_device, plummer_small):
    """impl='sharded' on a 1-device GPU mesh: the Pallas ring tiles under
    shard_map on the card, against the single-device kernel."""
    import jax.numpy as jnp

    from nbody_streams_tpu.ops.dispatch import DirectGravity

    xv, m = plummer_small
    soft = np.full(512, 0.05)
    sharded = DirectGravity(m, soft, impl="sharded", devices=[gpu_device])
    assert sharded._sharded.use_pallas
    single = DirectGravity(m, soft, impl="pallas")
    p = jnp.asarray(xv[:, :3], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(sharded.accel(p)), np.asarray(single.accel(p)),
        atol=2e-6 * np.abs(np.asarray(single.accel(p))).max())
    p_1 = np.asarray(single.potential(p))
    np.testing.assert_allclose(np.asarray(sharded.potential(p)), p_1,
                               atol=2e-6 * np.abs(p_1).max())


def test_xla_two_pass_backend_on_card(gpu_device):
    """impl='xla' on the card: one-shot accel matches the Pallas kernel,
    and a presorted scanned chunk (poison guard, in-scan re-sort) stays
    finite."""
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.integrate import (
        init_state, make_accel_fn, make_kdk_step, run_chunk)
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    n = 16384
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=4)
    soft = np.full(n, 0.05)
    pos = jnp.asarray(xv[:, :3], jnp.float32)
    sx = DirectGravity(m, soft, impl="xla")
    sp = DirectGravity(m, soft, impl="pallas")
    ax = np.asarray(jax.device_get(sx.accel(pos)), float)
    ap = np.asarray(jax.device_get(sp.accel(pos)), float)
    assert np.isfinite(ax).all()
    assert np.abs(ax - ap).max() / np.abs(ap).max() < 5e-6

    accel_fn = make_accel_fn(sx, sx.mass)
    step_fn = make_kdk_step(accel_fn, dt=2e-5, t0=0.0)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, sx.mass, 0.0,
                       sort_fn=sx.sort_key)
    state = run_chunk(step_fn, state, 25, presort=True,
                      presort_every=sx.presort_interval)
    assert np.isfinite(np.asarray(jax.device_get(state.pos))).all()


def test_bfe_potentials_on_card(gpu_device):
    """BFE evaluators (CylSpline Hermite dot, Multipole quintic) against
    their analytic sources: the CylSpline evaluation ends in a vmapped
    dot that must stay at Precision.HIGHEST, not TF32."""
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu.potentials.analytic import (
        MiyamotoNagaiPotential, PlummerPotential)
    from nbody_streams_tpu.potentials.coefs import (
        CylSplineCoefs, MultipoleCoefs)
    from nbody_streams_tpu.potentials.cylspline import CylSplinePotential
    from nbody_streams_tpu.potentials.multipole import MultipolePotential

    rng = np.random.default_rng(0)
    mn = MiyamotoNagaiPotential(mass=5e10, scaleRadius=3.0,
                                scaleHeight=0.3)
    r_grid = np.concatenate([[0.0], np.geomspace(0.1, 100.0, 30)])
    zp = np.geomspace(0.05, 100.0, 15)
    z_grid = np.concatenate([-zp[::-1], [0.0], zp])
    rr, zz = np.meshgrid(r_grid, z_grid, indexing="ij")
    tab = np.asarray(mn.potential(np.column_stack(
        [rr.ravel(), np.zeros(rr.size), zz.ravel()]))).reshape(rr.shape)
    cs = CylSplinePotential(CylSplineCoefs(
        R_grid=r_grid, z_grid=z_grid, m_values=[0], phi=tab[None]))
    pts = rng.normal(0, 10, (2048, 3)).astype(np.float32)
    f = np.asarray(jax.device_get(jax.jit(cs.force)(jnp.asarray(pts))))
    f_ref = np.asarray(mn.force(pts))
    assert np.isfinite(f).all()
    assert np.abs(f - f_ref).max() / np.abs(f_ref).max() < 5e-3

    pl = PlummerPotential(mass=1e11, scaleRadius=5.0)
    rg = np.geomspace(0.05, 500, 40)
    pts_r = np.column_stack([rg, 0 * rg, 0 * rg])
    phi_r = np.asarray(pl.potential(pts_r))
    dphi = -np.asarray(pl.force(pts_r))[:, 0]
    mp = MultipolePotential(MultipoleCoefs(
        R_grid=rg, lm_labels=[(0, 0)], phi=phi_r[:, None],
        dphi_dr=dphi[:, None]))
    g = np.asarray(jax.device_get(jax.jit(mp.force)(jnp.asarray(pts))))
    g_ref = np.asarray(pl.force(pts))
    assert np.isfinite(g).all()
    assert np.abs(g - g_ref).max() / np.abs(g_ref).max() < 1e-4
