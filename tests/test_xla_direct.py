"""XLA two-pass direct-summation backend (``impl='xla'``) vs oracles.

Mirrors the Pallas-path test contract (tests/test_pallas.py): elementwise
agreement with the float64 jnp oracle at the fp32+Kahan floor, exactness
under stale/shuffled sort orders, the single-pass fallback when the
softening is too large for the band, potential-mode self-pair
subtraction, and integrator order-reuse plumbing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_streams_tpu.ops.dispatch import DirectGravity

N = 16384          # smallest size the sorted path engages
BS = 2048          # small blocks: keeps the CPU run fast


@pytest.fixture(scope="module")
def cloud():
    r = np.random.default_rng(7)
    pos = r.normal(0, 1.0, (N, 3))
    mass = r.uniform(0.5, 1.5, N) * 1e9 / N
    soft = r.uniform(0.03, 0.08, N)
    return pos, mass, soft


@pytest.fixture(scope="module")
def oracle_acc(cloud):
    pos, mass, soft = cloud
    o = DirectGravity(mass, soft, kernel="spline", precision="float64",
                      impl="jnp")
    return np.asarray(o.accel(jnp.asarray(pos, jnp.float64)), float)


def _solver(mass, soft, **kw):
    kw.setdefault("kernel", "spline")
    kw.setdefault("precision", "float32_kahan")
    kw.setdefault("block_size", BS)
    return DirectGravity(mass, soft, impl="xla", **kw)


def test_accel_matches_f64_oracle(cloud, oracle_acc):
    pos, mass, soft = cloud
    s = _solver(mass, soft)
    a = np.asarray(s.accel(jnp.asarray(pos, jnp.float32)), float)
    err = np.abs(a - oracle_acc).max() / np.abs(oracle_acc).max()
    assert err < 3e-6


def test_potential_matches_f64_oracle(cloud):
    pos, mass, soft = cloud
    o = DirectGravity(mass, soft, kernel="spline", precision="float64",
                      impl="jnp")
    p_ref = np.asarray(o.potential(jnp.asarray(pos, jnp.float64)), float)
    s = _solver(mass, soft)
    p = np.asarray(s.potential(jnp.asarray(pos, jnp.float32)), float)
    err = np.abs(p - p_ref).max() / np.abs(p_ref).max()
    assert err < 3e-6


def test_mildly_stale_order_exact(cloud, oracle_acc):
    """Mild staleness (neighbour swaps, as accumulated within one
    scanned chunk) stays exact: windows are recomputed from the actual
    positions and carry >= 12 rows of slack."""
    pos, mass, soft = cloud
    s = _solver(mass, soft)
    p32 = jnp.asarray(pos, jnp.float32)
    order = np.asarray(s.sort_key(p32))
    stale = order.copy()
    stale[0::2], stale[1::2] = order[1::2], order[0::2]  # swap neighbours
    a = np.asarray(s.accel(p32, order=jnp.asarray(stale)), float)
    err = np.abs(a - oracle_acc).max() / np.abs(oracle_acc).max()
    assert err < 3e-6


def test_shuffled_order_poisons_not_silently_wrong(cloud, rng):
    """A fully shuffled order breaks band coverage.  With a supplied
    order (= scan context) the guard is exact-or-NaN: the output must be
    poisoned, never a silently wrong force.  (The self-sorting call form
    keeps the exact cond fallback instead — tested above via the
    fallback test.)"""
    pos, mass, soft = cloud
    s = _solver(mass, soft)
    p32 = jnp.asarray(pos, jnp.float32)
    shuffled = jnp.asarray(rng.permutation(N), jnp.int32)
    a = np.asarray(s.accel(p32, order=shuffled), float)
    assert np.isnan(a).all()


def test_fallback_when_softening_exceeds_band(cloud):
    """h_max comparable to the system size forces max_width > nb_rows;
    the single-pass fallback must stay exact (incl. potential-mode self
    subtraction)."""
    pos, mass, _ = cloud
    soft_big = np.full(N, 3.0)
    o = DirectGravity(mass, soft_big, kernel="spline",
                      precision="float64", impl="jnp")
    p64 = jnp.asarray(pos, jnp.float64)
    a_ref = np.asarray(o.accel(p64), float)
    p_ref = np.asarray(o.potential(p64), float)
    s = _solver(mass, soft_big)
    p32 = jnp.asarray(pos, jnp.float32)
    ea = np.abs(np.asarray(s.accel(p32), float) - a_ref).max() \
        / np.abs(a_ref).max()
    ep = np.abs(np.asarray(s.potential(p32), float) - p_ref).max() \
        / np.abs(p_ref).max()
    assert ea < 3e-6 and ep < 3e-6


def test_uneven_n_padding(rng):
    n = 16411   # prime-ish: exercises edge-padding of every array
    pos = rng.normal(0, 1.0, (n, 3))
    mass = np.full(n, 1e9 / n)
    soft = np.full(n, 0.05)
    o = DirectGravity(mass, soft, kernel="spline", precision="float64",
                      impl="jnp")
    a_ref = np.asarray(o.accel(jnp.asarray(pos, jnp.float64)), float)
    s = _solver(mass, soft)
    a = np.asarray(s.accel(jnp.asarray(pos, jnp.float32)), float)
    assert np.abs(a - a_ref).max() / np.abs(a_ref).max() < 3e-6


def test_small_n_uses_blocked_oracle(rng):
    """Below the sort threshold the xla impl is the jnp blocked path
    bit-for-bit."""
    n = 1000
    pos = jnp.asarray(rng.normal(0, 1.0, (n, 3)), jnp.float32)
    mass = np.full(n, 1e6)
    soft = np.full(n, 0.05)
    x = DirectGravity(mass, soft, kernel="spline",
                      precision="float32_kahan", impl="xla")
    o = DirectGravity(mass, soft, kernel="spline",
                      precision="float32_kahan", impl="jnp")
    assert np.array_equal(np.asarray(x.accel(pos)),
                          np.asarray(o.accel(pos)))


@pytest.mark.parametrize("n", [65536, 131072, 262144, 1048576])
def test_band_ladder_covers_bench_population(n):
    """Regression for the 128k-256k poison (found live on hardware,
    2026-08-19): the static band ladder must cover the *initial* band
    width of the standard bench population (Plummer a=1, h=0.05, the
    exact ICs benchmarks/direct_paths.py steps) with enough slack for
    in-scan drift.  The width check here is the same bookkeeping
    _xla_self_sorted computes (row extents + h_max reach), evaluated in
    NumPy so 1M runs in milliseconds."""
    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.ops.xla_direct import BS, RS, _nb_rows

    xv, _ = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    x = np.sort(xv[:, 0]).astype(np.float32)
    npad = -(-n // BS) * BS
    x = np.pad(x, (0, npad - n), mode="edge")
    rows = npad // RS
    nblk = npad // BS
    xt = x.reshape(nblk, BS)
    xr = x.reshape(rows, RS)
    h = 0.05
    far = (xr.max(1)[None] < (xt.min(1) - h)[:, None]) \
        | (xr.min(1)[None] > (xt.max(1) + h)[:, None])
    ridx = np.arange(rows)[None]
    first = np.where(far, rows, ridx).min(1)
    last = np.where(far, -1, ridx).max(1)
    max_width = int((last - first + 1).max())
    nb = _nb_rows(BS, RS, npad)
    # >= 4 rows of drift cushion (measured ~2 band-rows per 50 steps at
    # 64k; the in-scan order refresh runs every 10 steps)
    assert nb >= max_width + 4, (n, max_width, nb)


def test_measure_band_rows_matches_static_bookkeeping(cloud):
    """measure_band_rows must reproduce the exact max_width the ladder
    test above derives (same bookkeeping, shared helper) and be bounded
    by [block span, total rows]; a wider softening reach can only widen
    the window."""
    from nbody_streams_tpu.ops.xla_direct import measure_band_rows

    pos, mass, soft = cloud
    w = measure_band_rows(pos, soft, bs=BS, rs=512)
    npad = -(-N // BS) * BS
    assert BS // 512 <= w <= npad // 512
    w_wide = measure_band_rows(pos, np.full(N, 0.5), bs=BS, rs=512)
    assert w_wide >= w


def test_band_rows_override_exact_and_tighter(cloud, oracle_acc):
    """A solver provisioned from the measured width (+ slack) must stay
    at the fp32+Kahan oracle floor — the override changes cost, never
    values — for both accel and potential, one-shot and with a supplied
    fresh order."""
    from nbody_streams_tpu.ops.xla_direct import _nb_rows, measure_band_rows

    pos, mass, soft = cloud
    w = measure_band_rows(pos, soft, bs=BS, rs=512)
    npad = -(-N // BS) * BS
    assert w + 4 < _nb_rows(BS, 512, npad), \
        "population no longer exercises a *tighter*-than-default band"
    s = _solver(mass, soft, band_rows=w + 4)
    p32 = jnp.asarray(pos, jnp.float32)
    a = np.asarray(s.accel(p32), float)
    assert np.abs(a - oracle_acc).max() / np.abs(oracle_acc).max() < 3e-6
    o = DirectGravity(mass, soft, kernel="spline", precision="float64",
                      impl="jnp")
    p_ref = np.asarray(o.potential(jnp.asarray(pos, jnp.float64)), float)
    p = np.asarray(s.potential(p32), float)
    assert np.abs(p - p_ref).max() / np.abs(p_ref).max() < 3e-6
    order = jnp.argsort(p32[:, 0])
    a_ord = np.asarray(s.accel(p32, order=order), float)
    assert np.abs(a_ord - oracle_acc).max() / np.abs(oracle_acc).max() < 3e-6


def test_band_rows_too_narrow_one_shot_falls_back(cloud, oracle_acc):
    """An under-provisioned override on the one-shot path must take the
    single-pass cond fallback and stay exact (same contract as the
    too-large-softening fallback)."""
    pos, mass, soft = cloud
    s = _solver(mass, soft, band_rows=BS // 512 + 1)
    a = np.asarray(s.accel(jnp.asarray(pos, jnp.float32)), float)
    assert np.abs(a - oracle_acc).max() / np.abs(oracle_acc).max() < 3e-6


def test_band_rows_too_narrow_in_scan_poisons(cloud):
    """With a supplied order (scan context) an under-provisioned band
    must poison with NaN, never return silently wrong forces."""
    pos, mass, soft = cloud
    s = _solver(mass, soft, band_rows=BS // 512 + 1)
    p32 = jnp.asarray(pos, jnp.float32)
    a = np.asarray(s.accel(p32, order=jnp.argsort(p32[:, 0])), float)
    assert np.isnan(a).all()


def test_band_rows_rejected_off_the_xla_backend(cloud):
    pos, mass, soft = cloud
    with pytest.raises(ValueError, match="band_rows"):
        DirectGravity(mass, soft, kernel="spline",
                      precision="float32_kahan", impl="jnp", band_rows=20)


@pytest.mark.parametrize("rs", [128, 256])
def test_row_size_override_exact(cloud, oracle_acc, rs):
    """Finer band bookkeeping rows (row_size=) change the band/base
    split geometry only — results stay at the fp32+Kahan oracle floor,
    one-shot and with a supplied order, with and without a measured
    band_rows override."""
    from nbody_streams_tpu.ops.xla_direct import measure_band_rows

    pos, mass, soft = cloud
    p32 = jnp.asarray(pos, jnp.float32)
    s = _solver(mass, soft, row_size=rs)
    a = np.asarray(s.accel(p32), float)
    assert np.abs(a - oracle_acc).max() / np.abs(oracle_acc).max() < 3e-6
    w = measure_band_rows(pos, soft, bs=BS, rs=rs)
    s_mb = _solver(mass, soft, row_size=rs, band_rows=w + 1024 // rs)
    a_mb = np.asarray(
        s_mb.accel(p32, order=jnp.argsort(p32[:, 0])), float)
    assert np.abs(a_mb - oracle_acc).max() / np.abs(oracle_acc).max() < 3e-6
    p = np.asarray(s_mb.potential(p32), float)
    o = DirectGravity(mass, soft, kernel="spline", precision="float64",
                      impl="jnp")
    p_ref = np.asarray(o.potential(jnp.asarray(pos, jnp.float64)), float)
    assert np.abs(p - p_ref).max() / np.abs(p_ref).max() < 3e-6


def test_row_size_rejected_off_the_xla_backend(cloud):
    pos, mass, soft = cloud
    with pytest.raises(ValueError, match="row_size"):
        DirectGravity(mass, soft, kernel="spline",
                      precision="float32_kahan", impl="jnp", row_size=128)


def test_spatial_sort_active_and_integrator_reuse(cloud):
    """The integrator's order-reuse contract extends to impl='xla':
    spatial_sort_active is True, and a scanned chunk with presorted
    carry agrees with per-call sorting."""
    from nbody_streams_tpu.integrate import (
        init_state, make_accel_fn, make_kdk_step, run_chunk)

    pos, mass, soft = cloud
    s = _solver(mass, soft)
    assert s.spatial_sort_active
    vel = np.zeros_like(pos)
    accel_fn = make_accel_fn(s, s.mass)
    step_fn = make_kdk_step(accel_fn, dt=1e-4, t0=0.0)
    state = init_state(pos, vel, accel_fn, s.mass, 0.0,
                       sort_fn=s.sort_key)
    state = run_chunk(step_fn, state, 3, presort=True)

    s2 = DirectGravity(mass, soft, kernel="spline",
                       precision="float32_kahan", impl="jnp")
    accel2 = make_accel_fn(s2, s2.mass)
    step2 = make_kdk_step(accel2, dt=1e-4, t0=0.0)
    ref = init_state(pos, vel, accel2, s2.mass, 0.0)
    ref = run_chunk(step2, ref, 3)
    err = np.abs(np.asarray(state.pos) - np.asarray(ref.pos)).max()
    scale = np.abs(np.asarray(ref.pos)).max()
    assert err / scale < 1e-5


def test_non_multiple_block_size_rounds_up(cloud, oracle_acc):
    """A user block_size above RS that is not a multiple of it is
    rounded up to whole band rows (1000 -> 1024) instead of crashing at
    trace time with an opaque reshape error — and stays exact."""
    pos, mass, soft = cloud
    s = _solver(mass, soft, block_size=1000)
    a = np.asarray(s.accel(jnp.asarray(pos, jnp.float32)), float)
    err = np.abs(a - oracle_acc).max() / np.abs(oracle_acc).max()
    assert err < 3e-6


def test_uses_spatial_sort_delegates_to_pallas(monkeypatch):
    """xla_direct's predicate is the shared slab policy (ops/slab.py,
    the one the Pallas path uses): re-tuning the threshold must move
    both backends with it, never silently diverge."""
    from nbody_streams_tpu.ops import slab, xla_direct

    assert xla_direct.uses_spatial_sort("spline", 16384)
    assert not xla_direct.uses_spatial_sort("spline", 16383)
    assert not xla_direct.uses_spatial_sort("plummer", 1 << 20)
    monkeypatch.setattr(slab, "uses_spatial_sort",
                        lambda kind, n, spatial_sort=None: n >= 7)
    assert xla_direct.uses_spatial_sort("plummer", 7)
    assert not xla_direct.uses_spatial_sort("spline", 6)


def test_driver_bounds_order_staleness_under_dispatch_cap(
        cloud, monkeypatch, tmp_path):
    """When watchdog sub-chunks are shorter than presort_interval,
    run_chunk's in-scan refresh never fires — the driver must instead
    presort at sub-chunk start whenever skipping would let the slab
    order go staler than the cadence, or the exact-or-NaN guard
    eventually poisons the run mid-boundary."""
    from nbody_streams_tpu import run as run_mod
    from nbody_streams_tpu.sim import run_simulation
    from nbody_streams_tpu.species import Species

    pos, mass, soft = cloud
    xv = np.concatenate([pos, np.zeros_like(pos)], axis=1)
    sp = [Species.dark(N=N, mass=float(mass[0]), softening=0.05)]

    seen = []
    real_run_chunk = run_mod.run_chunk

    def spy(step_fn, state, n_steps, presort=False, presort_every=None):
        seen.append((n_steps, presort, presort_every))
        return real_run_chunk(step_fn, state, n_steps, presort=presort,
                              presort_every=presort_every)

    monkeypatch.setattr(run_mod, "run_chunk", spy)
    monkeypatch.setattr(run_mod, "_WATCHDOG_SUB_STEPS", 3)

    dt = 1e-5
    res = run_simulation(
        xv, sp, 0.0, 12 * dt, dt, architecture="cpu", method="direct",
        impl="xla", block_size=BS, output_dir=str(tmp_path),
        save_snapshots=False, verbose=False, precision="float32_kahan",
        step_timeout_s=600.0,
    )
    assert np.isfinite(res["dark"]).all()
    # 12 steps in 3-step sub-chunks with presort_interval=10: sorts at
    # 0 (chunk start) and again entering the sub-chunk where staleness
    # would reach 12 > 10 — never drops the sort entirely
    pat = [(s_, p) for s_, p, pe in seen if pe == 10]
    assert pat == [(3, True), (3, False), (3, False), (3, True)]


def test_presort_every_override(cloud):
    """presort_every= stretches the in-scan order-refresh cadence the
    integrator reads via solver.presort_interval; xla-only, >= 1."""
    pos, mass, soft = cloud
    s = _solver(mass, soft, presort_every=25)
    assert s.presort_interval == 25
    assert _solver(mass, soft).presort_interval == 10
    with pytest.raises(ValueError, match="presort_every"):
        DirectGravity(mass, soft, kernel="spline",
                      precision="float32_kahan", impl="jnp",
                      presort_every=25)
    with pytest.raises(ValueError, match="presort_every"):
        _solver(mass, soft, presort_every=0)
