"""Pallas (Triton route) kernel correctness in interpret mode (CPU).

The compiled kernel is checked on the card by tests/test_gpu_smoke.py
and chip_smoke.py; these tests pin its arithmetic, padding, block
choice and sorted form against the jnp oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_streams_tpu.ops.pallas_direct import (
    pallas_accel,
    pallas_potential,
)
from nbody_streams_tpu.ops import (
    compute_forces_direct,
    compute_potential_direct,
)

INTERPRET = True
KINDS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.default_rng(5)
    n = 700  # exercises padding in both target and source dims
    pos = jnp.asarray(rng.normal(0, 1, (n, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n) * 1e5, jnp.float32)
    soft = jnp.asarray(rng.uniform(0.05, 0.3, n), jnp.float32)
    return pos, mass, soft


@pytest.mark.parametrize("kind", KINDS)
def test_pallas_accel_matches_oracle(cluster, kind):
    pos, mass, soft = cluster
    a_p = np.asarray(pallas_accel(pos, mass, soft, 4.3e-6, kind, True,
                                  interpret=INTERPRET))
    a_j = np.asarray(compute_forces_direct(pos, mass, soft, G=4.3e-6,
                                           kernel=kind,
                                           precision="float32_kahan"))
    np.testing.assert_allclose(a_p, a_j, atol=3e-6 * np.abs(a_j).max())
    assert np.isfinite(a_p).all()


@pytest.mark.parametrize("kind", KINDS)
def test_pallas_potential_matches_oracle(cluster, kind):
    pos, mass, soft = cluster
    p_p = np.asarray(pallas_potential(pos, mass, soft, 4.3e-6, kind, True,
                                      interpret=INTERPRET))
    p_j = np.asarray(compute_potential_direct(pos, mass, soft, G=4.3e-6,
                                              kernel=kind,
                                              precision="float32_kahan"))
    np.testing.assert_allclose(p_p, p_j, atol=3e-6 * np.abs(p_j).max())


@pytest.mark.parametrize("kind", KINDS)
def test_unsoftened_particles_every_kernel(kind):
    """h = 0 particles mixed with softened ones, every kernel: finite and
    on the float64 oracle (fed the same float32 inputs).  An unsoftened
    self pair has d = eps2, where d^-3.5 overflows float32 — dehnen_k2
    must not turn that into 0 * inf = NaN."""
    rng = np.random.default_rng(5)
    n = 300
    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    pos = f32(rng.normal(0, 1, (n, 3)))
    mass = f32(rng.uniform(0.5, 2.0, n) * 1e5)
    soft = f32(rng.uniform(0.05, 0.3, n))
    soft[:20] = 0.0
    args = [jnp.asarray(a, jnp.float32) for a in (pos, mass, soft)]
    a = np.asarray(pallas_accel(*args, 4.3e-6, kind, True,
                                interpret=INTERPRET), np.float64)
    p = np.asarray(pallas_potential(*args, 4.3e-6, kind, True,
                                    interpret=INTERPRET), np.float64)
    a_ref = np.asarray(compute_forces_direct(pos, mass, soft, G=4.3e-6,
                                             kernel=kind,
                                             precision="float64"))
    p_ref = np.asarray(compute_potential_direct(pos, mass, soft, G=4.3e-6,
                                                kernel=kind,
                                                precision="float64"))
    assert np.isfinite(a).all() and np.isfinite(p).all()
    assert np.abs(a - a_ref).max() < 3e-6 * np.abs(a_ref).max()
    assert np.abs(p - p_ref).max() < 3e-6 * np.abs(p_ref).max()


def test_pallas_zero_softening_no_nan(cluster):
    pos, mass, _ = cluster
    zero = jnp.zeros(pos.shape[0], jnp.float32)
    a = np.asarray(pallas_accel(pos, mass, zero, 1.0, "newtonian", False,
                                interpret=INTERPRET))
    assert np.isfinite(a).all()


def test_pallas_potential_with_zero_softening_particles(cluster):
    """h = 0 particles: the in-kernel self mask must avoid the
    catastrophic cancellation an outside self-term subtraction causes."""
    pos, mass, soft = cluster
    s = np.asarray(soft).copy()
    s[:50] = 0.0
    s = jnp.asarray(s)
    p_p = np.asarray(pallas_potential(pos, mass, s, 4.3e-6, "spline", True,
                                      interpret=INTERPRET))
    p_j = np.asarray(compute_potential_direct(
        pos, mass, s, G=4.3e-6, kernel="spline",
        precision="float32_kahan"))
    np.testing.assert_allclose(p_p, p_j, atol=3e-6 * np.abs(p_j).max())


def _unsorted(pos, soft, gm, mode, **kw):
    from nbody_streams_tpu.ops.pallas_direct import _pallas_direct, _soft_pre

    pre = _soft_pre("spline", soft)
    return _pallas_direct(pos, pre, pos, gm, pre, kind="spline", kahan=True,
                          mode=mode, eps2=1e-15, mask_self=(mode == "pot"),
                          interpret=INTERPRET, **kw)


def test_two_pass_sorted_matches_single_pass(cluster):
    """The slab-sorted form (far source tiles take the Newtonian factor)
    must agree with the unsorted spline kernel to f32 summation-reorder
    level, including when the softening is comparable to the system size
    and no tile is far."""
    from nbody_streams_tpu.ops.pallas_direct import _pallas_self_sorted

    pos, mass, soft = cluster
    gm = mass * 4.3e-6
    for mode in ("acc", "pot"):
        ref = _unsorted(pos, soft, gm, mode)
        two = _pallas_self_sorted(pos, gm, soft, "spline", True, mode,
                                  1e-15, interpret=INTERPRET)
        d = np.abs(np.asarray(ref) - np.asarray(two)).max()
        assert d < 1e-6 * np.abs(np.asarray(ref)).max(), mode

    hbig = jnp.full(pos.shape[0], 5.0, jnp.float32)
    ref = _unsorted(pos, hbig, gm, "acc")
    two = _pallas_self_sorted(pos, gm, hbig, "spline", True, "acc",
                              1e-15, interpret=INTERPRET)
    d = np.abs(np.asarray(ref) - np.asarray(two)).max()
    assert d < 1e-6 * np.abs(np.asarray(ref)).max()


def test_sorted_path_stale_order_is_exact():
    """A precomputed slab order — fresh, stale (perturbed positions), or
    adversarially shuffled — must give oracle-level results: the tile
    bounds are recomputed from actual positions, so any permutation is
    exact (fewer far tiles, never wrong)."""
    from nbody_streams_tpu.ops.pallas_direct import _pallas_self_sorted

    rng = np.random.default_rng(11)
    n = 6000
    pos = jnp.asarray(rng.normal(0, 1.0, (n, 3)), jnp.float32)
    gm = jnp.asarray(rng.uniform(0.5, 1.5, n) * 4.3e-6, jnp.float32)
    soft = jnp.full((n,), 0.05, jnp.float32)
    # the default 8-wide source tiles: most are far from most target
    # blocks at this N, so both kernel bodies run
    kw = dict(interpret=INTERPRET)
    ref = np.asarray(_pallas_self_sorted(pos, gm, soft, "spline", True,
                                         "acc", 1e-15, **kw), np.float64)

    # stale: the order of slightly-perturbed past positions
    past = pos + jnp.asarray(rng.normal(0, 0.02, pos.shape), jnp.float32)
    stale = jnp.argsort(past[:, 0])
    # adversarial: a completely random permutation
    shuf = jnp.asarray(rng.permutation(pos.shape[0]), jnp.int32)
    # drifter: order is fresh EXCEPT one particle crossed the whole
    # system since the sort.  This breaks tile-span monotonicity; the
    # per-tile min/max bounds must stay exact.
    drift_pos = np.asarray(pos).copy()
    lo = int(np.argmin(drift_pos[:, 0]))
    hi = int(np.argmax(drift_pos[:, 0]))
    # land INSIDE the spline support of the x-max particle (3-D offset
    # 0.017 << h = 0.05): its pair force is dominated by the kernel
    # factor, so a Newtonian misclassification is large and visible
    drift_pos[lo] = drift_pos[hi] + np.array([0.012, 0.012, 0.0])
    drift_pos = jnp.asarray(drift_pos)
    drift_order = jnp.argsort(pos[:, 0])              # stale: pre-drift
    ref_drift = np.asarray(_pallas_self_sorted(
        drift_pos, gm, soft, "spline", True, "acc", 1e-15, **kw),
        np.float64)

    for p, order, r in ((pos, jnp.argsort(pos[:, 0]), ref),
                        (pos, stale, ref),
                        (pos, shuf, ref),
                        (drift_pos, drift_order, ref_drift)):
        out = np.asarray(_pallas_self_sorted(
            p, gm, soft, "spline", True, "acc", 1e-15, order=order,
            **kw), np.float64)
        # 5e-6: a permuted order reorders the fp32 summation across all
        # ~6000 sources (pure round-off, both sides exact)
        assert np.abs(out - r).max() < 5e-6 * np.abs(r).max()


def test_run_chunk_presort_matches_per_call_sort():
    """run_chunk(presort=True) — one slab sort per chunk threaded
    through the scan carry — must integrate to the same state as the
    per-force-call sort (fp32 summation-reorder level)."""
    import jax

    from nbody_streams_tpu.integrate import (
        init_state,
        make_accel_fn,
        make_kdk_step,
        run_chunk,
    )
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    rng = np.random.default_rng(3)
    n = 256
    pos = rng.normal(0, 1, (n, 3))
    vel = rng.normal(0, 0.1, (n, 3))
    mass = np.full(n, 1e9 / n)

    class SortedPallas(DirectGravity):
        """Force the sorted interpret-mode path at small N."""

        def accel(self, pos, order=None):
            from nbody_streams_tpu.ops import pallas_direct

            return pallas_direct.pallas_accel(
                pos.astype(self.dtype), self.mass, self.softening, self.G,
                self.kernel, self.kahan, self.eps2, interpret=True,
                spatial_sort=True, order=order)

    solver = SortedPallas(mass, np.full(n, 0.05), impl="jnp")
    accel_fn = make_accel_fn(solver, solver.mass)
    step_fn = make_kdk_step(accel_fn, 2e-5, 0.0)
    s0 = init_state(pos, vel, accel_fn, solver.mass, 0.0)

    # run_chunk donates its state: deep-copy for the first call
    fresh = run_chunk(step_fn, jax.tree.map(jnp.copy, s0), 8)

    # materialised-at-init order: the carry pytree structure must be
    # IDENTICAL before and after a presorted chunk — a () -> array flip
    # would double every compiled executable
    s1 = init_state(pos, vel, accel_fn, solver.mass, 0.0,
                    sort_fn=solver.sort_key)
    struct_before = jax.tree.structure(s1)
    pre = run_chunk(step_fn, s1, 8, presort=True)
    assert jax.tree.structure(pre) == struct_before
    order = np.asarray(pre.sort_order)
    assert np.array_equal(np.sort(order), np.arange(n))
    scale = np.abs(np.asarray(fresh.pos)).max()
    assert np.abs(np.asarray(pre.pos) - np.asarray(fresh.pos)).max() \
        < 1e-6 * scale
    assert np.abs(np.asarray(pre.vel) - np.asarray(fresh.vel)).max() \
        < 1e-6 * np.abs(np.asarray(fresh.vel)).max()


def test_mxu_contractions_pin_operand_precision():
    """Every JAX contraction whose result feeds a force on the main
    path must carry ``precision=jax.lax.Precision.HIGHEST``: on the GPU
    XLA may otherwise run it in TF32 (about three decimal digits), far
    outside the 3e-6 force tolerance and invisible to CPU tests.
    Source-level guard because no CPU test can see the truncation."""
    import re
    from pathlib import Path

    pkg = Path(__file__).resolve().parent.parent / "nbody_streams_tpu"
    pin = "precision=jax.lax.Precision.HIGHEST"
    for rel in ("ops/scf.py", "potentials/cylspline.py", "integrate.py",
                "potentials/galpot.py", "run.py", "potentials/fit.py",
                "ops/pallas_direct.py", "ops/xla_direct.py",
                "ops/pairwise.py"):
        src = (pkg / rel).read_text()
        for match in re.finditer(
                r"dot_general\(|jnp\.dot\(|jnp\.matmul\(|jnp\.einsum\(",
                src):
            window = src[match.start():match.start() + 400]
            assert pin in window, (
                f"{rel}: contraction at offset {match.start()} has no "
                "precision=HIGHEST (TF32 on the GPU)")
    # (the '@' products in potentials/galpot.py and potentials/fit.py
    # are NumPy float64 on the host, set-up work outside XLA)


def _cloud(n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 3)).astype(np.float64),
            rng.uniform(0.5, 2.0, n) * 1e5,
            rng.uniform(0.02, 0.2, n))


@pytest.mark.parametrize("n", [1, 2, 17, 129, 300])
def test_padding_any_n_matches_oracle(n):
    """Target padding to whole programs and source padding to whole
    reduction groups (zero mass) are invisible for any N, including a
    single particle (zero force, zero potential)."""
    pos, mass, soft = _cloud(n)
    p32 = [jnp.asarray(a, jnp.float32) for a in (pos, mass, soft)]
    a = np.asarray(pallas_accel(*p32, 4.3e-6, "spline", True,
                                interpret=INTERPRET))
    p = np.asarray(pallas_potential(*p32, 4.3e-6, "spline", True,
                                    interpret=INTERPRET))
    a_ref = np.asarray(compute_forces_direct(pos, mass, soft, G=4.3e-6,
                                             precision="float64"))
    p_ref = np.asarray(compute_potential_direct(pos, mass, soft, G=4.3e-6,
                                                precision="float64"))
    assert a.shape == (n, 3) and p.shape == (n,)
    np.testing.assert_allclose(a, a_ref, atol=3e-6 * max(
        np.abs(a_ref).max(), 1e-30))
    np.testing.assert_allclose(p, p_ref, atol=3e-6 * max(
        np.abs(p_ref).max(), 1e-30))


@pytest.mark.parametrize("nt,ns,want", [
    (1, 1, (16, 8, 1)),
    (100, 100, (128, 8, 16)),
    (700, 700, (128, 8, 32)),
    (65536, 65536, (128, 8, 32)),
    (20, 5000, (32, 8, 32)),
    (5000, 20, (128, 8, 4)),
])
def test_block_config(nt, ns, want):
    """Block sizes are powers of two, shrink with small problems so the
    padding stays bounded, and never exceed the tuned defaults."""
    from nbody_streams_tpu.ops.pallas_direct import block_config

    got = block_config(nt, ns)
    assert got == want
    for v in got:
        assert v & (v - 1) == 0


@pytest.mark.parametrize("kind", ["plummer", "spline"])
@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_two_set_matches_oracle(kind, mode):
    """Two-set form (the sharded ring tile, the potential fit): targets
    and sources are different arrays of different lengths."""
    from nbody_streams_tpu.ops.pairwise import accel_tile, potential_tile
    from nbody_streams_tpu.ops.pallas_direct import (pallas_accel_2set,
                                                     pallas_potential_2set)

    pt, _, ht = _cloud(300, seed=1)
    ps, ms, hs = _cloud(1000, seed=2)
    ps = ps + 0.5
    gm = ms * 4.3e-6
    f = pallas_accel_2set if mode == "acc" else pallas_potential_2set
    out = np.asarray(f(*(jnp.asarray(a, jnp.float32)
                         for a in (pt, ht, ps, gm, hs)), kind, True,
                       interpret=INTERPRET))
    tile = accel_tile if mode == "acc" else potential_tile
    ref = np.asarray(tile(kind, jnp.asarray(pt), jnp.asarray(ht),
                          jnp.full(300, -1, jnp.int32), jnp.asarray(ps),
                          jnp.asarray(gm), jnp.asarray(hs),
                          jnp.arange(1000, dtype=jnp.int32)))
    np.testing.assert_allclose(out, ref, atol=3e-6 * np.abs(ref).max())


def test_two_set_potential_mask_self_matches_single_set(cluster):
    """mask_self=True on identical target/source arrays is the
    single-set potential (the ring's self-block step)."""
    from nbody_streams_tpu.ops.pallas_direct import pallas_potential_2set

    pos, mass, soft = cluster
    gm = mass * 4.3e-6
    two = np.asarray(pallas_potential_2set(pos, soft, pos, gm, soft,
                                           "spline", True,
                                           interpret=INTERPRET,
                                           mask_self=True))
    one = np.asarray(pallas_potential(pos, mass, soft, 4.3e-6, "spline",
                                      True, interpret=INTERPRET))
    np.testing.assert_allclose(two, one, rtol=1e-6)


def test_plain_float32_within_stated_bound(cluster):
    """kahan=False (precision='float32') stays inside its stated 3e-5
    bound against the float64 oracle."""
    pos, mass, soft = cluster
    a = np.asarray(pallas_accel(pos, mass, soft, 4.3e-6, "spline", False,
                                interpret=INTERPRET), np.float64)
    ref = np.asarray(compute_forces_direct(
        np.asarray(pos, np.float64), np.asarray(mass, np.float64),
        np.asarray(soft, np.float64), G=4.3e-6, precision="float64"))
    assert np.abs(a - ref).max() < 3e-5 * np.abs(ref).max()


def test_sorted_bounds_make_far_tiles():
    """On a slab-sorted Plummer sphere most (target block, source tile)
    pairs are farther apart than max(h): the compact-support test has
    work to skip.  Mirrors the bounds _pallas_self_sorted passes."""
    from nbody_streams_tpu import make_plummer_sphere

    n, bt, bs = 20000, 128, 8
    xv, _ = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    x = np.sort(xv[:, 0])
    xt = np.pad(x, (0, -n % bt), mode="edge").reshape(-1, bt)
    xs = np.pad(x, (0, -n % bs), mode="edge").reshape(-1, bs)
    h = 0.05
    far = ((xs.max(1)[None, :] < xt.min(1)[:, None] - h)
           | (xs.min(1)[None, :] > xt.max(1)[:, None] + h))
    assert far.mean() > 0.8


@pytest.mark.parametrize("precision,impl", [("float32_kahan", "pallas"),
                                            ("float32", "pallas"),
                                            ("float64", "jnp")])
def test_direct_gravity_pallas_impl(precision, impl):
    """DirectGravity(impl='pallas') routes to the kernel for both fp32
    tiers and falls back to the jnp oracle for float64."""
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    pos, mass, soft = _cloud(64)
    s = DirectGravity(mass, soft, impl="pallas", precision=precision)
    assert s.impl == impl
    assert s.kahan == (precision == "float32_kahan")


@pytest.mark.parametrize("bad", [{"tile_config": {"tm": 256}},
                                 {"target_drift": 1e-8}])
def test_removed_options_rejected(bad):
    """The accelerator-tuning options of the earlier kernel are gone and
    fail loudly instead of being silently ignored."""
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    with pytest.raises(TypeError):
        DirectGravity(np.ones(8), np.full(8, 0.05), **bad)


def test_float32_fast_rejected():
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    with pytest.raises(ValueError, match="precision"):
        DirectGravity(np.ones(8), np.full(8, 0.05),
                      precision="float32_fast")
