"""Pairwise force/potential oracle cross-validation and property tests."""
import numpy as np
import pytest

from nbody_streams_tpu.ops import (
    compute_forces_direct,
    compute_potential_direct,
)

from numpy_oracle import oracle_forces, oracle_potential

KERNELS = ["newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"]


def make_cluster(rng, n=96, scale=1.0):
    pos = rng.normal(0.0, scale, (n, 3))
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = rng.uniform(0.05, 0.3, n)
    return pos, mass, soft


@pytest.mark.parametrize("kernel", KERNELS)
def test_forces_match_numpy_oracle_f64(rng, kernel):
    pos, mass, soft = make_cluster(rng)
    G = 4.300917270069976e-06
    acc = np.asarray(
        compute_forces_direct(pos, mass, soft, G=G, kernel=kernel,
                              precision="float64", block_size=32)
    )
    ref = oracle_forces(pos, mass, soft, G, kernel)
    np.testing.assert_allclose(acc, ref, rtol=1e-9,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("kernel", KERNELS)
def test_potential_match_numpy_oracle_f64(rng, kernel):
    pos, mass, soft = make_cluster(rng)
    G = 4.300917270069976e-06
    phi = np.asarray(
        compute_potential_direct(pos, mass, soft, G=G, kernel=kernel,
                                 precision="float64", block_size=32)
    )
    ref = oracle_potential(pos, mass, soft, G, kernel)
    np.testing.assert_allclose(phi, ref, rtol=1e-9,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("precision", ["float32", "float32_kahan"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_f32_close_to_f64(rng, kernel, precision):
    pos, mass, soft = make_cluster(rng, n=128)
    G = 4.300917270069976e-06
    a32 = np.asarray(
        compute_forces_direct(pos, mass, soft, G=G, kernel=kernel,
                              precision=precision, block_size=32)
    )
    a64 = oracle_forces(pos, mass, soft, G, kernel)
    scale = np.abs(a64).max()
    np.testing.assert_allclose(a32, a64, atol=2e-5 * scale)


@pytest.mark.parametrize("precision", ["float32", "float32_kahan", "float64"])
def test_newtons_third_law(rng, precision):
    """Net force on the whole system must vanish (momentum conservation)."""
    pos, mass, soft = make_cluster(rng, n=200)
    acc = np.asarray(
        compute_forces_direct(pos, mass, soft, G=1.0, kernel="spline",
                              precision=precision)
    ).astype(np.float64)
    net = (np.asarray(mass)[:, None] * acc).sum(axis=0)
    fscale = np.abs(np.asarray(mass)[:, None] * acc).sum()
    tol = 1e-12 if precision == "float64" else 3e-6
    assert np.abs(net).max() < tol * fscale


def test_spline_matches_newtonian_outside_support(rng):
    """Cubic-spline kernel must be exactly Newtonian for r >= h."""
    pos = np.array([[0.0, 0, 0], [3.0, 0, 0], [0, 5.0, 0]])
    mass = np.array([1.0, 2.0, 3.0])
    soft = np.array([0.5, 0.5, 0.5])
    a_spline = np.asarray(compute_forces_direct(
        pos, mass, soft, G=1.0, kernel="spline", precision="float64"))
    a_newton = np.asarray(compute_forces_direct(
        pos, mass, soft, G=1.0, kernel="newtonian", precision="float64"))
    np.testing.assert_allclose(a_spline, a_newton, rtol=1e-13)


def test_scalar_mass_softening_broadcast(rng):
    pos = rng.normal(size=(50, 3))
    a1 = np.asarray(compute_forces_direct(
        pos, 2.0, 0.1, G=1.0, precision="float64"))
    a2 = np.asarray(compute_forces_direct(
        pos, np.full(50, 2.0), np.full(50, 0.1), G=1.0, precision="float64"))
    np.testing.assert_allclose(a1, a2)


def test_pair_softening_max_rule(rng):
    """h_eff = max(h_i, h_j): a small-h particle near a big-h one must feel
    the larger softening."""
    pos = np.array([[0.0, 0, 0], [0.2, 0, 0]])
    mass = np.array([1.0, 1.0])
    a = np.asarray(compute_forces_direct(
        pos, mass, np.array([0.0, 1.0]), G=1.0, kernel="plummer",
        precision="float64"))
    expected_w = (0.2**2 + 1.0**2 + 1e-15) ** -1.5
    np.testing.assert_allclose(a[0, 0], expected_w * 0.2, rtol=1e-12)


def test_block_size_invariance(rng):
    pos, mass, soft = make_cluster(rng, n=100)
    a_small = np.asarray(compute_forces_direct(
        pos, mass, soft, G=1.0, precision="float64", block_size=16))
    a_big = np.asarray(compute_forces_direct(
        pos, mass, soft, G=1.0, precision="float64", block_size=128))
    # atol floor: summation order differs between block sizes
    np.testing.assert_allclose(a_small, a_big, rtol=1e-12,
                               atol=1e-11 * np.abs(a_big).max())


def test_invalid_inputs():
    with pytest.raises(ValueError):
        compute_forces_direct(np.zeros((4, 2)), 1.0)
    with pytest.raises(ValueError):
        compute_forces_direct(np.zeros((4, 3)), np.ones(3))
    with pytest.raises(ValueError):
        compute_forces_direct(np.zeros((4, 3)), 1.0, kernel="bogus")
    with pytest.raises(ValueError):
        compute_forces_direct(np.zeros((4, 3)), 1.0, precision="float16")


def test_spline_potential_is_antiderivative_of_force():
    """dU/dr == w(r) r for the spline kernel across both branches and
    the q=0.5 seam (r2 review: the reference's own CUDA potential
    kernel is discontinuous there — cuda_kernels.py:422 uses q4 where
    the Gadget form needs q2; we deliberately diverge)."""
    from nbody_streams_tpu.ops.kernels import (force_factor,
                                               potential_factor)

    h = 1.0
    r = np.linspace(0.01, 1.2, 2000)
    u = np.asarray(potential_factor("spline", r**2, h))
    w = np.asarray(force_factor("spline", r**2, h))
    # centred finite difference of U vs w(r) * r
    dU = np.gradient(u, r)
    np.testing.assert_allclose(dU[5:-5], (w * r)[5:-5], rtol=5e-3,
                               atol=5e-3)
    # continuity at the q = 0.5 seam
    lo = float(np.asarray(potential_factor("spline", (0.5 - 1e-9)**2, h)))
    hi = float(np.asarray(potential_factor("spline", (0.5 + 1e-9)**2, h)))
    assert abs(lo - hi) < 1e-6
    # exact Gadget values: U(0) = -2.8/h, U(0.5h) = -1.8666.../h
    assert float(np.asarray(potential_factor(
        "spline", 1e-20, h))) == pytest.approx(-2.8)
    assert lo == pytest.approx(-2.8 + 16/3/4 - 9.6/16 + 6.4/32, rel=1e-6)
