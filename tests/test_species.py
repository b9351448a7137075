"""Species dataclass, builders, validation, split and warning tests."""
import numpy as np
import pytest

from nbody_streams_tpu.species import (
    Species,
    PerformanceWarning,
    _build_particle_arrays,
    _validate_species,
    _split_by_species,
    _emit_performance_warnings,
)


def test_species_basic():
    s = Species.dark(N=100, mass=1e6, softening=0.1)
    assert s.name == "dark"
    assert s.N == 100
    assert np.allclose(s.mass_array(), 1e6)
    assert np.allclose(s.softening_array(), 0.1)


def test_species_array_mass():
    m = np.linspace(1, 2, 10)
    s = Species("bh", 10, m)
    np.testing.assert_allclose(s.mass_array(), m)
    assert np.allclose(s.softening_array(), 0.0)


def test_species_validation_errors():
    with pytest.raises(ValueError):
        Species("", 10, 1.0)
    with pytest.raises(ValueError):
        Species("x", 0, 1.0)
    with pytest.raises(ValueError):
        Species("x", 10, np.ones(5))
    with pytest.raises(ValueError):
        Species("x", 10, 1.0, softening=np.ones(4))


def test_build_particle_arrays():
    dm = Species.dark(3, 2.0, 0.5)
    st = Species.star(2, np.array([1.0, 3.0]), 0.1)
    mass, soft = _build_particle_arrays([dm, st])
    np.testing.assert_allclose(mass, [2, 2, 2, 1, 3])
    np.testing.assert_allclose(soft, [0.5, 0.5, 0.5, 0.1, 0.1])


def test_validate_species():
    xv = np.zeros((5, 6))
    _validate_species(xv, [Species.dark(3, 1.0), Species.star(2, 1.0)])
    with pytest.raises(ValueError, match="not be empty"):
        _validate_species(xv, [])
    with pytest.raises(ValueError, match="Duplicate"):
        _validate_species(xv, [Species.dark(3, 1.0), Species.dark(2, 1.0)])
    with pytest.raises(ValueError, match="does not match"):
        _validate_species(xv, [Species.dark(4, 1.0)])


def test_split_by_species():
    xv = np.arange(30).reshape(5, 6)
    parts = _split_by_species(xv, [Species.dark(3, 1.0), Species.star(2, 1.0)])
    assert list(parts) == ["dark", "star"]
    np.testing.assert_array_equal(parts["dark"], xv[:3])
    np.testing.assert_array_equal(parts["star"], xv[3:])


@pytest.mark.parametrize(
    "n,arch,method",
    [
        (2_000_001, "gpu", "direct"),
        (20_001, "cpu", "direct"),
        (2_000_001, "cpu", "direct"),
        (500_001, "gpu", "direct"),
    ],
)
def test_performance_warnings(n, arch, method):
    with pytest.warns(PerformanceWarning):
        _emit_performance_warnings(n, arch, method)


def test_no_warning_small():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _emit_performance_warnings(1000, "gpu", "direct")


def test_performance_warning_fires_under_auto():
    """The default architecture='auto' must resolve to the actual
    backend before the per-backend thresholds are compared — it used to
    match neither branch and silently skip every warning."""
    # tests run with the cpu backend forced (conftest), so 'auto'
    # resolves to 'cpu' and the 20k cpu-direct threshold applies
    with pytest.warns(PerformanceWarning):
        _emit_performance_warnings(25_000, "auto", "direct")


def test_run_simulation_invalid_architecture_message():
    """The rejection message must list every accepted value — it used
    to omit accepted values."""
    from nbody_streams_tpu.sim import run_simulation

    xv = np.zeros((4, 6))
    with pytest.raises(ValueError, match="'auto'.*'cpu'.*'gpu'"):
        run_simulation(xv, [Species.dark(4, 1.0)], 0.0, 1.0, 0.5,
                       architecture="cuda")
