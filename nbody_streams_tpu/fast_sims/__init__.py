"""Fast stream-generation methods: particle spray and restricted N-body.

Native equivalent of the reference's fast_sims package — orbit
integration, King/Plummer progenitors, Jacobi-radius machinery and
Chen+2025 / Fardal+2015 spray ICs all run on the native potential stack
(no Agama dependency).
"""
from .orbits import integrate_orbit, integrate_orbits_released
from .king import KingModel, make_king_potential, sample_king
from .spray import (
    create_particle_spray_stream,
    create_ic_particle_spray_chen2025,
    create_ic_particle_spray_fardal2015,
    get_jacobi_radius,
)
from .restricted import run_restricted_nbody
from ._common import (
    make_progenitor_potential,
    sample_progenitor,
    moving_potential,
    make_perturber_potential,
    spherical_potential_from_particles,
)

__all__ = [
    "integrate_orbit",
    "integrate_orbits_released",
    "KingModel",
    "make_king_potential",
    "sample_king",
    "create_particle_spray_stream",
    "create_ic_particle_spray_chen2025",
    "create_ic_particle_spray_fardal2015",
    "get_jacobi_radius",
    "run_restricted_nbody",
    "make_progenitor_potential",
    "sample_progenitor",
    "moving_potential",
    "make_perturber_potential",
    "spherical_potential_from_particles",
]
