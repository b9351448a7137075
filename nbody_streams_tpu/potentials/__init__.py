"""External potentials: analytic, BFE (Multipole/CylSpline), modifiers.

Native equivalent of the reference's ``agama_helper`` package: all
evaluators are jittable JAX callables usable directly inside the scanned
KDK step (``potential``/``force``/``density``/``forceDeriv`` with Agama
conventions).
"""
from .base import Potential, CompositePotential
from .analytic import (
    NFWPotential,
    PlummerPotential,
    HernquistPotential,
    DehnenPotential,
    IsochronePotential,
    MiyamotoNagaiPotential,
    LogHaloPotential,
    DiskAnsatzPotential,
    UniformAcceleration,
    AnalyticPotential,
)
from .multipole import MultipolePotential
from .cylspline import CylSplinePotential
from .modifiers import ShiftedPotential, ScaledPotential, EvolvingPotential
from .coefs import (
    MultipoleCoefs,
    CylSplineCoefs,
    read_mult_coefs,
    read_cylspl_coefs,
    read_coefs,
    generate_lmax_pairs,
)
from .io import (
    write_coef_to_h5,
    write_snapshot_coefs_to_h5,
    read_coef_string,
)
from .load import (
    load_potential,
    load_evolving_potential,
    load_agama_potential,
    load_agama_evolving_potential,
)
from .fit import (
    fit_potential,
    fit_multipole_from_particles,
    fit_cylspline_from_particles,
    create_snapshot_dict,
)
from .factory import make_potential, load_potential_ini
from .fire import (
    read_snapshot_times,
    create_evolving_ini,
    create_fire_evolving_ini,
    load_fire_pot,
)

# Drop-in aliases for reference call sites.  The reference exposes its
# evaluators under *GPU names (agama_helper/_potential.py,
# _analytic_potentials.py); the native classes accept the same
# constructor forms, so bare aliases make reference code run unchanged.
PotentialTPU = make_potential
PotentialGPU = make_potential
NFWPotentialGPU = NFWPotential
PlummerPotentialGPU = PlummerPotential
HernquistPotentialGPU = HernquistPotential
DehnenSphericalPotentialGPU = DehnenPotential
IsochronePotentialGPU = IsochronePotential
MiyamotoNagaiPotentialGPU = MiyamotoNagaiPotential
LogHaloPotentialGPU = LogHaloPotential
DiskAnsatzPotentialGPU = DiskAnsatzPotential
UniformAccelerationGPU = UniformAcceleration
AnalyticPotentialGPU = AnalyticPotential
CompositePotentialGPU = CompositePotential
MultipolePotentialGPU = MultipolePotential
CylSplinePotentialGPU = CylSplinePotential
ShiftedPotentialGPU = ShiftedPotential
ScaledPotentialGPU = ScaledPotential
EvolvingPotentialGPU = EvolvingPotential

__all__ = [
    "Potential",
    "CompositePotential",
    "NFWPotential",
    "PlummerPotential",
    "HernquistPotential",
    "DehnenPotential",
    "IsochronePotential",
    "MiyamotoNagaiPotential",
    "LogHaloPotential",
    "DiskAnsatzPotential",
    "UniformAcceleration",
    "AnalyticPotential",
    "MultipolePotential",
    "CylSplinePotential",
    "ShiftedPotential",
    "ScaledPotential",
    "EvolvingPotential",
    "MultipoleCoefs",
    "CylSplineCoefs",
    "read_mult_coefs",
    "read_cylspl_coefs",
    "read_coefs",
    "generate_lmax_pairs",
    "write_coef_to_h5",
    "write_snapshot_coefs_to_h5",
    "read_coef_string",
    "load_potential",
    "load_evolving_potential",
    "load_agama_potential",
    "load_agama_evolving_potential",
    "create_snapshot_dict",
    "fit_potential",
    "fit_multipole_from_particles",
    "fit_cylspline_from_particles",
    "make_potential",
    "load_potential_ini",
    "read_snapshot_times",
    "create_evolving_ini",
    "create_fire_evolving_ini",
    "load_fire_pot",
    "PotentialTPU",
    "PotentialGPU",
    "NFWPotentialGPU",
    "PlummerPotentialGPU",
    "HernquistPotentialGPU",
    "DehnenSphericalPotentialGPU",
    "IsochronePotentialGPU",
    "MiyamotoNagaiPotentialGPU",
    "LogHaloPotentialGPU",
    "DiskAnsatzPotentialGPU",
    "UniformAccelerationGPU",
    "AnalyticPotentialGPU",
    "CompositePotentialGPU",
    "MultipolePotentialGPU",
    "CylSplinePotentialGPU",
    "ShiftedPotentialGPU",
    "ScaledPotentialGPU",
    "EvolvingPotentialGPU",
]
