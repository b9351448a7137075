"""nbody_streams_tpu — JAX direct N-body framework.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of the
reference CUDA framework (appy2806/Nbody_streams): multi-species
collisionless N-body simulation, stellar-stream generation, external BFE
potentials, dynamical friction, analysis utilities and SPH visualization —
jitted lax.scan integration, a Pallas (Triton) pairwise kernel on the GPU
and mesh-sharded direct summation over several devices.
"""
import os as _os


def _compile_cache_dir(environ=_os.environ) -> str:
    """The persistent XLA compilation cache directory: the one
    ``JAX_COMPILATION_CACHE_DIR`` names, else ``<checkout>/.jax_cache``
    (a fixed path, so a later process finds what an earlier one
    compiled)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# JAX reads JAX_COMPILATION_CACHE_DIR itself; only the fallback is set
# here, and never over a directory the caller configured.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    if not _jax.config.jax_compilation_cache_dir:
        _jax.config.update("jax_compilation_cache_dir", _compile_cache_dir())

from .__version__ import __version__
from .constants import G_DEFAULT, NBODY_UNITS, KERNEL_IDS
from .species import Species, PerformanceWarning
from .ops import (
    compute_forces_direct,
    compute_potential_direct,
)
from .ic import make_plummer_sphere, place_on_orbit
from .df import sample_quasispherical, sample_disk, eddington_df
from .run import run_nbody, run_nbody_gpu, run_nbody_tpu, run_nbody_cpu
from .sim import run_simulation
from .nbody_io import ParticleReader
from . import potentials
from . import fast_sims
from . import utils
from . import coords
from . import viz
from .friction import make_df_force_extra, ChandrasekharFriction
from .utils.devices import get_device_info, device_alive
from . import agama_helper   # reference module-path alias -> potentials
from . import tree_gpu       # reference module-path alias -> tree

# Drop-in aliases for reference call sites (reference: __init__.py:63-96)
get_gpu_info = get_device_info
cuda_alive = device_alive
from .tree import TreeGPU, tree_gravity_gpu, run_nbody_gpu_tree
compute_nbody_forces_gpu = compute_forces_direct
compute_nbody_forces_cpu = compute_forces_direct
compute_nbody_potential_gpu = compute_potential_direct
compute_nbody_potential_cpu = compute_potential_direct

__all__ = [
    "__version__",
    "G_DEFAULT",
    "NBODY_UNITS",
    "KERNEL_IDS",
    "Species",
    "PerformanceWarning",
    "run_simulation",
    "run_nbody",
    "run_nbody_tpu",
    "run_nbody_cpu",
    "run_nbody_gpu",
    "ParticleReader",
    "make_plummer_sphere",
    "place_on_orbit",
    "sample_quasispherical",
    "sample_disk",
    "eddington_df",
    "compute_forces_direct",
    "compute_potential_direct",
    "compute_nbody_forces_gpu",
    "compute_nbody_forces_cpu",
    "compute_nbody_potential_gpu",
    "compute_nbody_potential_cpu",
    "potentials",
    "fast_sims",
    "utils",
    "coords",
    "viz",
    "agama_helper",
    "tree_gpu",
    "make_df_force_extra",
    "ChandrasekharFriction",
    "get_device_info",
    "device_alive",
    "get_gpu_info",
    "cuda_alive",
    "TreeGPU",
    "tree_gravity_gpu",
    "run_nbody_gpu_tree",
]
