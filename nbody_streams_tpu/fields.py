"""Import-path alias for reference call sites.

The reference keeps its force/potential field entry points in
``nbody_streams.fields`` (reference: fields.py); here they live in
:mod:`nbody_streams_tpu.ops`.  One path serves both the reference's
"gpu" and "cpu" names — the jitted kernels run wherever JAX runs.
"""
from .constants import G_DEFAULT  # noqa: F401
from .ops import compute_forces_direct, compute_potential_direct  # noqa: F401
from .utils.devices import get_device_info as get_gpu_info  # noqa: F401

compute_nbody_forces_gpu = compute_forces_direct
compute_nbody_forces_cpu = compute_forces_direct
compute_nbody_potential_gpu = compute_potential_direct
compute_nbody_potential_cpu = compute_potential_direct

__all__ = [
    "compute_nbody_forces_gpu",
    "compute_nbody_forces_cpu",
    "compute_nbody_potential_gpu",
    "compute_nbody_potential_cpu",
    "get_gpu_info",
    "G_DEFAULT",
]
