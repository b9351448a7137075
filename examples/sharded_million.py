"""Mesh-sharded direct summation at large N.

On a host of several GPUs (four joined by NVLink, say) this runs the
exact O(N^2/D) ring-sharded force path, the Pallas kernel computing
each ring tile; on a CPU-only host set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
to demo the sharding on a virtual mesh (tiny N!).

Run:  python examples/sharded_million.py [N]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os
import time

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # pin the live config too, in case jax was configured earlier
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
devices = jax.devices()
print(f"{len(devices)} device(s): {devices[0].platform}")

xv, masses = make_plummer_sphere(N, M_total=1e10, a=2.0, seed=3)

# slab-sort before sharding: each device then owns a thin x-slab, so
# non-adjacent ring blocks take the compact-support Newtonian fast path
from nbody_streams_tpu.parallel.sharded import slab_sort_for_sharding

xv, masses = slab_sort_for_sharding(xv, masses)
species = [Species.dark(N=N, mass=float(masses[0]), softening=0.1)]

t0 = time.perf_counter()
result = run_simulation(
    xv, species, 0.0, 10 * 1e-4, 1e-4,
    architecture="auto",
    method="tree",            # = sharded direct tier
    devices=devices,
    save_snapshots=False, verbose=True,
    output_dir="./output_sharded",
)
wall = time.perf_counter() - t0
rate = N * N * 10 / wall / 1e9
print(f"10 steps at N={N:,} on {len(devices)} devices: {wall:.1f} s "
      f"({rate:.1f} Gint/s aggregate)")
