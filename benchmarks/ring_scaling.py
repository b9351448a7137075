"""Ring-sharding overhead measurement on the virtual CPU mesh.

The ring's *orchestration overhead* is measurable without several
devices: the 8 virtual
CPU devices (``--xla_force_host_platform_device_count``) share the same
physical core(s), so total pairwise work is executed by the same silicon
regardless of D — if the ring added nothing, wall time would be flat in
D.  The measured ratio t(D)/t(1) therefore isolates exactly the cost
the mesh adds per evaluation: D partial-tile dispatches, D-1
collective-permutes of the source block, shard_map bookkeeping, and the
Kahan cross-step accumulation.  (Sizes are kept small; the
per-evaluation ratios are what transfer, not the absolute times.)

Usage:  JAX does NOT need env flags — the script forces the CPU
platform and an 8-device host itself (run from the repo root):

    python benchmarks/ring_scaling.py [--profile DIR]

Prints a strong-scaling table (fixed N, growing D) and a weak-scaling
table (fixed N/D); with ``--profile`` also captures a jax.profiler
trace of the D=8 evaluation (look for the async collective-permute ops
interleaved with the tile computations).
"""
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from nbody_streams_tpu import make_plummer_sphere  # noqa: E402
from nbody_streams_tpu.ops.dispatch import DirectGravity  # noqa: E402
from nbody_streams_tpu.parallel.sharded import (  # noqa: E402
    make_particle_mesh,
    slab_sort_for_sharding,
)

REPS = 5


def eval_time(n, d, profile_dir=None):
    devs = jax.devices()[:d]
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    soft = np.full(n, 0.05)
    xv, m, soft = slab_sort_for_sharding(xv, m, soft)
    # D=1 runs the SAME shard_map ring body on a 1-device mesh (one
    # ring step, no collective) so t(D)/t(1) isolates pure ring cost:
    # D partial-tile dispatches, D-1 collective-permutes, bookkeeping.
    mesh = make_particle_mesh(devs)
    solver = DirectGravity(m, soft, kernel="spline",
                           precision="float32_kahan", impl="sharded",
                           devices=devs, sharded_opts={"mesh": mesh})
    pos = solver.shard_state(
        jax.numpy.asarray(xv[:, :3], jax.numpy.float32))
    fn = jax.jit(solver.accel)
    jax.block_until_ready(fn(pos))          # compile
    best = float("inf")
    ctx = None
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(pos))
        best = min(best, time.perf_counter() - t0)
    if profile_dir:
        jax.profiler.stop_trace()
    del ctx
    return best


def main():
    profile_dir = None
    if "--profile" in sys.argv:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]

    print("== strong scaling: fixed N, growing D (shared physical core:"
          " flat = zero ring overhead) ==", flush=True)
    for n in (8192, 16384):
        t1 = None
        row = []
        for d in (1, 2, 4, 8):
            t = eval_time(n, d)
            t1 = t1 or t
            row.append(f"D={d}: {t * 1e3:8.1f} ms ({t / t1:5.2f}x)")
            print(f"  N={n:>6}  " + row[-1], flush=True)
        print(f"N={n:>6}  " + "  ".join(row), flush=True)

    print("== weak scaling: fixed N/D = 2048 (pair work grows as D^2 on "
          "the same core) ==", flush=True)
    base = None
    for d in (1, 2, 4, 8):
        n = 2048 * d
        t = eval_time(n, d)
        base = base or t
        pairs = n * n
        print(f"D={d}: N={n:>6}  {t * 1e3:8.1f} ms  "
              f"{pairs / t / 1e9:6.2f} Gint/s (host total)", flush=True)

    if profile_dir:
        t = eval_time(16384, 8, profile_dir=profile_dir)
        print(f"profiled D=8 N=16384 eval: {t * 1e3:.1f} ms -> "
              f"{profile_dir}")


if __name__ == "__main__":
    main()
