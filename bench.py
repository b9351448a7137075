"""Headline benchmark: direct-force KDK stepping throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Measures the fully-jitted KDK step rate (spline softening, float32 with
Kahan compensation, ``impl='auto'``) at N = 65,536 and reports pairwise
interactions per second.  ``vs_baseline`` divides by the reference's
direct-force CUDA path, ~124 Gint/s on an RTX 3080 Laptop GPU
(reference: fields.py:743-746; BASELINE.md).

Runs in one process and refuses any platform but ``gpu`` (exit 1, no
JSON line).  stderr carries the device (platform, device_kind, count),
the card's name and power limit from ``nvidia-smi``, and |dE/E| over
the measured steps.
"""
import json
import subprocess
import sys
import time

import jax
import numpy as np

N = 65536
DT = 2e-5
STEPS = 150
WINDOWS = 5
BASELINE_GINT = 124.0  # reference direct f32 path, RTX 3080 Laptop GPU


def require_gpu():
    """The first JAX device, or exit 1 when it is not a GPU: a timing
    taken anywhere else says nothing about the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: JAX's first device is {dev.platform!r}, not a "
              "GPU — refusing to measure", file=sys.stderr)
        sys.exit(1)
    return dev


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the card(s)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main():
    dev = require_gpu()
    print(f"# platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(jax.devices())}", file=sys.stderr)
    print(f"# card: {card_name_and_power()}", file=sys.stderr)

    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.integrate import (
        init_state,
        make_accel_fn,
        make_kdk_step,
        run_chunk,
        system_energy,
    )
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    xv, m = make_plummer_sphere(N, M_total=1e9, a=1.0, seed=2)
    solver = DirectGravity(m, np.full(N, 0.05), kernel="spline",
                           precision="float32_kahan", impl="auto")
    accel_fn = make_accel_fn(solver, solver.mass)
    step_fn = make_kdk_step(accel_fn, dt=DT, t0=0.0)
    # slab-order reuse exactly as the run_simulation driver does it
    presort = solver.spatial_sort_active
    cadence = solver.presort_interval
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                       sort_fn=solver.sort_key if presort else None)
    energy = jax.jit(lambda s: system_energy(s, solver, solver.mass))
    ke0, pe0 = energy(state)
    e0 = float(ke0) + float(pe0)

    state = run_chunk(step_fn, state, STEPS, presort=presort,
                      presort_every=cadence)       # compile + warm up
    jax.block_until_ready(state)
    dt_step = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        state = run_chunk(step_fn, state, STEPS, presort=presort,
                          presort_every=cadence)
        jax.block_until_ready(state)
        dt_step = min(dt_step, (time.perf_counter() - t0) / STEPS)
    ke1, pe1 = energy(state)
    de = abs((float(ke1) + float(pe1) - e0) / e0)
    gint = N * N / dt_step / 1e9
    print(f"# N={N} {dt_step * 1e3:.3f} ms/step |dE/E|={de:.2e} "
          f"(best of {WINDOWS}x{STEPS} steps) impl={solver.impl}; "
          f"vs_baseline = Gint/s / {BASELINE_GINT} (reference, RTX 3080 "
          "Laptop GPU)", file=sys.stderr)
    print(json.dumps({
        "metric": f"direct-force KDK pairwise throughput (N={N}, spline "
                  "softening, float32+Kahan)",
        "value": round(gint, 2),
        "unit": "Gint/s",
        "vs_baseline": round(gint / BASELINE_GINT, 3),
    }))


if __name__ == "__main__":
    main()
