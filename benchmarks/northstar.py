"""North-star scale gates, measured end-to-end.

Three measurements, each writing one JSON line so results are machine
readable (run on a GPU; one process):

  python benchmarks/northstar.py argsort   # per-call slab-sort cost @ 2M
  python benchmarks/northstar.py gate2m    # 2M KDK, 100 steps, full I/O
  python benchmarks/northstar.py gate1m    # 1M Plummer, 1000-step drift

gate2m runs the *flagship configuration*: N = 2,097,152 single-device
KDK integration through run_simulation with snapshots, restart and
debug_energy enabled, at the BASELINE north-star scale.  gate1m is the
|dE/E| < 1e-4 acceptance gate at 1M.  Results land in PERF.md.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def _hbm_peak():
    import jax

    try:
        stats = jax.devices()[0].memory_stats()
        return int(stats.get("peak_bytes_in_use", 0))
    except Exception:
        return None


def run_argsort(n=2_097_152):
    """Cost of the per-chunk slab argsort (ops/slab.py), amortised
    in-graph."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.normal(0, 1, (n, 3)), jnp.float32)

    @jax.jit
    def sort5(p):
        def body(c, _):
            o = jnp.argsort(p[:, 0] + c)
            return c + p[o[0], 0] * 1e-20, None

        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=5)
        return c

    sort5(pos)  # compile
    t0 = time.perf_counter()
    jax.device_get(sort5(pos))
    per_sort = (time.perf_counter() - t0) / 5
    print(json.dumps({"metric": "argsort_2m_ms", "value": per_sort * 1e3,
                      "unit": "ms"}))
    return per_sort


def run_gate2m(n=2_097_152, steps=100):
    import jax.numpy as jnp

    from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    out_dir = Path("./output_northstar_2m")
    xv, masses = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=1)
    species = [Species.dark(N=n, mass=float(masses[0]), softening=0.05)]
    dt = 2e-5

    # independent fp64 host-side energy bracket (same pattern as gate1m),
    # so the recorded |dE/E| does not rely on the driver's own debug path
    solver = DirectGravity(masses, np.full(n, 0.05), impl="pallas")

    def energy(arr):
        pos = jnp.asarray(arr[:, :3], jnp.float32)
        vel = np.asarray(arr[:, 3:], np.float64)
        phi = np.asarray(solver.potential(pos), np.float64)
        ke = 0.5 * (masses * (vel**2).sum(1)).sum()
        pe = 0.5 * (masses * phi).sum()
        return ke, pe

    ke0, pe0 = energy(xv)
    # warm-up run with the same *chunk lengths* as the timed run: with
    # snapshots=3 + restart_interval=50 over 100 steps every boundary
    # chunk is 50 steps, so a 50-step run (snapshots=2 -> schedule
    # {0, 50}) compiles exactly the executables the timed run reuses
    # from the persistent cache — half the warm-up cost of an identical
    # replay
    run_simulation(
        xv, species, 0.0, (steps // 2) * dt, dt,
        architecture="gpu", method="direct", impl="pallas",
        snapshots=2, restart_interval=50, debug_energy=True,
        verbose=True, overwrite=True, step_timeout_s=120,
        output_dir=str(out_dir) + "_warmup",
    )
    t0 = time.perf_counter()
    res = run_simulation(
        xv, species, 0.0, steps * dt, dt,
        architecture="gpu", method="direct", impl="pallas",
        snapshots=3, restart_interval=50, debug_energy=True,
        verbose=True, overwrite=True, step_timeout_s=120,
        output_dir=str(out_dir),
    )
    wall = time.perf_counter() - t0
    ke1, pe1 = energy(res["dark"])
    e0, e1 = ke0 + pe0, ke1 + pe1
    peak = _hbm_peak()
    print(json.dumps({
        "metric": "gate2m_ms_per_step", "value": 1e3 * wall / steps,
        "unit": "ms/step", "steps": steps, "n": n,
        "gint_per_s": n * n * steps / wall / 1e9,
        "abs_dE_over_E": abs((e1 - e0) / e0),
        "Q0": ke0 / abs(pe0), "Q1": ke1 / abs(pe1),
        "peak_hbm_gb": None if peak is None else peak / 2**30,
        "wall_s": wall,
        "snapshots": sorted(p.name for p in out_dir.glob("snapshot*")),
        "restart": (out_dir / "restart.npz").exists(),
    }))


def run_gate1m(n=1_048_576, steps=1000):
    import jax.numpy as jnp

    from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    out_dir = Path("./output_northstar_1m")
    xv, masses = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    species = [Species.dark(N=n, mass=float(masses[0]), softening=0.05)]
    dt = 2e-5

    solver = DirectGravity(masses, np.full(n, 0.05), impl="pallas")

    def energy(arr):
        pos = jnp.asarray(arr[:, :3], jnp.float32)
        vel = np.asarray(arr[:, 3:], np.float64)
        phi = np.asarray(solver.potential(pos), np.float64)
        ke = 0.5 * (masses * (vel**2).sum(1)).sum()
        pe = 0.5 * (masses * phi).sum()
        return ke, pe

    ke0, pe0 = energy(xv)
    # hang recovery: arm the driver watchdog so a hang saves an
    # emergency restart and fails fast, and resume from any restart.npz
    # a previous (killed/hung) attempt left behind instead of replaying
    # from step 0.  e0 is recomputed from the
    # deterministic ICs, so the drift bracket survives the resume.
    start_step = 0
    resume = (out_dir / "restart.npz").exists()
    if resume:
        start_step = int(np.load(out_dir / "restart.npz")["step"])
        resume = 0 < start_step < steps
    if not resume:
        # 50-step warm-up: with no snapshot events the driver's
        # sub-chunks are all length 50, so this compiles exactly the
        # executables the 1000-step timed run reuses from the
        # persistent cache
        run_simulation(
            xv, species, 0.0, 50 * dt, dt,
            architecture="gpu", method="direct", impl="pallas",
            save_snapshots=False, verbose=True, overwrite=True,
            output_dir=str(out_dir) + "_warmup", step_timeout_s=60,
        )
    t0 = time.perf_counter()
    res = run_simulation(
        xv, species, 0.0, steps * dt, dt,
        architecture="gpu", method="direct", impl="pallas",
        save_snapshots=False, verbose=True, output_dir=str(out_dir),
        step_timeout_s=60, restart_interval=100,
        **({"continue_run": True} if resume else {"overwrite": True}),
    )
    wall = time.perf_counter() - t0
    stepped = steps - start_step if resume else steps
    ke1, pe1 = energy(res["dark"])
    e0, e1 = ke0 + pe0, ke1 + pe1
    peak = _hbm_peak()
    print(json.dumps({
        "metric": "gate1m_abs_dE_over_E", "value": abs((e1 - e0) / e0),
        "unit": "dimensionless", "steps": steps, "n": n,
        "ms_per_step": 1e3 * wall / stepped,
        "gint_per_s": n * n * stepped / wall / 1e9,
        "Q0": ke0 / abs(pe0), "Q1": ke1 / abs(pe1),
        "peak_hbm_gb": None if peak is None else peak / 2**30,
        "wall_s": wall, "resumed_from_step": start_step if resume else 0,
    }))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "argsort"
    {"argsort": run_argsort, "gate2m": run_gate2m,
     "gate1m": run_gate1m}[mode]()
