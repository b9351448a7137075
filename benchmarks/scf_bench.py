"""SCF gravity tier: performance + accuracy evidence.

Three modes, each printing machine-readable JSON lines (run on a GPU,
one process):

  python benchmarks/scf_bench.py speed    # ms/force-eval + ms/KDK-step
                                          # at N = 1M and 8M, (8, 4)
  python benchmarks/scf_bench.py ladder   # force error vs direct
                                          # summation over (nmax, lmax)
  python benchmarks/scf_bench.py drift    # 1M x 1000-step |dE/E|
                                          # through the full driver

Context: the reference's answer at this scale is its Barnes-Hut GPU
tree (~1-2 s/call at 2M, 1-5% force error — reference README.md:848-855);
the SCF tier is the dense-array replacement.  Results land in PERF.md
and docs/forces.md.
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


def run_speed(ns=(1_048_576, 8_388_608), nmax=8, lmax=4, iters=10):
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.integrate import (
        init_state, make_accel_fn, make_kdk_step, run_chunk)
    from nbody_streams_tpu.ops.scf import SCFGravity

    for n in ns:
        xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=7)
        solver = SCFGravity(m, nmax=nmax, lmax=lmax, a=1.0)

        # force-eval rate, amortised in-graph
        @jax.jit
        def force_iters(p):
            def body(c, _):
                a = solver.accel(p + c)
                return c + a[0, 0] * 1e-30, None

            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=iters)
            return c

        pos = jnp.asarray(xv[:, :3], jnp.float32)
        try:
            jax.device_get(force_iters(pos))  # compile
            t0 = time.perf_counter()
            jax.device_get(force_iters(pos))
            dt_force = (time.perf_counter() - t0) / iters

            # full KDK stepping via the integrator (solver + Kahan state)
            accel_fn = make_accel_fn(solver, solver.mass)
            step_fn = make_kdk_step(accel_fn, dt=2e-5, t0=0.0)
            state = init_state(xv[:, :3], xv[:, 3:], accel_fn,
                               solver.mass, 0.0)
            state = run_chunk(step_fn, state, 20)   # compile + warm
            jax.device_get(state.pos)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                state = run_chunk(step_fn, state, 20)
                jax.device_get(state.pos)
                best = min(best, (time.perf_counter() - t0) / 20)
        except Exception as exc:   # OOM at a given N is data too
            print(json.dumps({"metric": "scf_speed", "n": n,
                              "nmax": nmax, "lmax": lmax,
                              "error": str(exc)[:200]}), flush=True)
            continue
        peak = _hbm_peak()
        print(json.dumps({
            "metric": "scf_speed", "n": n, "nmax": nmax, "lmax": lmax,
            "terms": solver.terms,
            "ms_per_force_eval": round(dt_force * 1e3, 2),
            "ms_per_kdk_step": round(best * 1e3, 2),
            "mpart_steps_per_s": round(n / best / 1e6, 1),
            "peak_hbm_gb": None if peak is None else round(peak / 2**30, 2),
        }), flush=True)


def run_ladder(n=65536):
    """Median/p99 relative force error of the truncated expansion vs
    exact direct summation (newtonian, fp32 Pallas path), on the
    anisotropy-bearing case: a Plummer sphere displaced off-centre so
    l > 0 terms matter."""
    import jax.numpy as jnp

    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.ops.dispatch import DirectGravity
    from nbody_streams_tpu.ops.scf import SCFGravity

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=8)
    xv[:, 0] += 0.5  # off-centre expansion: excites l > 0
    pos = jnp.asarray(xv[:, :3], jnp.float32)
    exact = DirectGravity(m, np.full(n, 1e-4), kernel="plummer",
                          impl="pallas")
    a_ref = np.asarray(exact.accel(pos), np.float64)
    ref_mag = np.linalg.norm(a_ref, axis=1)

    for nmax, lmax in [(2, 0), (4, 2), (8, 4), (12, 6), (16, 8)]:
        scf = SCFGravity(m, nmax=nmax, lmax=lmax, a=1.0)
        a = np.asarray(scf.accel(pos), np.float64)
        rel = np.linalg.norm(a - a_ref, axis=1) / ref_mag
        print(json.dumps({
            "metric": "scf_force_error_vs_direct", "n": n,
            "nmax": nmax, "lmax": lmax, "terms": scf.terms,
            "median_rel_err": float(np.median(rel)),
            "p99_rel_err": float(np.quantile(rel, 0.99)),
        }), flush=True)


def run_drift(n=1_048_576, steps=1000, nmax=8, lmax=4):
    """1M x 1000-step energy drift of the truncated field through the
    full driver (the gate1m analogue for the SCF tier).  The SCF force
    is exactly curl-free but NOT the exact self-force, so KDK is
    symplectic in the *truncated* Hamiltonian — drift should be bounded
    and small, which is what this records."""
    import jax.numpy as jnp

    from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation
    from nbody_streams_tpu.ops.scf import SCFGravity

    out_dir = Path("./output_scf_1m")
    xv, masses = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    species = [Species.dark(N=n, mass=float(masses[0]), softening=0.05)]
    dt = 2e-5

    # energy bracket in the SAME truncated field (fp64 host reduction):
    # the conserved quantity of the integrated system
    scf = SCFGravity(masses, nmax=nmax, lmax=lmax, a=1.0)

    def energy(arr):
        pos = jnp.asarray(arr[:, :3], jnp.float32)
        vel = np.asarray(arr[:, 3:], np.float64)
        phi = np.asarray(scf.potential(pos), np.float64)
        ke = 0.5 * (masses * (vel**2).sum(1)).sum()
        pe = 0.5 * (masses * phi).sum()
        return ke, pe

    ke0, pe0 = energy(xv)
    t0 = time.perf_counter()
    res = run_simulation(
        xv, species, 0.0, steps * dt, dt,
        architecture="gpu", method="scf", scf_nmax=nmax, scf_lmax=lmax,
        scf_a=1.0, save_snapshots=False, verbose=True, overwrite=True,
        output_dir=str(out_dir),
    )
    wall = time.perf_counter() - t0
    ke1, pe1 = energy(res["dark"])
    e0, e1 = ke0 + pe0, ke1 + pe1
    peak = _hbm_peak()
    print(json.dumps({
        "metric": "scf_gate1m_abs_dE_over_E",
        "value": abs((e1 - e0) / e0), "steps": steps, "n": n,
        "nmax": nmax, "lmax": lmax,
        "ms_per_step": round(1e3 * wall / steps, 2),
        "Q0": ke0 / abs(pe0), "Q1": ke1 / abs(pe1),
        "peak_hbm_gb": None if peak is None else round(peak / 2**30, 2),
        "wall_s": round(wall, 1),
    }))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "speed"
    {"speed": run_speed, "ladder": run_ladder,
     "drift": run_drift}[mode]()
