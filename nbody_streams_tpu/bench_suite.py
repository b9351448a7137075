"""Comprehensive benchmark suite (`python -m nbody_streams_tpu.bench_suite`).

Native equivalent of the reference's `python -m nbody_streams.fields`
benchmark CLI (reference: fields.py:1201-1796): per-kernel and
per-precision force/potential timings, backend cross-validation, host
transfer overhead, and N-scaling.  Every timing runs inside a single
jitted `lax.scan` (no per-call dispatch in the measurement) and ends in
a device sync.

Usage:
    python -m nbody_streams_tpu.bench_suite [-N 65536] [--reps 6] \
        [--sections 1,2,3,4,5,6]

On a GPU all matrix rows pin ``impl='pallas'`` (the Triton kernel), so
kernel changes are measured at a fixed backend; benchmarks/direct_paths.py
compares the backends end to end.

The sharded-ring correctness-timed row (8 virtual CPU devices,
interpret-mode Pallas) is a separate invocation because it needs the
host-platform mesh before jax initialises:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m nbody_streams_tpu.bench_suite --sharded -N 8192
"""
from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _timeit_scan(fn, carry0, reps):
    @jax.jit
    def run(c):
        def body(c, _):
            out = fn(c)
            return c + 1e-30 * out[: c.shape[0]], None

        c, _ = lax.scan(body, c, None, length=reps)
        return c

    jax.device_get(run(carry0))           # compile + warm
    t0 = time.perf_counter()
    jax.device_get(run(carry0))
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-N", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--sections", type=str, default="1,2,3,4,5,6",
                    help="comma-separated section numbers to run")
    args = ap.parse_args(argv)
    n, reps = args.N, args.reps
    sections = {int(s) for s in args.sections.split(",")}

    from . import make_plummer_sphere
    from .ops.dispatch import DirectGravity

    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    print(f"N = {n}, reps = {reps} (scan-amortised)\n")

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    pos64 = xv[:, :3]
    soft = np.full(n, 0.05)

    # the Pallas kernel on a GPU; the jnp path is the only backend
    # elsewhere
    impl = "pallas" if jax.default_backend() == "gpu" else "jnp"

    if 1 in sections:
        # ---- section 1: force throughput by kernel x precision ------------
        print("SECTION 1: force kernels (Gint/s = N^2 pair interactions/s)")
        results = {}
        for kernel in ("spline", "plummer", "dehnen_k1", "newtonian"):
            for precision in ("float32_kahan", "float32"):
                solver = DirectGravity(m, soft, kernel=kernel,
                                       precision=precision, impl=impl)
                p0 = jnp.asarray(pos64, solver.dtype)
                dt = _timeit_scan(lambda c, s=solver: s.accel(c), p0, reps)
                gint = n * n / dt / 1e9
                results[(kernel, precision)] = gint
                print(f"  {kernel:10s} {precision:14s} {dt*1e3:9.2f} ms "
                      f"{gint:8.1f} Gint/s")

        # float64 rows (jnp oracle path — the Pallas kernel is fp32-only by
        # design, matching the reference's fp64 fallback matrix rows,
        # fields.py:1201-1796).  Two kernels bound the cost; skipped above
        # 256k, where one f64 jnp evaluation takes minutes.
        if n <= 262144:
            with jax.enable_x64():
                for kernel in ("spline", "newtonian"):
                    solver = DirectGravity(m.astype(np.float64), soft,
                                           kernel=kernel, precision="float64",
                                           impl="jnp")
                    p0 = jnp.asarray(pos64, jnp.float64)
                    dt = _timeit_scan(lambda c, s=solver: s.accel(c), p0,
                                      max(1, reps // 3))
                    gint = n * n / dt / 1e9
                    results[(kernel, "float64")] = gint
                    print(f"  {kernel:10s} {'float64':14s} {dt*1e3:9.2f} ms "
                          f"{gint:8.1f} Gint/s")
        else:
            print("  (float64 rows skipped above N=262144: one jnp f64 "
                  "eval takes minutes there)")

    if 2 in sections:
        # ---- section 2: potential kernel ----------------------------------
        print("\nSECTION 2: potential (vs force) kernel")
        solver = DirectGravity(m, soft, kernel="spline",
                               precision="float32_kahan", impl=impl)
        p0 = jnp.asarray(pos64, solver.dtype)
        dtf = _timeit_scan(lambda c: solver.accel(c), p0, reps)
        dtp = _timeit_scan(lambda c: solver.potential(c)[:, None], p0, reps)
        print(f"  force {dtf*1e3:9.2f} ms   potential {dtp*1e3:9.2f} ms "
              f"({dtf/dtp:.2f}x)")

    if 3 in sections:
        # ---- section 3: cross-backend validation --------------------------
        # The fp32 solver runs at FULL N so the production code path is
        # what gets validated: a truncated-N problem would take the
        # unsorted small-N kernel instead of the sorted one.  The float64
        # oracle is rectangular — 4096 targets against all N sources via
        # the shared accel_tile primitive — so its cost stays O(4096*N).
        nv = min(n, 4096)
        print(f"\nSECTION 3: validation vs the float64 jnp oracle "
              f"({nv} targets x all {n:,} sources, full-N fp32 solve)")
        from .constants import G_DEFAULT
        from .ops.pairwise import accel_tile

        with jax.enable_x64():
            cs = 4096
            npad = -(-n // cs) * cs
            pt = jnp.asarray(pos64[:nv], jnp.float64)
            ht = jnp.asarray(soft[:nv], jnp.float64)
            it = jnp.arange(nv, dtype=jnp.int32)
            ps = jnp.asarray(np.pad(pos64, ((0, npad - n), (0, 0))),
                             jnp.float64).reshape(-1, cs, 3)
            msr = jnp.asarray(np.pad(m, (0, npad - n)),
                              jnp.float64).reshape(-1, cs)
            hsr = jnp.asarray(np.pad(soft, (0, npad - n)),
                              jnp.float64).reshape(-1, cs)
            isr = jnp.arange(npad, dtype=jnp.int32).reshape(-1, cs)

            def _src_block(acc, sb):
                pos_s, m_s, h_s, idx_s = sb
                return acc + accel_tile("spline", pt, ht, it,
                                        pos_s, m_s, h_s, idx_s), None

            a_ref, _ = jax.lax.scan(
                _src_block, jnp.zeros((nv, 3), jnp.float64),
                (ps, msr, hsr, isr))
            a_ref = np.asarray(jax.device_get(G_DEFAULT * a_ref), float)
        scale = np.abs(a_ref).max()
        for precision in ("float32_kahan", "float32"):
            s = DirectGravity(m, soft, kernel="spline",
                              precision=precision, impl=impl)
            a = np.asarray(jax.device_get(
                s.accel(jnp.asarray(pos64, s.dtype))), float)
            err = np.abs(a[:nv] - a_ref).max() / scale
            net = np.abs((m[:, None] * a).sum(0)).max() \
                / np.abs(m[:, None] * a).sum()
            print(f"  {precision:14s} max rel err {err:.2e}   "
                  f"net-force/|F|sum {net:.2e}")

    if 4 in sections:
        # ---- section 4: host transfer overhead ----------------------------
        print("\nSECTION 4: host <-> device transfer")
        x = jnp.asarray(pos64, jnp.float32)
        jax.device_get(x)
        t0 = time.perf_counter()
        for _ in range(10):
            jax.device_get(x)
        d2h = (time.perf_counter() - t0) / 10
        print(f"  D->H (N,3) float32: {d2h*1e3:.2f} ms "
              f"({pos64.nbytes / 2 / d2h / 1e9:.2f} GB/s)")

    if 5 in sections:
        # ---- section 5: N-scaling -----------------------------------------
        print("\nSECTION 5: N-scaling (spline + Kahan)")
        for nn in (16384, 65536, 262144, 1048576):
            if nn > n * 4:
                break
            xvn, mn = make_plummer_sphere(nn, M_total=1e9, a=1.0, seed=2)
            s = DirectGravity(mn, np.full(nn, 0.05), kernel="spline",
                              precision="float32_kahan", impl=impl)
            p = jnp.asarray(xvn[:, :3], s.dtype)
            rr = max(2, reps // 2) if nn <= 262144 else 2
            dt = _timeit_scan(lambda c, s=s: s.accel(c), p, rr)
            print(f"  N={nn:8d}: {dt*1e3:9.2f} ms  {nn*nn/dt/1e9:8.1f} "
                  f"Gint/s")

    if 6 in sections:
        # ---- section 6: KDK stepping drift by precision tier --------------
        # The accuracy side of the compensation trade: |dE/E| accumulated
        # over a real KDK window, per tier, at this N (reference ships the
        # matching per-precision matrix, fields.py:1201-1796).
        steps = 300 if n <= 262144 else 60
        print(f"\nSECTION 6: KDK stepping (spline): Gint/s + |dE/E| over "
              f"{steps} steps")
        from .integrate import (init_state, make_accel_fn, make_kdk_step,
                                run_chunk, system_energy)
        for precision in ("float32_kahan", "float32"):
            s = DirectGravity(m, soft, kernel="spline", precision=precision,
                              impl=impl)
            accel_fn = make_accel_fn(s, s.mass)
            step_fn = make_kdk_step(accel_fn, dt=2e-5, t0=0.0)
            presort = s.spatial_sort_active
            pint = s.presort_interval
            state = init_state(xv[:, :3], xv[:, 3:], accel_fn, s.mass, 0.0,
                               sort_fn=s.sort_key if presort else None)
            e_fn = jax.jit(lambda st, s=s: system_energy(st, s, s.mass))
            ke, pe = jax.device_get(e_fn(state))
            e0 = float(ke) + float(pe)
            # the first chunk compiles the scan; the second is timed
            state = run_chunk(step_fn, state, steps, presort=presort,
                              presort_every=pint)
            jax.block_until_ready(state)
            t0 = time.perf_counter()
            state = run_chunk(step_fn, state, steps, presort=presort,
                              presort_every=pint)
            jax.block_until_ready(state)
            dt_step = (time.perf_counter() - t0) / steps
            ke, pe = jax.device_get(e_fn(state))
            e1 = float(ke) + float(pe)
            print(f"  {precision:14s} {dt_step*1e3:9.2f} ms/step "
                  f"{n*n/dt_step/1e9:8.1f} Gint/s   |dE/E| = "
                  f"{abs((e1 - e0) / e0):.2e} over {2 * steps} steps")

    print("\ndone.")


def main_sharded(argv=None):
    """Correctness-timed sharded-ring row: the 8-virtual-device CPU
    mesh stepping the interpret-mode Pallas ring.  Timing here measures
    the *orchestration* (ring ppermute + interpret overhead), not kernel
    speed — its value is recording that the multi-device path runs and
    agrees with the single-device oracle."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("-N", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    n = args.N

    # the virtual mesh is a CPU mesh: pin the platform before any
    # backend initialises
    jax.config.update("jax_platforms", "cpu")

    from . import make_plummer_sphere
    from .ops.dispatch import DirectGravity

    ndev = len(jax.devices())
    print(f"backend: {jax.default_backend()}  devices: {ndev}")
    if jax.default_backend() != "cpu" or ndev < 2:
        print("sharded row needs the virtual CPU mesh; run with\n"
              "  XLA_FLAGS=--xla_force_host_platform_device_count=8 "
              "JAX_PLATFORMS=cpu")
        return

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    soft = np.full(n, 0.05)
    sharded = DirectGravity(m, soft, kernel="spline", impl="sharded",
                            precision="float32_kahan")
    single = DirectGravity(m, soft, kernel="spline", impl="jnp",
                           precision="float32_kahan")
    p = jnp.asarray(xv[:, :3], jnp.float32)
    a_s = np.asarray(sharded.accel(p), float)
    a_1 = np.asarray(single.accel(p), float)
    rel = np.abs(a_s - a_1).max() / np.abs(a_1).max()
    dt = _timeit_scan(lambda c: sharded.accel(c), p, args.reps)
    print(f"  sharded ring {ndev}-dev (interpret): N={n}  "
          f"{dt*1e3:9.2f} ms/eval   max rel vs single-device "
          f"{rel:.2e}")


if __name__ == "__main__":
    if "--sharded" in sys.argv:
        main_sharded()
    else:
        main()
