"""Smoke run of the main path on the GPU: the quickest proof that the
system still starts, computes correct forces and integrates on the card.

    python chip_smoke.py               # one GPU, phases 1-5
    python chip_smoke.py --four-cards  # the ring-sharded direct sum on 4 GPUs

Phases (one process; any failure exits non-zero with no result line):

1. environment: the card's name and power limit, JAX, its devices, the
   compile-cache directory; refuses any platform but ``gpu``;
2. every direct path (Pallas kernel, XLA two-pass, jnp) against the
   float64 oracle: acceleration and potential at N = 65,536 in full,
   the five softening kernels, one force evaluation at N = 1,048,576
   checked on 4,096 sampled targets; each error beside its bound;
3. ``run_simulation(architecture='gpu', method='direct')``: 1000-step
   Plummer run at N = 65,536, |dE/E| < 1e-4;
4. the multi-species run (dark 100,000 + stars 20,000 + one black hole,
   per-particle mass and softening), 200 steps, Newton's third law and
   |dE/E| < 1e-4;
5. the card-only pytest tier (``-m gpu``), in this process.

The last line of stdout is the device record:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
G = 4.300917270038e-06          # constants.G_DEFAULT, kpc (km/s)^2 / Msun

# Sizes of each phase; tolerances are max|err| / max|ref| against the
# float64 oracle.  float32_kahan holds the CPU tests' bound; plain
# float32 sums without compensation and gets a wider one.
SIZES = dict(n_full=65_536, n_big=1_048_576, n_sample=4_096,
             n_run=65_536, run_steps=1000, n_dark=100_000, n_star=20_000,
             multi_steps=200, n_ring=2_097_155, ring_steps=10)
TOL = {"float32_kahan": 3e-6, "float32": 3e-5}
DE_MAX = 1e-4
NEWTON3_MAX = 1e-5


def card():
    """``nvidia-smi``'s name and power limit of the card(s)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def require_gpu(jax):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's first device is "
                         f"{dev.platform!r}, not a GPU")
    return dev


def timed(fn, *args):
    """(seconds of one warm call, result)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def check(name, err, bound):
    ok = bool(np.isfinite(err)) and err < bound
    print(f"  {name}: err {err:.3e} (bound {bound:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} above {bound:.0e}")


def oracle(mode, kind, pos, mass, soft, targets=None):
    """float64 jnp oracle: every target (or the ``targets`` rows) against
    all sources, blocked over sources.  The inputs are the float32 values
    the paths under test receive, so the comparison measures their
    arithmetic and not the rounding of their inputs (which alone costs
    ~1e-4 relative for the closest unsoftened pairs)."""
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu.ops import pairwise

    pos, mass, soft = (np.asarray(a, np.float32).astype(np.float64)
                       for a in (pos, mass, soft))
    n = pos.shape[0]
    idx = np.arange(n) if targets is None else targets
    cs = 4096
    npad = -(-n // cs) * cs
    src = (jnp.asarray(np.pad(pos, ((0, npad - n), (0, 0)))).reshape(
               -1, cs, 3),
           jnp.asarray(np.pad(mass, (0, npad - n))).reshape(-1, cs),
           jnp.asarray(np.pad(soft, (0, npad - n))).reshape(-1, cs),
           jnp.arange(npad, dtype=jnp.int32).reshape(-1, cs))
    tile = pairwise.accel_tile if mode == "acc" else pairwise.potential_tile

    @jax.jit
    def one_block(pt, ht, it):
        def body(acc, sb):
            return acc + tile(kind, pt, ht, it, *sb), None

        zero = jnp.zeros(pt.shape if mode == "acc" else pt.shape[:1])
        out, _ = jax.lax.scan(body, zero, src)
        return G * out

    outs = []
    for lo in range(0, len(idx), cs):
        sel = idx[lo:lo + cs]
        outs.append(np.asarray(one_block(
            jnp.asarray(pos[sel]), jnp.asarray(soft[sel]),
            jnp.asarray(sel, jnp.int32))))
    return np.concatenate(outs)


def rel_err(out, ref):
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu import make_plummer_sphere
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    impls = ("pallas", "xla", "jnp")
    n = SIZES["n_full"]
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    pos, soft = xv[:, :3], np.full(n, 0.05)
    p32 = jnp.asarray(pos, jnp.float32)
    for kind in ("spline", "plummer", "dehnen_k1", "dehnen_k2",
                 "newtonian"):
        ref = {md: oracle(md, kind, pos, m, soft) for md in ("acc", "pot")}
        for impl in impls if kind == "spline" else ("pallas",):
            precs = (("float32_kahan", "float32") if kind == "spline"
                     else ("float32_kahan",))
            for prec in precs:
                s = DirectGravity(m, soft, G=G, kernel=kind, impl=impl,
                                  precision=prec)
                for md in ("acc", "pot"):
                    fn = jax.jit(s.accel if md == "acc" else s.potential)
                    t, out = timed(fn, p32)
                    check(f"N={n} {impl} {kind} {prec} {md} "
                          f"[{t * 1e3:.2f} ms]",
                          rel_err(out, ref[md]), TOL[prec])

    n = SIZES["n_big"]
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=3)
    pos, soft = xv[:, :3], np.full(n, 0.05)
    sample = np.random.default_rng(0).choice(n, SIZES["n_sample"],
                                             replace=False)
    ref = oracle("acc", "spline", pos, m, soft, targets=sample)
    p32 = jnp.asarray(pos, jnp.float32)
    for impl in impls:
        s = DirectGravity(m, soft, G=G, impl=impl)
        t, out = timed(jax.jit(s.accel), p32)
        check(f"N={n} {impl} spline float32_kahan acc, "
              f"{len(sample)} sampled targets [{t * 1e3:.1f} ms]",
              rel_err(np.asarray(out)[sample], ref), TOL["float32_kahan"])


def energy(xv, mass, soft):
    """float64 total energy (self-gravity), from the jnp oracle."""
    from nbody_streams_tpu import compute_potential_direct

    phi = np.asarray(compute_potential_direct(xv[:, :3], mass, soft, G=G,
                                              precision="float64"))
    ke = 0.5 * np.sum(mass * np.sum(xv[:, 3:] ** 2, axis=1))
    return ke + 0.5 * np.sum(mass * phi)


def run(xv, species, steps):
    """run_simulation on the card in two chunks; returns the final phase
    space, the steady (second-chunk) ms/step and run_nbody's log."""
    from nbody_streams_tpu import run_simulation

    buf = io.StringIO()
    dt = 2e-5
    with tempfile.TemporaryDirectory() as out, \
            contextlib.redirect_stdout(buf):
        res = run_simulation(xv, species, 0.0, steps * dt, dt,
                             architecture="gpu", method="direct",
                             output_dir=out, save_snapshots=False,
                             restart_interval=steps // 2,
                             debug_energy=True)
    log = buf.getvalue()
    print("\n".join("    " + ln for ln in log.splitlines()), flush=True)
    final = np.concatenate([res[s.name] for s in species])
    return final, float(re.findall(r"chunk ([0-9.]+) ms/step", log)[-1])


def step_memory(xv, m, soft):
    """``compiled.memory_analysis()`` of one KDK step of the main path."""
    import jax

    from nbody_streams_tpu.integrate import (init_state, make_accel_fn,
                                             make_kdk_step)
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    solver = DirectGravity(m, soft, G=G)
    accel_fn = make_accel_fn(solver, solver.mass)
    step_fn = make_kdk_step(accel_fn, 2e-5, 0.0)
    state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                       sort_fn=(solver.sort_key if solver.spatial_sort_active
                                else None))
    compiled = jax.jit(lambda s: step_fn(s, None)[0]).lower(state).compile()
    return solver.impl, compiled.memory_analysis()


def phase_run_single():
    from nbody_streams_tpu import Species, make_plummer_sphere

    n = SIZES["n_run"]
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
    sp = [Species.dark(N=n, mass=float(m[0]), softening=0.05)]
    impl, mem = step_memory(xv, m, np.full(n, 0.05))
    print(f"  KDK step memory analysis (N={n}, impl={impl}): {mem}",
          flush=True)
    final, ms = run(xv, sp, SIZES["run_steps"])
    assert np.isfinite(final).all(), "non-finite final state"
    soft = np.full(n, 0.05)
    de = abs(energy(final, m, soft) / energy(xv, m, soft) - 1.0)
    print(f"  N={n} {SIZES['run_steps']} steps, impl={impl}: "
          f"{ms:.3f} ms/step, |dE/E| = {de:.3e} (bound {DE_MAX:.0e})",
          flush=True)
    assert de < DE_MAX, f"|dE/E| = {de:.3e}"


def phase_run_multi():
    import jax.numpy as jnp

    from nbody_streams_tpu import Species, make_plummer_sphere
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    nd, ns = SIZES["n_dark"], SIZES["n_star"]
    rng = np.random.default_rng(4)
    xv_d, m_d = make_plummer_sphere(nd, M_total=8e8, a=1.2, seed=1)
    xv_s, m_s = make_plummer_sphere(ns, M_total=2e8, a=0.6, seed=2)
    xv = np.concatenate([xv_d, xv_s, np.zeros((1, 6))])
    m_d = m_d * rng.uniform(0.5, 1.5, nd)
    m_s = m_s * rng.uniform(0.5, 1.5, ns)
    h_d = rng.uniform(0.06, 0.1, nd)
    h_s = rng.uniform(0.03, 0.05, ns)
    sp = [Species.dark(N=nd, mass=m_d, softening=h_d),
          Species.star(N=ns, mass=m_s, softening=h_s),
          Species(name="bh", N=1, mass=1e7, softening=0.01)]
    mass = np.concatenate([m_d, m_s, [1e7]])
    soft = np.concatenate([h_d, h_s, [0.01]])
    final, ms = run(xv, sp, SIZES["multi_steps"])
    assert np.isfinite(final).all(), "non-finite final state"
    solver = DirectGravity(mass, soft, G=G)
    acc = np.asarray(solver.accel(jnp.asarray(final[:, :3], jnp.float32)),
                     np.float64)
    f = mass[:, None] * acc
    n3 = float(np.abs(f.sum(axis=0)).max() / np.abs(f).sum(axis=0).max())
    de = abs(energy(final, mass, soft) / energy(xv, mass, soft) - 1.0)
    print(f"  N={len(mass)} multi-species {SIZES['multi_steps']} steps, "
          f"impl={solver.impl}: {ms:.3f} ms/step, |dE/E| = {de:.3e} "
          f"(bound {DE_MAX:.0e}), |sum m a| / sum|m a| = {n3:.3e} "
          f"(bound {NEWTON3_MAX:.0e})", flush=True)
    assert de < DE_MAX, f"|dE/E| = {de:.3e}"
    assert n3 < NEWTON3_MAX, f"Newton's third law violated: {n3:.3e}"


class _Outcomes:
    """pytest plugin counting test outcomes (a skip here is a failure:
    on the card no card-only test has a reason to skip)."""

    def __init__(self):
        self.passed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.skipped:
            self.skipped += 1
        elif report.when == "call" and report.passed:
            self.passed += 1


def phase_gpu_tests():
    import pytest

    os.environ["NBODY_TEST_GPU"] = "1"
    seen = _Outcomes()
    rc = pytest.main([str(ROOT / "tests" / "test_gpu_smoke.py"), "-m", "gpu",
                      "-q", "-p", "no:cacheprovider", "-rs"], plugins=[seen])
    if rc != 0 or seen.skipped or not seen.passed:
        raise AssertionError(
            f"card-only tests: pytest rc={rc}, {seen.passed} passed, "
            f"{seen.skipped} skipped")


def phase_four_cards(jax):
    """The ring-sharded direct sum (method='tree') over four cards."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation
    from nbody_streams_tpu.ops.dispatch import DirectGravity
    from nbody_streams_tpu.parallel.sharded import (
        AXIS, make_particle_mesh, slab_sort_for_sharding)

    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX finds "
                         f"{len(jax.devices())}")
    mesh = make_particle_mesh(devs)
    n = SIZES["n_ring"]
    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=5)
    xv, m = slab_sort_for_sharding(xv, m)
    soft = np.full(n, 0.05)
    s = DirectGravity(m, soft, G=G, impl="sharded", devices=devs)
    print(f"  N={n} over {len(devs)} devices: {s.state_pad} ghost rows, "
          f"Pallas ring tiles: {s._sharded.use_pallas}", flush=True)
    pos = jnp.asarray(xv[:, :3], jnp.float32)
    t, out = timed(jax.jit(s.accel), pos)
    sample = np.random.default_rng(0).choice(n, SIZES["n_sample"],
                                             replace=False)
    ref = oracle("acc", "spline", xv[:, :3], m, soft, targets=sample)
    check(f"N={n} sharded spline float32_kahan acc, {len(sample)} sampled "
          f"targets [{t * 1e3:.1f} ms]",
          rel_err(np.asarray(out)[sample], ref), TOL["float32_kahan"])

    # the ring's collectives alone: the same d-1 source-block permutes
    # per evaluation, without the tile work they overlap with
    d = len(devs)
    nl = s._sharded.n_local
    perm = [(i, (i + 1) % d) for i in range(d)]

    def ring_only(p, gm, h):
        src = (p, gm, h)
        for _ in range(d - 1):
            src = tuple(jax.lax.ppermute(a, AXIS, perm) for a in src)
        return src[0]

    shard = NamedSharding(mesh, P(AXIS))
    blocks = (jax.device_put(jnp.zeros((d * nl, 3), jnp.float32), shard),
              s._sharded.gmass, s._sharded.soft)
    t_ring, _ = timed(jax.jit(jax.shard_map(
        ring_only, mesh=mesh, in_specs=(P(AXIS),) * 3, out_specs=P(AXIS))),
        *blocks)
    print(f"  ring permutes alone: {t_ring * 1e3:.2f} ms per evaluation "
          f"({d - 1} steps of {nl} particles); full sharded evaluation "
          f"{t * 1e3:.1f} ms", flush=True)

    sp = [Species.dark(N=n, mass=m, softening=0.05)]
    buf = io.StringIO()
    dt, steps = 2e-5, SIZES["ring_steps"]
    with tempfile.TemporaryDirectory() as outdir, \
            contextlib.redirect_stdout(buf):
        res = run_simulation(xv, sp, 0.0, steps * dt, dt, method="tree",
                             devices=devs, output_dir=outdir,
                             save_snapshots=False,
                             restart_interval=steps // 2,
                             debug_energy=True)
    log = buf.getvalue()
    print("\n".join("    " + ln for ln in log.splitlines()), flush=True)
    de = [float(x) for x in re.findall(r"dE/E=([-+0-9.e]+)", log)]
    ms = float(re.findall(r"chunk ([0-9.]+) ms/step", log)[-1])
    assert np.isfinite(res["dark"]).all(), "non-finite final state"
    assert de and all(np.isfinite(de)), f"|dE/E| not finite: {de}"
    print(f"  method='tree' {steps} steps: {ms:.1f} ms/step, "
          f"|dE/E| = {abs(de[-1]):.3e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the ring-sharded path over 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)   # the float64 oracle
    print(f"card: {card()}", flush=True)
    print(f"jax {jax.__version__}; devices: {jax.devices()}", flush=True)
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)
    dev = require_gpu(jax)
    import nbody_streams_tpu  # noqa: F401  (sets the cache fallback)

    print(f"compile cache in effect: "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    if args.four_cards:
        phases = [("four cards: ring-sharded direct",
                   lambda: phase_four_cards(jax))]
    else:
        phases = [("kernels vs float64 oracle", phase_kernels),
                  ("run_simulation, single species", phase_run_single),
                  ("run_simulation, multi-species", phase_run_multi),
                  ("card-only tests", phase_gpu_tests)]
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        fn()
        print(f"== {name}: passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
