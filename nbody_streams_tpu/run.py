"""Integration drivers: device-resident KDK runs with snapshot/restart I/O.

Redesign of the reference's integrator entry points (reference:
run.py:327-1219).  One driver serves every backend; the differences (CPU
vs GPU device, jnp vs Pallas vs sharded force implementation,
fp32-compensated vs fp64 state) are configuration, not separate code
paths:

* the hot loop is chunks of ``lax.scan``-compiled KDK steps (no per-step
  Python dispatch — the reference pays a kernel launch per step),
* state stays on device; hosts see data only at snapshot/restart
  boundaries,
* user ``force_extra`` callables run through an ordered host callback
  inside the compiled step, so even the compatibility path keeps the
  scanned structure; jittable :class:`~nbody_streams_tpu.integrate.ForceExtra`
  objects (e.g. dynamical friction) stay fully on device.
"""
from __future__ import annotations

import time as pytime
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .constants import G_DEFAULT, validate_kernel, validate_precision
from .integrate import (
    ForceExtra,
    IntegratorState,
    init_state,
    make_accel_fn,
    make_kdk_step,
    run_chunk,
    system_energy,
)
from .nbody_io import (
    _load_restart,
    _save_restart,
    _save_snapshot,
    _update_snapshot_times,
)
from .ops.dispatch import DirectGravity
from .species import Species

__all__ = ["run_nbody", "run_nbody_gpu", "run_nbody_tpu", "run_nbody_cpu"]

# grace added to the boundary-work watchdog deadline (fetch + energy
# eval + compile headroom); module-level so tests can shrink it
_BOUNDARY_GRACE_S = 60.0
# steps per watchdog-armed sub-chunk (module-level so tests can shrink it)
_WATCHDOG_SUB_STEPS = 50


class CallbackForceExtra(ForceExtra):
    """Adapter for reference-style plain callables.

    Wraps ``fn(pos, vel, masses, time) -> (N, 3)`` (reference semantics,
    run.py:689-692) in an ordered host callback so it executes at the right
    point inside the scanned KDK step.  Stateful closures (the reference's
    DF force_extra mutates a dict) remain correct because the callback is
    ordered.
    """

    def __init__(self, fn, mass_np, n, dtype, pad: int = 0):
        self.fn = fn
        self.mass_np = np.asarray(mass_np, np.float64)
        self.n = int(n)
        self.dtype = dtype
        # ghost-padded state (sharded backend, uneven N): the user
        # callable keeps its exact contract — it sees only the n real
        # rows; ghost rows get zero extra force
        self.pad = int(pad)

    def __call__(self, state, pos, vel, mass, t, phi=None, step=0):
        import jax.experimental

        def host(p, v, tt):
            out = self.fn(np.asarray(p)[:self.n], np.asarray(v)[:self.n],
                          self.mass_np, float(tt))
            out = np.asarray(out, dtype=self.dtype)
            if self.pad:
                out = np.vstack(
                    [out, np.zeros((self.pad, 3), self.dtype)])
            return out

        acc = jax.experimental.io_callback(
            host,
            jax.ShapeDtypeStruct((self.n + self.pad, 3), self.dtype),
            pos, vel, t,
            ordered=True,
        )
        return acc, state


class _ChunkWatchdog:
    """Per-chunk deadline (reference _StepWatchdog analogue,
    run_gpu_tree.py:79-135): a daemon timer that, if a compiled chunk
    exceeds its deadline, saves an emergency restart from the last host
    state and interrupts the main thread (a hung device call cannot be
    cancelled, but the run fails fast with state preserved)."""

    def __init__(self, timeout_s: float, on_timeout):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer = None

    def __enter__(self):
        import _thread
        import threading

        def fire():
            try:
                self.on_timeout()
            finally:
                _thread.interrupt_main()

        self._timer = threading.Timer(self.timeout_s, fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


def _resolve_device(architecture: str):
    """The device a run is pinned to (None: JAX's default device).

    'gpu' never falls back: without a GPU it raises instead of carrying
    on on the CPU."""
    if architecture in ("auto", None):
        return None
    if architecture == "cpu":
        return jax.devices("cpu")[0]
    if architecture == "gpu":
        try:
            return jax.devices("gpu")[0]
        except RuntimeError as e:
            raise RuntimeError(
                "architecture='gpu' but JAX finds no GPU "
                f"({e}); use architecture='cpu' or 'auto'") from None
    raise ValueError(
        f"Unknown architecture {architecture!r}; expected 'auto', 'cpu' "
        "or 'gpu'")


def _snapshot_schedule(total_steps: int, snapshots: int) -> np.ndarray:
    if snapshots > 1:
        steps = np.round(np.linspace(0, total_steps, snapshots)).astype(int)
        # more snapshots than steps: the rounded schedule repeats steps,
        # and duplicates would be written with the wrong data/time —
        # collapse them (fewer snapshots than asked, each one correct)
        return np.unique(steps)
    return np.array([total_steps], dtype=int)


def run_nbody(
    phase_space: np.ndarray,
    masses: np.ndarray,
    time_start: float,
    time_end: float,
    dt: float,
    softening=0.0,
    G: float = G_DEFAULT,
    precision: str = "float32_kahan",
    kernel: str = "spline",
    external_potential=None,
    external_update_interval: int = 1,
    force_extra=None,
    output_dir: str = "./output",
    save_snapshots: bool = True,
    snapshots: int = 10,
    num_files_to_write: int = 1,
    restart_interval: int = 1000,
    continue_run: bool = False,
    overwrite: bool = False,
    verbose: bool = True,
    debug_energy: bool = False,
    species: list[Species] | None = None,
    architecture: str = "auto",
    impl: str = "auto",
    devices=None,
    block_size: int | None = None,
    nan_check: bool = True,
    step_timeout_s: float | None = None,
    profile_dir: str | None = None,
    solver_factory=None,
) -> np.ndarray:
    """Run a KDK leapfrog N-body integration; returns final (N, 6) float64.

    Reference-equivalent surface of ``run_nbody_gpu``/``run_nbody_cpu``
    (reference: run.py:327,777):

    * ``architecture``: 'auto' | 'cpu' | 'gpu' ('gpu' raises when JAX
      finds no GPU).
    * ``precision``: 'float32' | 'float32_kahan' (compensated force
      accumulation *and* compensated state updates) | 'float64' (requires
      x64; validation use).
    * ``impl``: force backend — 'auto' | 'jnp' | 'pallas' | 'xla' |
      'sharded' ('pallas' is the Triton kernel, 'xla' the pure-XLA
      two-pass split; see ops/dispatch.py).
    * ``devices``: device list for the sharded backend (defaults to all).
    * ``solver_factory``: optional ``(mass_arr, soft_arr) -> solver``
      called on the target device in place of the DirectGravity
      construction (how ``run_simulation(method='scf')`` installs the
      SCF expansion tier); ``impl``/``kernel``/``block_size`` are then
      ignored.
    * snapshots/restart files are schema-compatible with the reference
      (see nbody_io).
    """
    validate_kernel(kernel)
    validate_precision(precision)

    phase_space = np.asarray(phase_space, np.float64)
    if phase_space.ndim != 2 or phase_space.shape[1] != 6:
        raise ValueError(f"phase_space must be (N, 6), got {phase_space.shape}")
    n = phase_space.shape[0]
    masses = np.asarray(masses, np.float64)
    if masses.ndim == 0:
        masses = np.full(n, float(masses))
    if masses.shape != (n,):
        raise ValueError(f"masses must have length N={n}, got {masses.shape}")
    soft_arr = np.asarray(softening, np.float64)
    if soft_arr.ndim == 0:
        soft_arr = np.full(n, float(soft_arr))

    output_path = Path(output_dir)

    # Overwrite / continue guards (reference: run.py:513-526)
    if save_snapshots and not continue_run:
        existing = sorted(output_path.glob("snapshot*.h5"))
        if existing:
            if overwrite:
                for f in existing:
                    f.unlink()
                (output_path / "snapshot.times").unlink(missing_ok=True)
                # a stale restart.npz from the clobbered run must not
                # survive: a later continue_run would silently resume
                # the OLD run's state
                (output_path / "restart.npz").unlink(missing_ok=True)
                if verbose:
                    print(f"Removed {len(existing)} existing snapshot "
                          f"file(s) in '{output_dir}'.")
            else:
                raise FileExistsError(
                    f"Output directory '{output_dir}' already contains "
                    f"snapshot files: {[f.name for f in existing]}. Pass "
                    "overwrite=True to delete them, or continue_run=True "
                    "to resume."
                )

    start_step = 0
    t_now = float(time_start)
    snapshot_counter = None
    xv = phase_space.copy()
    if continue_run:
        restart = _load_restart(output_path)
        if restart is not None:
            xv, t_now, start_step, saved_counter = restart[:4]
            # reference-format files carry no counter: leave None so the
            # searchsorted fallback below reconstructs it from start_step
            snapshot_counter = (None if saved_counter is None
                                else int(saved_counter))
            if verbose:
                print(f"Resuming from step {start_step}, time {t_now:.6e}")
        elif save_snapshots and sorted(output_path.glob("snapshot*.h5")):
            # no restart but old snapshots present: starting from step 0
            # would silently no-op every write (snapshots are
            # append-only) while relabelling snapshot.times
            raise FileNotFoundError(
                f"continue_run=True but '{output_path}/restart.npz' is "
                "missing while snapshot files exist — cannot resume. "
                "Pass overwrite=True to start over, or restore the "
                "restart file.")
        else:
            warnings.warn(
                "continue_run=True but no restart.npz found in "
                f"'{output_path}': starting a fresh run from step 0",
                stacklevel=2)

    total_steps = int(round((time_end - time_start) / dt))
    snap_steps = _snapshot_schedule(total_steps, snapshots)
    if snapshot_counter is None:
        snapshot_counter = int(np.searchsorted(snap_steps, start_step, "left"))

    device = _resolve_device(architecture)
    state_dtype = jnp.float64 if precision == "float64" else jnp.float32

    snap_kwargs = dict(
        num_files_to_write=num_files_to_write,
        total_expected_snapshots=snapshots,
        time_step=dt,
    )
    restart_kwargs = {}
    if species is not None:
        snap_kwargs["species"] = species
        restart_kwargs = dict(
            mass_arr=masses,
            softening_arr=soft_arr,
            species_names=[s.name for s in species],
            species_N=[s.N for s in species],
        )
    else:
        # full array: nbody_io smart storage compresses to a scalar when
        # uniform; masses[0] alone would mislabel unequal-mass runs
        snap_kwargs["mass_dark"] = np.asarray(masses, float)
        snap_kwargs["eps_dark"] = np.asarray(soft_arr, float)

    ctx = jax.default_device(device) if device is not None else _nullctx()
    with ctx:
        if solver_factory is not None:
            solver = solver_factory(masses, soft_arr)
        else:
            solver = DirectGravity(
                masses, soft_arr, G=G, kernel=kernel, precision=precision,
                impl=impl, block_size=block_size, devices=devices,
            )
        # Ghost padding (sharded backend, N not divisible by the device
        # count): integrate N + pad rows so the state block-shards
        # evenly — no per-step reshard.  Ghosts are zero-mass (invisible
        # to forces and mass-weighted diagnostics), frozen (zero-masked
        # acceleration below, so they can never wander to non-finite
        # coordinates), and stripped from every host-visible output.
        pad = getattr(solver, "state_pad", 0)
        mass_dev = jnp.pad(solver.mass, (0, pad)) if pad else solver.mass

        if verbose:
            backend = device.platform if device else jax.default_backend()
            print("=" * 70)
            print(f"N-body integration  [{backend}/"
                  f"{solver.impl}, {precision}, "
                  f"kernel={getattr(solver, 'kernel', kernel)}]")
            print(f"Particles: {n:,}  steps: {total_steps:,} "
                  f"(start {start_step})  dt={dt:.3e}"
                  + (f"  [+{pad} zero-mass ghost rows: even shards]"
                     if pad else ""))
            print("=" * 70)

        fx = force_extra
        if fx is not None and not isinstance(fx, ForceExtra):
            fx = CallbackForceExtra(fx, masses, n, state_dtype, pad=pad)

        accel_fn = make_accel_fn(
            solver, mass_dev, external_potential, external_update_interval,
            fx,
        )
        if pad:
            _base_accel = accel_fn
            _live = jnp.concatenate(
                [jnp.ones((n, 1), state_dtype),
                 jnp.zeros((pad, 1), state_dtype)])

            def accel_fn(pos, vel, t, step, ext_acc, extra_state,
                         refresh_ext=False, order=None):
                acc, ext_acc, extra_state = _base_accel(
                    pos, vel, t, step, ext_acc, extra_state,
                    refresh_ext=refresh_ext, order=order)
                # freeze the ghosts: one fused multiply per step
                return acc * _live, ext_acc, extra_state
        step_fn = make_kdk_step(accel_fn, dt, time_start,
                                compensated=(precision == "float32_kahan"))

        # slab-order reuse: re-sort once per scanned chunk, not per force
        # call.  The order is materialised in the INITIAL carry so its
        # pytree structure never changes — a () -> array flip after the
        # first chunk would silently double every compiled executable
        # (chunks, energy fn, watchdog allowances)
        presort = solver.spatial_sort_active
        # in-scan order-refresh cadence (xla backend's exact-or-NaN
        # guard needs it; None for the fallback-capable Pallas path)
        presort_every = getattr(solver, "presort_interval", None)
        xv_init = xv
        if pad:
            # ghost rows: last real particle's position (stays inside
            # the slab extent, so the ring's compact-support windows do
            # not widen), zero velocity — padded BEFORE init so every
            # executable (init force eval, chunks, energy) compiles for
            # the single padded length
            ghost = np.repeat(xv[-1:], pad, axis=0)
            ghost[:, 3:] = 0.0
            xv_init = np.vstack([xv, ghost])
        state = init_state(
            xv_init[:, :3], xv_init[:, 3:], accel_fn, mass_dev, time_start,
            start_step=start_step, dt=dt, dtype=state_dtype, force_extra=fx,
            sort_fn=solver.sort_key if presort else None,
        )
        # multi-chip: place the state block-sharded so scanned KDK steps
        # run fully sharded instead of resharding pos every force call
        state = solver.shard_state(state)

        e_ref = None
        energy_fn = None
        if debug_energy:
            # jit ONCE: re-wrapping a fresh lambda per report would
            # retrace every time
            energy_fn = jax.jit(
                lambda s: system_energy(s, solver, mass_dev))
            ke, pe = energy_fn(state)
            e_ref = float(ke) + float(pe)
            if verbose:
                print(f"[energy t0] KE={float(ke):.4e} PE={float(pe):.4e} "
                      f"E={e_ref:.4e}")

        def fetch_xv(st: IntegratorState) -> np.ndarray:
            pos, vel = jax.device_get((st.pos, st.vel))
            # [:n] strips the ghost rows (no-op when pad == 0)
            return np.hstack([np.asarray(pos, np.float64),
                              np.asarray(vel, np.float64)])[:n]

        def write_snapshot(xv_host, counter, t):
            _save_snapshot(xv_host, counter, t, output_path, **snap_kwargs)
            _update_snapshot_times(output_path, counter, t)
            if verbose:
                print(f"  snapshot {counter:03d} @ t={t:.6e}")

        # Initial snapshot if scheduled at start_step
        if (snapshot_counter < len(snap_steps)
                and snap_steps[snapshot_counter] == start_step):
            if save_snapshots:
                write_snapshot(fetch_xv(state), snapshot_counter, t_now)
            snapshot_counter += 1

        # Event boundaries: snapshot steps + restart multiples.  When
        # snapshots are off, their schedule must NOT break the scan into
        # small chunks: every boundary costs a dispatch, a D2H fetch and
        # a chunk presort (a 1M run with the default 100-snapshot
        # schedule was paying these every 10 steps instead of every 50).
        # But the NaN gate lives at boundaries too, so keep a bounded
        # check cadence (<= 250 steps) — a run that blows up must not
        # burn the remaining thousands of steps before aborting
        if save_snapshots:
            events = set(snap_steps[snap_steps > start_step].tolist())
        elif nan_check:
            events = set(range(start_step + 250, total_steps, 250))
        else:
            events = set()
        if restart_interval and restart_interval > 0:
            events.update(
                range(
                    ((start_step // restart_interval) + 1) * restart_interval,
                    total_steps + 1,
                    restart_interval,
                )
            )
        events.add(total_steps)
        boundaries = sorted(e for e in events if e > start_step)

        if profile_dir:
            jax.profiler.start_trace(profile_dir)
        try:

            last_xv = xv          # emergency payload: last *completed* state
            wd_step = start_step
            wd_t = time_start + start_step * dt

            def emergency_restart():
                _save_restart(last_xv, wd_t, wd_step, output_path,
                              snapshot_counter, **restart_kwargs)
                print(f"WATCHDOG: sub-chunk exceeded the {step_timeout_s}s/"
                      f"step deadline after step {wd_step}; emergency "
                      f"restart (all completed work) saved to "
                      f"{output_path}/restart.npz", flush=True)

            def boundary_guard():
                # Boundary device work (payload fetch, debug-energy
                # eval) sits outside the per-sub-chunk watchdog; a
                # device call can hang there just as it can mid-chunk.
                # Guard it with a generous deadline — an energy eval
                # costs about one step, a fetch far less.
                return (_ChunkWatchdog(step_timeout_s * 4
                                       + _BOUNDARY_GRACE_S,
                                       emergency_restart)
                        if step_timeout_s else _nullctx())

            # watchdog granularity: arm the deadline over sub-chunks of at
            # most 50 steps and refresh the restart payload after each, so a
            # hang loses <= 50 steps instead of a whole chunk (the reference
            # interrupts per step, run_gpu_tree.py:79-135; per-step host
            # sync would defeat the scanned-chunk design, 50 is the
            # compromise)
            wd_sub = _WATCHDOG_SUB_STEPS
            compiled_lengths: set = set()

            t_wall0 = pytime.perf_counter()
            current = start_step
            for boundary in boundaries:
                n_steps = boundary - current
                if n_steps <= 0:
                    continue
                t_chunk0 = pytime.perf_counter()
                done = 0
                fetched_at = 0   # steps into this chunk at last payload fetch
                since_sort = 0   # order staleness (steps) entering a dispatch
                while done < n_steps:
                    limit = wd_sub if step_timeout_s else n_steps
                    s = min(limit, n_steps - done)
                    if presort_every:
                        # xla backend: the exact-or-NaN guard tolerates
                        # only ~presort_every steps of order staleness,
                        # and run_chunk's in-scan refresh fires only when
                        # the dispatched length exceeds that cadence — so
                        # when watchdog sub-chunks are shorter than it,
                        # sort at sub-chunk start whenever skipping would
                        # let staleness exceed the cadence mid-dispatch
                        do_presort = presort and (
                            done == 0 or since_sort + s > presort_every)
                    else:
                        do_presort = presort and done == 0
                    # run_chunk executables are specialised on BOTH the scan
                    # length and the static presort flag — key the compile
                    # allowance on the pair, or a fresh presort variant is
                    # mistaken for pre-compiled (watchdog fires mid-compile)
                    pre_compiled = (s, do_presort) in compiled_lengths
                    if step_timeout_s:
                        allow = 600.0 if not pre_compiled else 30.0
                        with _ChunkWatchdog(step_timeout_s * s + allow,
                                            emergency_restart):
                            # Pallas path: re-sort only on the first
                            # sub-chunk of each boundary chunk — a stale
                            # order is exact by construction.  xla path:
                            # do_presort above bounds staleness at
                            # presort_every
                            state = run_chunk(step_fn, state, s,
                                              presort=do_presort,
                                              presort_every=presort_every)
                            jax.block_until_ready(state.pos)
                    else:
                        state = run_chunk(step_fn, state, s,
                                          presort=do_presort,
                                          presort_every=presort_every)
                    compiled_lengths.add((s, do_presort))
                    done += s
                    # order-staleness accounting for the next iteration:
                    # run_chunk's in-scan refresh leaves the order
                    # (s % k or k) steps stale; a sub-chunk-start sort
                    # leaves it s stale; otherwise staleness accumulates
                    if presort_every and presort_every < s:
                        since_sort = s % presort_every or presort_every
                    elif do_presort:
                        since_sort = s
                    else:
                        since_sort += s
                    # refresh the emergency payload every wd_sub completed
                    # steps and at the chunk end (the boundary code below
                    # reuses that final fetch).  A hang loses <= wd_sub
                    # steps.
                    if step_timeout_s and (done - fetched_at >= wd_sub
                                           or done >= n_steps):
                        with boundary_guard():
                            last_xv = fetch_xv(state)
                        fetched_at = done
                        wd_step = current + done
                        wd_t = time_start + wd_step * dt
                if verbose:
                    # the chunk's own rate (the first chunk includes its
                    # compilation): wait for the device, not the enqueue
                    jax.block_until_ready(state.pos)
                chunk_s = pytime.perf_counter() - t_chunk0
                current = boundary
                t_now = time_start + current * dt

                due_snap = (snapshot_counter < len(snap_steps)
                            and current >= snap_steps[snapshot_counter])
                due_restart = (restart_interval and current % restart_interval == 0
                               ) or current == total_steps
                # snapshots-off boundaries exist only as NaN-gate checks
                due_check = nan_check and not save_snapshots
                if due_snap or due_restart or debug_energy or due_check:
                    # the watchdog path already fetched this exact state
                    # after its final sub-chunk — skip the duplicate D2H
                    # transfer (96 MB at 2M)
                    xv_host = last_xv if step_timeout_s else fetch_xv(state)
                    last_xv = xv_host
                    if nan_check and not np.isfinite(xv_host).all():
                        # diagnostic payload goes to a SEPARATE file: the
                        # last good restart.npz is the only recoverable
                        # checkpoint and must survive the abort
                        _save_restart(xv_host, t_now, current, output_path,
                                      snapshot_counter,
                                      filename="restart_nanabort.npz",
                                      **restart_kwargs)
                        raise FloatingPointError(
                            f"Non-finite phase space at step {current}; "
                            f"offending state saved to "
                            f"{output_path}/restart_nanabort.npz (the last "
                            f"good restart.npz is untouched — rerun with "
                            f"continue_run=True to resume from it)"
                        )
                    while (snapshot_counter < len(snap_steps)
                           and current >= snap_steps[snapshot_counter]):
                        if save_snapshots:
                            write_snapshot(xv_host, snapshot_counter, t_now)
                        snapshot_counter += 1
                    if due_restart:
                        _save_restart(xv_host, t_now, current, output_path,
                                      snapshot_counter, **restart_kwargs)
                if verbose:
                    elapsed = pytime.perf_counter() - t_wall0
                    done = current - start_step
                    rate = done / elapsed if elapsed > 0 else 0.0
                    line = (f"  step {current:>7}/{total_steps} | t={t_now:.4e} "
                            f"| {rate:.1f} steps/s | "
                            f"avg {1e3 * elapsed / max(done, 1):.1f} ms/step"
                            f" | chunk {1e3 * chunk_s / n_steps:.3f} ms/step")
                    if debug_energy and e_ref is not None:
                        with boundary_guard():
                            ke, pe = energy_fn(state)
                            ke, pe = float(ke), float(pe)
                        etot = ke + pe
                        # pe == 0 (massless tracers in an external field) and
                        # e_ref == 0 are legitimate states, not report errors
                        q = f"{ke / abs(pe):.3f}" if pe else "inf"
                        de = ((etot - e_ref) / abs(e_ref) if e_ref
                              else etot - e_ref)
                        line += f" | Q={q} dE/E={de:+.2e}"
                    print(line, flush=True)

        finally:
            # a watchdog KeyboardInterrupt or NaN abort must still
            # flush the trace — that failing run is the one being
            # profiled
            if profile_dir:
                jax.profiler.stop_trace()

        with boundary_guard():
            xv_final = fetch_xv(state)
        if current != total_steps:
            # only when no boundary reached total_steps (e.g. resuming a
            # finished run, where boundaries is empty and the state never
            # advanced): the loop's own due_restart already wrote this
            # payload otherwise — a duplicate compressed write of the
            # full phase space at shutdown is not free at 2M.  Save the
            # ACTUAL step of the state (`current`), not total_steps: the
            # state was never integrated to total_steps here, and a
            # mislabelled restart would re-integrate on top of
            # already-evolved phase space on the next continue_run
            _save_restart(xv_final, t_now, current, output_path,
                          snapshot_counter, **restart_kwargs)

    if verbose:
        wall = pytime.perf_counter() - t_wall0
        done = total_steps - start_step
        if done > 0 and wall > 0:
            print(f"Done: {done} steps in {wall:.2f} s "
                  f"({done / wall:.1f} steps/s, "
                  f"{1e3 * wall / done:.2f} ms/step)")
    return xv_final


def _nullctx():
    import contextlib

    return contextlib.nullcontext()


def run_nbody_gpu(*args, **kwargs):
    """GPU-pinned driver (reference run_nbody_gpu)."""
    kwargs.setdefault("architecture", "gpu")
    return run_nbody(*args, **kwargs)


# historical name of the accelerator-pinned driver, kept for callers
run_nbody_tpu = run_nbody_gpu


def run_nbody_cpu(*args, **kwargs):
    """CPU-pinned driver (reference run_nbody_cpu equivalent).

    The reference's CPU-only knobs are accepted: ``method`` ('direct' or
    'tree' — the reference's pyfalcon tree runs here as the exact direct
    sum), ``theta`` (tree opening angle: exact here) and ``nthreads``
    (XLA manages its own CPU thread pool) are validated and ignored
    (reference run.py run_nbody_cpu).
    """
    method = kwargs.pop("method", "direct")
    if method not in ("direct", "tree"):
        raise ValueError(f"unknown method {method!r} (use 'direct' or "
                         "'tree')")
    kwargs.pop("theta", None)
    kwargs.pop("nthreads", None)
    kwargs.setdefault("architecture", "cpu")
    kwargs.setdefault("impl", "jnp")
    return run_nbody(*args, **kwargs)
