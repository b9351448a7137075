"""KDK leapfrog integration as a fully-jitted ``lax.scan``.

The reference drives its KDK loop from Python, one CUDA launch per step
(reference: run.py:666-737).  This design instead compiles whole
*chunks* of steps — everything between two snapshot boundaries — into a
single XLA program via ``lax.scan``: zero per-step dispatch overhead, full
fusion of the kick/drift updates into the force kernel's epilogue, and
device-resident state throughout.

Precision model: float64 runs far below the float32 rate on the devices
this targets, so the state is float32 with
*compensated* (Kahan two-sum) position/velocity accumulation — each state
array carries a correction array, recovering ~2x the mantissa for the
accumulated drift/kick updates.  This replaces the reference's
float64-state/float32-force split and meets the |dE/E| < 1e-4 @ 1000 steps
target at fp32 speed.  Float64 state is still available (CPU validation,
``precision='float64'``).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["IntegratorState", "ForceExtra", "make_kdk_step", "run_chunk",
           "system_energy"]


class IntegratorState(NamedTuple):
    """Device-resident integration state (a pytree; scan carry)."""

    pos: jax.Array          # (N, 3)
    vel: jax.Array          # (N, 3)
    pos_c: jax.Array        # compensation for pos (zeros when not used)
    vel_c: jax.Array        # compensation for vel
    acc: jax.Array          # (N, 3) total acceleration at current state
    ext_acc: jax.Array      # cached external-potential acceleration
    extra_state: Any        # ForceExtra threaded state (pytree or ())
    step: jax.Array         # int32 global step counter
    # (N,) int32 slab order for the sorted paths, refreshed once per
    # scanned chunk (run_chunk presort=True); () when unused.  A stale
    # order is exact by construction (see pallas_direct), so re-sorting
    # per chunk instead of per step deletes the in-step argsort.
    sort_order: Any = ()


def _carry_order(state: IntegratorState):
    """The reusable slab order, or None when the carry doesn't hold one."""
    return None if isinstance(state.sort_order, tuple) else state.sort_order


class ForceExtra:
    """Protocol for jittable extra-force terms (e.g. dynamical friction).

    Replaces the reference's plain ``force_extra(pos, vel, masses, time)``
    host callback (reference: run.py:689-692) with a stateful, traceable
    interface so the term can live *inside* the scanned step:

    * ``init_state(pos, vel, mass, t)`` -> pytree of device state
    * ``__call__(state, pos, vel, mass, t, phi=None)`` -> (acc, new_state)

    Plain Python callables are still supported by the driver via a
    host-stepping fallback (see run.py).
    """

    def init_state(self, pos, vel, mass, t):
        return ()

    def __call__(self, state, pos, vel, mass, t, phi=None, step=0):
        raise NotImplementedError


def _comp_add(x, c, delta):
    """Kahan two-sum accumulate: (x, c) += delta with compensation c."""
    y = delta - c
    t = x + y
    c = (t - x) - y
    return t, c


def make_accel_fn(
    solver,
    mass,
    external_potential=None,
    external_update_interval: int = 1,
    force_extra: ForceExtra | None = None,
):
    """Total acceleration = self gravity + cached external + extra term.

    Returns ``accel(pos, vel, t, step, ext_acc, extra_state, refresh_ext)
    -> (acc, ext_acc, extra_state)``.  External forces are recomputed when
    ``step % external_update_interval == 0`` (reference semantics,
    run.py:197-212), via ``lax.cond`` so stale steps skip the evaluation
    entirely.
    """
    k = int(external_update_interval)

    def accel(pos, vel, t, step, ext_acc, extra_state, refresh_ext=False,
              order=None):
        acc = solver.accel(pos, order=order)
        if external_potential is not None:
            def fresh(_):
                return external_potential.force(pos, t).astype(acc.dtype)

            def stale(cached):
                return cached

            if k > 1 and not refresh_ext:
                # refresh_ext (static True at state init) forces an
                # evaluation even when start_step % k != 0 — a resumed
                # run must not inherit the zero initializer for up to
                # k-1 steps
                ext_acc = lax.cond(step % k == 0, fresh, stale, ext_acc)
            else:
                ext_acc = fresh(ext_acc)
            acc = acc + ext_acc
        if force_extra is not None:
            # phi-aware terms (e.g. DF bound-centre tracking) get the
            # self-gravity potential — one extra O(N^2) pass per step,
            # matching the reference's direct-path cost trade-off.  The
            # carried slab order is reused (a per-step argsort here
            # would silently re-pay exactly the cost presort removes)
            phi = (solver.potential(pos, order=order)
                   if getattr(force_extra, "needs_phi", False) else None)
            extra, extra_state = force_extra(
                extra_state, pos, vel, mass, t, phi=phi, step=step
            )
            acc = acc + extra.astype(acc.dtype)
        return acc, ext_acc, extra_state

    return accel


def make_kdk_step(accel_fn, dt: float, t0: float, compensated: bool = True):
    """One symplectic kick-drift-kick step as a scan body.

    ``t`` is reconstructed as ``t0 + step*dt`` from the integer step
    counter (never accumulated in low precision).
    """

    def step_fn(state: IntegratorState, _):
        dtype = state.pos.dtype
        h = jnp.asarray(dt, dtype)
        half = jnp.asarray(0.5 * dt, dtype)

        vel, vel_c = (
            _comp_add(state.vel, state.vel_c, state.acc * half)
            if compensated else (state.vel + state.acc * half, state.vel_c)
        )
        pos, pos_c = (
            _comp_add(state.pos, state.pos_c, vel * h)
            if compensated else (state.pos + vel * h, state.pos_c)
        )
        step = state.step + 1
        t = jnp.asarray(t0, jnp.float64 if dtype == jnp.float64
                        else jnp.float32) + step.astype(dtype) * h

        acc, ext_acc, extra_state = accel_fn(
            pos, vel, t, step, state.ext_acc, state.extra_state,
            order=_carry_order(state)
        )
        vel, vel_c = (
            _comp_add(vel, vel_c, acc * half)
            if compensated else (vel + acc * half, vel_c)
        )
        return IntegratorState(pos, vel, pos_c, vel_c, acc, ext_acc,
                               extra_state, step, state.sort_order), None

    return step_fn


@functools.partial(jax.jit, static_argnames=("step_fn", "n_steps", "presort",
                                             "presort_every"),
                   donate_argnums=(1,))
def run_chunk(step_fn, state: IntegratorState, n_steps: int,
              presort: bool = False, presort_every: int | None = None):
    """Scan ``n_steps`` KDK steps in one compiled program (donated state).

    ``presort=True`` refreshes the carry's slab order from the current
    positions before the scan — one argsort per chunk instead of one
    per force call (pass it when the solver's ``spatial_sort_active``).

    ``presort_every=k`` additionally refreshes the order every ``k``
    steps *inside* the compiled program (nested scan; the argsort is
    in-graph).  The XLA two-pass backend needs this: its in-scan guard
    is exact-or-NaN with a finite band slack, and the slack absorbs
    only a few band-rows of position drift — the measured drift at
    N=64k Plummer is ~2 rows per 50 steps, so a per-boundary-chunk sort
    alone would trip the guard mid-chunk.
    """
    if presort or presort_every:
        from .ops.slab import slab_sort_key

    in_scan_sort = bool(presort_every and presort_every < n_steps)
    if presort and not in_scan_sort:
        # when the in-scan branch below is active its first outer_body
        # iteration re-sorts at step 0 anyway — skip the duplicate
        # argsort (one wasted in-graph sort per dispatched chunk,
        # ~4.8 s at 2M)
        state = state._replace(sort_order=slab_sort_key(state.pos))
    if in_scan_sort:
        k = presort_every

        def outer_body(st, _):
            st = st._replace(sort_order=slab_sort_key(st.pos))
            st, _ = lax.scan(step_fn, st, None, length=k)
            return st, None

        state, _ = lax.scan(outer_body, state, None,
                            length=n_steps // k)
        rem = n_steps % k
        if rem:
            state = state._replace(sort_order=slab_sort_key(state.pos))
            state, _ = lax.scan(step_fn, state, None, length=rem)
    else:
        state, _ = lax.scan(step_fn, state, None, length=n_steps)
    return state


def system_energy(state: IntegratorState, solver, mass):
    """(KE, PE) with PE = 0.5 sum m_i phi_i (self-gravity only).

    A ghost-padded state (sharded backend, N not divisible by the
    device count) is handled by zero-padding ``mass`` to the state
    length — ghosts are zero-mass by construction, so they contribute
    exactly nothing either way."""
    phi = solver.potential(state.pos, order=_carry_order(state))
    if mass.shape[0] != state.pos.shape[0]:
        mass = jnp.pad(mass, (0, state.pos.shape[0] - mass.shape[0]))
    v2 = jnp.sum(state.vel * state.vel, axis=1)
    ke = 0.5 * jnp.sum(mass * v2)
    pe = 0.5 * jnp.sum(mass * phi)
    return ke, pe


def init_state(
    pos,
    vel,
    accel_fn,
    mass,
    t0: float,
    start_step: int = 0,
    dt: float = 0.0,
    dtype=jnp.float32,
    force_extra: ForceExtra | None = None,
    sort_fn=None,
) -> IntegratorState:
    """Build the initial device state, including the first force evaluation.

    On a resumed run (``start_step > 0``) pass ``dt`` so the first force
    and the force_extra state are evaluated at the resume time
    ``t0 + start_step*dt``, not at ``t0`` — time-dependent external
    potentials would otherwise see the wrong epoch for the first kick.

    Pass ``sort_fn`` (e.g. ``solver.sort_key``) whenever the chunks will
    run with ``presort=True``: it materialises ``sort_order`` in the
    carry from the start, so the carry PYTREE STRUCTURE never changes
    between the first and later chunks — a () -> array flip would
    silently double every compiled executable (run_chunk, energy fns).
    """
    pos = jnp.asarray(pos, dtype)
    vel = jnp.asarray(vel, dtype)
    zeros = jnp.zeros_like(pos)
    sort_order = sort_fn(pos) if sort_fn is not None else ()
    t = jnp.asarray(t0 + start_step * dt, dtype)
    extra_state = (
        force_extra.init_state(pos, vel, mass, t)
        if force_extra is not None else ()
    )
    step = jnp.asarray(start_step, jnp.int32)
    acc, ext_acc, extra_state = jax.jit(
        lambda p, v, s, es, o: _init_accel(
            accel_fn, p, v, t, s, zeros, es, o
        )
    )(pos, vel, step, extra_state, sort_order)
    return IntegratorState(pos, vel, zeros, jnp.zeros_like(vel), acc,
                           ext_acc, extra_state, step, sort_order)


def _init_accel(accel_fn, pos, vel, t, step, ext0, extra_state, order=()):
    return accel_fn(pos, vel, t, step, ext0, extra_state, refresh_ext=True,
                    order=None if isinstance(order, tuple) else order)
