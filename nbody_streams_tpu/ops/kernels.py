"""Softening-kernel mathematics as branchless jax-traceable functions.

Each *force* kernel returns the scalar factor ``w(r^2, h)`` such that the
acceleration contribution of source ``j`` on target ``i`` is::

    a_i += G * m_j * w(r_ij^2, h_eff) * (x_j - x_i)

i.e. ``w = 1/r^3`` in the Newtonian far field.  Each *potential* kernel
returns ``u(r^2, h)`` such that ``phi_i += G * m_j * u`` with
``u = -1/r`` in the far field.

The five kernels and their integer ids mirror the reference framework
(reference: cuda_kernels.py:22-87 for forces, :373-436 for potentials):

====  ===========  ==========================================================
id    name         description
====  ===========  ==========================================================
0     newtonian    unsoftened 1/r^2
1     plummer      (r^2 + h^2)^(-3/2)
2     dehnen_k1    Dehnen (2001) K1 compensated kernel
3     dehnen_k2    Dehnen (2001) K2 kernel
4     spline       Monaghan (1992) cubic spline, compact support (exactly
                   Newtonian for r >= h)
====  ===========  ==========================================================

All functions are written branch-free (``jnp.where`` ladders with
denominators guarded *before* division) so they vectorise with no
control flow.  ``kind`` is a static Python string: each kernel choice
traces to a distinct XLA program, exactly like the reference compiling one
CUDA kernel per ``kernel_id``.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..constants import KERNEL_IDS, validate_kernel

__all__ = ["force_factor", "potential_factor", "KERNEL_IDS"]


def _rsqrt(x):
    return lax.rsqrt(x)


# ---------------------------------------------------------------------------
# Force factors  w(r2, h):  a_i += G m_j w (x_j - x_i)
# ---------------------------------------------------------------------------

def _force_newtonian(r2, h):
    inv_r = _rsqrt(r2)
    return inv_r * inv_r * inv_r


def _force_plummer(r2, h):
    d = r2 + h * h
    inv = _rsqrt(d)
    return inv * inv * inv


def _force_dehnen_k1(r2, h):
    h2 = h * h
    d = r2 + h2
    inv = _rsqrt(d)
    inv_d = inv * inv
    inv_d32 = inv_d * inv
    inv_d52 = inv_d32 * inv_d
    return inv_d32 + 1.5 * h2 * inv_d52


def _force_dehnen_k2(r2, h):
    h2 = h * h
    d = r2 + h2
    inv = _rsqrt(d)
    inv_d = inv * inv
    inv_d32 = inv_d * inv
    inv_d52 = inv_d32 * inv_d
    # h^4 / d^3.5 as (h^2/d) (h^2/d^2.5): d^-3.5 overflows float32 for an
    # unsoftened self pair (d = eps2), and 0 * inf would be NaN
    return inv_d32 + 1.5 * h2 * inv_d52 + 3.75 * (h2 * inv_d) * (h2 * inv_d52)


def _force_spline(r2, h):
    # Monaghan-1992 cubic spline with compact support: Newtonian for r >= h.
    # Division-free formulation (rsqrt is cheap, divide is not):
    # q = r/h = r * hinv,  1/q^3 * h^-3 = 1/r^3 = inv_r^3, so the outer
    # branch's 1/q^3 term folds into the Newtonian factor.
    inv_r = _rsqrt(r2)
    r = r2 * inv_r
    newton = inv_r * inv_r * inv_r

    # Guard h == 0 (pure Newtonian particles): hinv only used when r < h,
    # which cannot happen for h == 0, so any finite placeholder works.
    h_safe = jnp.where(h > 0, h, 1.0)
    hinv = _rsqrt(h_safe * h_safe)
    h3inv = hinv * hinv * hinv
    q = r * hinv
    q2 = q * q

    inner = h3inv * (q2 * (32.0 * q - 38.4) + 10.666666666666666)

    outer = h3inv * (
        21.333333333333333
        + q * (-48.0 + q * (38.4 - 10.666666666666667 * q))
    ) - 0.0666666666666667 * newton

    center = h3inv * 10.666666666666666

    soft = jnp.where(q <= 0.5, inner, outer)
    soft = jnp.where(q < 1e-8, center, soft)
    return jnp.where(r >= h, newton, soft)


_FORCE_FUNCS = {
    "newtonian": _force_newtonian,
    "plummer": _force_plummer,
    "dehnen_k1": _force_dehnen_k1,
    "dehnen_k2": _force_dehnen_k2,
    "spline": _force_spline,
}


def force_factor(kind: str, r2, h):
    """Force softening factor ``w(r2, h)`` for a static kernel ``kind``."""
    validate_kernel(kind)
    return _FORCE_FUNCS[kind](r2, h)


# ---------------------------------------------------------------------------
# Potential factors  u(r2, h):  phi_i += G m_j u
# ---------------------------------------------------------------------------

def _pot_newtonian(r2, h):
    r = jnp.sqrt(r2)
    inv_r = _rsqrt(jnp.where(r2 > 0, r2, 1.0))
    return jnp.where(r > 0, -inv_r, 0.0)


def _pot_plummer(r2, h):
    return -_rsqrt(r2 + h * h)


def _pot_dehnen_k1(r2, h):
    h2 = h * h
    d = r2 + h2
    inv = _rsqrt(d)
    inv_d32 = inv * inv * inv
    return -inv - 0.5 * h2 * inv_d32


def _pot_dehnen_k2(r2, h):
    h2 = h * h
    h4 = h2 * h2
    d = r2 + h2
    inv = _rsqrt(d)
    inv_d32 = inv * inv * inv
    inv_d52 = inv_d32 * inv * inv
    return -inv - 0.5 * h2 * inv_d32 - 0.375 * h4 * inv_d52


def _pot_spline(r2, h):
    # Division-free: -1/r = -inv_r; (1/q)*hinv = 1/r = inv_r, so the outer
    # branch's 1/q term folds into inv_r.
    inv_r = _rsqrt(jnp.where(r2 > 0, r2, 1.0))
    r = r2 * inv_r
    newton = jnp.where(r > 0, -inv_r, 0.0)

    h_safe = jnp.where(h > 0, h, 1.0)
    hinv = _rsqrt(h_safe * h_safe)
    q = r * hinv
    q2 = q * q

    # Gadget/Monaghan W2 inner branch: -2.8 + 16/3 q^2 - 48/5 q^4
    # + 32/5 q^5 = -2.8 + q^2 (16/3 + q^2 (6.4 q - 9.6)).  NOTE the q^2
    # (not q^4) nesting: the reference's own CUDA kernel has q4 here
    # (cuda_kernels.py:422), which is discontinuous at q = 0.5
    # (-1.567/h vs -1.867/h) and is NOT the antiderivative of its force
    # kernel; we deliberately diverge (dU/dr == w(r) r verified in
    # tests/test_forces.py).
    inner = (-2.8 + q2 * (5.333333333333333 + q2 * (6.4 * q - 9.6))) * hinv

    outer = (
        -3.2
        + q2 * (10.666666666666666
                + q * (-16.0 + q * (9.6 - 2.1333333333333333 * q)))
    ) * hinv + 0.06666666666666667 * inv_r

    center = -2.8 * hinv

    soft = jnp.where(q <= 0.5, inner, outer)
    soft = jnp.where(q < 1e-8, center, soft)
    return jnp.where((h <= 0) | (r >= h), newton, soft)


_POT_FUNCS = {
    "newtonian": _pot_newtonian,
    "plummer": _pot_plummer,
    "dehnen_k1": _pot_dehnen_k1,
    "dehnen_k2": _pot_dehnen_k2,
    "spline": _pot_spline,
}


def potential_factor(kind: str, r2, h):
    """Potential softening factor ``u(r2, h)`` for a static kernel ``kind``."""
    validate_kernel(kind)
    return _POT_FUNCS[kind](r2, h)
