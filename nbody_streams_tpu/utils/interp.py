"""Jittable piecewise-polynomial evaluation for time-varying modifiers.

Spline *construction* happens host-side in SciPy (one-off, at potential
build time); *evaluation* is pure jnp (searchsorted + Horner) so it traces
into the scanned KDK step.  Replaces the reference's direct SciPy spline
calls inside the force loop (reference: _potential.py:1880-1938), which
would be a host round-trip per step on the device.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["JaxPPoly", "spline_coeffs", "hermite_coeffs",
           "pchip_coeffs"]


class JaxPPoly:
    """Piecewise cubic polynomial y(t), clamped or linearly extrapolated.

    Built from a SciPy PPoly (CubicSpline / CubicHermiteSpline): holds
    breakpoints (K+1,) and coefficients (4, K, D); evaluation is jittable.
    """

    def __init__(self, breakpoints, coeffs, extrapolate: str = "clamp"):
        self.x = jnp.asarray(breakpoints)
        c = np.asarray(coeffs)
        if c.ndim == 2:
            c = c[:, :, None]
        self.c = jnp.asarray(c)            # (order, K, D)
        self.dim = self.c.shape[-1]
        if extrapolate not in ("clamp", "linear"):
            raise ValueError(extrapolate)
        self.extrapolate = extrapolate

    @classmethod
    def from_scipy(cls, ppoly, extrapolate: str = "clamp"):
        return cls(ppoly.x, ppoly.c, extrapolate)

    def __call__(self, t):
        t = jnp.asarray(t)
        tc = jnp.clip(t, self.x[0], self.x[-1])
        k = jnp.clip(jnp.searchsorted(self.x, tc, side="right") - 1,
                     0, self.x.shape[0] - 2)
        dt = tc - self.x[k]
        dtb = dt[..., None]                # broadcast against the D axis
        coef = self.c[:, k, :]             # (order, ..., D)
        val = coef[0]
        for i in range(1, self.c.shape[0]):
            val = val * dtb + coef[i]
        if self.extrapolate == "linear":
            # derivative at the clamped point
            dcoef = coef[:-1] * jnp.reshape(
                jnp.arange(self.c.shape[0] - 1, 0, -1, dtype=val.dtype),
                (-1,) + (1,) * (coef.ndim - 1))
            der = dcoef[0]
            for i in range(1, dcoef.shape[0]):
                der = der * dtb + dcoef[i]
            val = val + der * (t - tc)[..., None]
        if self.dim == 1:
            return val[..., 0]
        return val

    def derivative_at(self, t):
        t = jnp.asarray(t)
        tc = jnp.clip(t, self.x[0], self.x[-1])
        k = jnp.clip(jnp.searchsorted(self.x, tc, side="right") - 1,
                     0, self.x.shape[0] - 2)
        dt = tc - self.x[k]
        dtb = dt[..., None]
        coef = self.c[:, k, :]
        dcoef = coef[:-1] * jnp.reshape(
            jnp.arange(self.c.shape[0] - 1, 0, -1, dtype=coef.dtype),
            (-1,) + (1,) * (coef.ndim - 1))
        der = dcoef[0]
        for i in range(1, dcoef.shape[0]):
            der = der * dtb + dcoef[i]
        if self.dim == 1:
            return der[..., 0]
        return der


def spline_coeffs(times, values, extrapolate: str = "clamp") -> JaxPPoly:
    """Not-a-knot cubic spline through (times, values)."""
    from scipy.interpolate import CubicSpline

    times = np.asarray(times, float)
    values = np.asarray(values, float)
    if times.size < 2:
        # constant: degenerate single-interval polynomial
        v = np.atleast_1d(values.reshape(times.size, -1)[0])
        c = np.zeros((4, 1, v.size))
        c[3, 0] = v
        return JaxPPoly(np.array([times[0] - 1.0, times[0] + 1.0]), c,
                        extrapolate)
    bc = "not-a-knot" if times.size > 3 else "natural"
    return JaxPPoly.from_scipy(CubicSpline(times, values, bc_type=bc),
                               extrapolate)


def hermite_coeffs(times, values, derivs,
                   extrapolate: str = "clamp") -> JaxPPoly:
    """Cubic Hermite spline matching values and first derivatives."""
    from scipy.interpolate import CubicHermiteSpline

    times = np.asarray(times, float)
    if times.size < 2:
        # constant fallback, same contract as spline_coeffs (a one-row
        # trajectory table is a fixed offset)
        return spline_coeffs(times, values, extrapolate)
    return JaxPPoly.from_scipy(
        CubicHermiteSpline(times, np.asarray(values, float),
                           np.asarray(derivs, float)),
        extrapolate,
    )


def pchip_coeffs(times, values, extrapolate: str = "clamp") -> JaxPPoly:
    """Monotone (PCHIP) cubic through (times, values) — no ringing.

    The right interpolant for amplitude/scale *schedules* (on/off
    windows, dissolution ramps): a not-a-knot spline through a
    near-step table overshoots by orders of magnitude, while PCHIP
    preserves the data's monotone segments exactly.
    """
    from scipy.interpolate import PchipInterpolator

    times = np.asarray(times, float)
    values = np.asarray(values, float)
    if times.size < 2:
        return spline_coeffs(times, values, extrapolate)
    return JaxPPoly.from_scipy(PchipInterpolator(times, values),
                               extrapolate)
