"""CylSpline (azimuthal-harmonic 2-D BFE) potential — jittable evaluator.

Re-design of the reference's CylSplinePotentialGPU
(reference: agama_helper/_potential.py:1000-1615 +
_cylspl_potential_kernel.cu).  Follows the same mathematical pipeline
(the Agama CylSpline behaviour spec, documented in the reference kernel
header :1-36):

* coordinates scaled as lR = asinh(R/Rscale), lz = asinh(z/Rscale) with
  Rscale = -Mtot/Phi0 (fallback: mid-grid radius),
* m=0 term log-scaled as log(-Phi_0) when Phi_0 < 0 everywhere; other
  harmonics stored as Phi_m/Phi_0,
* 2-D bicubic *Hermite* interpolation from per-node (f, f_lR, f_lz,
  f_lRlz) tables — node derivatives from natural cubic splines in lz and
  clamped-left (f'=0 on the axis) splines in lR,
* Fourier sum Phi = sum_m Phi_m(R, z) x {cos(m phi), m >= 0;
  sin(|m| phi), m < 0},
* outside the grid: vacuum harmonic continuation
  Phi_lm(r) = W_lm (r/r0)^-(l+1), least-squares fitted to *densely
  sampled* boundary values of the interior spline (z caps + Rmax wall)
  with radial row-weights (r/r_enc)^2.  This is the same
  PowerLaw-multipole boundary fit as Agama's determineAsympt
  (reference: _determine_asympt_cylspline, _potential.py:1072-1180)
  with two upgrades: dense sampling instead of grid nodes, and radial
  weighting that pins the fit where the exterior expansion is valid.
  Measured on an exponential disk: phi error ~1e-4..2e-3 everywhere
  outside the grid vs ~5e-3..1e-2 for the reference's unweighted node
  fit (and ~5% for round-1's inscribed-sphere projection).  Two dead
  ends evaluated and rejected: Green's-identity exterior moments (the
  l-th moment cancellation on a non-spherical surface amplifies
  boundary-data error by (r_enc/r_char)^l — hopeless at l = 8 from
  spline-grade data) and a blended near/far coefficient pair (the
  blend-weight derivative amplifies the sets' disagreement into ~5%
  force errors in the transition shell).
  Remaining intrinsic limit: in the 'buffer' (outside a disk-shaped
  grid's z caps but inside r_enc) no origin-centred truncated
  expansion is exact; errors there are ~1e-2, same class as Agama.

Forces/Hessians via jax.grad through the evaluator (the interpolant is
C1, so forces are continuous).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .base import Potential
from .coefs import CylSplineCoefs, read_cylspl_coefs
from .multipole import MUL0, MUL1, legendre_nrm, trig_m_recurrence

__all__ = ["CylSplinePotential"]


def _natural_spline_deriv(x, y, axis=0):
    """First derivatives of a natural cubic spline at the nodes."""
    from scipy.interpolate import CubicSpline

    return CubicSpline(x, y, axis=axis, bc_type="natural")(x, 1)


def _clamped_left_spline_deriv(x, y, axis=0):
    """Spline derivatives with f'(x[0]) = 0 (symmetry at the R axis)."""
    from scipy.interpolate import CubicSpline

    other = y.shape[:axis] + y.shape[axis + 1:]
    cs = CubicSpline(x, y, axis=axis,
                     bc_type=((1, np.zeros(other)), "not-a-knot"))
    return cs(x, 1)


def _h00(s):
    return (2.0 * s - 3.0) * s * s + 1.0


def _h10(s):
    return ((s - 2.0) * s + 1.0) * s


def _h01(s):
    return (3.0 - 2.0 * s) * s * s


def _h11(s):
    return (s - 1.0) * s * s


class CylSplinePotential(Potential):
    """Evaluate an Agama CylSpline expansion on device."""

    def __init__(self, coefs, lmax_outer: int = 8, dtype=None,
                 log_scaling: bool = True, rscale: float | None = None,
                 prune: bool = True):
        if not isinstance(coefs, CylSplineCoefs):
            coefs = read_cylspl_coefs(coefs)
        self.coefs = coefs

        r_grid = np.asarray(coefs.R_grid, float)
        z_grid = np.asarray(coefs.z_grid, float)
        m_vals = [int(m) for m in coefs.m_values]
        phi = np.asarray(coefs.phi, float)        # (n_m, nR, nz)

        # prune zero harmonics (disabled for stacked evolving sequences,
        # where all snapshots must share a harmonic list)
        tol = 1e-14 * np.abs(phi).max() if prune else -1.0
        keep = [i for i, m in enumerate(m_vals)
                if m == 0 or np.abs(phi[i]).max() > tol]
        m_vals = [m_vals[i] for i in keep]
        phi = phi[keep]
        if 0 not in m_vals:
            raise ValueError("CylSpline requires the m=0 harmonic")
        i0 = m_vals.index(0)
        phi0 = phi[i0]                             # (nR, nz)

        # Rscale from the monopole mass estimate (reference recipe,
        # _potential.py:1340-1360): Mtot ~ -Phi(Rmax, 0) * Rmax
        iz_mid = int(np.argmin(np.abs(z_grid)))
        phi_c = phi0[0, iz_mid]
        mtot_g = -phi0[-1, iz_mid] * r_grid[-1]    # G*Mtot estimate
        if rscale is None:
            if phi_c < 0.0 and mtot_g > 0.0:
                rscale = -mtot_g / phi_c
            else:
                rscale = float(r_grid[len(r_grid) // 2])
        self.rscale = float(rscale)

        lr = np.arcsinh(r_grid / rscale)
        lz = np.arcsinh(z_grid / rscale)

        log_scaling = bool(log_scaling) and bool(np.all(phi0 < 0.0))
        self.log_scaling = log_scaling

        nodes = []
        for i, m in enumerate(m_vals):
            f = phi[i]
            if log_scaling:
                f = np.log(-f) if m == 0 else f / phi0
            fy = _natural_spline_deriv(lz, f, axis=1)
            # the zero-slope axis clamp expresses Phi_m ~ R^|m| symmetry
            # at R = 0 — valid for every harmonic EXCEPT |m| = 1, whose
            # axis derivative is generically nonzero (Phi_1 ~ c(z) R)
            if abs(m) == 1:
                fx = _natural_spline_deriv(lr, f, axis=0)
                fxy = _natural_spline_deriv(lr, fy, axis=0)
            else:
                fx = _clamped_left_spline_deriv(lr, f, axis=0)
                fxy = _clamped_left_spline_deriv(lr, fy, axis=0)
            nodes.append(np.stack([f, fx, fy, fxy], axis=-1))
        node_arr = np.stack(nodes)                 # (n_m, nR, nz, 4)

        dt = dtype or jnp.asarray(0.0).dtype
        self.m_vals = m_vals
        self.i0 = i0
        self.mmax = max(abs(m) for m in m_vals)
        self.lr_grid = jnp.asarray(lr, dt)
        self.lz_grid = jnp.asarray(lz, dt)
        self.nodes = jnp.asarray(node_arr, dt)
        self.r_max = float(r_grid[-1])
        self.z_min = float(z_grid[0])
        self.z_max = float(z_grid[-1])

        # ---- outer harmonic continuation -------------------------------
        self.r_b = min(self.r_max, self.z_max, -self.z_min)
        self.r_enc = math.hypot(self.r_max, max(self.z_max, -self.z_min))
        self.r0_outer = min(self.r_max, max(self.z_max, -self.z_min))
        self._prune = bool(prune)
        self.lmax_outer = int(lmax_outer)
        self._build_outer(lmax_outer, dt)

    # ------------------------------------------------------------------
    def _build_outer(self, lmax: int, dt):
        """PowerLaw outer continuation: least squares on densely sampled
        boundary values of the interior spline, row-weighted by
        (r / r_enc)^2 (see module docstring; reference algorithm:
        _determine_asympt_cylspline, _potential.py:1072)."""
        import jax
        from scipy.linalg import lstsq

        shrink = 0.9995
        r_b_eff = self.r_max * shrink
        z_top = self.z_max * shrink
        z_bot = self.z_min * shrink
        r0 = self.r0_outer
        mmax_fit = min(lmax, self.mmax)
        labels = [(l, m) for l in range(lmax + 1) for m in self.m_vals
                  if abs(m) <= min(l, mmax_fit)]

        n_phi_q = max(8, 4 * mmax_fit + 4)
        phis = 2.0 * np.pi * (np.arange(n_phi_q) + 0.5) / n_phi_q
        cp, sp = np.cos(phis), np.sin(phis)
        pts = []
        zq = np.linspace(z_bot, z_top, 64)
        for z in zq:                                 # side wall
            pts.append(np.column_stack([r_b_eff * cp, r_b_eff * sp,
                                        np.full(n_phi_q, z)]))
        rq = np.linspace(0.0, r_b_eff, 96)
        for zcap in (z_top, z_bot):                  # caps
            for R in rq:
                pts.append(np.column_stack([R * cp, R * sp,
                                            np.full(n_phi_q, zcap)]))
        pts = np.concatenate(pts)

        def phi_xyz(p):
            rc = jnp.sqrt(p[0] ** 2 + p[1] ** 2 + 1e-30)
            return self._interior_point(rc, p[2], p[0] / rc, p[1] / rc)

        vals = np.asarray(jax.vmap(phi_xyz)(jnp.asarray(pts)), float)

        from .fit import _real_sph_harm

        r = np.linalg.norm(pts, axis=1)
        y = _real_sph_harm(labels, pts)              # (nl, npts)
        ll = np.array([l for l, _ in labels], float)
        design = (y * (r[None, :] / r0) ** (-(ll[:, None] + 1.0))).T
        w_row = (r / self.r_enc) ** 2
        sol = lstsq(design * w_row[:, None], vals * w_row)[0]

        scale = np.abs(vals).max()
        tol = 1e-13 * scale if self._prune else -1.0
        keep = [(k, float(v)) for k, v in zip(labels, sol)
                if abs(v) > tol]
        if not keep:
            keep = [((0, 0), float(np.mean(vals * r / r0)))]
        self.outer_labels = [k for k, _ in keep]
        self.outer_l = np.array([l for l, _ in self.outer_labels])
        self.outer_w = jnp.asarray(np.array([v for _, v in keep]), dt)

    # ------------------------------------------------------------------
    def _interior_point(self, R, z, cos_p, sin_p, nodes=None):
        """Interior spline sum at one (R, z, azimuth); inputs clamped.

        Azimuth enters as (cos, sin) rather than an angle: atan2 has a
        NaN gradient at the axis, while the trig recurrence is safe there
        (m != 0 harmonics vanish on-axis in the tables).
        """
        lr = jnp.arcsinh(R / self.rscale)
        lz = jnp.arcsinh(z / self.rscale)
        # where-based clamp (NOT jnp.clip: min/max split the gradient
        # 0.5/0.5 at exact ties, halving forces at boundary nodes)
        lr = jnp.where(lr < self.lr_grid[0], self.lr_grid[0],
                       jnp.where(lr > self.lr_grid[-1],
                                 self.lr_grid[-1], lr))
        lz = jnp.where(lz < self.lz_grid[0], self.lz_grid[0],
                       jnp.where(lz > self.lz_grid[-1],
                                 self.lz_grid[-1], lz))

        iu = jnp.clip(jnp.searchsorted(self.lr_grid, lr, side="right") - 1,
                      0, self.lr_grid.shape[0] - 2)
        iv = jnp.clip(jnp.searchsorted(self.lz_grid, lz, side="right") - 1,
                      0, self.lz_grid.shape[0] - 2)
        hu = self.lr_grid[iu + 1] - self.lr_grid[iu]
        hv = self.lz_grid[iv + 1] - self.lz_grid[iv]
        s = (lr - self.lr_grid[iu]) / hu
        t = (lz - self.lz_grid[iv]) / hv

        bu = jnp.stack([_h00(s), _h10(s) * hu, _h01(s), _h11(s) * hu])
        bv = jnp.stack([_h00(t), _h10(t) * hv, _h01(t), _h11(t) * hv])

        node_arr = self.nodes if nodes is None else nodes

        def cell_eval(mm):
            n = node_arr[mm]
            c00 = n[iu, iv]          # (4,): f, fx, fy, fxy
            c10 = n[iu + 1, iv]
            c01 = n[iu, iv + 1]
            c11 = n[iu + 1, iv + 1]
            # M[iu-basis, iv-basis] layout:
            m00 = jnp.stack([c00[0], c00[2], c01[0], c01[2]])
            m10 = jnp.stack([c00[1], c00[3], c01[1], c01[3]])
            m01 = jnp.stack([c10[0], c10[2], c11[0], c11[2]])
            m11 = jnp.stack([c10[1], c10[3], c11[1], c11[3]])
            row = (bu[0] * m00 + bu[1] * m10 + bu[2] * m01 + bu[3] * m11)
            # precision: XLA may batch the vmapped (4,)x(4,) dots into
            # one matrix product, which on the GPU may run in TF32
            return jnp.dot(row, bv,
                           precision=jax.lax.Precision.HIGHEST)

        fsc0 = cell_eval(self.i0)
        if self.log_scaling:
            phi0 = -jnp.exp(fsc0)
        else:
            phi0 = fsc0

        cos_m, sin_m = trig_m_recurrence(cos_p, sin_p, self.mmax)

        total = phi0  # m = 0 contribution (trig = 1)
        for idx, m in enumerate(self.m_vals):
            if m == 0:
                continue
            fsc = cell_eval(idx)
            phim = fsc * phi0 if self.log_scaling else fsc
            am = abs(m)
            trig = cos_m[am] if m > 0 else sin_m[am]
            total = total + phim * trig
        return total

    # ------------------------------------------------------------------
    def _outer_point(self, r, cos_t, sin_t, cos_p, sin_p,
                     outer_w=None):
        lmax = int(self.outer_l.max()) if len(self.outer_labels) else 0
        mmax = max(abs(m) for _, m in self.outer_labels)
        r = jnp.maximum(r, 0.5 * self.r_b)

        cos_m, sin_m = trig_m_recurrence(cos_p, sin_p, mmax)
        p = legendre_nrm(cos_t, sin_t, lmax, mmax)

        w = self.outer_w if outer_w is None else outer_w
        total = 0.0
        ratio = self.r0_outer / r
        for i, (l, m) in enumerate(self.outer_labels):
            am = abs(m)
            mul = MUL0 if m == 0 else MUL1
            trig = cos_m[am] if m >= 0 else sin_m[am]
            total = total + (w[i] * ratio ** (l + 1)
                             * mul * p[(l, am)] * trig)
        return total

    # ------------------------------------------------------------------
    def phi_point(self, xyz, t, nodes=None, outer_w=None):
        eps = 1e-30
        R = jnp.sqrt(xyz[0] ** 2 + xyz[1] ** 2 + eps)
        z = xyz[2]
        cos_p = xyz[0] / R
        sin_p = xyz[1] / R
        r = jnp.sqrt(R * R + z * z)
        cos_t = z / r
        sin_t = R / r

        inside = ((R <= self.r_max) & (z <= self.z_max)
                  & (z >= self.z_min))
        interior = self._interior_point(R, z, cos_p, sin_p, nodes=nodes)
        outer = self._outer_point(r, cos_t, sin_t, cos_p, sin_p,
                                  outer_w=outer_w)
        return jnp.where(inside, interior, outer)

    @classmethod
    def from_file(cls, path, **kw):
        return cls(read_cylspl_coefs(path), **kw)
