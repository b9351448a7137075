"""Self-consistent-field (SCF / basis-function-expansion) gravity tier.

The reference's answer to "N beyond the direct-summation budget" is its
Barnes-Hut GPU tree (reference: tree_gpu/, README.md:799-807 crossover
guidance: ">2M use tree/FMM"); its fast-sims tier rebuilds an Agama
Multipole from the progenitor's bound particles every few steps
(reference: fast_sims/restricted.py:39-372, agama_helper/_fit.py).  A
tree walk means irregular gathers and data-dependent control flow; the
dense-array equivalent of "approximate far field, cheap per step" is
the classic **Hernquist–Ostriker (1992) SCF expansion**: project the particle density onto a fixed biorthogonal
potential–density basis and differentiate the smooth truncated field.

Per step this is two dense passes over the particles — an
``(N, P) x (N, Q)`` coefficient contraction and a basis evaluation —
i.e. plain dense matrix products plus elementwise recurrences,
O(N (nmax+1) (lmax+1)^2) with NO pair interactions, no sorting, no
tree — at the reference tree's own accuracy class (1-5% force error,
README.md:848-855; the SCF ladder measures 3-5% median vs direct at
(nmax, lmax) >= (4, 2), saturating at the sampled system's shot-noise
floor).  Its speed on the GPU is not measured yet (PERF.md).

Mathematical scheme (dimensionless s = r/a, xi = (s-1)/(s+1)):

    phi_nl(s)   = - s^l (1+s)^-(2l+1) C_n^{2l+3/2}(xi)      (HO92 eq. 2.9)
    psi_nlm(x)  = phi_nl(s) B_lm(theta, phi)

with ``C_n^alpha`` Gegenbauer polynomials and ``B_lm`` the framework's
real spherical-harmonic basis (Y_00 = 1 convention, int B^2 dOmega =
4 pi — same convention as potentials/multipole.py).  The basis is
biorthogonal under the Poisson pairing, so the field of the particle
set {m_k, x_k} truncated at (nmax, lmax) is

    Phi(x) = -(G/a) sum_nlm  [ sum_k m_k psi_nlm(x_k) / K_nl ] psi_nlm(x)

    K_nl   = int_0^inf [ phi_nl'(s)^2 + l(l+1) (phi_nl(s)/s)^2 ] s^2 ds

(K_nl > 0; derivation: K_nl = -a/G int rho~ Phi~ dV via
int |grad psi|^2 = -int psi lap psi; e.g. K_00 = 1/3 reproduces the
Hernquist potential exactly from a Hernquist density — pinned in
tests/test_scf.py).  K_nl is computed once at setup by Gauss–Legendre
quadrature in xi (the integrand is a smooth rational polynomial on
[-1, 1]), sidestepping the transcription-error-prone closed forms.

Accuracy is controlled by (nmax, lmax) exactly like the tree's theta:
tests pin a convergence ladder against direct summation.  Both SCF
matmuls run at ``lax.Precision.HIGHEST`` so the dial holds on the GPU
too (a TF32 product would floor the relative error near 1e-3
regardless of truncation order).  The expansion
is global and smooth — no self-interaction, no softening (the
``softening`` argument is accepted and ignored for driver
compatibility), forces are curl-free by construction.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import G_DEFAULT
from ..potentials.multipole import MUL0, MUL1, legendre_nrm, trig_m_recurrence

__all__ = ["SCFGravity", "CompositeSCFGravity", "scf_coefficients",
           "scf_potential", "scf_accel"]


# ---------------------------------------------------------------------------
# Host-side setup: radial norms K_nl and label bookkeeping
# ---------------------------------------------------------------------------

def _gegenbauer_np(xi, alpha, nmax):
    """C_n^alpha(xi) for n = 0..nmax, NumPy, shape (nmax+1, ...)."""
    out = [np.ones_like(xi)]
    if nmax >= 1:
        out.append(2.0 * alpha * xi)
    for n in range(2, nmax + 1):
        out.append((2.0 * (n + alpha - 1.0) * xi * out[n - 1]
                    - (n + 2.0 * alpha - 2.0) * out[n - 2]) / n)
    return np.stack(out)


def _radial_norms(nmax, lmax, n_quad=512):
    """K_nl = int [ phi'^2 + l(l+1) (phi/s)^2 ] s^2 ds, shape
    (nmax+1, lmax+1), by Gauss-Legendre in xi = (s-1)/(s+1).

    With s = (1+xi)/(1-xi):  ds = 2/(1-xi)^2 dxi, and the integrand is a
    smooth rational polynomial of xi on [-1, 1] (exponentially convergent
    quadrature; K_00 = 1/3 analytically — pinned in tests)."""
    xi, w = np.polynomial.legendre.leggauss(n_quad)
    s = (1.0 + xi) / (1.0 - xi)
    ds = 2.0 / (1.0 - xi) ** 2
    K = np.empty((nmax + 1, lmax + 1))
    for l in range(lmax + 1):
        alpha = 2.0 * l + 1.5
        c = _gegenbauer_np(xi, alpha, nmax)                    # (n+1, q)
        # dC_n^a/dxi = 2a C_{n-1}^{a+1}
        dc = np.zeros_like(c)
        if nmax >= 1:
            dc[1:] = 2.0 * alpha * _gegenbauer_np(xi, alpha + 1.0, nmax - 1)
        base = s**l / (1.0 + s) ** (2 * l + 1)                 # radial shell
        dbase = base * (l / np.maximum(s, 1e-300)
                        - (2 * l + 1) / (1.0 + s))
        dxi_ds = 2.0 / (1.0 + s) ** 2
        phi = -base * c                                        # (n+1, q)
        dphi = -(dbase * c + base * dc * dxi_ds)
        integrand = (dphi**2 + l * (l + 1) * (phi / s) ** 2) * s**2
        K[:, l] = (integrand * (w * ds)).sum(axis=1)
    return K


# ---------------------------------------------------------------------------
# Jittable basis evaluation
# ---------------------------------------------------------------------------

def _gegenbauer(xi, alpha, nmax):
    """C_n^alpha(xi) for n = 0..nmax as a python list of arrays (static
    unrolled recurrence — nmax is a trace-time constant)."""
    out = [jnp.ones_like(xi)]
    if nmax >= 1:
        out.append(2.0 * alpha * xi)
    for n in range(2, nmax + 1):
        out.append((2.0 * (n + alpha - 1.0) * xi * out[n - 1]
                    - (n + 2.0 * alpha - 2.0) * out[n - 2]) / n)
    return out


def _basis_rows(pos, a, nmax, lmax, labels):
    """R (N, P) radial factors phi_nl and B (N, Q) angular factors B_lm.

    P enumerates (n, l) pairs row-major; ``labels`` gives the (l, m)
    columns of B.  The tiny floors keep r = 0 / the z-axis finite AND
    differentiable (autodiff of sqrt/atan2-style expressions at the
    singular point yields NaN otherwise); they displace the evaluation
    point by ~1e-6 a — far below the truncation error of any practical
    (nmax, lmax)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    tiny = jnp.asarray(1e-12 * a * a, pos.dtype)
    rc2 = x * x + y * y + tiny
    r = jnp.sqrt(rc2 + z * z)
    rc = jnp.sqrt(rc2)
    ct = z / r
    st = rc / r
    cp = x / rc
    sp = y / rc

    s = r / a
    xi = (s - 1.0) / (s + 1.0)

    mmax = max((abs(m) for _, m in labels), default=0)
    p_lm = legendre_nrm(ct, st, lmax, mmax)
    cos_m, sin_m = trig_m_recurrence(cp, sp, mmax)
    b_cols = []
    for l, m in labels:
        am = abs(m)
        mul = MUL0 if m == 0 else MUL1
        trig = cos_m[am] if m >= 0 else sin_m[am]
        b_cols.append(mul * p_lm[(l, am)] * trig)
    B = jnp.stack(b_cols, axis=-1)                             # (N, Q)

    r_cols = []
    one_p_s = 1.0 + s
    inv = 1.0 / one_p_s
    shell = inv                                                # s^l/(1+s)^(2l+1)
    inv2 = inv * inv
    for l in range(lmax + 1):
        if l > 0:
            shell = shell * s * inv2
        c = _gegenbauer(xi, 2.0 * l + 1.5, nmax)
        for n in range(nmax + 1):
            r_cols.append(-shell * c[n])
    R = jnp.stack(r_cols, axis=-1)                             # (N, P)
    return R, B


def _l_mask(nmax, lmax, labels):
    """(P, Q) static 0/1 mask selecting matching-l (radial, angular)
    pairs — zeroing the non-physical cross terms of the dense coefficient
    matmul is free compared to gathers."""
    P = (nmax + 1) * (lmax + 1)
    mask = np.zeros((P, len(labels)), np.float32)
    for p in range(P):
        l_p = p // (nmax + 1)
        for q, (l, _) in enumerate(labels):
            if l == l_p:
                mask[p, q] = 1.0
    return mask


def scf_coefficients(pos, mass, a, nmax, lmax, labels, K_flat, mask):
    """A (P, Q) expansion coefficients of the particle set (masked to
    matching l; already divided by the radial norms K_nl)."""
    R, B = _basis_rows(pos, a, nmax, lmax, labels)
    # Precision.HIGHEST: a float32 product left to XLA may run in TF32
    # on the GPU, which would put a ~1e-3-class relative floor under
    # the coefficients that (nmax, lmax) could not reduce.  Both SCF
    # matmuls are tiny (P, Q ~ tens), so full fp32 costs little
    # against the O(N P) basis recurrences.
    M = jax.lax.dot_general((mass[:, None] * R), B,
                            (((0,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=R.dtype)    # (P, Q)
    return -(M / K_flat[:, None]) * mask


def _phi_of(pos, A, a, G, nmax, lmax, labels):
    R, B = _basis_rows(pos, a, nmax, lmax, labels)
    RA = jnp.matmul(R, A, precision=jax.lax.Precision.HIGHEST)
    return (G / a) * jnp.sum(RA * B, axis=-1)


def scf_potential(pos_eval, A, a, G, nmax, lmax, labels):
    """Phi at pos_eval from coefficients A."""
    return _phi_of(pos_eval, A, a, G, nmax, lmax, labels)


def scf_accel(pos_eval, A, a, G, nmax, lmax, labels):
    """-grad Phi at pos_eval (reverse-mode through the basis — exact
    derivatives of the truncated field, so the force is curl-free)."""
    def phi_one(x):
        return _phi_of(x[None, :], A, a, G, nmax, lmax, labels)[0]

    return -jax.vmap(jax.grad(phi_one))(pos_eval)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class SCFGravity:
    """Drop-in self-gravity solver (same driver interface as
    :class:`~nbody_streams_tpu.ops.dispatch.DirectGravity`) using the
    Hernquist–Ostriker SCF expansion.

    Parameters
    ----------
    mass : (N,) masses.
    nmax, lmax : radial / angular truncation (accuracy dials — the
        SCF analogue of the tree code's theta; see docs/forces.md).
    mmax : azimuthal truncation (default lmax).
    a : basis scale radius.  Default: the median particle radius about
        ``center`` at construction (the n = 0, l = 0 term is then a
        Hernquist profile of roughly the right size; convergence is
        broad in a).
    symmetry : 'none' | 'spherical' | 'axisymmetric' | 'triaxial' |
        'bisymmetric' — drops (l, m) terms exactly as
        potentials.fit._symmetry_labels does.
    center : static (3,) expansion center, or 'com' to re-center on the
        instantaneous mass centroid inside each evaluation (jittable;
        makes the field translation-following at the cost of strict
        energy conservation), or None for the origin.
    phase_space : optional (N, >=3) initial positions, only used to
        auto-pick ``a`` when it is not given.

    Multi-chip: every op here is a dense matmul or an elementwise
    recurrence over particles, so under ``jit`` with row-sharded inputs
    GSPMD shards the basis passes and inserts the (P, Q)-sized psum for
    the coefficient contraction automatically — no bespoke ring needed
    (tested on the 8-device CPU mesh).
    """

    spatial_sort_active = False
    sort_key = None

    def __init__(self, mass, softening=None, *, nmax: int = 8,
                 lmax: int = 4, mmax: int | None = None, a: float | None
                 = None, symmetry: str = "none", center=None,
                 G: float = G_DEFAULT, precision: str = "float32",
                 phase_space=None):
        from ..potentials.fit import _symmetry_labels

        if nmax < 0 or lmax < 0:
            raise ValueError("nmax and lmax must be >= 0")
        self.impl = "scf"
        self.kernel = "scf"
        self.precision = precision
        self.dtype = jnp.float64 if precision == "float64" else jnp.float32
        mass = jnp.asarray(mass, self.dtype)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        self.n = int(mass.shape[0])
        self.mass = mass
        self.G = float(G)
        self.nmax = int(nmax)
        self.lmax = int(lmax)
        self.labels = tuple(
            _symmetry_labels(self.lmax,
                             self.lmax if mmax is None else int(mmax),
                             symmetry))

        self._follow_com = center == "com"
        if self._follow_com or center is None:
            self.center = jnp.zeros((3,), self.dtype)
        else:
            self.center = jnp.asarray(center, self.dtype)

        if a is None:
            if phase_space is None:
                raise ValueError(
                    "pass a= (basis scale radius) or phase_space= so "
                    "SCFGravity can pick it from the median radius")
            p = np.asarray(phase_space, float)[:, :3] - np.asarray(
                jax.device_get(self.center), float)
            a = float(np.median(np.linalg.norm(p, axis=1)))
            if not np.isfinite(a) or a <= 0:
                raise ValueError(
                    f"auto-picked basis scale a = {a!r} from the particle "
                    "median radius is not usable; pass a= explicitly")
        self.a = float(a)

        K = _radial_norms(self.nmax, self.lmax)                # (n+1, l+1)
        # flat (P,) in the (l, n) row-major order of _basis_rows
        self._K_flat = jnp.asarray(K.T.reshape(-1), self.dtype)
        self._mask = jnp.asarray(
            _l_mask(self.nmax, self.lmax, self.labels), self.dtype)
        # terms per particle per pass (cost model: O(N * terms))
        self.terms = (self.nmax + 1) * len(self.labels)

    # -- driver interface ---------------------------------------------------
    def shard_state(self, tree):
        """No-op: the SCF passes are GSPMD-shardable as-is."""
        return tree

    def _frame(self, pos):
        pos = pos.astype(self.dtype)
        if self._follow_com:
            com = (jnp.sum(self.mass[:, None] * pos, axis=0)
                   / jnp.sum(self.mass))
            return pos - com
        return pos - self.center

    def _coefs(self, pos):
        return scf_coefficients(self._frame(pos), self.mass, self.a,
                                self.nmax, self.lmax, self.labels,
                                self._K_flat, self._mask)

    def accel(self, pos, order=None):
        """(N, 3) accelerations of the particles on themselves."""
        p = self._frame(pos)
        A = scf_coefficients(p, self.mass, self.a, self.nmax, self.lmax,
                             self.labels, self._K_flat, self._mask)
        return scf_accel(p, A, self.a, self.G, self.nmax, self.lmax,
                         self.labels)

    def potential(self, pos, order=None):
        """(N,) potential of the particles at the particles."""
        p = self._frame(pos)
        A = scf_coefficients(p, self.mass, self.a, self.nmax, self.lmax,
                             self.labels, self._K_flat, self._mask)
        return scf_potential(p, A, self.a, self.G, self.nmax, self.lmax,
                             self.labels)

    # -- field evaluation at arbitrary points (fast_sims / analysis) --------
    def field(self, pos_src, pos_eval):
        """(phi, acc) of the particle set at arbitrary points."""
        ps = self._frame(pos_src)
        pe = self._frame(pos_eval)
        A = scf_coefficients(ps, self.mass, self.a, self.nmax, self.lmax,
                             self.labels, self._K_flat, self._mask)
        phi = scf_potential(pe, A, self.a, self.G, self.nmax, self.lmax,
                            self.labels)
        acc = scf_accel(pe, A, self.a, self.G, self.nmax, self.lmax,
                        self.labels)
        return phi, acc


class CompositeSCFGravity:
    """Multi-center SCF: one expansion per particle group, summed fields.

    A single-center spherical-harmonic basis converges slowly on
    strongly clustered geometry — a second center (an LMC-mass
    satellite, a dissolving progenitor) far from the expansion origin
    needs l ~ r_center/δr terms to resolve, so the single-center tier
    falls out of the 1-5% class exactly where the reference's tree
    would not (reference: tree_gpu/computeForces.cu:647 — the tree
    opening criterion is geometry-blind; README.md:850-855).  The
    dense-array fix is one SCF expansion per mass concentration: each
    group keeps its own center (typically ``center='com'`` so the
    expansion follows its group), own scale radius, own (nmax, lmax),
    and the total field is the exact sum of the truncated group fields
    — still O(N · Σ terms) dense matmuls, no pair interactions.

    ``groups``: list of ``(sl, opts)`` where ``sl`` is a slice into the
    particle array (species are contiguous — ``run_simulation`` can map
    species directly onto groups) and ``opts`` are per-group
    ``SCFGravity`` kwargs (``nmax``, ``lmax``, ``a``, ``center``,
    ``symmetry``, ...).  Every particle must belong to exactly one
    group.

    Measured (tests/test_scf.py, two-center MW+LMC 10:1 at distance
    8 a): single-center (8, 4) median force error on the satellite's
    particles >5% (out of class); this composite at the same per-group
    truncation 4.9% — the 4000-particle satellite sample's shot-noise
    floor, back in the tree's published 1-5% class (accuracy table:
    docs/performance.md 'Clustered geometry').

    ``run_simulation(method='scf', scf_groups=...)`` exposes this tier
    end-to-end, mapping species names onto group slices.
    """

    spatial_sort_active = False
    sort_key = None

    def __init__(self, mass, softening=None, *, groups, G: float = G_DEFAULT,
                 precision: str = "float32", phase_space=None, **shared):
        self.impl = "scf"
        self.kernel = "scf-composite"
        self.precision = precision
        self.dtype = jnp.float64 if precision == "float64" else jnp.float32
        mass = jnp.asarray(mass, self.dtype)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        self.n = int(mass.shape[0])
        self.mass = mass
        self.G = float(G)
        if not groups:
            raise ValueError("groups must be a non-empty list of "
                             "(slice, opts) pairs")
        covered = np.zeros(self.n, bool)
        self._slices = []
        self.solvers = []
        for item in groups:
            sl, opts = item if isinstance(item, tuple) else (item, {})
            idx = np.arange(self.n)[sl]
            if idx.size == 0:
                raise ValueError(f"group slice {sl} selects no particles")
            if covered[idx].any():
                raise ValueError(f"group slice {sl} overlaps another group")
            covered[idx] = True
            merged = dict(shared)
            merged.update(opts)
            ps_g = (None if phase_space is None
                    else np.asarray(phase_space)[sl])
            self._slices.append(sl)
            self.solvers.append(SCFGravity(
                mass[sl], G=G, precision=precision, phase_space=ps_g,
                **merged))
        if not covered.all():
            missing = int((~covered).sum())
            raise ValueError(
                f"{missing} particles belong to no group; groups must "
                "partition the particle array")
        self.terms = sum(s.terms for s in self.solvers)

    def shard_state(self, tree):
        return tree

    def _sum_fields(self, pos, want):
        """Sum each group's truncated field over ALL positions."""
        pos = pos.astype(self.dtype)
        out = None
        for sl, s in zip(self._slices, self.solvers):
            p_src = s._frame(pos[sl])
            A = scf_coefficients(p_src, s.mass, s.a, s.nmax, s.lmax,
                                 s.labels, s._K_flat, s._mask)
            # evaluation points in the group's frame: subtract the same
            # offset _frame applied to the sources (static center or the
            # group's instantaneous COM)
            if s._follow_com:
                off = (jnp.sum(s.mass[:, None] * pos[sl].astype(s.dtype),
                               axis=0) / jnp.sum(s.mass))
            else:
                off = s.center
            pe = pos - off
            if want == "acc":
                part = scf_accel(pe, A, s.a, s.G, s.nmax, s.lmax, s.labels)
            else:
                part = scf_potential(pe, A, s.a, s.G, s.nmax, s.lmax,
                                     s.labels)
            out = part if out is None else out + part
        return out

    def accel(self, pos, order=None):
        """(N, 3) accelerations: sum of every group's field at pos."""
        return self._sum_fields(pos, "acc")

    def potential(self, pos, order=None):
        """(N,) potential: sum of every group's field at pos."""
        return self._sum_fields(pos, "pot")
