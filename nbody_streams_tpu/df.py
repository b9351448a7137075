"""Native distribution-function sampling for initial conditions.

The reference generates equilibrium ICs by delegating to Agama's
``DistributionFunction`` / ``GalaxyModel`` machinery (its MW stability
notebook requires ``agama`` for the QuasiSpherical halo/bulge DFs and the
QuasiIsothermal disk DF; reference: ``examples/MW_gpu_tree_stability.ipynb``,
``fast_sims/_common.py:222``).  Agama is not a dependency here, so this
module implements the two samplers natively:

* :func:`sample_quasispherical` — isotropic Eddington-inversion DF
  ``f(E)`` for an arbitrary spherical(ish) tracer density inside an
  arbitrary host potential (the tracer need not be self-consistent), with
  vectorised rejection sampling of speeds.
* :func:`sample_disk` — warm axisymmetric disk: radii from the surface
  density, vertical structure from the exact ``h(z)`` profile, and
  velocities from the epicyclic approximation (radial/azimuthal) plus the
  exact vertical Jeans integral in the full potential — the same physics
  Agama's QuasiIsothermal DF encodes.

All sampling is host-side vectorised NumPy (a one-off cost, like the
reference's Agama calls); the resulting phase space feeds straight into
:func:`nbody_streams_tpu.run_simulation`.
"""
from __future__ import annotations

import numpy as np

from .constants import G_DEFAULT
from .ic import sample_isotropic

__all__ = [
    "eddington_df",
    "sample_quasispherical",
    "sample_disk",
]


def _density_callable(density):
    """Accept a callable pts->rho or a potential-like object with .density."""
    if callable(density) and not hasattr(density, "density"):
        return density
    if hasattr(density, "density"):
        return lambda pts: np.asarray(density.density(pts), float)
    raise TypeError("density must be callable pts->(N,) or expose .density")


def eddington_df(density, potential, r_grid=None, t: float = 0.0):
    """Isotropic Eddington-inversion DF of a tracer density in a potential.

    f(E) = 8^{-1/2} pi^{-2} \\int_0^E d^2rho/dpsi^2 dpsi / sqrt(E - psi),
    psi = -Phi (relative potential).  The substitution psi = E(1 - u^2)
    removes the endpoint singularity (reference delegates this to Agama's
    ``type='QuasiSpherical'`` DF; see also friction.compute_sigma_r).

    Parameters
    ----------
    density : callable pts->(N,) or object with .density
        Tracer density; need not generate ``potential``.
    potential : potential object (``.potential(pts, t=)``)
    r_grid : (M,) radii to tabulate on (default geomspace(1e-2, 2e3, 256)).

    Returns
    -------
    e_grid : (M',) increasing relative energies  E = psi(r_used) reversed
    f_e : (M',) DF values (clipped at 0)
    r_used : (M',) the radii actually used (ties in psi dropped)
    psi_of_r : (M',) psi on r_used
    """
    from scipy.interpolate import CubicSpline

    rho_fn = _density_callable(density)
    r = (np.asarray(r_grid, float) if r_grid is not None
         else np.geomspace(1e-2, 2e3, 256))
    # extend outward: the quadrature below evaluates d2rho/dpsi2 at
    # psi -> 0 for every E, i.e. beyond psi(r_max) of a truncated
    # grid — spline EXTRApolation there biases f(E) at low energies
    # (measured: 18% for a Plummer tabulated to 10 a).  Applies to the
    # DEFAULT grid too: a tracer with a scale radius of hundreds of
    # length units truncates at 2e3 just as badly as a user grid
    r = np.concatenate([r, np.geomspace(r.max() * 1.25,
                                        r.max() * 1e4, 48)])
    pts = np.column_stack([r, np.zeros_like(r), np.zeros_like(r)])
    rho = np.maximum(rho_fn(pts), 1e-300)
    psi = -np.asarray(potential.potential(pts, t=t), float)
    # f32 potential evaluations can tie at small radii; keep the strictly
    # decreasing subsequence and only reject genuinely rising psi
    rel_rise = (np.diff(psi) / np.maximum(np.abs(psi[:-1]), 1e-300)).max()
    if rel_rise > 1e-4:
        raise ValueError("eddington_df needs psi = -Phi decreasing in r "
                         "(spherical-ish potential)")
    keep = np.concatenate([[True], np.minimum.accumulate(psi)[1:]
                           < np.minimum.accumulate(psi)[:-1]])
    if keep.sum() < 16:
        raise ValueError("too few usable radii: psi = -Phi is flat on the "
                         "supplied r_grid")
    r, pts, rho, psi = r[keep], pts[keep], rho[keep], psi[keep]
    # E = psi must be positive: a potential that does not vanish at
    # infinity (e.g. the logarithmic halo, Phi -> +inf) makes every
    # sqrt(E) below NaN and the sampler's rejection loop then dies with
    # an unrelated numpy error.  Drop any non-positive tail (round-off
    # at the far extension radius) and fail with the physics if nothing
    # bound remains
    pos = psi > 0
    if pos.sum() < 16:
        raise ValueError(
            "eddington_df needs psi = -Phi > 0, i.e. a potential that "
            f"vanishes at infinity (max psi on the grid: {psi.max():.3e});"
            " potentials like the logarithmic halo have no isotropic DF "
            "in this form")
    r, pts, rho, psi = r[pos], pts[pos], rho[pos], psi[pos]

    rho_of_psi = CubicSpline(psi[::-1], rho[::-1])
    d2rho = rho_of_psi.derivative(2)

    u, wu = np.polynomial.legendre.leggauss(64)
    u = 0.5 * (u + 1.0)
    wu = 0.5 * wu
    e_grid = psi[::-1]
    vals = d2rho(e_grid[:, None] * (1.0 - u[None, :] ** 2))
    f_e = (2.0 * np.sqrt(e_grid) * (vals * wu[None, :]).sum(1)
           / (np.sqrt(8.0) * np.pi ** 2))
    return e_grid, np.maximum(f_e, 0.0), r, psi


def sample_quasispherical(density, potential, n: int, seed: int = 0,
                          r_grid=None, t: float = 0.0,
                          total_mass: float | None = None):
    """Sample an isotropic equilibrium tracer population.

    Positions follow the tracer density's enclosed-mass profile
    (spherically averaged for mildly flattened densities); speeds are
    rejection-sampled from p(v|r) \\propto f(psi(r) - v^2/2) v^2 with the
    Eddington DF of :func:`eddington_df`.  Native replacement for the
    reference's ``agama.GalaxyModel(pot, df).sample(n)`` IC path
    (``examples/MW_gpu_tree_stability.ipynb``).

    Returns
    -------
    phase_space : (n, 6) float64
    masses : (n,) float64 — equal masses summing to the tracer mass inside
        the sampled radial range (or ``total_mass`` if given).
    """
    rng = np.random.default_rng(seed)
    rho_fn = _density_callable(density)
    r = (np.asarray(r_grid, float) if r_grid is not None
         else np.geomspace(1e-2, 2e3, 256))

    e_grid, f_e, r_f, psi_f = eddington_df(density, potential, r_grid=r, t=t)
    # piecewise-linear ln f(ln E): a cubic spline would oscillate and
    # overflow exp() across clipped f = 0 stretches (tracer DFs can have
    # d2rho/dpsi2 < 0 noise near the outer boundary)
    ln_e, ln_fv = np.log(e_grid), np.log(f_e + 1e-300)

    def ln_f(e):
        return np.interp(np.log(np.maximum(e, e_grid[0])), ln_e, ln_fv)

    ln_rf = np.log(r_f)

    # --- radii: inverse CDF of M(<r) = 4 pi int rho r^2 dr (log-trapezoid)
    pts = np.column_stack([r, np.zeros_like(r), np.zeros_like(r)])
    rho = np.maximum(rho_fn(pts), 1e-300)
    lnr = np.log(r)
    integ = 4.0 * np.pi * rho * r ** 3              # dM/dlnr
    m_enc = np.concatenate([[0.0],
                            np.cumsum(0.5 * (integ[1:] + integ[:-1])
                                      * np.diff(lnr))])
    m_tot = m_enc[-1]
    u = rng.uniform(0.0, 1.0, n) * m_tot
    r_s = np.exp(np.interp(u, m_enc, lnr))
    pos = r_s[:, None] * sample_isotropic(rng, n)

    # --- speeds: rejection sample q = v / v_max, v_max = sqrt(2 psi)
    psi_s = np.interp(np.log(r_s), ln_rf, psi_f)

    def g_of_q(q, psi_v):
        # p(q) ∝ f(psi (1 - q^2)) q^2 on q in (0, 1)
        e = np.maximum(psi_v * (1.0 - q ** 2), e_grid[0])
        return np.exp(ln_f(e)) * q ** 2

    # per-psi envelope: max over q, tabulated once on the psi grid and
    # interpolated in LOG space (f can fall ~100 orders of magnitude
    # between radial nodes near the tracer's outer edge; linear interp
    # there overestimates the envelope so badly that acceptance stalls).
    # NOTE the 2x headroom is a heuristic, not a proven bound on the
    # continuous maximum between nodes: for DFs varying faster than
    # ~e^{+-0.7} between adjacent radial nodes the envelope can clip the
    # speed distribution's peak — densify r_grid if the tracer is that
    # steep (the straggler fallback below re-maximises per particle, so
    # stalls are handled; statistical bias from a too-low envelope is
    # bounded by the node-to-node variation over the 2x margin)
    qg = np.linspace(1e-3, 1.0, 192)
    env_tab = np.array([g_of_q(qg, pv).max() for pv in psi_f])
    env = 2.0 * np.exp(np.interp(np.log(r_s), ln_rf,
                                 np.log(env_tab + 1e-300)))

    q_s = np.empty(n)
    remaining = np.arange(n)
    rounds = 0
    while remaining.size:
        q = rng.uniform(0.0, 1.0, remaining.size)
        h = rng.uniform(0.0, env[remaining])
        ok = h <= g_of_q(q, psi_s[remaining])
        q_s[remaining[ok]] = q[ok]
        remaining = remaining[~ok]
        rounds += 1
        if rounds == 12 and remaining.size:
            # stragglers: replace the interpolated envelope with each
            # particle's exact max over the q grid (chunked, tight bound)
            for lo in range(0, remaining.size, 65536):
                idx = remaining[lo:lo + 65536]
                env[idx] = 1.2 * g_of_q(qg[None, :],
                                        psi_s[idx, None]).max(axis=1)

    v_mag = q_s * np.sqrt(2.0 * psi_s)
    vel = v_mag[:, None] * sample_isotropic(rng, n)

    mass_each = (total_mass if total_mass is not None else m_tot) / n
    return (np.concatenate([pos, vel], axis=1),
            np.full(n, mass_each, dtype=np.float64))


def sample_disk(n: int, potential, surfaceDensity: float | None = None,
                scaleRadius: float = 3.0, scaleHeight: float = 0.3,
                innerCutoffRadius: float = 0.0, sersicIndex: float = 1.0,
                mass: float | None = None, sigma_r0: float | None = None,
                Rsigma: float | None = None, toomre_Q: float = 1.5,
                seed: int = 0, G: float = G_DEFAULT, t: float = 0.0,
                r_max_factor: float = 12.0):
    """Sample a warm axisymmetric disk in (dynamical) equilibrium.

    Radial profile is the GalPot form Sigma(R) = Sigma0
    exp(-(R/Rd)^(1/n) - R0/R); vertical profile exponential
    (``scaleHeight > 0``) or isothermal sech^2 (``scaleHeight < 0``),
    matching :class:`nbody_streams_tpu.potentials.galpot.DiskDensity`.

    Velocity structure (the physics of Agama's QuasiIsothermal DF, which
    the reference samples through ``agama.GalaxyModel``):

    * ``sigma_R(R) = sigma_r0 exp(-R / Rsigma)`` — if ``sigma_r0`` is not
      given it is set so min Toomre Q(R) = ``toomre_Q``;
    * ``sigma_phi = sigma_R * kappa / (2 Omega)`` (epicyclic);
    * mean streaming from the asymmetric-drift equation
      ``vc^2 - vbar_phi^2 = sigma_R^2 (kappa^2/(4 Omega^2) - 1
      - d ln(Sigma sigma_R^2)/d ln R)`` (BT2008 eq. 4.228 form; the
      gradient term is negative for a declining disk, so it *adds* to
      the drift);
    * ``sigma_z^2(R) = (1/h(0)) int_0^inf h(z) dPhi/dz dz`` — the exact
      vertical Jeans integral in the supplied (total) potential.

    Returns (phase_space (n, 6), masses (n,)).
    """
    from .potentials.galpot import _disk_sigma_funcs, _vertical_funcs

    if scaleHeight == 0:
        raise ValueError(
            "scaleHeight must be nonzero (positive = exponential, "
            "negative = sech^2); 0 gives a razor-thin disk whose "
            "vertical Jeans integral is undefined")
    rng = np.random.default_rng(seed)
    norm_by_mass = surfaceDensity is None
    if norm_by_mass:
        if mass is None:
            raise ValueError("give surfaceDensity or mass")
        surfaceDensity = 1.0
    sig_fn, sig_d1, _ = _disk_sigma_funcs(surfaceDensity, scaleRadius,
                                          innerCutoffRadius, sersicIndex)
    h_fn, _, _ = _vertical_funcs(scaleHeight)

    # normalise Sigma0 to the requested total mass
    rg = np.geomspace(max(1e-4 * scaleRadius, 1e-6),
                      r_max_factor * scaleRadius, 512)
    ln_rg = np.log(rg)
    dM = 2.0 * np.pi * sig_fn(rg) * rg ** 2          # dM/dlnR
    m_cum = np.concatenate([[0.0],
                            np.cumsum(0.5 * (dM[1:] + dM[:-1])
                                      * np.diff(ln_rg))])
    # precedence matches build_disk: an explicit surfaceDensity wins and
    # mass= is only used when surfaceDensity was not given, so matched
    # IC + potential construction with identical kwargs stays consistent
    if norm_by_mass:
        scale = mass / m_cum[-1]
        surfaceDensity *= scale
        sig_fn, sig_d1, _ = _disk_sigma_funcs(surfaceDensity, scaleRadius,
                                              innerCutoffRadius, sersicIndex)
        m_cum *= scale
    m_tot = m_cum[-1]

    # --- positions
    u = rng.uniform(0.0, 1.0, n) * m_tot
    R_s = np.exp(np.interp(u, m_cum, ln_rg))
    phi_s = rng.uniform(0.0, 2.0 * np.pi, n)
    uz = rng.uniform(0.0, 1.0, n)
    hz = float(scaleHeight)
    if hz > 0:   # exponential: |z| = -hz ln(1 - u'), u' in (0,1)
        z_s = -hz * np.log(1.0 - rng.uniform(0.0, 1.0, n))
        z_s *= np.where(uz < 0.5, -1.0, 1.0)
    else:        # sech^2(z / 2b)/(4b): CDF = (1 + tanh(z/2b))/2
        b = abs(hz)
        uz = np.clip(uz, 1e-12, 1.0 - 1e-12)
        z_s = 2.0 * b * np.arctanh(2.0 * uz - 1.0)

    # --- rotation curve / epicyclic frequencies on the R grid (midplane)
    pts = np.column_stack([rg, np.zeros_like(rg), np.zeros_like(rg)])
    gR = -np.asarray(potential.force(pts, t=t), float)[:, 0]   # inward > 0
    vc2 = np.maximum(rg * gR, 1e-12)
    om2 = vc2 / rg ** 2
    dom2_dlnr = np.gradient(np.log(om2), ln_rg)
    kap2 = np.maximum(om2 * (4.0 + dom2_dlnr), 1e-12 * om2)

    # --- radial dispersion profile
    Rsig = float(Rsigma) if Rsigma is not None else 2.0 * scaleRadius
    if sigma_r0 is None:
        # Toomre: sigma_R = Q 3.36 G Sigma / kappa; pick sigma_r0 so the
        # minimum of Q(R) over (0.5 Rd, 8 Rd) equals toomre_Q
        sel = (rg > 0.5 * scaleRadius) & (rg < 8.0 * scaleRadius)
        need = (toomre_Q * 3.36 * G * sig_fn(rg[sel])
                / np.sqrt(kap2[sel])) * np.exp(rg[sel] / Rsig)
        sigma_r0 = float(need.max())
    sigR_g = sigma_r0 * np.exp(-rg / Rsig)

    # --- asymmetric drift (BT08 eq. 4.228, flat-ish sigma_z term absorbed)
    dln_ssig2 = (rg * sig_d1(rg) / np.maximum(sig_fn(rg), 1e-300)
                 - 2.0 * rg / Rsig)
    vbar2 = vc2 + sigR_g ** 2 * (1.0 - kap2 / (4.0 * om2) + dln_ssig2)
    vbar_g = np.sqrt(np.maximum(vbar2, 0.0))

    # --- vertical Jeans integral on the R grid
    zq, wz = np.polynomial.legendre.leggauss(48)
    zmax = 12.0 * abs(hz)
    z_nodes = 0.5 * zmax * (zq + 1.0)
    wz = 0.5 * zmax * wz
    h0 = h_fn(np.zeros(1))[0]
    RR, ZZ = np.meshgrid(rg, z_nodes, indexing="ij")     # (nR, nz)
    p3 = np.column_stack([RR.ravel(), np.zeros(RR.size), ZZ.ravel()])
    g_z = np.abs(np.asarray(potential.force(p3, t=t), float)[:, 2]
                 ).reshape(RR.shape)
    sigz2_g = (h_fn(ZZ) * g_z * wz[None, :]).sum(axis=1) / h0
    sigz_g = np.sqrt(np.maximum(sigz2_g, 1e-12))

    # --- draw velocities in cylindrical frame, rotate to Cartesian
    lnR_s = np.log(R_s)
    sigR_s = np.interp(lnR_s, ln_rg, sigR_g)
    sigphi_s = sigR_s * np.sqrt(np.interp(lnR_s, ln_rg, kap2 / (4.0 * om2)))
    sigz_s = np.interp(lnR_s, ln_rg, sigz_g)
    vbar_s = np.interp(lnR_s, ln_rg, vbar_g)

    vR = rng.normal(0.0, 1.0, n) * sigR_s
    vph = vbar_s + rng.normal(0.0, 1.0, n) * sigphi_s
    vz = rng.normal(0.0, 1.0, n) * sigz_s

    c, s = np.cos(phi_s), np.sin(phi_s)
    pos = np.column_stack([R_s * c, R_s * s, z_s])
    vel = np.column_stack([vR * c - vph * s, vR * s + vph * c, vz])
    return (np.concatenate([pos, vel], axis=1),
            np.full(n, m_tot / n, dtype=np.float64))
