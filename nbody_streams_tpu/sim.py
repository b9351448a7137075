"""Unified multi-species simulation entry point.

Reference-equivalent surface of ``run_simulation`` (reference: sim.py:34),
re-targeted at the JAX backends: one driver handles every architecture
(see run.py), so this layer only does species validation/assembly, DF
wiring, and kwarg routing.

Method mapping (reference hardcodes a solver per backend, sim.py:236-242):

* ``method='direct'`` — O(N^2) direct summation; Pallas kernel on a single
  GPU, blocked jnp elsewhere.  Kernel default 'spline'.
* ``method='tree'``   — the reference's tree tier is replaced by
  *mesh-sharded direct summation* (particles sharded over the device mesh,
  source blocks ring-permuted between devices).  Same accuracy class or better
  (it is exact), comparable throughput scaling; accepts ``devices=``.
* ``method='scf'``    — Hernquist-Ostriker self-consistent-field
  expansion (ops/scf.py): O(N) per step, the answer to the reference's
  ">2M use tree/FMM" crossover guidance (reference: README.md:799-807).
  Accuracy dials ``scf_nmax``/``scf_lmax`` play the role of the tree's
  ``theta``; for collisionless systems the truncation
  error sits below the particle shot noise at modest orders.
"""
from __future__ import annotations

import numpy as np

from .constants import G_DEFAULT
from .run import run_nbody
from .species import (
    Species,
    _build_particle_arrays,
    _emit_performance_warnings,
    _split_by_species,
    _validate_species,
)

__all__ = ["run_simulation"]

_DIRECT_KW = {
    "precision", "kernel", "external_update_interval", "impl", "devices",
    "block_size", "nan_check", "step_timeout_s", "profile_dir",
}
_DF_KW = {
    "df_M_sat", "df_coulomb_mode", "df_fixed_ln_lambda", "df_core_gamma",
    "df_r_core", "df_update_interval", "df_sigma_method",
    "df_apply_radius_factor", "df_shrink_n_iter", "df_shrink_frac",
    "df_sigma_grid_r", "df_com_method", "df_bound_r_max",
}
_SCF_KW = {
    "scf_nmax", "scf_lmax", "scf_mmax", "scf_a", "scf_symmetry",
    "scf_center", "scf_groups",
}


def run_simulation(
    phase_space: np.ndarray,
    species: list[Species],
    time_start: float,
    time_end: float,
    dt: float,
    G: float = G_DEFAULT,
    architecture: str = "auto",
    method: str = "direct",
    external_potential=None,
    dynamical_friction: bool = False,
    output_dir: str = "./output",
    save_snapshots: bool = True,
    snapshots: int = 100,
    num_files_to_write: int = 1,
    restart_interval: int = 1000,
    continue_run: bool = False,
    overwrite: bool = False,
    verbose: bool = True,
    debug_energy: bool = False,
    **kwargs,
) -> dict[str, np.ndarray]:
    """Run a multi-species N-body simulation; returns {name: (N_k, 6)}.

    See the reference docstring surface (reference: sim.py:34-250) for the
    full parameter semantics; differences here:

    * ``architecture``: 'auto' | 'cpu' | 'gpu'.  'gpu' never falls back:
      without a GPU it raises.
    * ``method='tree'`` routes to the sharded direct backend (see module
      docstring); ``theta``/``nleaf``/``ncrit``/``level_split`` are
      accepted and ignored with a warning (no tree approximation exists —
      results are exact).
    * dynamical friction is a fully jittable on-device term (``df_*``
      kwargs as in the reference).
    """
    phase_space = np.asarray(phase_space, np.float64)
    if phase_space.ndim != 2 or phase_space.shape[1] != 6:
        raise ValueError(
            f"phase_space must be (N, 6), got {phase_space.shape}"
        )
    if architecture not in ("cpu", "gpu", "auto"):
        raise ValueError(
            "architecture must be 'auto', 'cpu' or 'gpu', got "
            f"{architecture!r}"
        )
    if method not in ("direct", "tree", "scf"):
        raise ValueError(
            f"method must be 'direct', 'tree' or 'scf', got {method!r}")

    _validate_species(phase_space, species)
    mass_arr, soft_arr = _build_particle_arrays(species)
    n_total = phase_space.shape[0]
    _emit_performance_warnings(n_total, architecture, method)

    # Route kwargs
    kw = dict(kwargs)
    direct_kwargs = {k: kw.pop(k) for k in list(kw) if k in _DIRECT_KW}
    df_kwargs = {k: kw.pop(k) for k in list(kw) if k in _DF_KW}
    scf_kwargs = {k: kw.pop(k) for k in list(kw) if k in _SCF_KW}
    if scf_kwargs and method != "scf":
        raise TypeError(
            f"scf_* kwargs given but method={method!r}: {sorted(scf_kwargs)}")
    for legacy in ("theta", "nleaf", "ncrit", "level_split", "nthreads"):
        if legacy in kw:
            kw.pop(legacy)
            if verbose:
                print(f"note: {legacy!r} has no effect here "
                      "(sharded direct summation is exact)")
    if kw:
        raise TypeError(f"Unknown keyword arguments: {sorted(kw)}")

    force_extra = None
    if dynamical_friction:
        if external_potential is None:
            raise ValueError(
                "dynamical_friction=True requires external_potential"
            )
        from .friction import make_df_force_extra

        m_sat = df_kwargs.pop("df_M_sat", float(mass_arr.sum()))
        force_extra = make_df_force_extra(
            external_potential,
            M_sat=m_sat,
            G=G,
            t_start=time_start,
            t_end=time_end,
            **{k.removeprefix("df_"): v for k, v in df_kwargs.items()},
        )
    elif df_kwargs:
        raise TypeError(
            f"df_* kwargs given but dynamical_friction=False: "
            f"{sorted(df_kwargs)}"
        )

    if method == "tree":
        direct_kwargs.setdefault("impl", "sharded")
    elif method == "scf":
        from .ops.scf import SCFGravity

        precision = direct_kwargs.get("precision", "float32_kahan")
        scf_prec = "float64" if precision == "float64" else "float32"
        for bad in ("impl", "block_size", "kernel", "devices"):
            if bad in direct_kwargs:
                raise TypeError(f"{bad!r} has no effect with method='scf'")
        xv0 = phase_space
        opts = {k.removeprefix("scf_"): v for k, v in scf_kwargs.items()}
        groups_spec = opts.pop("groups", None)

        if groups_spec is not None:
            # multi-center composite tier: scf_groups maps species onto
            # per-group expansions (clustered geometry — an LMC-mass
            # satellite or dissolving progenitor falls out of the 1-5%
            # class under a single-center basis; see
            # docs/performance.md 'Clustered geometry').  Accepts
            # {species_name: opts} or [(species_name | slice, opts)].
            from .ops.scf import CompositeSCFGravity

            by_name, start = {}, 0
            for s in species:
                by_name[s.name] = slice(start, start + s.N)
                start += s.N
            items = (groups_spec.items() if isinstance(groups_spec, dict)
                     else groups_spec)
            groups = []
            for key, gopts in items:
                if isinstance(key, str):
                    if key not in by_name:
                        raise ValueError(
                            f"scf_groups references unknown species "
                            f"{key!r}; have {sorted(by_name)}")
                    key = by_name[key]
                groups.append((key, dict(gopts)))

            def _scf_factory(mass_arr_np, soft_arr_np, _g=groups,
                             _shared=opts):
                return CompositeSCFGravity(
                    mass_arr_np, soft_arr_np, groups=_g, G=G,
                    precision=scf_prec, phase_space=xv0, **_shared)
        else:
            def _scf_factory(mass_arr_np, soft_arr_np, _opts=opts):
                return SCFGravity(mass_arr_np, soft_arr_np, G=G,
                                  precision=scf_prec, phase_space=xv0,
                                  **_opts)

        direct_kwargs["solver_factory"] = _scf_factory

    xv_final = run_nbody(
        phase_space,
        mass_arr,
        time_start,
        time_end,
        dt,
        softening=soft_arr,
        G=G,
        external_potential=external_potential,
        force_extra=force_extra,
        output_dir=output_dir,
        save_snapshots=save_snapshots,
        snapshots=snapshots,
        num_files_to_write=num_files_to_write,
        restart_interval=restart_interval,
        continue_run=continue_run,
        overwrite=overwrite,
        verbose=verbose,
        debug_energy=debug_energy,
        species=species,
        architecture=architecture,
        **direct_kwargs,
    )
    return _split_by_species(xv_final, species)
