"""BASELINE config #5 flagship at N = 2M: multi-species satellite in the
evolving MW + LMC potential with dynamical friction.

The reference's flagship demonstration is an N≈2M multi-species run over
long times on one GPU (reference: examples/MW_gpu_tree_stability.ipynb,
CHANGELOG.md:225-228).  This drives the same scale through this stack
with every flagship subsystem on at once:

* N = 2,097,153 particles in three species — dark (Plummer halo),
  stars (compact Plummer), and a central BH particle — sampled in
  equilibrium from the Eddington DF of the combined satellite potential
  (native sampler, df.py);
* self-gravity via the direct O(N^2) solver (impl='auto': the Pallas
  kernel on a GPU);
* external field: the evolving MW + moving LMC + non-inertial frame
  acceleration (potentials/mwlmc.py — the reference's MW_LMC_evolv
  tables through the native GalPot builders);
* Chandrasekhar dynamical friction on the satellite CoM
  (friction.py, shrinking-sphere CoM, variable Coulomb log);
* snapshots + restart through the reference-schema HDF5 writer, with
  the emergency-restart machinery armed (step_timeout_s);
* post-run on-device SPH surface-density renders of first/last
  snapshots (viz/sph.py), written next to the snapshots.

Usage:  python benchmarks/flagship2m.py [N_total] [steps] [--figures-only]
Defaults N=2,097,153, steps=200, dt=5e-4 (~0.49 Myr; t: -0.1 -> 0 =
~98 Myr of infall ending at the present day of the LMC tables).
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

N_TOTAL = 2_097_153
STEPS = 200
DT = 5e-4
OUT = "./output_flagship2m"
FIGDIR = Path(OUT) / "figures"

# satellite model (Sgr-class dwarf): Plummer dark halo + compact
# stellar Plummer + central BH
M_DARK = 2.0e9
A_DARK = 1.5          # kpc
M_STAR = 2.5e8
A_STAR = 0.4
M_BH = 1.0e6
R0 = np.array([52.0, 0.0, 35.0])       # ~63 kpc out, infalling
V0 = np.array([-35.0, 95.0, -40.0])    # sub-circular: decaying orbit


def build_ics(n_total, seed=42):
    from nbody_streams_tpu import Species
    from nbody_streams_tpu.df import sample_quasispherical
    from nbody_streams_tpu.potentials.analytic import PlummerPotential

    n_dark = int(round((n_total - 1) * 5 / 6))
    n_star = n_total - 1 - n_dark

    pot_sat = (PlummerPotential(mass=M_DARK, scaleRadius=A_DARK)
               + PlummerPotential(mass=M_STAR, scaleRadius=A_STAR)
               + PlummerPotential(mass=M_BH, scaleRadius=1e-3))
    r_grid = np.geomspace(1e-3, 60.0, 384)
    print(f"sampling {n_dark:,} dark + {n_star:,} star particles "
          "from the Eddington DF of the combined satellite potential ...",
          flush=True)
    t0 = time.time()
    xv_dark, m_dark = sample_quasispherical(
        PlummerPotential(mass=M_DARK, scaleRadius=A_DARK), pot_sat,
        n_dark, seed=seed, r_grid=r_grid, total_mass=M_DARK)
    xv_star, m_star = sample_quasispherical(
        PlummerPotential(mass=M_STAR, scaleRadius=A_STAR), pot_sat,
        n_star, seed=seed + 1, r_grid=r_grid, total_mass=M_STAR)
    print(f"  sampled in {time.time() - t0:.0f} s", flush=True)

    xv_bh = np.zeros((1, 6))
    xv = np.concatenate([xv_dark, xv_star, xv_bh], axis=0)
    # common CoM correction, then place the whole satellite on its orbit
    mass = np.concatenate([m_dark, m_star, [M_BH]])
    w = mass / mass.sum()
    xv -= (w[:, None] * xv).sum(axis=0, keepdims=True)
    xv[:, :3] += R0
    xv[:, 3:] += V0

    species = [
        Species(name="dark", N=n_dark, mass=m_dark, softening=0.05),
        Species(name="stars", N=n_star, mass=m_star, softening=0.02),
        Species(name="bh", N=1, mass=np.array([M_BH]), softening=0.02),
    ]
    return xv, species


def run(n_total, steps):
    from nbody_streams_tpu import run_simulation
    from nbody_streams_tpu.potentials.mwlmc import load_mw_lmc_potential

    pot_ext, traj = load_mw_lmc_potential()
    print(f"MW+LMC evolving potential loaded (LMC table t = "
          f"{traj[0, 0]:.1f} .. {traj[-1, 0]:.1f})", flush=True)

    xv, species = build_ics(n_total)
    t_end = 0.0
    t_start = t_end - steps * DT

    t0 = time.time()
    out = run_simulation(
        xv, species, t_start, t_end, DT,
        architecture="gpu",
        method="direct",
        external_potential=pot_ext,
        dynamical_friction=True,
        df_M_sat=M_DARK + M_STAR + M_BH,
        df_coulomb_mode="variable",
        df_update_interval=10,
        output_dir=OUT,
        save_snapshots=True,
        snapshots=4,
        restart_interval=50,
        continue_run=Path(OUT, "restart.npz").exists(),
        overwrite=not Path(OUT, "restart.npz").exists(),
        verbose=True,
        debug_energy=True,
        precision="float32_kahan",
        step_timeout_s=900.0,
    )
    wall = time.time() - t0
    pairs = float(n_total) ** 2 * steps
    print(f"\nFLAGSHIP 2M DONE: {steps} steps x N={n_total:,} in "
          f"{wall:.0f} s ({wall / steps:.1f} s/step, "
          f"{pairs / wall / 1e9:.1f} Gint/s sustained incl. IC+I/O)",
          flush=True)
    for k, v in out.items():
        print(f"  {k}: {v.shape}")
    return out


def figures():
    """On-device SPH surface-density renders of first/last snapshots."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nbody_streams_tpu import ParticleReader
    from nbody_streams_tpu.viz.sph import render_surface_density

    FIGDIR.mkdir(parents=True, exist_ok=True)
    reader = ParticleReader(f"{OUT}/snapshot*.h5")
    snaps = [int(s) for s in reader.Times.snap]
    times = np.asarray(reader.Times.time, float)
    print(f"snapshots {snaps} at t = {times}")
    for tag, k in (("first", 0), ("last", len(snaps) - 1)):
        snap = reader.read_snapshot(snaps[k])
        fig, axes = plt.subplots(1, 2, figsize=(11, 5), dpi=110)
        for ax, name in zip(axes, ("dark", "stars")):
            pos = np.asarray(snap.species[name]["posvel"][:, :3], float)
            mass = np.asarray(snap.species[name]["mass"], float)
            com = np.average(pos, axis=0, weights=mass)
            half = 12.0 if name == "dark" else 4.0
            ext = (com[0] - half, com[0] + half,
                   com[1] - half, com[1] + half)
            img, ext_out = render_surface_density(pos, mass, extent=ext,
                                                  npix=384)
            img = np.asarray(img)
            floor = img[img > 0].min() if (img > 0).any() else 1.0
            ax.imshow(np.log10(img + floor), origin="lower",
                      extent=ext_out, cmap="magma")
            ax.set_title(f"{name}  t={snap.time:+.4f}")
            ax.set_xlabel("x [kpc]")
            ax.set_ylabel("y [kpc]")
        fig.tight_layout()
        out = FIGDIR / f"sph_{tag}.png"
        fig.savefig(out)
        print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_total = int(args[0]) if args else N_TOTAL
    steps = int(args[1]) if len(args) > 1 else STEPS
    if "--figures-only" not in sys.argv:
        run(n_total, steps)
    figures()
