"""High-level loaders (reference: agama_helper/_load.py:91,234).

``load_potential``: coef file / HDF5 archive / raw string / dataclass ->
evaluator, with in-memory harmonic filtering and recentering.
``load_evolving_potential``: HDF5 archive of snapshot coefficients (or an
Agama Evolving .ini) -> time-interpolated potential.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .coefs import CylSplineCoefs, MultipoleCoefs, read_coefs
from .cylspline import CylSplinePotential
from .factory import load_potential_ini
from .io import list_coef_groups, read_coef_string
from .modifiers import EvolvingPotential, ShiftedPotential
from .multipole import MultipolePotential

__all__ = ["load_potential", "load_evolving_potential",
           "load_agama_potential", "load_agama_evolving_potential"]


def _wrap_center(pot, center):
    """Recenter: (3,) fixed offset, (T,4)/(T,7) trajectory table, or a
    whitespace table file path."""
    if center is None:
        return pot
    if isinstance(center, (str, Path)):
        center = np.loadtxt(center)
    return ShiftedPotential(pot, np.asarray(center, float))


def _build(coefs, keep_lm_mult=None, keep_m_cylspl=None):
    if isinstance(coefs, MultipoleCoefs):
        if keep_lm_mult is not None:
            # exact-pair semantics: load_agama_* pre-expands
            # (incl. the include_negative_m=False contract)
            coefs = coefs.zeroed(keep_lm_mult,
                                 include_negative=False)
        return MultipolePotential(coefs)
    if isinstance(coefs, CylSplineCoefs):
        if keep_m_cylspl is not None:
            coefs = coefs.zeroed(keep_m_cylspl,
                                 include_negative=False)
        return CylSplinePotential(coefs)
    raise TypeError(type(coefs))


def load_potential(source, group_name: str = "snap_000",
                   keep_lm_mult=None, keep_m_cylspl=None, center=None,
                   dataset_name: str = "coefs"):
    """Build a BFE potential evaluator from any coefficient source.

    source: coef text file path | HDF5 archive path (reads
    group_name/dataset_name) | raw coef string |
    MultipoleCoefs/CylSplineCoefs.  ``keep_lm_mult`` / ``keep_m_cylspl``
    filter harmonics before building; ``center`` wraps in a
    ShiftedPotential ((3,), (T,4), (T,7) or a file path).
    """
    if isinstance(source, (MultipoleCoefs, CylSplineCoefs)):
        coefs = source
    else:
        if isinstance(source, (str, Path)) and "\n" not in str(source) \
                and Path(source).suffix.lower() in (".h5", ".hdf5"):
            if not Path(source).exists():
                # falling through to the text parser would report a
                # confusing 'not a valid Agama coef file' for a typo'd
                # archive path
                raise FileNotFoundError(
                    f"coefficient archive not found: {source}")
            source = read_coef_string(source, group_name, dataset_name)
        coefs = read_coefs(source)
    return _wrap_center(_build(coefs, keep_lm_mult, keep_m_cylspl), center)


def load_evolving_potential(source, times=None, keep_lm_mult=None,
                            keep_m_cylspl=None, center=None,
                            interpolate: bool = True,
                            group_names=None,
                            dataset_name: str = "coefs"):
    """Time-evolving BFE potential from an HDF5 snapshot-coef archive
    (embedded ``times`` dataset or explicit ``times``) or an Agama
    Evolving .ini file.  ``group_names`` restricts/orders the archive
    groups read (default: every group, archive order)."""
    if isinstance(source, (str, Path)) and \
            Path(source).suffix.lower() == ".ini":
        if keep_lm_mult is not None or keep_m_cylspl is not None \
                or times is not None or group_names is not None:
            raise ValueError(
                "times/keep_lm_mult/keep_m_cylspl/group_names are not "
                "supported for .ini sources (the INI defines its own "
                "snapshots); load the HDF5 archive directly to filter "
                "harmonics")
        return _wrap_center(load_potential_ini(source), center)

    groups, t_embedded = list_coef_groups(source)
    if group_names is not None:
        missing = [g for g in group_names if g not in groups]
        if missing:
            raise ValueError(
                f"groups not in archive {source}: {missing} "
                f"(archive has {groups})")
        if t_embedded is not None and times is None:
            # embedded times are positional per archive group — keep the
            # selected groups paired with their own times
            idx = {g: i for i, g in enumerate(groups)}
            t_embedded = [t_embedded[idx[g]] for g in group_names]
        groups = list(group_names)
    if not groups:
        raise ValueError(f"No coefficient groups in {source}")
    if times is None:
        times = t_embedded
    if times is None:
        raise ValueError(
            "archive has no embedded 'times' dataset; pass times="
        )
    if len(times) != len(groups):
        raise ValueError(
            f"{len(groups)} snapshot groups but {len(times)} times"
        )
    # one h5py open for the whole archive (read_coef_string per group
    # would reopen the file N times — slow on network filesystems)
    import h5py

    with h5py.File(source, "r") as f:
        strings = []
        for g in groups:
            raw = f[g][dataset_name][()]
            strings.append(raw.decode() if isinstance(raw, bytes)
                           else str(raw))
    pots = [
        load_potential(s, keep_lm_mult=keep_lm_mult,
                       keep_m_cylspl=keep_m_cylspl)
        for s in strings
    ]
    return _wrap_center(EvolvingPotential(pots, times,
                                          interpolate=interpolate), center)


# --------------------------------------------------------------------------
# Reference-name compatibility wrappers (reference: agama_helper/_load.py:
# 91-232 load_agama_potential, 234-430 load_agama_evolving_potential).
# Same call forms; the only semantic difference is that the returned object
# is always the native JAX evaluator — the reference's ``gpu=False`` form
# returns an Agama C++ potential, which this framework does not use.
# --------------------------------------------------------------------------

def _expand_keep_lm(keep_lm, coefs, include_negative_m):
    """Reference keep-list semantics (reference _coefs.py:213-232): a bare
    int ``l`` keeps every (l, m) present in the expansion; (l, m) pairs keep
    that harmonic; negative-m counterparts are auto-added unless
    ``include_negative_m=False``."""
    out = set()
    for item in keep_lm:
        if isinstance(item, (int, np.integer)):
            out.update(tuple(lm) for lm in coefs.lm_labels
                       if lm[0] == int(item))
        else:
            l, m = item
            out.add((int(l), int(m)))
    if include_negative_m:
        out |= {(l, -m) for l, m in out}
    return sorted(out)


def _expand_keep_m(keep_m, include_negative_m):
    keep = {int(m) for m in keep_m}
    if include_negative_m:
        keep |= {-m for m in keep}
    return sorted(keep)


def load_agama_potential(source, group_name: str = "snap_000",
                         dataset_name: str = "coefs", center=None,
                         keep_lm_mult=None, keep_m_cylspl=None,
                         include_negative_m: bool = True,
                         gpu: bool = False):
    """Drop-in for the reference ``load_agama_potential``.

    ``gpu`` is accepted and ignored: both values return the native
    evaluator (the reference's CPU form returns an Agama object, which
    does not exist here — the native evaluator serves both roles).
    """
    if isinstance(source, (MultipoleCoefs, CylSplineCoefs)):
        coefs = source
    else:
        if isinstance(source, (str, Path)) and "\n" not in str(source) \
                and Path(source).suffix.lower() in (".h5", ".hdf5"):
            if not Path(source).exists():
                raise FileNotFoundError(
                    f"coefficient archive not found: {source}")
            source = read_coef_string(source, group_name, dataset_name)
        coefs = read_coefs(source)
    if keep_lm_mult is not None and isinstance(coefs, MultipoleCoefs):
        keep_lm_mult = _expand_keep_lm(keep_lm_mult, coefs,
                                       include_negative_m)
    if keep_m_cylspl is not None and isinstance(coefs, CylSplineCoefs):
        keep_m_cylspl = _expand_keep_m(keep_m_cylspl, include_negative_m)
    return load_potential(coefs, keep_lm_mult=keep_lm_mult,
                          keep_m_cylspl=keep_m_cylspl, center=center)


def load_agama_evolving_potential(source, times=None, *,
                                  group_names=None,
                                  dataset_name: str = "coefs",
                                  center=None,
                                  interp_linear: bool = True,
                                  keep_lm_mult=None, keep_m_cylspl=None,
                                  include_negative_m: bool = True,
                                  gpu: bool = False):
    """Drop-in for the reference ``load_agama_evolving_potential``
    (``interp_linear`` maps to ``interpolate``; ``gpu`` accepted and
    ignored as in :func:`load_agama_potential`)."""
    if keep_lm_mult is not None:
        if any(isinstance(p, (int, np.integer)) for p in keep_lm_mult):
            # bare-int l shorthand needs the expansion's lm labels: read
            # the first archive group (all snapshots share one layout)
            groups, _ = list_coef_groups(source)
            if not groups:
                raise ValueError(f"No coefficient groups in {source}")
            first = read_coefs(
                read_coef_string(source, groups[0], dataset_name))
            keep_lm_mult = _expand_keep_lm(keep_lm_mult, first,
                                           include_negative_m)
        else:
            keep_lm_mult = _expand_keep_lm(keep_lm_mult, None,
                                           include_negative_m)
    if keep_m_cylspl is not None:
        keep_m_cylspl = _expand_keep_m(keep_m_cylspl, include_negative_m)
    return load_evolving_potential(
        source, times=times, keep_lm_mult=keep_lm_mult,
        keep_m_cylspl=keep_m_cylspl, center=center,
        interpolate=interp_linear, group_names=group_names,
        dataset_name=dataset_name)
