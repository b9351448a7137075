"""Slab-order policy shared by the sorted direct paths.

The spline kernel has compact support: a pair farther apart than the
softening length is exactly Newtonian.  Sorting particles by x ("slab
order") groups near pairs, so the Pallas kernel (per source tile) and
the XLA two-pass backend (per band window) can give most pairs the
cheaper Newtonian factor.  Both take a reusable, possibly stale order
from the integrator carry; this module is the one place that decides
when the sort is used and what it is.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["uses_spatial_sort", "slab_sort_key"]


def uses_spatial_sort(kind: str, n: int, spatial_sort=None) -> bool:
    """Whether the sorted paths slab-sort this population (the predicate
    the integrator uses to decide whether to thread a reusable order
    through the scan carry)."""
    if spatial_sort is None:
        return kind == "spline" and n >= 16384
    return bool(spatial_sort) and kind == "spline"


def slab_sort_key(pos):
    """The slab order: argsort along x."""
    return jnp.argsort(pos[:, 0])
