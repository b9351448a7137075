"""Drop-in surface of the reference's ``tree_gpu`` tier.

The reference ships a warp-centric Barnes-Hut CUDA treecode exposed as
``TreeGPU`` / ``tree_gravity_gpu`` / ``run_nbody_gpu_tree`` (reference:
tree_gpu/_force.py:167,224, tree_gpu/run_gpu_tree.py:142).  Here the
tree tier is replaced by *exact* mesh-sharded direct summation (see
``parallel/sharded.py`` and SURVEY.md §7): the ring-sharded O(N²/D)
direct sum covers the same particle range with zero force error.

These shims keep reference call sites working unchanged: the tree
approximation knobs (``theta``, ``nleaf``, ``ncrit``, ``level_split``)
are accepted and ignored — forces are exact, which is strictly more
accurate than any setting of them (warned once per process).
"""
from __future__ import annotations

import warnings

import jax
import numpy as np

from .constants import G_DEFAULT
from .ops.dispatch import DirectGravity

__all__ = ["TreeGPU", "tree_gravity_gpu", "run_nbody_gpu_tree"]

_warned = False


def _note_exact(theta):
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "the tree tier is exact sharded direct summation; theta/"
            f"nleaf/ncrit/level_split are ignored (theta={theta} "
            "requested, force error is 0 instead of the reference "
            "tree's 1-5%)", stacklevel=3)


class TreeGPU:
    """Reusable solver handle (reference ``TreeGPU``, _force.py:167).

    The reference pre-allocates device buffers to save ~27 ms of
    malloc/free per step; here the analogue is caching the compiled
    solver so repeated calls with the same (mass, eps, G) skip retracing.
    """

    def __init__(self, n: int, eps: float = 0.05, theta: float = 0.6,
                 **_ignored):
        self.n = int(n)
        self.eps = eps
        self.theta = theta
        self._solver = None
        self._key = None

    def _get_solver(self, mass, eps, G):
        mass = np.asarray(mass, np.float32)
        eps = np.asarray(eps, np.float32)
        key = (mass.tobytes(), eps.tobytes(), float(G))
        if self._key != key:
            self._solver = DirectGravity(mass, eps, G=G, kernel="plummer",
                                         precision="float32_kahan",
                                         impl="auto")
            self._key = key
        return self._solver


def tree_gravity_gpu(pos, mass, eps=None, G: float = G_DEFAULT,
                     theta: float = 0.6, nleaf: int = 64, ncrit: int = 64,
                     level_split: int = 5, verbose: bool = False,
                     tree: TreeGPU | None = None):
    """(acc, phi) for all particles (reference ``tree_gravity_gpu``,
    tree_gpu/_force.py:224) — computed exactly.

    Plummer softening with the per-particle ``eps`` max-pair rule (the
    reference tree supports only Plummer, computeForces.cu:152).
    Returns float32 ``acc`` (N, 3) and ``phi`` (N,) in input order.
    """
    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    if eps is None:                    # fall back to the handle's eps
        eps = tree.eps if tree is not None else 0.05
    eps_arr = np.broadcast_to(np.asarray(eps, np.float32), (n,))
    # scalar (shared) mass is part of the reference surface too
    mass = np.broadcast_to(np.asarray(mass, np.float32), (n,))
    del verbose              # reference CUDA-timing chatter: no analogue
    _note_exact(theta)
    handle = tree if tree is not None else TreeGPU(n)
    solver = handle._get_solver(mass, eps_arr, G)
    acc = solver.accel(pos)
    phi = solver.potential(pos)
    return np.asarray(jax.device_get(acc)), np.asarray(jax.device_get(phi))


def run_nbody_gpu_tree(phase_space, masses, time_start, time_end, dt,
                       softening=0.05, G: float = G_DEFAULT,
                       theta: float = 0.6, nleaf: int = 64, ncrit: int = 64,
                       level_split: int = 5, **kwargs):
    """KDK integration through the tree-tier backend (reference
    ``run_nbody_gpu_tree``, tree_gpu/run_gpu_tree.py:142).

    Routes to the sharded-direct integrator (multi-chip when a mesh is
    available, single-chip Pallas otherwise); all ``run_nbody`` kwargs
    (snapshots, restart, watchdog ``step_timeout_s``, external
    potentials, ``force_extra`` ...) pass through.
    """
    from .run import run_nbody

    _note_exact(theta)
    kwargs.setdefault("kernel", "plummer")  # the reference tree's kernel
    if len(jax.devices()) > 1:
        kwargs.setdefault("impl", "sharded")
    return run_nbody(phase_space, masses, time_start, time_end, dt,
                     softening=softening, G=G, **kwargs)
