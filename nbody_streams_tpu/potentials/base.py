"""Potential base class: autodiff-derived forces, Agama-compatible surface.

Redesign of the reference's GPU potential stack
(reference: agama_helper/_analytic_potentials.py:87-171 `_AnalyticBase`,
_potential.py:85-101 `_GPUPotBase`): where the reference hand-writes four
CUDA kernels per potential (phi/rho/grad/hess), here each potential defines
a single scalar field ``phi_point(xyz, t)`` and JAX autodiff supplies
gradients, Hessians and densities (Laplacian / 4 pi G) — exactly
consistent with each other by construction, fused by XLA, and usable
directly inside the jitted KDK step.

Public surface (Agama conventions, matching the reference):

* ``potential(xyz, t)``  -> Phi, (km/s)^2
* ``force(xyz, t)``      -> -grad Phi, (km/s)^2/kpc
* ``density(xyz, t)``    -> Laplacian Phi / (4 pi G), Msun/kpc^3
* ``forceDeriv(xyz, t)`` -> (force, -hess6) with hess6 = [xx,yy,zz,xy,yz,xz]
* ``evalDeriv``, ``eval(pot=, acc=, der=)`` — Agama-compatible combos
* ``+`` composition -> CompositePotential
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import G_DEFAULT

__all__ = ["Potential", "CompositePotential"]

FOUR_PI_G = 4.0 * jnp.pi * G_DEFAULT


def _prep(xyz):
    """Coerce any (..., 3) input to a flat (N, 3) batch.

    Returns (arr (N, 3), lead) where ``lead`` is the original leading
    shape (``None`` for a single (3,) point) — ``_out`` restores it.
    The vmapped evaluators only batch one axis, so higher-rank inputs
    MUST be flattened here (feeding a (S, N, 3) array through a single
    vmap would hand whole blocks to phi_point and silently collapse
    them to one scalar each).
    """
    arr = jnp.asarray(xyz)
    if arr.ndim == 0 or arr.shape[-1] != 3:
        raise ValueError(f"positions must be (..., 3), got {arr.shape}")
    if arr.dtype not in (jnp.float32, jnp.float64):
        # integer/bool input: promote to the DEFAULT float width —
        # float64 under x64 (hard-coding float32 here would silently
        # degrade the float64 validation pipeline to 1e-7 accuracy)
        arr = arr.astype(jnp.result_type(float))
    if arr.ndim == 1:
        return arr[None, :], None
    lead = arr.shape[:-1]
    return arr.reshape(-1, 3), lead


def _out(val, lead):
    if lead is None:
        return val[0]
    return val.reshape(lead + val.shape[1:])


def _hess6(h):
    """(3,3) Hessian -> Agama 6-vector [xx, yy, zz, xy, yz, xz]."""
    return jnp.stack([h[0, 0], h[1, 1], h[2, 2], h[0, 1], h[1, 2], h[0, 2]])


class Potential:
    """Base class; subclasses implement ``phi_point(xyz3, t) -> scalar``."""

    #: Subclasses flip this when Phi genuinely depends on t (modifiers do).
    time_dependent: bool = False

    # -- to implement -------------------------------------------------------
    def phi_point(self, xyz, t):
        raise NotImplementedError

    # -- derived, vmapped ---------------------------------------------------
    def _phi_v(self, arr, t):
        return jax.vmap(lambda p: self.phi_point(p, t))(arr)

    def _force_v(self, arr, t):
        g = jax.grad(lambda p: self.phi_point(p, t))
        return -jax.vmap(g)(arr)

    def _hess_v(self, arr, t):
        h = jax.hessian(lambda p: self.phi_point(p, t))
        return jax.vmap(lambda p: _hess6(h(p)))(arr)

    def _phi_force_v(self, arr, t):
        """(phi, force) sharing ONE forward pass via value_and_grad —
        halves the cost of combined queries (eval/evalDeriv) for plain
        potentials.  Subclasses with bespoke _phi_v/_force_v fast paths
        fall back to their own implementations."""
        if (type(self)._phi_v is Potential._phi_v
                and type(self)._force_v is Potential._force_v):
            vg = jax.value_and_grad(lambda p: self.phi_point(p, t))
            phi, g = jax.vmap(vg)(arr)
            return phi, -g
        return self._phi_v(arr, t), self._force_v(arr, t)

    # -- public (Agama-compatible) -----------------------------------------
    def potential(self, xyz, t=0.0):
        arr, single = _prep(xyz)
        return _out(self._phi_v(arr, t), single)

    def force(self, xyz, t=0.0):
        arr, single = _prep(xyz)
        return _out(self._force_v(arr, t), single)

    def density(self, xyz, t=0.0):
        arr, single = _prep(xyz)
        h6 = self._hess_v(arr, t)
        rho = (h6[:, 0] + h6[:, 1] + h6[:, 2]) / FOUR_PI_G
        return _out(rho, single)

    def forceDeriv(self, xyz, t=0.0):
        arr, single = _prep(xyz)
        f = self._force_v(arr, t)
        d = -self._hess_v(arr, t)
        return _out(f, single), _out(d, single)

    def evalDeriv(self, xyz, t=0.0):
        arr, single = _prep(xyz)
        phi, f = self._phi_force_v(arr, t)
        d = -self._hess_v(arr, t)
        return _out(phi, single), _out(f, single), _out(d, single)

    def eval(self, xyz, pot: bool = False, acc: bool = False,
             der: bool = False, t=0.0):
        if not (pot or acc or der):
            raise ValueError("eval(): request at least one of pot/acc/der")
        arr, single = _prep(xyz)
        results = []
        if pot and acc:
            phi, f = self._phi_force_v(arr, t)
            results += [_out(phi, single), _out(f, single)]
        elif pot:
            results.append(_out(self._phi_v(arr, t), single))
        elif acc:
            results.append(_out(self._force_v(arr, t), single))
        if der:
            results.append(_out(-self._hess_v(arr, t), single))
        return results[0] if len(results) == 1 else tuple(results)

    # -- composition --------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Potential):
            return NotImplemented
        parts = []
        for p in (self, other):
            parts.extend(p.components if isinstance(p, CompositePotential)
                         else [p])
        return CompositePotential(parts)

    def __radd__(self, other):
        if other == 0:  # support sum()
            return self
        return self.__add__(other)


class CompositePotential(Potential):
    """Sum of member potentials (reference: _potential.py:1617)."""

    def __init__(self, components):
        self.components = list(components)
        if not self.components:
            raise ValueError("CompositePotential needs >= 1 component")
        self.time_dependent = any(c.time_dependent for c in self.components)

    def phi_point(self, xyz, t):
        return sum(c.phi_point(xyz, t) for c in self.components)

    # Sum member implementations directly (lets members override their own
    # fast paths instead of autodiffing through the sum).
    def _phi_v(self, arr, t):
        return sum(c._phi_v(arr, t) for c in self.components)

    def _force_v(self, arr, t):
        return sum(c._force_v(arr, t) for c in self.components)

    def _hess_v(self, arr, t):
        return sum(c._hess_v(arr, t) for c in self.components)

    def _phi_force_v(self, arr, t):
        parts = [c._phi_force_v(arr, t) for c in self.components]
        return (sum(p for p, _ in parts), sum(f for _, f in parts))

    def __len__(self):
        return len(self.components)

    def __getitem__(self, i):
        return self.components[i]
