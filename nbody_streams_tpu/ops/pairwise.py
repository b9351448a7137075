"""Reference O(N^2) pairwise force / potential evaluation in pure jax.numpy.

This is the *oracle* implementation: dtype-polymorphic, runs on any backend
(float64 for validation, float32 where no faster path exists), and is the
ground truth that the Pallas fast path (`ops/pallas_direct.py`) and the
mesh-sharded path (`parallel/sharded.py`) are tested against.

Design notes:

* The N^2 interaction matrix is never materialised at full size.  Targets are
  processed in blocks of ``block_size`` via ``lax.map`` and sources are
  streamed in blocks via ``lax.scan``, so peak memory is
  O(block_size^2) regardless of N, and every intermediate is a
  (block, block) fp array that XLA fuses into one elementwise kernel.
* Pairwise convention matches the reference framework exactly
  (reference: cuda_kernels.py:105-180): softening pair rule
  ``h_eff = max(h_i, h_j)``, additive ``eps2 = 1e-15`` regularisation inside
  r^2, branch-free self-exclusion by global-index comparison, and zero-mass
  padding of partial tiles.
* ``precision='float32_kahan'`` keeps within-block sums in fp32 (tree
  reduction) and applies compensated (two-sum/Kahan) accumulation *across*
  source blocks, recovering near-fp64 force accuracy at fp32 speed.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    G_DEFAULT,
    PAIRWISE_EPS2,
    validate_kernel,
    validate_precision,
)
from .kernels import force_factor, potential_factor

__all__ = [
    "compute_forces_direct",
    "compute_potential_direct",
    "accel_tile",
    "potential_tile",
    "kahan_add",
]


def kahan_add(total, comp, delta):
    """One compensated (Kahan) accumulation step: returns (total', comp')."""
    y = delta - comp
    t = total + y
    comp = (t - total) - y
    return t, comp


# ---------------------------------------------------------------------------
# Tile primitives (shared with the sharded ring path)
# ---------------------------------------------------------------------------

def accel_tile(kind, pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s,
               eps2=PAIRWISE_EPS2):
    """Un-scaled acceleration of target tile due to source tile.

    Parameters
    ----------
    pos_t : (TM, 3), h_t : (TM,), idx_t : (TM,) int32 global indices
    pos_s : (TN, 3), m_s/h_s : (TN,), idx_s : (TN,) int32 global indices

    Returns
    -------
    (TM, 3) sum over sources of ``m_j * w(r2, h_eff) * (x_j - x_i)``
    (caller multiplies by G).  Self pairs (same global index) and padded
    sources (mass 0) contribute exactly zero.
    """
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + jnp.asarray(eps2, dx.dtype)
    h_eff = jnp.maximum(h_t[:, None], h_s[None, :])
    w = force_factor(kind, r2, h_eff)
    not_self = (idx_t[:, None] != idx_s[None, :]).astype(w.dtype)
    s = m_s[None, :] * w * not_self
    ax = jnp.sum(s * dx, axis=1)
    ay = jnp.sum(s * dy, axis=1)
    az = jnp.sum(s * dz, axis=1)
    return jnp.stack([ax, ay, az], axis=-1)


def potential_tile(kind, pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s,
                   eps2=PAIRWISE_EPS2):
    """Un-scaled potential of target tile due to source tile: (TM,)."""
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + jnp.asarray(eps2, dx.dtype)
    h_eff = jnp.maximum(h_t[:, None], h_s[None, :])
    u = potential_factor(kind, r2, h_eff)
    not_self = (idx_t[:, None] != idx_s[None, :]).astype(u.dtype)
    s = m_s[None, :] * u * not_self
    return jnp.sum(s, axis=1)


# ---------------------------------------------------------------------------
# Full O(N^2) evaluation, blocked
# ---------------------------------------------------------------------------

def _pad_to(arr, n, axis=0):
    pad = n - arr.shape[axis]
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return jnp.pad(arr, widths)


def _choose_block(n):
    # Keep (B, B) fp32 tiles around a few MB; small problems use one block.
    b = 1 << max(4, min(11, math.ceil(math.log2(max(n, 2)))))
    return min(b, 2048)


@functools.partial(
    jax.jit,
    static_argnames=("kind", "kahan", "block_size", "mode"),
)
def _pairwise_blocked(pos, mass, soft, G, kind, kahan, block_size, mode,
                      eps2):
    n = pos.shape[0]
    nb = -(-n // block_size)
    npad = nb * block_size
    dtype = pos.dtype

    posp = _pad_to(pos, npad)
    massp = _pad_to(mass, npad)
    softp = _pad_to(soft, npad)
    idx = jnp.arange(npad, dtype=jnp.int32)

    # (nb, B, ...) stacked blocks
    pos_b = posp.reshape(nb, block_size, 3)
    m_b = massp.reshape(nb, block_size)
    h_b = softp.reshape(nb, block_size)
    i_b = idx.reshape(nb, block_size)

    tile = accel_tile if mode == "acc" else potential_tile
    out_shape = (block_size, 3) if mode == "acc" else (block_size,)

    def per_target_block(tb):
        pos_t, h_t, idx_t = tb

        def scan_src(carry, sb):
            total, comp = carry
            pos_s, m_s, h_s, idx_s = sb
            part = tile(kind, pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s,
                        eps2=eps2)
            if kahan:
                total, comp = kahan_add(total, comp, part)
            else:
                total = total + part
            return (total, comp), None

        init = (jnp.zeros(out_shape, dtype), jnp.zeros(out_shape, dtype))
        (total, _), _ = lax.scan(scan_src, init, (pos_b, m_b, h_b, i_b))
        return total

    out = lax.map(per_target_block, (pos_b, h_b, i_b))
    out = out.reshape((npad,) + out_shape[1:])[:n]
    return G * out


def _prepare(pos, mass, softening, precision, kernel):
    validate_kernel(kernel)
    validate_precision(precision)
    dtype = jnp.float64 if precision == "float64" else jnp.float32
    if precision == "float64" and not jax.config.jax_enable_x64:
        raise ValueError(
            "precision='float64' requires x64 mode; call "
            "jax.config.update('jax_enable_x64', True) first"
        )
    pos = jnp.asarray(pos, dtype)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {pos.shape}")
    n = pos.shape[0]
    mass = jnp.asarray(mass, dtype)
    if mass.ndim == 0:
        mass = jnp.full((n,), mass, dtype)
    if mass.shape != (n,):
        raise ValueError(f"mass must be scalar or (N,), got {mass.shape}")
    soft = jnp.asarray(softening, dtype)
    if soft.ndim == 0:
        soft = jnp.full((n,), soft, dtype)
    if soft.shape != (n,):
        raise ValueError(
            f"softening must be scalar or (N,), got {soft.shape}"
        )
    return pos, mass, soft, dtype


def compute_forces_direct(
    pos,
    mass,
    softening=0.0,
    G: float = G_DEFAULT,
    kernel: str = "spline",
    precision: str = "float32_kahan",
    block_size: int | None = None,
    eps2: float = PAIRWISE_EPS2,
):
    """O(N^2) softened gravitational accelerations, pure-jnp reference path.

    Equivalent surface to the reference's ``compute_nbody_forces_{gpu,cpu}``
    (reference: fields.py:664,1021): per-particle softening with the
    max-pair rule, five kernels, selectable precision.

    Returns ``acc`` of shape (N, 3) in the precision's dtype.
    """
    pos, mass, soft, dtype = _prepare(pos, mass, softening, precision, kernel)
    n = pos.shape[0]
    bs = block_size or _choose_block(n)
    return _pairwise_blocked(
        pos, mass, soft, jnp.asarray(G, dtype), kernel,
        precision == "float32_kahan", bs, "acc", eps2,
    )


def compute_potential_direct(
    pos,
    mass,
    softening=0.0,
    G: float = G_DEFAULT,
    kernel: str = "spline",
    precision: str = "float32_kahan",
    block_size: int | None = None,
    eps2: float = PAIRWISE_EPS2,
):
    """O(N^2) softened gravitational potential per particle, shape (N,)."""
    pos, mass, soft, dtype = _prepare(pos, mass, softening, precision, kernel)
    n = pos.shape[0]
    bs = block_size or _choose_block(n)
    return _pairwise_blocked(
        pos, mass, soft, jnp.asarray(G, dtype), kernel,
        precision == "float32_kahan", bs, "pot", eps2,
    )
