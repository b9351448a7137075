"""Mesh-sharded direct summation: the multi-chip force backend.

This replaces the reference's C++/CUDA Barnes-Hut tree tier
(reference: tree_gpu/, ~4.3k LoC) with an exact scaling strategy:
O(N^2/D) direct summation, particles sharded over a 1-D device mesh,
source blocks ring-permuted between devices (NVLink on a GPU host, where
every card reaches every other at the same rate, so the mesh is a plain
ring).

Algorithm (classic systolic ring, the N-body analogue of ring attention):

1. Particles are block-sharded over mesh axis ``'shards'``: each device
   owns N/D targets (positions, G-premultiplied masses, softenings).
2. For D ring steps, every device computes the partial forces of its
   resident targets against the currently-held source block (the Pallas
   kernel in its two-set form on a GPU, the blocked jnp tile elsewhere),
   then
   ``lax.ppermute``s the source block to its ring neighbour.  The permute
   of the *next* block is independent of the current tile computation, so
   XLA's async collective-permute overlaps communication with compute.
3. Partial sums accumulate with two-sum (Kahan) compensation across ring
   steps (precision equivalent to the single-chip kahan path).

Self-interactions need no masking in force mode (dx == 0 exactly for the
self pair, eps2 > 0 keeps the kernel finite); the potential path masks
the self pair in-kernel on the ring step that holds the local block.

Diagnostics (energy, momentum) reduce with ``psum`` over the same axis.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import PAIRWISE_EPS2
from ..ops import pairwise

__all__ = ["ShardedDirect", "make_particle_mesh",
           "slab_sort_for_sharding"]

AXIS = "shards"


def make_particle_mesh(devices=None) -> Mesh:
    """1-D mesh over the particle axis (the only meaningful axis for
    direct N-body; cf. SURVEY.md section 2.5)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def _tile_blocked(mode, kind, kahan, block, eps2,
                  pos_t, h_t, idx_t, pos_s, m_s, h_s, idx_s):
    """Blocked jnp fallback tile: targets (Nt) x sources (Ns),
    ``mode`` = 'acc' (forces, (Nt, 3)) or 'pot' (potential, (Nt,))."""
    ns = pos_s.shape[0]
    nb = -(-ns // block)
    npad = nb * block
    pos_sp = jnp.pad(pos_s, ((0, npad - ns), (0, 0)))
    m_sp = jnp.pad(m_s, (0, npad - ns))
    h_sp = jnp.pad(h_s, (0, npad - ns))
    idx_sp = jnp.pad(idx_s, (0, npad - ns), constant_values=-1)
    tile_fn = pairwise.accel_tile if mode == "acc" else pairwise.potential_tile

    def scan_fn(carry, sb):
        total, comp = carry
        ps, ms, hs, js = sb
        part = tile_fn(kind, pos_t, h_t, idx_t, ps, ms, hs, js, eps2=eps2)
        if kahan:
            total, comp = pairwise.kahan_add(total, comp, part)
        else:
            total = total + part
        return (total, comp), None

    # zeros_like keeps the shard_map varying-axis annotation of pos_t
    zero = jnp.zeros_like(pos_t if mode == "acc" else pos_t[:, 0])
    (total, _), _ = lax.scan(
        scan_fn, (zero, zero),
        (pos_sp.reshape(nb, block, 3), m_sp.reshape(nb, block),
         h_sp.reshape(nb, block), idx_sp.reshape(nb, block)),
    )
    return total


class ShardedDirect:
    """Ring-sharded direct summation bound to a DirectGravity solver.

    ``use_pallas=None`` auto-selects the Pallas tile kernel on GPU meshes
    (fp32 only) and the blocked jnp tile elsewhere.  Pass
    ``use_pallas=True, interpret=True`` to execute the Pallas ring tiles
    on a CPU mesh in Pallas interpret mode — how the multi-device kernel
    path is tested without GPUs (tests/test_sharded.py)."""

    def __init__(self, solver, mesh: Mesh | None = None,
                 use_pallas: bool | None = None, interpret: bool = False):
        self.solver = solver
        devices = solver.devices
        self.mesh = mesh or make_particle_mesh(devices)
        self.n_dev = self.mesh.devices.size
        n = solver.n
        self.npad = -(-n // self.n_dev) * self.n_dev
        self.n_local = self.npad // self.n_dev

        pad = self.npad - n
        gm = jnp.pad(solver.mass * solver.G, (0, pad)).astype(solver.dtype)
        h = jnp.pad(solver.softening, (0, pad)).astype(solver.dtype)
        shard = NamedSharding(self.mesh, P(AXIS))
        self.gmass = jax.device_put(gm, shard)
        self.soft = jax.device_put(h, shard)
        if use_pallas is None:
            use_pallas = self.mesh.devices.flat[0].platform == "gpu"
        # The Pallas tile kernel is fp32-only by design (as on the
        # single-chip path); fp64 solvers always take the jnp tile.
        self.use_pallas = bool(use_pallas) \
            and solver.dtype == jnp.float32
        self.interpret = bool(interpret)

    # -- ring kernels -------------------------------------------------------
    def _ring(self, mode, pos_l, gm_l, h_l):
        kind = self.solver.kernel
        kahan = self.solver.kahan
        eps2 = self.solver.eps2
        d = self.n_dev
        nl = self.n_local
        me = lax.axis_index(AXIS)
        perm = [(i, (i + 1) % d) for i in range(d)]
        local_idx = jnp.arange(nl, dtype=jnp.int32)
        idx_t = me.astype(jnp.int32) * nl + local_idx

        if mode == "acc":
            zero = jnp.zeros_like(pos_l)
        else:
            zero = jnp.zeros_like(pos_l[:, 0])

        interp = self.interpret

        def tile(src, r):
            ps, ms, hs = src
            if self.use_pallas:
                from ..ops import pallas_direct

                if mode == "acc":
                    if kind == "spline":
                        # compact support at block level: when the
                        # incoming ring block's x-interval is farther
                        # than max(h) from the local targets', every
                        # pair has r > h_eff and the spline IS the bare
                        # Newtonian factor — run the cheaper kernel
                        # (XLA-level cond: only the taken branch
                        # executes).  Fires when particles are
                        # slab-sorted before sharding; always correct.
                        gap = jnp.maximum(
                            jnp.min(pos_l[:, 0]) - jnp.max(ps[:, 0]),
                            jnp.min(ps[:, 0]) - jnp.max(pos_l[:, 0]))
                        far = gap > jnp.maximum(jnp.max(h_l),
                                                jnp.max(hs))
                        return lax.cond(
                            far,
                            lambda a: pallas_direct.pallas_accel_2set(
                                pos_l, h_l, a[0], a[1], a[2],
                                "newtonian", kahan, eps2,
                                interpret=interp),
                            lambda a: pallas_direct.pallas_accel_2set(
                                pos_l, h_l, a[0], a[1], a[2],
                                kind, kahan, eps2, interpret=interp),
                            (ps, ms, hs),
                        )
                    return pallas_direct.pallas_accel_2set(
                        pos_l, h_l, ps, ms, hs, kind, kahan, eps2,
                        interpret=interp)
                # mask the self pair on the step where the ring block is
                # the local block (r == 0): local row indices align
                return lax.cond(
                    r == 0,
                    lambda a: pallas_direct.pallas_potential_2set(
                        pos_l, h_l, a[0], a[1], a[2], kind, kahan, eps2,
                        interpret=interp, mask_self=True),
                    lambda a: pallas_direct.pallas_potential_2set(
                        pos_l, h_l, a[0], a[1], a[2], kind, kahan, eps2,
                        interpret=interp, mask_self=False),
                    (ps, ms, hs),
                )
            # jnp path: exact self-handling via global indices
            src_dev = (me - r) % d
            idx_s = src_dev.astype(jnp.int32) * nl + local_idx
            return _tile_blocked(mode, kind, kahan, min(1024, nl), eps2,
                                 pos_l, h_l, idx_t, ps, ms, hs, idx_s)

        def body(carry, r):
            total, comp, src = carry
            # Issue the permute first: independent of the tile compute, so
            # XLA can overlap the transfer with the tile kernel.
            src_next = tuple(lax.ppermute(a, AXIS, perm) for a in src)
            part = tile(src, r)
            total, comp = pairwise.kahan_add(total, comp, part)
            return (total, comp, src_next), None

        # d-1 permuting ring steps, then the last tile with no trailing
        # permute (its result would be discarded — one full source-block
        # transfer saved per evaluation)
        carry = (zero, jnp.zeros_like(zero), (pos_l, gm_l, h_l))
        if d > 1:
            carry, _ = lax.scan(body, carry,
                                jnp.arange(d - 1, dtype=jnp.int32))
        total, comp, src = carry
        part = tile(src, jnp.asarray(d - 1, jnp.int32))
        total, _ = pairwise.kahan_add(total, comp, part)
        return total

    # -- public ------------------------------------------------------------
    def _sharded_eval(self, mode, pos):
        n = self.solver.n
        # ghost-padded state (see shard_state): inputs arrive already at
        # the even npad length and keep it on output, so scanned KDK
        # steps never reshard
        padded_in = pos.shape[0] == self.npad and self.npad != n
        posp = pos if padded_in else jnp.pad(
            pos, ((0, self.npad - n), (0, 0)))

        fn = functools.partial(self._ring, mode)
        # check_vma=False: pallas_call outputs carry no varying-axis
        # annotation, which the vma checker (JAX >= 0.9) rejects inside
        # shard_map even though the program is correct.
        out = jax.shard_map(
            fn, mesh=self.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=P(AXIS),
            check_vma=False,
        )(posp, self.gmass, self.soft)
        return out if padded_in else out[:n]

    def accel(self, pos):
        return self._sharded_eval("acc", pos)

    def potential(self, pos):
        return self._sharded_eval("pot", pos)

    def shard_state(self, tree):
        """Place (N, ...) state arrays block-sharded over the mesh.

        When N is not divisible by the device count, arrays are first
        padded with ``npad - N`` zero rows — ghost particles.  Ghosts
        are exact by construction: their G-premultiplied mass is zero
        (padded at __init__), so they contribute nothing to any real
        row, and every mass-weighted diagnostic (energy, momentum,
        centre of mass) is ghost-blind.  The run_nbody driver freezes
        ghost rows (zero-masked acceleration) and strips them from
        every host-visible output; see docs/parallel.md.  Arrays
        already at the padded length are sharded as-is.
        """
        n, npad = self.solver.n, self.npad

        def put(x):
            if hasattr(x, "ndim") and x.ndim >= 1 \
                    and x.shape[0] in (n, npad):
                if x.shape[0] == n and npad != n:
                    x = jnp.concatenate(
                        [x, jnp.zeros((npad - n,) + x.shape[1:], x.dtype)])
                return jax.device_put(x, NamedSharding(
                    self.mesh, P(AXIS, *([None] * (x.ndim - 1)))))
            return x

        return jax.tree_util.tree_map(put, tree)


def slab_sort_for_sharding(phase_space, *arrays):
    """Order particles by x so block-sharding hands each device a thin
    slab.  With slab shards, all non-adjacent ring blocks are farther
    than max(h) from the local targets and take the compact-support
    Newtonian fast path (see ShardedDirect._ring) — on a D-device mesh
    that is ~(D-2)/D of the ring steps at ~16 ops/pair instead of ~29.

    Returns (phase_space[order], *arrays[order]).  Purely a performance
    transform: results are exact in any order.
    """
    phase_space = np.asarray(phase_space)
    order = np.argsort(phase_space[:, 0], kind="stable")
    return (phase_space[order],
            *(np.asarray(a)[order] for a in arrays))
