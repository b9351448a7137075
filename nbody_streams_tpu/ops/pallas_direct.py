"""Pallas (Triton route) kernel for O(N^2) all-pairs forces and potentials.

GPU translation of the reference's shared-memory-tiled CUDA kernels
(reference: cuda_kernels.py:18-180 — 128-thread blocks, one thread per
target, a 128-wide float4 source tile, Kahan variants):

CUDA concept                      ->  this kernel
---------------------------------------------------------------------------
one block of targets              ->  one program (grid axis 0) of ``bt``
                                      targets; nothing is carried between
                                      programs
loop over shared-memory tiles     ->  ``lax.fori_loop`` over ``bs``-wide
                                      source tiles inside the program
                                      (Triton pipelines the tile loads over
                                      ``num_stages``)
per-thread accumulators / Kahan   ->  (bt,) register accumulators, tile sums
                                      combined across tiles with two-sum
                                      compensation
branch-free ``not_self`` multiply ->  no mask in force mode (the self pair
                                      has dx == 0 exactly and eps2 > 0 keeps
                                      the factor finite); potential mode
                                      masks equal global indices in-kernel
float4 AoS                        ->  SoA float32 vectors, padded to whole
                                      blocks (zero-mass source padding)

Compact support.  With ``sorted_src`` the sources arrive slab-sorted by x
with per-tile x-bounds, and each program tests each source tile against
its own x-range widened by ``max(h)``: a tile that is provably farther
than every pair's softening length is exactly Newtonian for the spline
kernel and takes the ~half-cost Newtonian factor.  The test is uniform
across the program, so the untaken branch costs nothing, and it is exact
for ANY source order (a stale order only makes fewer tiles far).

Masses arrive pre-multiplied by G.  Pair rule ``h_eff = max(h_i, h_j)``
and ``eps2`` regularisation match the reference and ops/pairwise.py (the
test oracle for this file).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..constants import PAIRWISE_EPS2
from .slab import slab_sort_key, uses_spatial_sort

__all__ = ["pallas_accel", "pallas_potential", "pallas_accel_2set",
           "pallas_potential_2set", "block_config"]

# Per-pair softening via precomputed per-particle quantities:
# h_eff = max(h_i, h_j)  <=>  h2_eff = max(h_i^2, h_j^2)
#                        <=>  hinv_eff = min(1/h_i, 1/h_j)  (h >= 0),
# so the kernels below receive h^2 (plummer/dehnen) or 1/h (spline)
# directly and never re-derive them per pair.


def _force_pre(kind, r2, pre):
    """force_factor with the precomputed pair quantity `pre`."""
    if kind == "plummer":
        inv = lax.rsqrt(r2 + pre)
        return inv * inv * inv
    if kind == "dehnen_k1":
        inv = lax.rsqrt(r2 + pre)
        inv_d = inv * inv
        inv_d32 = inv_d * inv
        return inv_d32 + 1.5 * pre * (inv_d32 * inv_d)
    if kind == "dehnen_k2":
        inv = lax.rsqrt(r2 + pre)
        inv_d = inv * inv
        inv_d32 = inv_d * inv
        inv_d52 = inv_d32 * inv_d
        # h^4 / d^3.5 as (h^2/d) (h^2/d^2.5): d^-3.5 overflows float32
        # for an unsoftened self pair (d = eps2), and 0 * inf is NaN
        return (inv_d32 + 1.5 * pre * inv_d52
                + 3.75 * (pre * inv_d) * (pre * inv_d52))
    if kind == "newtonian":
        inv = lax.rsqrt(r2)
        return inv * inv * inv
    if kind == "spline":
        # pre = 1/h (inf for h == 0)
        inv_r = lax.rsqrt(r2)
        r = r2 * inv_r
        newton = inv_r * inv_r * inv_r
        hinv = pre
        h3inv = hinv * hinv * hinv
        q = r * hinv
        q2 = q * q
        # no q ~ 0 special case: eps2 > 0 keeps q finite and the inner
        # polynomial evaluates to the exact centre value h3inv * 32/3
        inner = h3inv * (q2 * (32.0 * q - 38.4) + 10.666666666666666)
        outer = h3inv * (
            21.333333333333333
            + q * (-48.0 + q * (38.4 - 10.666666666666667 * q))
        ) - 0.0666666666666667 * newton
        soft = jnp.where(q <= 0.5, inner, outer)
        return jnp.where(q >= 1.0, newton, soft)
    raise ValueError(kind)


def _pot_pre(kind, r2, pre):
    """potential_factor with the precomputed pair quantity `pre`."""
    if kind == "plummer":
        return -lax.rsqrt(r2 + pre)
    if kind == "dehnen_k1":
        inv = lax.rsqrt(r2 + pre)
        inv_d32 = inv * inv * inv
        return -inv - 0.5 * pre * inv_d32
    if kind == "dehnen_k2":
        inv = lax.rsqrt(r2 + pre)
        inv_d32 = inv * inv * inv
        inv_d52 = inv_d32 * inv * inv
        return -inv - 0.5 * pre * inv_d32 - 0.375 * (pre * pre) * inv_d52
    if kind == "newtonian":
        return -lax.rsqrt(r2)
    if kind == "spline":
        inv_r = lax.rsqrt(r2)
        r = r2 * inv_r
        newton = -inv_r
        hinv = pre
        q = r * hinv
        q2 = q * q
        # q2 nesting (not the reference's q4 — see ops/kernels.py note):
        # this is the true antiderivative of the force kernel
        inner = (-2.8 + q2 * (5.333333333333333
                              + q2 * (6.4 * q - 9.6))) * hinv
        outer = (
            -3.2
            + q2 * (10.666666666666666
                    + q * (-16.0 + q * (9.6 - 2.1333333333333333 * q)))
        ) * hinv + 0.06666666666666667 * inv_r
        soft = jnp.where(q <= 0.5, inner, outer)
        return jnp.where(q >= 1.0, newton, soft)
    raise ValueError(kind)


def _soft_pre(kind, h):
    """Per-particle precomputed softening quantity (see _force_pre)."""
    if kind == "spline":
        return jnp.where(h > 0, 1.0 / h, jnp.inf)
    return h * h


# Block geometry: BT targets per program, BS sources per tile, KT tiles
# between two reductions of the (BT, BS) accumulators (the Kahan step
# then runs once per BS*KT sources).  Powers of two (Triton's tensor
# sizes); small problems shrink BT and BS to the next power of two so
# padding stays bounded.
BT = 128
BS = 8
KT = 32
NUM_WARPS = 4
NUM_STAGES = 2


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def block_config(nt: int, ns: int) -> tuple[int, int, int]:
    """(targets per program, sources per tile, tiles per reduction) for
    an (nt x ns) call.  Sources are padded to a multiple of bs * kt."""
    bt = min(BT, max(16, _next_pow2(nt)))
    bs = min(BS, max(8, _next_pow2(ns)))
    kt = min(KT, _next_pow2(-(-ns // bs)))
    return bt, bs, kt


def _kernel(*refs, kind, mode, kahan, eps2, bt, bs, kt, n_super,
            mask_self, sorted_src):
    if sorted_src:
        (xt_ref, yt_ref, zt_ref, pt_ref, xs_ref, ys_ref, zs_ref, ms_ref,
         ps_ref, tlo_ref, thi_ref, slo_ref, shi_ref, *out_refs) = refs
    else:
        (xt_ref, yt_ref, zt_ref, pt_ref, xs_ref, ys_ref, zs_ref, ms_ref,
         ps_ref, *out_refs) = refs
    i = pl.program_id(0)
    xt = xt_ref[...][:, None]                       # (bt, 1)
    yt = yt_ref[...][:, None]
    zt = zt_ref[...][:, None]
    pt = pt_ref[...][:, None]
    iglob = i * bt + lax.broadcasted_iota(jnp.int32, (bt, 1), 0)
    width = 3 if mode == "acc" else 1

    def tile(k, kk, masked, acc):
        """Add one (bt, bs) tile of pair terms to the 2-D accumulators
        (no reduction here: that happens once per kt tiles)."""
        start = pl.multiple_of(k * bs, bs)
        sl = pl.ds(start, bs)
        dx = xs_ref[sl][None, :] - xt              # (bt, bs)
        dy = ys_ref[sl][None, :] - yt
        dz = zs_ref[sl][None, :] - zt
        gm = ms_ref[sl][None, :]
        # fma-chained with eps2 folded into the innermost term
        r2 = dx * dx + (dy * dy + (dz * dz + eps2))
        if kk == "newtonian":
            pre = None
        elif kk == "spline":
            pre = jnp.minimum(pt, ps_ref[sl][None, :])
        else:
            pre = jnp.maximum(pt, ps_ref[sl][None, :])
        if mode == "acc":
            s = gm * _force_pre(kk, r2, pre)
            return (acc[0] + s * dx, acc[1] + s * dy, acc[2] + s * dz)
        u = gm * _pot_pre(kk, r2, pre)
        if masked:
            jglob = start + lax.broadcasted_iota(jnp.int32, (1, bs), 1)
            u = jnp.where(iglob == jglob, 0.0, u)
        return (acc[0] + u,)

    if sorted_src:
        tlo = tlo_ref[i]
        thi = thi_ref[i]

    def inner(k, acc):
        if sorted_src:
            # far tiles never hold a target of this block, so they need
            # no self mask
            far = jnp.logical_or(shi_ref[k] < tlo, slo_ref[k] > thi)
            return lax.cond(far, lambda a: tile(k, "newtonian", False, a),
                            lambda a: tile(k, kind, mask_self, a), acc)
        return tile(k, kind, mask_self, acc)

    zero2 = tuple(jnp.zeros((bt, bs), jnp.float32) for _ in range(width))

    def outer(j, carry):
        tot, comp = carry
        acc = lax.fori_loop(j * kt, (j + 1) * kt, inner, zero2)
        part = [jnp.sum(a, axis=1) for a in acc]
        if kahan:
            ys = [p - c for p, c in zip(part, comp)]
            ts = [t + y for t, y in zip(tot, ys)]
            comp = tuple((t - o) - y for t, o, y in zip(ts, tot, ys))
            tot = tuple(ts)
        else:
            tot = tuple(t + p for t, p in zip(tot, part))
        return tot, comp

    zero = tuple(jnp.zeros((bt,), jnp.float32) for _ in range(width))
    tot, _ = lax.fori_loop(0, n_super, outer, (zero, zero))
    for o_ref, t in zip(out_refs, tot):
        o_ref[...] = t


@functools.partial(
    jax.jit,
    static_argnames=("kind", "kahan", "mode", "eps2", "mask_self",
                     "interpret"),
)
def _pallas_direct(pos_t, pre_t, pos_s, gmass_s, pre_s, bounds=None, *,
                   kind, kahan, mode, eps2, mask_self=False,
                   interpret=False):
    """Core call.  ``pre_*`` are the precomputed softening quantities
    (_soft_pre).  ``bounds=(tlo, thi, slo, shi)`` selects the sorted
    compact-support form: per-target-block x-bounds already widened by
    max(h), and per-source-tile x-bounds, for the padded geometry
    ``block_config`` gives."""
    nt = pos_t.shape[0]
    ns = pos_s.shape[0]
    bt, bs, kt = block_config(nt, ns)
    nt_pad = -(-nt // bt) * bt
    ns_pad = -(-ns // (bs * kt)) * (bs * kt)

    def pad(a, n):
        return jnp.pad(a, (0, n - a.shape[0]))

    tgt = [pad(pos_t[:, 0], nt_pad), pad(pos_t[:, 1], nt_pad),
           pad(pos_t[:, 2], nt_pad), pad(pre_t, nt_pad)]
    src = [pad(pos_s[:, 0], ns_pad), pad(pos_s[:, 1], ns_pad),
           pad(pos_s[:, 2], ns_pad), pad(gmass_s, ns_pad),
           pad(pre_s, ns_pad)]
    t_spec = pl.BlockSpec((bt,), lambda i: (i,))
    s_spec = pl.BlockSpec((ns_pad,), lambda i: (0,))
    in_specs = [t_spec] * 4 + [s_spec] * 5
    args = tgt + src
    if bounds is not None:
        in_specs += [pl.BlockSpec((b.shape[0],), lambda i: (0,))
                     for b in bounds]
        args += list(bounds)
    width = 3 if mode == "acc" else 1
    kernel = functools.partial(
        _kernel, kind=kind, mode=mode, kahan=kahan, eps2=eps2, bt=bt,
        bs=bs, kt=kt, n_super=ns_pad // (bs * kt), mask_self=mask_self,
        sorted_src=bounds is not None)
    # Trace with x64 off: every value here is explicitly f32/i32, and an
    # int64 loop index would leak into the Triton lowering.
    with jax.enable_x64(False):
        out = pl.pallas_call(
            kernel,
            grid=(nt_pad // bt,),
            in_specs=in_specs,
            out_specs=[t_spec] * width,
            out_shape=[jax.ShapeDtypeStruct((nt_pad,), jnp.float32)] * width,
            compiler_params=pltriton.CompilerParams(
                num_warps=NUM_WARPS, num_stages=NUM_STAGES),
            interpret=interpret,
            name=f"direct_{mode}_{kind}",
        )(*args)
    if mode == "acc":
        return jnp.stack(out, axis=1)[:nt]
    return out[0][:nt]


def _pallas_self_sorted(pos, gmass, soft, kind, kahan, mode, eps2,
                        interpret=False, order=None):
    """Self-gravity over slab-sorted sources with the per-tile
    compact-support test (see module docstring).

    ``order`` may supply a precomputed (possibly stale) slab order: the
    integrator re-sorts once per scanned chunk instead of per force
    call.  Any permutation is exact here: the tile bounds are recomputed
    from the actual positions every call."""
    if order is None:
        order = slab_sort_key(pos)
    ps = pos[order]
    gs = gmass[order]
    hs = soft[order]
    pre = _soft_pre(kind, hs)
    n = ps.shape[0]
    bt, bs, kt = block_config(n, n)
    # edge-pad x for the bounds so padding never widens a block's range
    x = ps[:, 0]
    ns_pad = -(-n // (bs * kt)) * (bs * kt)
    xt = jnp.pad(x, (0, -(-n // bt) * bt - n), mode="edge").reshape(-1, bt)
    xs = jnp.pad(x, (0, ns_pad - n), mode="edge").reshape(-1, bs)
    h_max = jnp.max(hs)
    bounds = (xt.min(axis=1) - h_max, xt.max(axis=1) + h_max,
              xs.min(axis=1), xs.max(axis=1))
    out = _pallas_direct(ps, pre, ps, gs, pre, bounds, kind=kind,
                         kahan=kahan, mode=mode, eps2=eps2,
                         mask_self=mode == "pot", interpret=interpret)
    return jnp.zeros_like(out).at[order].set(out)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def pallas_accel_2set(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan,
                      eps2=PAIRWISE_EPS2, interpret=False):
    """Accelerations of targets due to sources (G folded into gmass_s)."""
    return _pallas_direct(
        pos_t.astype(jnp.float32),
        _soft_pre(kind, soft_t.astype(jnp.float32)),
        pos_s.astype(jnp.float32), gmass_s.astype(jnp.float32),
        _soft_pre(kind, soft_s.astype(jnp.float32)),
        kind=kind, kahan=kahan, mode="acc", eps2=float(eps2),
        interpret=interpret)


def pallas_potential_2set(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan,
                          eps2=PAIRWISE_EPS2, interpret=False,
                          mask_self=False):
    """Potential of targets due to sources.

    ``mask_self=True`` excludes pairs at identical row index — use it
    when targets and sources are the *same* array (single-device path,
    or the self-block step of the sharded ring).  An outside closed-form
    subtraction would cancel catastrophically for h = 0 particles (the
    self term is -G m / sqrt(eps2) ~ 1e7 x the physical potential in
    fp32), so the exclusion happens in-kernel.
    """
    return _pallas_direct(
        pos_t.astype(jnp.float32),
        _soft_pre(kind, soft_t.astype(jnp.float32)),
        pos_s.astype(jnp.float32), gmass_s.astype(jnp.float32),
        _soft_pre(kind, soft_s.astype(jnp.float32)),
        kind=kind, kahan=kahan, mode="pot", eps2=float(eps2),
        mask_self=mask_self, interpret=interpret)


def _self(mode, pos, mass, soft, G, kind, kahan, eps2, interpret,
          spatial_sort, order):
    gmass = (mass * G).astype(jnp.float32)
    soft = soft.astype(jnp.float32)
    pos = pos.astype(jnp.float32)
    if uses_spatial_sort(kind, pos.shape[0], spatial_sort):
        return _pallas_self_sorted(pos, gmass, soft, kind, kahan, mode,
                                   float(eps2), interpret, order=order)
    pre = _soft_pre(kind, soft)
    return _pallas_direct(pos, pre, pos, gmass, pre, kind=kind,
                          kahan=kahan, mode=mode, eps2=float(eps2),
                          mask_self=mode == "pot", interpret=interpret)


def pallas_accel(pos, mass, soft, G, kind, kahan, eps2=PAIRWISE_EPS2,
                 interpret=False, spatial_sort=None, order=None):
    """(N, 3) float32 self-gravity accelerations (single device).

    ``spatial_sort`` (default: auto for the spline kernel at N >= 16384)
    slab-sorts the sources so far tiles take the Newtonian factor; every
    pair still gets its exact kernel factor, but the summation order
    differs from the unsorted call, so results agree to fp32 round-off
    (not bitwise).  ``order`` optionally supplies a precomputed slab
    order (exact even when stale)."""
    return _self("acc", pos, mass, soft, G, kind, kahan, eps2, interpret,
                 spatial_sort, order)


def pallas_potential(pos, mass, soft, G, kind, kahan, eps2=PAIRWISE_EPS2,
                     interpret=False, spatial_sort=None, order=None):
    """(N,) float32 self-gravity potential (self pair masked in-kernel)."""
    return _self("pot", pos, mass, soft, G, kind, kahan, eps2, interpret,
                 spatial_sort, order)
