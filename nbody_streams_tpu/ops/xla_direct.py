"""Pure-XLA two-pass direct-summation backend (``impl='xla'``).

The spline kernel's compact support expressed as plain XLA ops
(``lax.scan`` over blocked tiles, which XLA fuses into elementwise
kernels): what XLA makes of the sorted direct sum without a
hand-written kernel.  On the GPU the Pallas kernel beats it end to end
(PERF.md); it stays as the plain-XLA path.

Algorithm (same maths as the sorted Pallas path, ops/pallas_direct.py,
split in two passes — reference analogue: the shared-memory tiled CUDA
kernel, reference cuda_kernels.py:18-180):

* slab-sort by x (order reusable across a scanned chunk via ``order=``),
* pass 1: ~16-op Newtonian kernel over all pairs with each target
  block's banded near-diagonal source window zeroed *by masking the
  source masses* at band-row granularity (exact: zero mass = zero
  contribution),
* pass 2: the full softened kernel over exactly that window
  (``dynamic_slice`` per target block), so every pair is computed once
  with its exact factor — no cancellation between passes.

The Monaghan spline is exactly Newtonian at ``r >= h_eff``, so the
split is pure bookkeeping; a fallback to the single-pass blocked
evaluation guards the case where ``max(h)`` is too large for the band
(exact for any particle order).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import PAIRWISE_EPS2
from .kernels import force_factor, potential_factor
from .pairwise import kahan_add

__all__ = ["xla_accel", "xla_potential", "uses_spatial_sort",
           "measure_band_rows"]

# Default geometry.  BS: target-block size (bigger amortises XLA loop
# overhead).  RS: band
# bookkeeping row size — the band window is resolved at RS-source
# granularity, so the quadratic-cost band fraction is
# ~(BS + slack·RS)/N instead of ~3·BS/N.
BS = 4096
RS = 512


def _nb_rows(bs: int, rs: int, npad: int) -> int:
    """Static band-window width in rows.

    Must cover one target block's own span (``bs/rs`` rows) plus the
    softening reach in row units.  The reach is data-dependent (rows
    within ``h_max`` of a block boundary: ~2*h_max*local_density/rs)
    and in row units it GROWS with N (same physical slab, finer rows):
    measured initial widths for the Plummer/h=0.05 bench population are
    16 / 22 / 34 / 111 rows at N = 64k / 128k / 256k / 1M.  The
    original ``rows/16`` floor under-provisioned the 128k-256k range
    (20 < 22, 32 < 34), which the in-scan poison guard turns into NaN
    — so the floor is ``rows/12 + 16``: proportional term above every
    measured width, constant term as drift cushion between in-scan
    order refreshes (measured drift ~2 band-rows per 50 steps at 64k).
    Too-narrow windows remain *correct* on the one-shot path (the
    max_width cond falls back to the single-pass kernel) and poison —
    never silently wrong — on the in-scan path."""
    rows = npad // rs
    return min(max(bs // rs + 12, rows // 12 + 16), rows)


def measure_band_rows(pos, soft, bs: int = BS, rs: int = RS) -> int:
    """Concrete (host-side) band-window width for THIS population.

    Replicates ``_xla_self_sorted``'s window bookkeeping in NumPy —
    slab-sort by x, edge-pad to a whole number of ``bs`` blocks, resolve
    per-target-block [first, last] not-provably-far band rows at ``rs``
    granularity — and returns ``max(last - first + 1)`` over blocks.

    The static ``_nb_rows`` floor must over-provision (it cannot see the
    data, and a too-narrow window poisons in-scan), which at the bench
    population costs a measurable band-pass surplus: 26 provisioned vs
    16 measured rows at N=64k, 186 vs 111 at N=1M.  Callers that know
    their population can instead pass ``measure_band_rows(...) + slack`` as the solver's
    ``band_rows`` override.  Slack budget: the window is re-resolved
    from *current* positions every force call, so the override only
    needs to absorb growth of the true width between calls under the
    in-scan order-refresh cadence (every 10 steps, dispatch.py
    ``presort_interval``; measured drift ~2 band-rows per 50 steps on
    the 64k bench population).  An insufficient override stays safe:
    one-shot calls fall back to the single-pass kernel, in-scan calls
    poison with NaN (never silently wrong).
    """
    pos = np.asarray(pos, np.float32)
    soft_arr = np.asarray(soft, np.float32)
    n = pos.shape[0]
    rs = min(rs, bs)              # mirror _dispatch's geometry exactly
    bs = -(-bs // rs) * rs if bs % rs else bs
    x = np.sort(pos[:, 0])
    npad = -(-n // bs) * bs
    if npad > n:
        x = np.concatenate([x, np.full(npad - n, x[-1], x.dtype)])
    nblk, rows = npad // bs, npad // rs
    x_t = x.reshape(nblk, bs)
    x_r = x.reshape(rows, rs)
    t_lo, t_hi = x_t.min(axis=1), x_t.max(axis=1)
    s_lo, s_hi = x_r.min(axis=1), x_r.max(axis=1)
    h_max = float(soft_arr.max()) if soft_arr.size else 0.0
    far = np.logical_or(s_hi[None, :] < (t_lo - h_max)[:, None],
                        s_lo[None, :] > (t_hi + h_max)[:, None])
    ridx = np.arange(rows)[None, :]
    first = np.where(far, rows, ridx).min(axis=1)
    last = np.where(far, -1, ridx).max(axis=1)
    return int((last - first + 1).max())


def uses_spatial_sort(kind: str, n: int) -> bool:
    """Delegates to the shared slab policy (ops/slab.py, also the Pallas
    path's): the two-pass split exists for the compact-support spline at
    sizes where the sort pays for itself."""
    from . import slab

    return slab.uses_spatial_sort(kind, n)


def _newton_block(pos_t, pos_s, m_s, eps2):
    """(BS,3) Newtonian acceleration moments of a target block against a
    source block.  No self mask (the self pair has dx=0 exactly and its
    band row is mass-zeroed anyway); no softening (every near pair is in
    the zeroed band)."""
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = lax.rsqrt(r2)
    s = m_s[None, :] * (inv * inv * inv)
    return jnp.stack([jnp.sum(s * dx, axis=1),
                      jnp.sum(s * dy, axis=1),
                      jnp.sum(s * dz, axis=1)], axis=-1)


def _newton_pot_block(pos_t, pos_s, m_s, eps2):
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    return jnp.sum(m_s[None, :] * -lax.rsqrt(r2), axis=1)


def _band_spline_acc(pos_t, hinv_t, pos_s, m_s, hinv_s, eps2):
    """Pre-transformed spline force over the banded window.

    Per-particle softening enters as ``hinv = 1/h`` (rsqrt(0) = inf for
    unsoftened particles), so the pair rule ``h_eff = max(h_i, h_j)``
    becomes one ``min`` and the whole kernel is division-free; the
    ``q -> 0`` guard of the generic path is unnecessary because
    ``eps2 > 0`` keeps ``inv_r`` finite (the inner polynomial's q -> 0
    limit is exact).  Mirrors the Pallas kernel's formulation
    (ops/pallas_direct.py _soft_pre)."""
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv_r = lax.rsqrt(r2)
    r = r2 * inv_r
    newton = inv_r * inv_r * inv_r
    hinv = jnp.minimum(hinv_t[:, None], hinv_s[None, :])
    h3inv = hinv * hinv * hinv
    q = r * hinv
    q2 = q * q
    inner = h3inv * (q2 * (32.0 * q - 38.4) + 10.666666666666666)
    outer = h3inv * (
        21.333333333333333
        + q * (-48.0 + q * (38.4 - 10.666666666666667 * q))
    ) - 0.0666666666666667 * newton
    w = jnp.where(q >= 1.0, newton, jnp.where(q <= 0.5, inner, outer))
    s = m_s[None, :] * w
    return jnp.stack([jnp.sum(s * dx, axis=1),
                      jnp.sum(s * dy, axis=1),
                      jnp.sum(s * dz, axis=1)], axis=-1)


def _band_block(kind, pos_t, h_t, pos_s, m_s, h_s, mode, eps2):
    """Full softened kernel over the banded window (few % of pairs)."""
    dx = pos_s[None, :, 0] - pos_t[:, None, 0]
    dy = pos_s[None, :, 1] - pos_t[:, None, 1]
    dz = pos_s[None, :, 2] - pos_t[:, None, 2]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    h_eff = jnp.maximum(h_t[:, None], h_s[None, :])
    if mode == "acc":
        w = force_factor(kind, r2, h_eff)
        s = m_s[None, :] * w
        return jnp.stack([jnp.sum(s * dx, axis=1),
                          jnp.sum(s * dy, axis=1),
                          jnp.sum(s * dz, axis=1)], axis=-1)
    u = potential_factor(kind, r2, h_eff)
    return jnp.sum(m_s[None, :] * u, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("kind", "kahan", "mode", "bs", "rs", "nb_rows",
                     "guard", "tbs"),
)
def _xla_self_sorted(pos, mass, soft, G, kind, kahan, mode, eps2,
                     order, bs, rs, nb_rows, guard, tbs=None):
    """``tbs`` (target block size, default = ``bs``) decouples the band
    WINDOW granularity from the source-scan block: the zeroed window is
    shared by all targets of one target block, so its width must cover
    that block's own x-span (tbs/rs rows) plus the softening reach —
    smaller target blocks hug the true near-pair set tighter and the
    band pass (billed at the full ~29-op spline rate) shrinks by the
    span difference.  The base pass still scans bs-sized source blocks
    (large fused elementwise loops), mapped over npad/tbs target
    tiles."""
    tbs = tbs or bs
    n = pos.shape[0]
    dtype = pos.dtype
    eps2 = jnp.asarray(eps2, dtype)

    ps = pos[order]
    ms = mass[order]
    hs = soft[order]

    npad = -(-n // bs) * bs
    # edge-pad positions (keeps x sorted so the band bookkeeping stays
    # valid), zero-pad mass (invisible to forces), edge-pad softening
    ps_p = jnp.pad(ps, ((0, npad - n), (0, 0)), mode="edge")
    ms_p = jnp.pad(ms, (0, npad - n))
    hs_p = jnp.pad(hs, (0, npad - n), mode="edge")

    nblk = npad // bs                  # source-scan blocks
    nblk_t = npad // tbs               # target tiles (window granularity)
    rows = npad // rs
    k = bs // rs                       # band rows per source block

    x = ps_p[:, 0]
    x_t = x.reshape(nblk_t, tbs)
    x_r = x.reshape(rows, rs)
    t_lo, t_hi = x_t.min(axis=1), x_t.max(axis=1)
    s_lo, s_hi = x_r.min(axis=1), x_r.max(axis=1)
    h_max = jnp.max(hs)
    # order-independent window: [first, last] row not provably far;
    # provably-far rows are exactly Newtonian
    # under ANY permutation, so a stale order only widens max_width
    # until the fallback takes over — performance degrades, correctness
    # never.
    far = jnp.logical_or(s_hi[None, :] < (t_lo - h_max)[:, None],
                         s_lo[None, :] > (t_hi + h_max)[:, None])
    ridx = jnp.arange(rows, dtype=jnp.int32)[None, :]
    first = jnp.min(jnp.where(far, rows, ridx), axis=1)
    last = jnp.max(jnp.where(far, -1, ridx), axis=1)
    max_width = jnp.max(last - first + 1)
    start = jnp.clip(first, 0, rows - nb_rows)         # (nblk,) int32

    m_b = ms_p.reshape(nblk, bs)
    h_b = hs_p.reshape(nblk_t, tbs)
    hinv_p = lax.rsqrt(hs_p * hs_p)        # inf for h == 0: exact (q
    #                                        >= 1 selects Newtonian)
    out_shape = (tbs, 3) if mode == "acc" else (tbs,)
    newton = _newton_block if mode == "acc" else _newton_pot_block

    def two_pass(ps_p):
        pos_b = ps_p.reshape(nblk_t, tbs, 3)
        src_b = ps_p.reshape(nblk, bs, 3)

        def per_target(tb):
            pos_t, h_t, start_t = tb

            # -- pass 1: Newtonian, band rows mass-zeroed -------------
            def scan_src(carry, sb):
                total, comp = carry
                pos_s, m_s, j = sb
                rj = j * k + jnp.arange(k, dtype=jnp.int32)
                in_band = (rj >= start_t) & (rj < start_t + nb_rows)
                gate = jnp.where(in_band, jnp.asarray(0, dtype),
                                 jnp.asarray(1, dtype))
                m_eff = (m_s.reshape(k, rs) * gate[:, None]).reshape(bs)
                part = newton(pos_t, pos_s, m_eff, eps2)
                if kahan:
                    total, comp = kahan_add(total, comp, part)
                else:
                    total = total + part
                return (total, comp), None

            init = (jnp.zeros(out_shape, dtype),
                    jnp.zeros(out_shape, dtype))
            (total, comp), _ = lax.scan(
                scan_src, init,
                (src_b, m_b, jnp.arange(nblk, dtype=jnp.int32)))

            # -- pass 2: full kernel over the banded window -----------
            lo = start_t * rs
            pos_w = lax.dynamic_slice(ps_p, (lo, jnp.int32(0)),
                                      (nb_rows * rs, 3))
            m_w = lax.dynamic_slice(ms_p, (lo,), (nb_rows * rs,))
            if kind == "spline" and mode == "acc":
                hi_t = lax.rsqrt(h_t * h_t)
                hi_w = lax.dynamic_slice(hinv_p, (lo,), (nb_rows * rs,))
                band = _band_spline_acc(pos_t, hi_t, pos_w, m_w, hi_w,
                                        eps2)
            else:
                h_w = lax.dynamic_slice(hs_p, (lo,), (nb_rows * rs,))
                band = _band_block(kind, pos_t, h_t, pos_w, m_w, h_w,
                                   mode, eps2)
            if kahan:
                total, _ = kahan_add(total, comp, band)
            else:
                total = total + band
            return total

        return lax.map(per_target, (pos_b, h_b, start))

    def single_pass(ps_p):
        pos_b = ps_p.reshape(nblk_t, tbs, 3)
        src_b = ps_p.reshape(nblk, bs, 3)
        hs_b = hs_p.reshape(nblk, bs)

        def per_target(tb):
            pos_t, h_t = tb

            def scan_src(carry, sb):
                total, comp = carry
                pos_s, m_s, h_s = sb
                part = _band_block(kind, pos_t, h_t, pos_s, m_s, h_s,
                                   mode, eps2)
                if kahan:
                    total, comp = kahan_add(total, comp, part)
                else:
                    total = total + part
                return (total, comp), None

            init = (jnp.zeros(out_shape, dtype),
                    jnp.zeros(out_shape, dtype))
            (total, _), _ = lax.scan(scan_src, init, (src_b, m_b, hs_b))
            return total

        return lax.map(per_target, (pos_b, h_b))

    if guard == "cond":
        out = lax.cond(max_width <= nb_rows, two_pass, single_pass, ps_p)
    else:
        # 'poison' guard, for use inside lax.scan: built for a backend
        # that executed the UNTAKEN branch of an in-scan lax.cond too,
        # so stepping would have paid both passes every step.  (The GPU
        # runs only the taken branch — PERF.md; ROADMAP Y3 returns to
        # the exact cond.)  Run the two-pass unconditionally and poison
        # the output with NaN if the band did not cover — exact or NaN,
        # never silently wrong.  The integrator's NaN gates surface the
        # (geometrically near-impossible: the order is refreshed every
        # chunk and the window carries >= 12 rows of slack) failure with
        # the last good restart preserved.
        out = two_pass(ps_p)
        ok = max_width <= nb_rows
        out = out * jnp.where(ok, jnp.asarray(1.0, dtype),
                              jnp.asarray(jnp.nan, dtype))
    out = out.reshape((npad,) + out_shape[1:])[:n]

    if mode == "pot":
        # the band pass (and the single-pass fallback) include the self
        # pair; its contribution is analytic — subtract it exactly
        out = out - ms * potential_factor(kind, eps2, hs)

    out = jnp.asarray(G, dtype) * out
    # scatter back to original particle order
    full = jnp.zeros_like(out)
    return full.at[order].set(out)


def _dispatch(pos, mass, soft, G, kind, kahan, mode, eps2, order,
              block_size, band_rows=None, row_size=None,
              target_block=None):
    n = pos.shape[0]
    if not uses_spatial_sort(kind, n):
        from .pairwise import _choose_block, _pairwise_blocked

        return _pairwise_blocked(
            pos, mass, soft, jnp.asarray(G, pos.dtype), kind, kahan,
            block_size or _choose_block(n), mode, eps2)
    bs = block_size or BS
    # row_size: band bookkeeping granularity.  Finer rows resolve the
    # band window tighter around the true near pairs (fewer surplus
    # band-pass pairs) at slightly more window bookkeeping.
    rs = min(int(row_size) if row_size else RS, bs)
    if bs % rs:
        # the band bookkeeping maps each bs-sized source block onto
        # whole rs-sized band rows (k = bs // rs), so a user block_size
        # above RS must be a multiple of it — round up rather than
        # crash at trace time with an opaque reshape error
        bs = -(-bs // rs) * rs
    npad = -(-n // bs) * bs
    # target_block: band WINDOW granularity (see _xla_self_sorted tbs).
    # Must tile the source block exactly, and stay a whole number of
    # band rows; round down to the nearest valid divisor-of-bs multiple
    # of rs rather than crash at trace time.
    tbs = bs
    if target_block:
        tbs = max(rs, min(int(target_block), bs))
        tbs = (tbs // rs) * rs
        while bs % tbs:
            tbs -= rs
    if band_rows is not None:
        # measured-width override (see measure_band_rows): trust the
        # caller's provisioning but keep it shape-valid.  Floor at the
        # target tile's own span + 1 (a window narrower than the tile
        # itself can never cover and would poison every call); a window
        # still narrower than the data falls back / poisons exactly as
        # a too-narrow static floor would.
        nb_rows = min(max(int(band_rows), tbs // rs + 1), npad // rs)
    else:
        nb_rows = _nb_rows(tbs, rs, npad)
    # guard semantics: a supplied order means "scan context" (the
    # integrator refreshes it once per chunk) -> poison guard, which
    # keeps the expensive fallback branch out of the per-step graph; a
    # self-sorting call keeps the exact cond fallback (outside scans the
    # untaken branch is genuinely skipped).
    guard = "cond" if order is None else "poison"
    if order is None:
        order = jnp.argsort(pos[:, 0])
    return _xla_self_sorted(pos, mass, soft, G, kind, kahan, mode,
                            eps2, order, bs, rs, nb_rows, guard, tbs=tbs)


def xla_accel(pos, mass, soft, G, kind, kahan, eps2=PAIRWISE_EPS2,
              order=None, block_size=None, band_rows=None, row_size=None,
              target_block=None):
    """Softened accelerations via the XLA two-pass path, (N, 3)."""
    return _dispatch(pos, mass, soft, G, kind, kahan, "acc", eps2,
                     order, block_size, band_rows, row_size, target_block)


def xla_potential(pos, mass, soft, G, kind, kahan, eps2=PAIRWISE_EPS2,
                  order=None, block_size=None, band_rows=None,
                  row_size=None, target_block=None):
    """Softened potential per particle via the XLA two-pass path, (N,)."""
    return _dispatch(pos, mass, soft, G, kind, kahan, "pot", eps2,
                     order, block_size, band_rows, row_size, target_block)
