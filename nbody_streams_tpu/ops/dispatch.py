"""Gravity-solver front-end: one object, several interchangeable backends.

``DirectGravity`` packages per-particle mass/softening (device-resident,
correct dtype) with a choice of implementation:

* ``'jnp'``     — blocked pure-jnp oracle (any backend; CPU float64 oracle)
* ``'pallas'``  — Pallas kernel through Triton (ops/pallas_direct.py), the
  single-GPU fast path
* ``'xla'``     — pure-XLA two-pass split (ops/xla_direct.py): the
  compact-support algorithm expressed as plain XLA ops
* ``'sharded'`` — shard_map mesh-sharded direct summation (several devices)
* ``'auto'``    — sharded when more than one device is supplied, pallas on
  a GPU, jnp elsewhere.

All backends share the same contract: ``accel(pos) -> (N, 3)`` and
``potential(pos) -> (N,)``, jittable, closed over static particle
properties.  This replaces the reference's per-backend compute functions
(reference: fields.py:664,866,1021,1088) with one dispatch point.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import (
    G_DEFAULT,
    PAIRWISE_EPS2,
    validate_kernel,
    validate_precision,
)
from . import pairwise
from .slab import slab_sort_key, uses_spatial_sort

__all__ = ["DirectGravity"]


def _default_impl(devices) -> str:
    """The backend ``impl='auto'`` resolves to, from what the call can
    observe: the device count and the platform of the default device.
    N and the kernel do not enter: the Pallas kernel was the fastest
    single-GPU direct path at both sizes measured (PERF.md)."""
    if devices is not None and len(devices) > 1:
        return "sharded"
    # respect an active jax.default_device(...) override (run.py pins
    # architecture='cpu' this way even when a GPU is the default backend)
    dd = jax.config.jax_default_device
    # jax.default_device accepts a Device OR a platform string
    platform = (getattr(dd, "platform", dd) if dd is not None
                else jax.default_backend())
    return "pallas" if platform == "gpu" else "jnp"


class DirectGravity:
    """O(N^2) direct-summation gravity bound to a particle population."""

    def __init__(
        self,
        mass,
        softening,
        G: float = G_DEFAULT,
        kernel: str = "spline",
        precision: str = "float32_kahan",
        impl: str = "auto",
        block_size: int | None = None,
        devices=None,
        eps2: float = PAIRWISE_EPS2,
        sharded_opts: dict | None = None,
        band_rows: int | None = None,
        row_size: int | None = None,
        target_block: int | None = None,
        presort_every: int | None = None,
    ):
        validate_kernel(kernel)
        validate_precision(precision)
        self.kernel = kernel
        self.precision = precision
        self.kahan = precision == "float32_kahan"
        self.dtype = jnp.float64 if precision == "float64" else jnp.float32
        self.G = float(G)
        self.eps2 = float(eps2)
        self.devices = devices

        if precision == "float64" and not jax.config.jax_enable_x64:
            raise ValueError(
                "precision='float64' needs jax_enable_x64; without it "
                "JAX silently computes in float32 (same check as "
                "compute_forces_direct)")
        mass = jnp.asarray(mass, self.dtype)
        softening = jnp.asarray(softening, self.dtype)
        if mass.ndim == 0:
            raise ValueError("mass must be a per-particle array")
        n = mass.shape[0]

        if impl == "auto":
            impl = _default_impl(devices)
        if impl not in ("jnp", "pallas", "xla", "sharded"):
            raise ValueError(f"Unknown gravity impl {impl!r}")
        if impl in ("pallas", "xla") and precision == "float64":
            impl = "jnp"  # the fast paths are fp32-only by design
        self.impl = impl
        if softening.ndim == 0:
            softening = jnp.full((n,), softening, self.dtype)
        self.n = n
        self.mass = mass
        self.softening = softening
        self.block_size = block_size or pairwise._choose_block(n)
        # the xla backend has its own (larger) default block size; only
        # an explicit user block_size overrides it
        self._user_block_size = block_size
        # band_rows: measured-width band provisioning for the XLA
        # two-pass backend (ops/xla_direct.py measure_band_rows) — an
        # expert knob; the static _nb_rows floor remains the default.
        # Other backends have no band bookkeeping to override.
        if band_rows is not None and impl != "xla":
            raise ValueError(
                f"band_rows= only applies to impl='xla' (got {impl!r}); "
                "only the XLA two-pass backend has a band")
        self.band_rows = band_rows
        # row_size: XLA-backend band bookkeeping granularity (finer rows
        # = tighter windows = fewer surplus band pairs; see
        # xla_direct._dispatch).
        if row_size is not None and impl != "xla":
            raise ValueError(
                f"row_size= only applies to impl='xla' (got {impl!r})")
        self.row_size = row_size
        # target_block: XLA-backend band-window granularity — smaller
        # target tiles hug the near-pair set tighter, shrinking the
        # band pass (xla_direct._xla_self_sorted tbs).
        if target_block is not None and impl != "xla":
            raise ValueError(
                f"target_block= only applies to impl='xla' (got {impl!r})")
        self.target_block = target_block
        # presort_every: override the XLA backend's in-scan order
        # refresh cadence (default 10 steps).  The in-graph argsort is
        # the dominant stepping-vs-eval overhead of this backend; a band
        # provisioned with a wide measured cushion tolerates more
        # staleness, so callers can stretch the cadence.  A cadence too long for the cushion
        # poisons with NaN (exact-or-NaN guard) — never silently wrong.
        if presort_every is not None:
            if impl != "xla":
                raise ValueError(
                    f"presort_every= only applies to impl='xla' "
                    f"(got {impl!r}); the Pallas path is exact for any "
                    "order staleness")
            if int(presort_every) < 1:
                raise ValueError(
                    f"presort_every must be >= 1, got {presort_every!r}")
        self.presort_every = (None if presort_every is None
                              else int(presort_every))

        if self.impl == "sharded":
            from ..parallel.sharded import ShardedDirect

            # sharded_opts forwards ShardedDirect kwargs (mesh=,
            # use_pallas=, interpret=) — e.g. use_pallas=True,
            # interpret=True runs the Pallas ring tiles on a CPU mesh
            self._sharded = ShardedDirect(self, **(sharded_opts or {}))
        elif sharded_opts:
            raise ValueError(
                f"sharded_opts given but impl resolved to {impl!r}; pass "
                "impl='sharded' (impl='auto' only selects the sharded "
                "backend when devices= has more than one device)")

    def shard_state(self, tree):
        """Block-shard (N, ...) state arrays over the particle mesh.

        A no-op for the single-device backends.  For ``impl='sharded'``
        this places the integrator state with the same sharding the ring
        body expects, so scanned KDK steps run fully sharded instead of
        paying an XLA reshard per force call."""
        if self.impl == "sharded":
            return self._sharded.shard_state(tree)
        return tree

    @property
    def state_pad(self) -> int:
        """Ghost rows the sharded backend appends to make N divisible by
        the device count (0 for the single-device backends and for even
        N).  Ghosts are zero-mass, so they are invisible to forces and
        to every mass-weighted diagnostic; the run_nbody driver freezes
        them and strips them from all host-visible output."""
        if self.impl == "sharded":
            return self._sharded.npad - self.n
        return 0

    def _check_pos(self, pos):
        ok = {(self.n, 3), (self.n + self.state_pad, 3)}
        if pos.ndim != 2 or tuple(pos.shape) not in ok:
            raise ValueError(
                f"pos shape {pos.shape} does not match the solver's "
                f"({self.n}, 3) particle population")

    # -- spatial-sort order reuse --------------------------------------------
    @property
    def spatial_sort_active(self) -> bool:
        """True when accel/potential take a slab-sorted two-pass path
        (Pallas or XLA) and therefore accept a reusable ``order=`` (the
        integrator re-sorts once per scanned chunk instead of per force
        call)."""
        if self.impl in ("pallas", "xla"):
            return uses_spatial_sort(self.kernel, self.n)
        return False

    def sort_key(self, pos):
        """The slab order accel/potential would compute internally."""
        return slab_sort_key(pos)

    @property
    def presort_interval(self):
        """In-scan order refresh cadence for ``run_chunk``.

        The XLA backend's in-scan guard is exact-or-NaN with a finite
        band slack (ops/xla_direct.py); the slack absorbs only a few
        band-rows of drift, so its order must be refreshed every ~10
        steps (in-graph argsort).  The Pallas path is exact for any
        order, so it keeps the cheaper once-per-chunk sort.  ``presort_every=``
        overrides the default cadence (see __init__)."""
        if self.impl == "xla" and self.spatial_sort_active:
            return self.presort_every or 10
        return None

    # -- backend dispatch ---------------------------------------------------
    def accel(self, pos, order=None):
        """Softened gravitational acceleration, (N, 3) in solver dtype.

        ``order`` optionally supplies a precomputed (possibly stale) slab
        order for the sorted paths — exact for any permutation; ignored
        by the other backends."""
        self._check_pos(pos)
        pos = pos.astype(self.dtype)
        if self.impl == "pallas":
            from . import pallas_direct

            return pallas_direct.pallas_accel(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, order=order,
            )
        if self.impl == "xla":
            from . import xla_direct

            return xla_direct.xla_accel(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, order=order,
                block_size=self._user_block_size,
                band_rows=self.band_rows, row_size=self.row_size,
                target_block=self.target_block,
            )
        if self.impl == "sharded":
            return self._sharded.accel(pos)
        return pairwise._pairwise_blocked(
            pos, self.mass, self.softening, jnp.asarray(self.G, self.dtype),
            self.kernel, self.kahan, self.block_size, "acc", self.eps2,
        )

    def potential(self, pos, order=None):
        """Softened gravitational potential per particle, (N,)."""
        self._check_pos(pos)
        pos = pos.astype(self.dtype)
        if self.impl == "pallas":
            from . import pallas_direct

            return pallas_direct.pallas_potential(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, order=order,
            )
        if self.impl == "xla":
            from . import xla_direct

            return xla_direct.xla_potential(
                pos, self.mass, self.softening, self.G, self.kernel,
                self.kahan, self.eps2, order=order,
                block_size=self._user_block_size,
                band_rows=self.band_rows, row_size=self.row_size,
                target_block=self.target_block,
            )
        if self.impl == "sharded":
            return self._sharded.potential(pos)
        return pairwise._pairwise_blocked(
            pos, self.mass, self.softening, jnp.asarray(self.G, self.dtype),
            self.kernel, self.kahan, self.block_size, "pot", self.eps2,
        )
