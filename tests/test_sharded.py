"""Mesh-sharded direct summation: equivalence with the single-device path
on a virtual 8-device CPU mesh (the reference has no multi-device tier;
this is the replacement for its Barnes-Hut tree)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_streams_tpu.ops.dispatch import DirectGravity
from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.default_rng(7)
    n = 1000  # deliberately not divisible by 8 (tests padding)
    return (
        rng.normal(0, 1, (n, 3)),
        rng.uniform(0.5, 2.0, n) * 1e5,
        rng.uniform(0.05, 0.3, n),
    )


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("precision", ["float32_kahan", "float64"])
def test_sharded_accel_matches_single(cluster, precision):
    pos, mass, soft = cluster
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision=precision)
    shard = DirectGravity(mass, soft, G=4.3e-6, impl="sharded",
                          precision=precision, devices=jax.devices())
    p = jnp.asarray(pos, single.dtype)
    a1 = np.asarray(single.accel(p))
    a2 = np.asarray(shard.accel(p))
    tol = 1e-14 if precision == "float64" else 1e-6
    np.testing.assert_allclose(a2, a1, atol=tol * np.abs(a1).max())


@pytest.mark.parametrize("kernel", ["spline", "plummer", "newtonian"])
def test_sharded_potential_matches_single(cluster, kernel):
    pos, mass, soft = cluster
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision="float64", kernel=kernel)
    shard = DirectGravity(mass, soft, G=4.3e-6, impl="sharded",
                          precision="float64", kernel=kernel,
                          devices=jax.devices())
    p = jnp.asarray(pos)
    p1 = np.asarray(single.potential(p))
    p2 = np.asarray(shard.potential(p))
    np.testing.assert_allclose(p2, p1, atol=1e-13 * np.abs(p1).max())


def test_method_tree_runs_sharded_end_to_end(tmp_path):
    """run_simulation(method='tree') = sharded direct tier; trajectory must
    match the single-device direct path to fp tolerance."""
    xv, m = make_plummer_sphere(256, M_total=1e4, a=0.01, seed=11)
    sp = [Species.dark(N=256, mass=float(m[0]), softening=0.003)]
    kw = dict(time_start=0.0, time_end=2e-4, dt=2e-5, architecture="cpu",
              save_snapshots=False, verbose=False, precision="float64")
    res_direct = run_simulation(xv, sp, output_dir=str(tmp_path / "a"),
                                method="direct", **kw)
    res_tree = run_simulation(xv, sp, output_dir=str(tmp_path / "b"),
                              method="tree", devices=jax.devices(), **kw)
    np.testing.assert_allclose(res_tree["dark"], res_direct["dark"],
                               rtol=1e-10, atol=1e-12)


def test_uneven_n_ghost_state_sharding():
    """N=517 on the 8-device mesh: shard_state appends zero-mass ghost
    rows (no reshard warning), the state actually shards, and the
    ghost-padded accel path matches the unpadded call on the real rows."""
    import warnings

    from nbody_streams_tpu.integrate import init_state, make_accel_fn

    rng = np.random.default_rng(5)
    n = 517
    pos = rng.normal(0, 1, (n, 3))
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = rng.uniform(0.05, 0.3, n)
    shard = DirectGravity(mass, soft, G=4.3e-6, impl="sharded",
                          precision="float32_kahan",
                          devices=jax.devices())
    assert shard.state_pad == (-n) % 8 == 3
    accel_fn = make_accel_fn(shard, shard.mass)
    vel = np.zeros_like(pos)
    state = init_state(pos, vel, accel_fn, shard.mass, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the old path warned here
        state = shard.shard_state(state)
    assert state.pos.shape[0] == n + shard.state_pad
    assert state.pos.shape[0] % 8 == 0
    assert len(state.pos.sharding.device_set) == 8, "state not sharded"
    # zero-mass ghosts are exact: the padded-length call agrees with the
    # unpadded one bitwise (identical padded operand either way)
    a_pad = np.asarray(shard.accel(state.pos))
    a_ref = np.asarray(shard.accel(jnp.asarray(pos, jnp.float32)))
    np.testing.assert_array_equal(a_pad[:n], a_ref)


def test_driver_uneven_n_sharded_matches_direct(tmp_path):
    """End-to-end run_simulation at N=517 (prime, not divisible by 8):
    the ghost-padded sharded tier must reproduce the single-device
    direct trajectory with no reshard warning and real-only output."""
    import warnings

    n = 517
    xv, m = make_plummer_sphere(n, M_total=1e4, a=0.01, seed=3)
    sp = [Species.dark(N=n, mass=float(m[0]), softening=0.003)]
    kw = dict(time_start=0.0, time_end=2e-4, dt=2e-5, architecture="cpu",
              save_snapshots=False, verbose=False, precision="float64")
    res_direct = run_simulation(xv, sp, output_dir=str(tmp_path / "a"),
                                method="direct", **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res_tree = run_simulation(xv, sp, output_dir=str(tmp_path / "b"),
                                  method="tree", devices=jax.devices(),
                                  **kw)
    assert not [w for w in rec if "divisible" in str(w.message)]
    assert res_tree["dark"].shape == (n, 6)
    np.testing.assert_allclose(res_tree["dark"], res_direct["dark"],
                               rtol=1e-10, atol=1e-12)


def _pallas_ring(single, use_pallas=True):
    """ShardedDirect forced onto the Pallas tile branch, interpret mode
    (executes the multi-device kernel path on the virtual CPU mesh — the
    same branch GPU meshes take)."""
    from nbody_streams_tpu.parallel.sharded import (
        ShardedDirect, make_particle_mesh)

    return ShardedDirect(single, mesh=make_particle_mesh(jax.devices()),
                         use_pallas=use_pallas, interpret=True)


@pytest.fixture(scope="module")
def slab_cluster():
    """1024 particles, small uniform softening: slab-sorted copy makes all
    non-adjacent ring blocks 'far' (Newtonian fast-path cond taken);
    shuffled copy keeps block x-intervals overlapping (cond not taken)."""
    rng = np.random.default_rng(41)
    n = 1024
    pos = rng.normal(0, 1, (n, 3))
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = np.full(n, 0.01)
    from nbody_streams_tpu.parallel.sharded import slab_sort_for_sharding

    pos_sorted, mass_sorted, soft_sorted = slab_sort_for_sharding(
        pos, mass, soft)
    return {"shuffled": (pos, mass, soft),
            "sorted": (pos_sorted, mass_sorted, soft_sorted)}


@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
def test_pallas_ring_accel_matches_single(slab_cluster, layout):
    pos, mass, soft = slab_cluster[layout]
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision="float32_kahan")
    sh = _pallas_ring(single)
    assert sh.use_pallas
    p = jnp.asarray(pos, jnp.float32)
    a1 = np.asarray(single.accel(p))
    a2 = np.asarray(sh.accel(p))
    np.testing.assert_allclose(a2, a1, atol=2e-6 * np.abs(a1).max())


@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
def test_pallas_ring_potential_matches_single(slab_cluster, layout):
    """Also covers the r == 0 in-kernel self-mask: an unmasked self pair
    would add -G m_i / sqrt(eps2) ~ 1e7 x the physical potential."""
    pos, mass, soft = slab_cluster[layout]
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision="float32_kahan")
    sh = _pallas_ring(single)
    p = jnp.asarray(pos, jnp.float32)
    p1 = np.asarray(single.potential(p))
    p2 = np.asarray(sh.potential(p))
    np.testing.assert_allclose(p2, p1, atol=2e-6 * np.abs(p1).max())


def test_pallas_ring_uneven_n_padding():
    """N = 1000 on 8 devices: the Pallas branch pads 125-row local blocks
    and the zero-mass padding must not contribute."""
    rng = np.random.default_rng(5)
    n = 1000
    pos = rng.normal(0, 1, (n, 3))
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = rng.uniform(0.05, 0.3, n)
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision="float32_kahan")
    sh = _pallas_ring(single)
    p = jnp.asarray(pos, jnp.float32)
    a1 = np.asarray(single.accel(p))
    a2 = np.asarray(sh.accel(p))
    np.testing.assert_allclose(a2, a1, atol=2e-6 * np.abs(a1).max())
    p1 = np.asarray(single.potential(p))
    p2 = np.asarray(sh.potential(p))
    np.testing.assert_allclose(p2, p1, atol=2e-6 * np.abs(p1).max())


def test_pallas_ring_newtonian_fastpath_fires(slab_cluster, monkeypatch):
    """White-box: with slab-sorted input the compact-support lax.cond must
    actually take the Newtonian branch on most ring steps (runtime
    callbacks fire only in the executed cond branch), and never on
    shuffled input's overlapping blocks."""
    from nbody_streams_tpu.ops import pallas_direct

    counts = {}
    orig = pallas_direct.pallas_accel_2set

    def spy(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan, eps2,
            interpret=False, **kw):
        out = orig(pos_t, soft_t, pos_s, gmass_s, soft_s, kind, kahan,
                   eps2, interpret=interpret, **kw)
        jax.debug.callback(
            lambda _, k=kind: counts.__setitem__(k, counts.get(k, 0) + 1),
            out[0, 0])
        return out

    monkeypatch.setattr(pallas_direct, "pallas_accel_2set", spy)

    for layout, expect_fast in [("sorted", True), ("shuffled", False)]:
        counts.clear()
        pos, mass, soft = slab_cluster[layout]
        single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                               precision="float32_kahan")
        sh = _pallas_ring(single)
        np.asarray(sh.accel(jnp.asarray(pos, jnp.float32)))
        jax.effects_barrier()
        d = len(jax.devices())
        total = d * d  # d ring steps on each of d devices
        assert sum(counts.values()) == total
        fast = counts.get("newtonian", 0)
        if expect_fast:
            # self + two adjacent slabs per device must stay spline;
            # expect the bulk of the remaining steps on the fast path
            assert fast >= total // 2, counts
        else:
            # overlapping block x-intervals: gap <= 0 on every step
            assert fast == 0, counts


def test_pallas_ring_fp64_falls_back_to_jnp():
    """The Pallas tile is fp32-only by design; a float64 solver must get
    the jnp tile even when use_pallas is requested."""
    mass = np.ones(64)
    soft = np.full(64, 0.1)
    single = DirectGravity(mass, soft, impl="jnp", precision="float64")
    sh = _pallas_ring(single, use_pallas=True)
    assert not sh.use_pallas


def test_dispatch_sharded_opts_passthrough(slab_cluster):
    """DirectGravity(impl='sharded', sharded_opts=...) forwards to
    ShardedDirect — the public route to the interpret-mode Pallas ring."""
    pos, mass, soft = slab_cluster["shuffled"]
    g = DirectGravity(mass, soft, G=4.3e-6, impl="sharded",
                      precision="float32_kahan", devices=jax.devices(),
                      sharded_opts={"use_pallas": True, "interpret": True})
    assert g._sharded.use_pallas and g._sharded.interpret
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision="float32_kahan")
    p = jnp.asarray(pos, jnp.float32)
    a1 = np.asarray(single.accel(p))
    a2 = np.asarray(g.accel(p))
    np.testing.assert_allclose(a2, a1, atol=2e-6 * np.abs(a1).max())


def test_slab_sort_for_sharding_preserves_physics(rng):
    """Slab sorting is pure bookkeeping: the 8-device ring on sorted
    input matches the unsorted result after unpermuting."""
    import numpy as np

    from nbody_streams_tpu.ops.dispatch import DirectGravity
    from nbody_streams_tpu.parallel.sharded import slab_sort_for_sharding

    n = 512
    xv = rng.normal(0, 1, (n, 6))
    m = rng.uniform(0.5, 1.5, n)
    h = np.full(n, 0.05)
    xv_s, m_s, h_s = slab_sort_for_sharding(xv, m, h)
    assert np.all(np.diff(xv_s[:, 0]) >= 0)

    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    s0 = DirectGravity(m, h, kernel="spline", impl="sharded",
                       devices=devs)
    s1 = DirectGravity(m_s, h_s, kernel="spline", impl="sharded",
                       devices=devs)
    a0 = np.asarray(s0.accel(jnp.asarray(xv[:, :3], s0.dtype)))
    a1 = np.asarray(s1.accel(jnp.asarray(xv_s[:, :3], s1.dtype)))
    order = np.argsort(xv[:, 0], kind="stable")
    np.testing.assert_allclose(a1, a0[order], rtol=2e-5, atol=1e-8)


def test_pallas_ring_offcentre_uneven_ghost_padding_exact():
    """Off-centre system with genuine ghost padding (N=601 -> 7 ghosts)
    through the interpret-mode Pallas ring: the padded path must match
    the single-device oracle on the real rows."""
    rng = np.random.default_rng(9)
    n = 601
    pos = rng.normal(0, 1, (n, 3)) + np.array([120.0, -80.0, 60.0])
    mass = rng.uniform(0.5, 2.0, n) * 1e5
    soft = np.full(n, 0.01)
    from nbody_streams_tpu.parallel.sharded import slab_sort_for_sharding

    pos, mass, soft = slab_sort_for_sharding(pos, mass, soft)
    single = DirectGravity(mass, soft, G=4.3e-6, impl="jnp",
                           precision="float32_kahan")
    sh = _pallas_ring(single)
    p = jnp.asarray(pos, jnp.float32)
    a1 = np.asarray(single.accel(p))
    pad = sh.npad - n
    assert pad == 7
    p_padded = jnp.concatenate([p, jnp.zeros((pad, 3), jnp.float32)])
    a2 = np.asarray(sh.accel(p_padded))[:n]
    np.testing.assert_allclose(a2, a1, atol=4e-6 * np.abs(a1).max())
