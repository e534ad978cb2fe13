"""The port's DRAM-cache metadata ops against the JAX reference.

Random insert / probe+touch sequences drive ``repro.core.dram_cache`` (one
state per lane) and ``repro_torch.core.dram_cache`` (all lanes batched, one
padded allocation, a different effective geometry per lane) with the same
numpy inputs; every returned value and the whole state must be equal bit
for bit after every op, under LRU and SRRIP, and the padded region must
stay invalid.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import dram_cache as jdc
from repro.policies.replacement import SRRIP as J_SRRIP
from repro_torch.core import dram_cache as tdc
from repro_torch.policies.replacement import SRRIP as T_SRRIP

PAD_SETS, PAD_WAYS = 16, 8
# effective (sets, ways) per lane, all inside the padded allocation
LANE_GEOMETRIES = [(16, 8), (5, 3), (1, 1), (8, 8)]


@functools.lru_cache(maxsize=None)
def _jax_ops(srrip):
    """The JAX ops vmapped over lanes (one state per lane), jitted once per
    replacement mode: (insert, probe-and-touch, occupancy)."""
    pol = J_SRRIP.bind(None) if srrip else None

    def probe(s, b, en, n, w):
        hit, si, way = jdc.lookup(s, b, num_sets=n, ways=w)
        return jdc.touch(s, si, way, enable=hit & en, policy=pol), hit, si, way

    return (jax.jit(jax.vmap(lambda s, b, en, n, w: jdc.insert(
                s, b, en, num_sets=n, ways=w, policy=pol))),
            jax.jit(jax.vmap(probe)),
            jax.jit(jax.vmap(jdc.occupancy)))


def _check_state(jstate, tstate, geoms):
    for a, b in zip(jstate, tstate):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for lane, (sets, ways) in enumerate(geoms):
        pad = np.ones((PAD_SETS, PAD_WAYS), bool)
        pad[:sets, :ways] = False
        assert (tstate.tags[lane].numpy()[pad] == 0).all()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 16), srrip=st.booleans())
def test_ops_match_reference_on_padded_lanes(seed, srrip):
    rng = np.random.default_rng(seed)
    j_insert, j_probe, j_occ = _jax_ops(srrip)
    tpol = T_SRRIP.bind(None) if srrip else None
    L = len(LANE_GEOMETRIES)
    sets = np.array([g[0] for g in LANE_GEOMETRIES], np.int32)
    ways = np.array([g[1] for g in LANE_GEOMETRIES], np.int32)
    js = jax.tree.map(lambda x: np.broadcast_to(x, (L,) + x.shape),
                      jdc.init_cache(PAD_SETS, PAD_WAYS))
    ts = tdc.init_cache(PAD_SETS, PAD_WAYS, batch=(L,))
    t_sets, t_ways = torch.from_numpy(sets), torch.from_numpy(ways)
    for _ in range(30):
        blk = rng.integers(0, 4 * PAD_SETS * PAD_WAYS, L).astype(np.int32)
        en = rng.random(L) < 0.8
        if rng.random() < 0.6:
            ts, t_ev, t_slot = tdc.insert(ts, torch.from_numpy(blk),
                                          torch.from_numpy(en), t_sets, t_ways,
                                          policy=tpol)
            js, ev, slot = j_insert(js, blk, en, sets, ways)
            np.testing.assert_array_equal(np.asarray(ev), t_ev.numpy())
            np.testing.assert_array_equal(np.asarray(slot), t_slot.numpy())
        else:
            hit, si, way = tdc.lookup(ts, torch.from_numpy(blk), t_sets, t_ways)
            ts = tdc.touch(ts, si, way, enable=hit & torch.from_numpy(en),
                           policy=tpol)
            js, jh, jsi, jway = j_probe(js, blk, en, sets, ways)
            np.testing.assert_array_equal(np.asarray(jh), hit.numpy())
            np.testing.assert_array_equal(np.asarray(jsi), si.numpy())
            np.testing.assert_array_equal(np.asarray(jway)[np.asarray(jh)],
                                          way.numpy()[hit.numpy()])
        np.testing.assert_array_equal(np.asarray(j_occ(js, sets, ways)),
                                      tdc.occupancy(ts, t_sets, t_ways).numpy())
        _check_state(js, ts, LANE_GEOMETRIES)


@pytest.mark.parametrize("srrip", [False, True])
def test_batched_probe_lookup_matches_reference(srrip):
    """A (lanes, P) batch of probes is P independent lookups per lane."""
    rng = np.random.default_rng(7)
    jpol = J_SRRIP.bind(None) if srrip else None
    tpol = T_SRRIP.bind(None) if srrip else None
    js = jdc.init_cache(8, 4)
    ts = tdc.init_cache(8, 4, batch=(1,))
    for b in rng.integers(0, 64, 40).astype(np.int32):
        js, _, _ = jdc.insert(js, jnp.int32(b), num_sets=6, ways=3, policy=jpol)
        tdc.insert(ts, torch.tensor([b]), torch.tensor([True]),
                   torch.tensor([6], dtype=torch.int32),
                   torch.tensor([3], dtype=torch.int32), policy=tpol)
    probes = rng.integers(0, 64, (1, 9)).astype(np.int32)
    hit, si, way = tdc.lookup(ts, torch.from_numpy(probes),
                              torch.tensor([6], dtype=torch.int32),
                              torch.tensor([3], dtype=torch.int32))
    for k, b in enumerate(probes[0]):
        jh, jsi, jway = jdc.lookup(js, jnp.int32(b), num_sets=6, ways=3)
        assert (bool(jh), int(jsi), int(jway)) == \
            (bool(hit[0, k]), int(si[0, k]), int(way[0, k]))


def test_eviction_ignores_padded_ways():
    """A full effective set evicts its LRU member even with padded ways
    empty beside it."""
    st_ = tdc.init_cache(1, 8)
    kw = dict(num_sets=1, ways=2)
    for b in (1, 2):
        tdc.insert(st_, torch.tensor(b, dtype=torch.int32), **kw)
    hit, si, way = tdc.lookup(st_, torch.tensor(1, dtype=torch.int32), **kw)
    tdc.touch(st_, si, way, enable=hit)           # 2 becomes LRU
    _, evicted, _ = tdc.insert(st_, torch.tensor(3, dtype=torch.int32), **kw)
    assert int(evicted) == 2
    assert (st_.tags[:, 2:] == 0).all()


def test_set_hash_matches_reference():
    a = np.concatenate([np.arange(0, 10_000, 37), [-1, -7, 2 ** 31 - 1]]
                       ).astype(np.int32)
    for n in (1, 2, 5, 64, 4096, 16384):
        want = np.asarray(jdc._set_index(jnp.asarray(a), jnp.int32(n)))
        got = tdc._set_index(torch.from_numpy(a), n).numpy()
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("srrip", [False, True])
def test_invalidate_matches_reference_on_padded_lanes(srrip):
    """Inserts, then invalidations of cached and absent blocks, per lane at
    each lane's effective geometry: the state bit for bit after each
    invalidation (only the hit's tag cleared, recency kept)."""
    rng = np.random.default_rng(11)
    j_insert = _jax_ops(srrip)[0]
    j_inv = jax.jit(jax.vmap(lambda s, b, n, w: jdc.invalidate(s, b, num_sets=n, ways=w)))
    tpol = T_SRRIP.bind(None) if srrip else None
    L = len(LANE_GEOMETRIES)
    sets = np.array([g[0] for g in LANE_GEOMETRIES], np.int32)
    ways = np.array([g[1] for g in LANE_GEOMETRIES], np.int32)
    js = jax.tree.map(lambda x: np.broadcast_to(x, (L,) + x.shape),
                      jdc.init_cache(PAD_SETS, PAD_WAYS))
    ts = tdc.init_cache(PAD_SETS, PAD_WAYS, batch=(L,))
    t_sets, t_ways = torch.from_numpy(sets), torch.from_numpy(ways)
    inserted = []
    for _ in range(20):
        blk = rng.integers(0, 2 * PAD_SETS * PAD_WAYS, L).astype(np.int32)
        inserted.append(blk)
        ts = tdc.insert(ts, torch.from_numpy(blk), torch.ones(L, dtype=torch.bool),
                        t_sets, t_ways, policy=tpol)[0]
        js = j_insert(js, blk, np.ones(L, bool), sets, ways)[0]
    hits = 0
    for k in range(12):
        blk = inserted[-1 - k] if k % 2 == 0 else \
            rng.integers(0, 2 * PAD_SETS * PAD_WAYS, L).astype(np.int32)
        hits += int(tdc.lookup(ts, torch.from_numpy(blk), t_sets, t_ways)[0].sum())
        ts = tdc.invalidate(ts, torch.from_numpy(blk), t_sets, t_ways)
        js = j_inv(js, blk, sets, ways)
        _check_state(js, ts, LANE_GEOMETRIES)
    assert hits > 0
