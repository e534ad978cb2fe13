"""The port's tiering runtime against the JAX package, on the same numpy
inputs from a seed: the DWRR schedule, ``TieredBlockPool.access`` (slots,
every ``TierState`` field and the counters bit for bit, for both kernel
backends), ``TieredKV.decode_step`` (within 2e-5 of JAX's, whose Pallas
paged attention runs in interpret mode), ``ExpertTier.gather_experts``
(exact in float32 and bfloat16), and a mid-run handover of a JAX state
through ``from_numpy``. A Python mirror of the ``tier_access`` kernel's
plan (the metadata chain first, the filled slots copied after) is held
bit for bit to the plain loop and to JAX, and so is a state passed from
one route to the other mid-run.
"""
import collections
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FamConfig as JFamConfig, fam_replace
from repro.core import spp as jspp
from repro.core import wfq as jwfq
from repro.core.tiering import TieredBlockPool as JPool
from repro.serve.expert_tiering import ExpertTier as JExpertTier
from repro.serve.tiered_kv import TieredKV as JTieredKV
from repro.serve.tiered_kv import TieredKVConfig as JKVConfig
from repro_torch.configs.base import FamConfig
from repro_torch.core import spp as tspp
from repro_torch.core import wfq as twfq
from repro_torch.core.fam_params import from_numpy
from repro_torch.core.tiering import TieredBlockPool, TierState
from repro_torch.kernels.cache_lookup import cache_lookup, tier_access
from repro_torch.serve.expert_tiering import ExpertTier
from repro_torch.serve.tiered_kv import TieredKV, TieredKVConfig

J_CFG = fam_replace(JFamConfig(), cache_ways=4, prefetch_degree=4)


def _cfg(backend="cuda", **kw):
    return FamConfig(cache_ways=4, prefetch_degree=4, kernel_backend=backend, **kw)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def assert_state_equal(jst, tst):
    """Every TierState field, nested states included, bit for bit."""
    assert isinstance(tst, TierState)
    jl, tl = jax.tree.leaves(jst), _leaves(tst)
    assert len(jl) == len(tl) == 19
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# DWRR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight,quantum,max_deficit,r,max_issues", [
    (2, 1, 8, 1, 260), (4, 1, 8, 4, 64), (1, 2, 3, 2, 40), (7, 1, 8, 1, 24)])
def test_schedule_batch_matches_jax(weight, quantum, max_deficit, r, max_issues):
    """The tensor schedule over 32 random states and backlogs equals the
    JAX reference exactly (state and issue order), and the host-int
    schedule equals it lane by lane."""
    rng = np.random.default_rng(weight * 10 + r)
    L = 32
    state = (rng.integers(0, weight + 1, L), rng.integers(-6, max_deficit + 1, L),
             rng.integers(-6, max_deficit * r + 1, L))
    state = tuple(a.astype(np.int32) for a in state)
    nd = rng.integers(0, 40, L).astype(np.int32)
    npf = rng.integers(0, 12, L).astype(np.int32)
    kw = dict(weight=weight, quantum=quantum, max_deficit=max_deficit, r=r,
              max_issues=max_issues)
    j_fn = jax.jit(jax.vmap(functools.partial(jwfq.schedule_batch, **kw)))
    j_state, j_order = j_fn(jwfq.WfqState(*state), nd, npf)
    t_state, t_order = twfq.schedule_batch(
        twfq.WfqState(*(torch.from_numpy(a) for a in state)),
        torch.from_numpy(nd), torch.from_numpy(npf), **kw)
    assert t_order.dtype == torch.int32 and t_order.shape == (L, max_issues)
    np.testing.assert_array_equal(np.asarray(j_order), t_order.numpy())
    for a, b in zip(j_state, t_state):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for lane in range(L):
        h_state, h_order = twfq.schedule_batch_host(
            tuple(int(a[lane]) for a in state), int(nd[lane]), int(npf[lane]), **kw)
        assert h_order == t_order[lane].tolist()
        assert h_state == tuple(int(b[lane]) for b in t_state)


def test_predict_defaults_to_the_config_threshold():
    """``spp.predict`` without a threshold uses the config's, as in JAX."""
    cfg = _cfg()
    rng = np.random.default_rng(3)
    s = tspp.init_spp(cfg)
    for blk in rng.integers(0, 16, 60):
        tspp.update(cfg, s, torch.tensor(2, dtype=torch.int32),
                    torch.tensor(int(blk), dtype=torch.int32))
    args = (cfg, s, torch.tensor(2, dtype=torch.int32), torch.tensor(5, dtype=torch.int32),
            torch.tensor(9, dtype=torch.int32), 4)
    for a, b in zip(tspp.predict(*args, bpp=16),
                    tspp.predict(*args, bpp=16, threshold=cfg.spp_confidence_threshold)):
        assert torch.equal(a, b)
    assert tspp.predict.__defaults__ == jspp.predict.__defaults__ == (64, None)


# ---------------------------------------------------------------------------
# TieredBlockPool.access
# ---------------------------------------------------------------------------

def _streams(kind, rng):
    if kind == "random":
        return [rng.integers(0, 64, 4).astype(np.int32) for _ in range(20)]
    seq = np.arange(48, dtype=np.int32)          # a stream SPP learns
    return [seq[i:i + 2] for i in range(0, 40, 2)]


@functools.lru_cache(maxsize=None)
def _j_access(fast_blocks, prefetch):
    pool = JPool(J_CFG, num_blocks=64, fast_blocks=fast_blocks, block_elems=8,
                 dtype=jnp.float32)
    return pool, jax.jit(functools.partial(pool.access, prefetch=prefetch))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind,fast_blocks", [("random", 16), ("stream", 32)])
def test_access_matches_jax(kind, fast_blocks, prefetch, backend):
    """After each of 20 accesses the slots, reads and the whole TierState
    (fast tier, side tables, cache, SPP, WFQ, counters) equal JAX's."""
    jpool, j_access = _j_access(fast_blocks, prefetch)
    slow_np = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    j_slow = jnp.asarray(slow_np)
    jst = jpool.init(j_slow)
    pool = TieredBlockPool(_cfg(backend), 64, fast_blocks, 8, dtype=torch.float32,
                           device="cpu")
    slow = torch.from_numpy(slow_np)
    tst = pool.init(slow)
    for ids in _streams(kind, np.random.default_rng(0)):
        jst, j_slots = j_access(jst, j_slow, jnp.asarray(ids))
        tst, t_slots = pool.access(tst, slow, torch.from_numpy(ids), prefetch=prefetch)
        np.testing.assert_array_equal(np.asarray(j_slots), t_slots.numpy())
        np.testing.assert_array_equal(pool.read(tst, t_slots).numpy(), slow_np[ids])
        assert_state_equal(jst, tst)
    if prefetch and kind == "stream":
        assert float(tst.prefetches) > 0
    assert float(pool.hit_rate(tst)) == float(jpool.hit_rate(jst))


def test_access_probes_through_the_lookup_wrapper(monkeypatch):
    """Under kernel_backend="cuda" the final probe goes through the
    cache_lookup wrapper once per access; under "torch" never."""
    calls = []
    import repro_torch.kernels.cache_lookup.ops as ops
    monkeypatch.setattr(ops, "cache_lookup",
                        lambda *a: calls.append(1) or cache_lookup(*a))
    slow = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    for backend, want in (("cuda", 3), ("torch", 0)):
        calls.clear()
        pool = TieredBlockPool(_cfg(backend), 64, 16, 8, dtype=torch.float32, device="cpu")
        st = pool.init(slow)
        for i in range(3):
            st, _ = pool.access(st, slow, torch.tensor([i, i + 1], dtype=torch.int32))
        assert len(calls) == want


# ---------------------------------------------------------------------------
# the tier_access kernel's plan, mirrored on host ints
# ---------------------------------------------------------------------------

def _u32_hash(x, shift):
    return (((x & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF) >> shift


def _mirror_dwrr(state, nd, npf, W, q, md, issues):
    """The kernel's DWRR (r = 1): cycles one by one while prefetches wait;
    while only demands wait, one demand a cycle (a demand turn sets dd =
    min(dd + q, md) - 1, a prefetch turn dd -= 1 and pd = min(pd + q, md));
    the idle rest in closed form (each demand turn sets dd = min(dd + q,
    md), each prefetch turn pd = min(pd + q, md))."""
    cr, dd, pd = state
    r, granted, c = 1, 0, 0
    while c < issues:
        in_range = W >= 0 and 0 <= cr <= W
        if npf <= 0 and nd > 0 and in_range:      # only demands: one a cycle
            m = min(nd, issues - c)
            for _ in range(m):
                cr = 0 if cr == W else cr + 1
                if cr:
                    dd = min(dd + q, md) - 1
                else:
                    dd, pd = dd - 1, min(pd + q * r, md * r)
            nd, c = nd - m, c + m
            continue
        if nd <= 0 and npf <= 0 and q >= 0 and in_range:
            break
        cr = (cr + 1) % (W + 1)
        turn, dr, pr = cr != 0, nd > 0, npf > 0
        dd_d = min(dd + q, md)
        cd = 1 if dr and dd_d > 0 else (2 if pr and pd > r else 0)
        pd_p = min(pd + q * r, md * r)
        cp = 2 if pr and pd_p > r else (1 if dr and dd > 0 else 0)
        choice = cd if turn else cp
        fallback = 1 if dr else (2 if pr else 0)
        floored = choice == 0 and fallback != 0
        choice = fallback if choice == 0 else choice
        if turn:
            dd, pd = (dd_d - 1 if cd == 1 else dd_d), (pd - r if cd == 2 else pd)
        else:
            dd, pd = (dd - 1 if cp == 1 else dd), (pd_p - r if cp == 2 else pd_p)
        dd -= floored and choice == 1
        pd -= r if floored and choice == 2 else 0
        nd -= choice == 1
        npf -= choice == 2
        granted += choice == 2
        c += 1
    n = issues - c
    if n > 0:
        p_turns = (cr + n) // (W + 1)
        if n - p_turns:
            dd = min(dd + q * (n - p_turns), md)
        if p_turns:
            pd = min(pd + q * r * p_turns, md * r)
        cr = (cr + n) % (W + 1)
    return (cr, dd, pd), granted


def _mirror_access(pool, st, slow, ids, prefetch=True):
    """``tier_access`` as ``csrc/tier_access.cu`` plans it, on host ints,
    with the chains split as the kernel splits them and walked in reverse
    order of their keys (any order of the chains must give the same
    state): the demand ids by set, id i at stamp + i + 1 (first match,
    first vacancy, first LRU minimum; each filled slot listed once); SPP
    update by signature-table entry, then by pattern row; predict (float32
    confidence), DWRR and the prefetch fills in order; only then is each
    listed slot copied once, from slow[block_of_slot[slot]]. Returns
    (state, fills per slot in this access)."""
    cfg = pool.cfg
    sets, ways = pool.num_sets, cfg.cache_ways
    tags, lru = st.cache.tags.view(-1).tolist(), st.cache.lru.view(-1).tolist()
    sob, bos = st.slot_of_block.tolist(), st.block_of_slot.tolist()
    stamp0 = int(st.cache.stamp)
    listed, writes = [], collections.Counter()
    set_of = lambda bid: _u32_hash(bid, 7) % sets

    def fill(bid, stamp):
        base = set_of(bid) * ways
        row = tags[base:base + ways]
        if 0 in row:
            way, evicted = row.index(0), -1
        else:
            lrow = lru[base:base + ways]
            way = lrow.index(min(lrow))
            evicted = row[way] - 1
        tags[base + way], lru[base + way] = bid + 1, stamp
        slot = base + way
        if evicted >= 0:
            sob[evicted] = -1
        sob[bid], bos[slot] = slot, bid
        if slot not in listed:
            listed.append(slot)
        writes[slot] += 1

    def by_key(keys):
        """{key: [i, ...] in id order}, the keys in reverse order."""
        groups = collections.defaultdict(list)
        for i, k in enumerate(keys):
            groups[k].append(i)
        return [groups[k] for k in sorted(groups, reverse=True)]

    ids_l = ids.tolist()
    n_miss = 0
    for chain in by_key([set_of(b) for b in ids_l]):
        for i in chain:
            bid, base = ids_l[i], set_of(ids_l[i]) * ways
            row = tags[base:base + ways]
            if bid + 1 in row:
                lru[base + row.index(bid + 1)] = stamp0 + i + 1
            else:
                n_miss += 1
                fill(bid, stamp0 + i + 1)
    stamp = stamp0 + len(ids_l)
    n_prefetched, wfq = 0, st.wfq
    if prefetch:
        sp = {k: v.view(-1).tolist() for k, v in st.spp._asdict().items()}
        ST, PT, ps = cfg.spp_signature_entries, cfg.spp_pattern_entries, pool.page_span
        mask = (1 << cfg.spp_signature_bits) - 1
        pages, blks = [b // ps for b in ids_l], [b % ps for b in ids_l]
        entry = [_u32_hash(p, 8) % ST for p in pages]
        row_of, delta_of, sigs = {}, {}, {}
        for chain in by_key(entry):
            for i in chain:
                idx, blk = entry[i], blks[i]
                hit = sp["st_tag"][idx] == pages[i] + 1
                delta, old = blk - sp["st_last"][idx], sp["st_sig"][idx]
                if hit and delta != 0:
                    row_of[i], delta_of[i] = old % PT, delta
                sigs[i] = ((old << 4) ^ (delta & mask)) & mask if hit else blk & mask
                sp["st_tag"][idx], sp["st_last"][idx], sp["st_sig"][idx] = pages[i] + 1, blk, sigs[i]
        for pt in sorted(set(row_of.values()), reverse=True):
            chain = sorted(i for i in row_of if row_of[i] == pt)
            # runs of one delta: the first trains, the rest only add weight
            runs = [list(g) for _, g in itertools.groupby(chain, key=lambda i: delta_of[i])]
            for run in runs:
                row, delta = pt * 4, delta_of[run[0]]
                d, w = sp["pt_delta"][row:row + 4], sp["pt_weight"][row:row + 4]
                live = [j for j in range(4) if d[j] == delta and w[j] > 0]
                way = live[0] if live else w.index(min(w))
                sp["pt_delta"][row + way] = delta
                w_new = min(w[way] + 1, 15) if live else 1
                sp["pt_weight"][row + way] = min(w_new + len(run) - 1, 15)
                if sp["pt_sigw"][pt] < 60:
                    sp["pt_sigw"][pt] = min(sp["pt_sigw"][pt] + len(run), 60)
        page = pages[-1]
        cur_sig, cur_blk, conf, alive = sigs[len(ids_l) - 1], blks[-1], np.float32(1.0), True
        cands = []
        for _ in range(pool.degree):
            row = cur_sig % PT * 4
            w = sp["pt_weight"][row:row + 4]
            way = w.index(max(w))
            step = np.float32(w[way]) / np.float32(max(sp["pt_sigw"][cur_sig % PT], 1))
            new_conf = conf * min(step * np.float32(4.0), np.float32(1.0))
            delta = sp["pt_delta"][row + way]
            nb = cur_blk + delta
            ok = (alive and w[way] > 0 and new_conf >= np.float32(cfg.spp_confidence_threshold)
                  and 0 <= nb < ps and delta != 0)
            cands.append((min(max(page * ps + (nb if ok else 0), 0), pool.num_blocks - 1), ok))
            if ok:
                cur_sig, cur_blk, conf = ((cur_sig << 4) ^ (delta & mask)) & mask, nb, new_conf
            alive = ok
        state, granted = _mirror_dwrr(
            tuple(int(x) for x in st.wfq), n_miss, sum(ok for _, ok in cands), pool.weight,
            cfg.wfq_quantum, cfg.wfq_max_deficit, pool.degree + len(ids_l))
        rank = -1
        for bid, ok in cands:
            rank += ok
            base = set_of(bid) * ways
            if ok and bid + 1 not in tags[base:base + ways] and rank < granted:
                n_prefetched += 1
                fill(bid, stamp + n_prefetched)
        for k, v in sp.items():
            getattr(st.spp, k).view(-1).copy_(torch.tensor(v, dtype=torch.int32))
        wfq = twfq.WfqState(*torch.tensor(state, dtype=torch.int32).unbind())
    # the metadata in place, then the copies of the listed slots
    st.cache.tags.view(-1).copy_(torch.tensor(tags, dtype=torch.int32))
    st.cache.lru.view(-1).copy_(torch.tensor(lru, dtype=torch.int32))
    st.cache.stamp.fill_(stamp + n_prefetched)
    st.slot_of_block.copy_(torch.tensor(sob, dtype=torch.int32))
    st.block_of_slot.copy_(torch.tensor(bos, dtype=torch.int32))
    for slot in listed:
        st.fast[slot] = slow[bos[slot]].to(st.fast.dtype)
    n_hit = np.float32(len(ids_l) - n_miss)
    counters = torch.tensor([st.hits + n_hit, st.demand_misses + np.float32(n_miss),
                             st.prefetch_hits + n_hit, st.prefetches + np.float32(n_prefetched)],
                            dtype=torch.float32)
    hits, misses, pf_hits, prefetches = counters.unbind()
    return st._replace(wfq=wfq, hits=hits, demand_misses=misses, prefetch_hits=pf_hits,
                       prefetches=prefetches), writes


@pytest.mark.parametrize("weight,quantum,max_deficit", [(2, 1, 8), (3, 2, 5), (1, 0, 4),
                                                        (2, -1, 8)])
def test_kernel_dwrr_plan_matches_the_schedule(weight, quantum, max_deficit):
    """The kernel's DWRR (the idle cycles in closed form) equals the host
    schedule on random states, rounds out of range and empty queues
    included."""
    rng = np.random.default_rng(weight * 7 + quantum)
    for _ in range(400):
        state = (int(rng.integers(-2, weight + 3)), int(rng.integers(-20, 12)),
                 int(rng.integers(-20, 12)))
        nd, npf = int(rng.integers(0, 40)), int(rng.integers(0, 6))
        issues = int(rng.integers(0, 60))
        want_state, order = twfq.schedule_batch_host(
            state, nd, npf, weight=weight, quantum=quantum, max_deficit=max_deficit, r=1,
            max_issues=issues)
        got = _mirror_dwrr(state, nd, npf, weight, quantum, max_deficit, issues)
        assert got == (want_state, order.count(twfq.PREFETCH))


def _mirror_streams(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        return [rng.integers(0, 64, 32).astype(np.int32) for _ in range(8)]
    # a sliding window over the blocks, larger than the fast tier: SPP
    # learns it, and every access evicts and refills slots
    return [((np.arange(32) + 5 * i) % 64).astype(np.int32) for i in range(8)]


@functools.lru_cache(maxsize=None)
def _j_access_dtype(fast_blocks, prefetch, dtype):
    pool = JPool(J_CFG, num_blocks=64, fast_blocks=fast_blocks, block_elems=8,
                 dtype=getattr(jnp, dtype))
    return pool, jax.jit(functools.partial(pool.access, prefetch=prefetch))


def _mirror_setup(prefetch, dtype):
    jpool, j_access = _j_access_dtype(16, prefetch, dtype)
    slow_np = np.random.default_rng(8).normal(size=(64, 8)).astype(np.float32)
    pool = TieredBlockPool(_cfg("torch"), 64, 16, 8, dtype=getattr(torch, dtype), device="cpu")
    return jpool, j_access, jnp.asarray(slow_np), pool, torch.from_numpy(slow_np)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind", ["random", "sliding"])
def test_kernel_plan_mirror_matches_plain_and_jax(kind, prefetch, dtype):
    """Fast tier 16 blocks (4 sets x 4 ways), K 32: the mirror of the
    kernel's plan, the plain loop and JAX leave the same TierState bit for
    bit after every access, and some access fills one slot twice."""
    jpool, j_access, j_slow, pool, slow = _mirror_setup(prefetch, dtype)
    jst, pst, mst = jpool.init(j_slow), pool.init(slow), pool.init(slow)
    twice, prefetched = 0, []
    for ids in _mirror_streams(kind):
        jst, _ = j_access(jst, j_slow, jnp.asarray(ids))
        t_ids = torch.from_numpy(ids)
        pst = pool._access_torch(pst, slow, t_ids, prefetch=prefetch)
        mst, writes = _mirror_access(pool, mst, slow, t_ids, prefetch)
        twice += max(writes.values()) > 1
        prefetched.append(float(mst.prefetches))
        assert_state_equal(jst, pst)
        assert_state_equal(jst, mst)
    assert twice > 0
    if prefetch and kind == "sliding":
        assert prefetched[-1] > 0


def test_routes_hand_over_mid_run():
    """A state passes plain loop -> kernel plan -> plain loop -> kernel
    plan every two accesses (the plan's counters and WFQ state are views
    of one tensor each, as the kernel leaves them) and stays JAX's."""
    jpool, j_access, j_slow, pool, slow = _mirror_setup(True, "float32")
    jst, st = jpool.init(j_slow), pool.init(slow)
    for i, ids in enumerate(_mirror_streams("sliding") + _mirror_streams("random")):
        jst, j_slots = j_access(jst, j_slow, jnp.asarray(ids))
        t_ids = torch.from_numpy(ids)
        if i // 2 % 2:
            st, _ = _mirror_access(pool, st, slow, t_ids)
        else:
            st = pool._access_torch(st, slow, t_ids)
        assert_state_equal(jst, st)
    assert float(st.prefetches) > 0


def test_tier_access_runs_the_plain_loop_on_cpu(monkeypatch):
    """On CPU tensors the pool runs its plain loop under either backend
    and the kernel wrapper is never reached (no launch counted); the
    wrapper itself takes CUDA tensors only and raises on any other device
    or on ids of another type; the pool refuses an unknown backend."""
    slow = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    for backend in ("cuda", "torch"):
        pool = TieredBlockPool(_cfg(backend), 64, 16, 8, dtype=torch.float32, device="cpu")
        calls = []
        plain = pool._access_torch
        monkeypatch.setattr(pool, "_access_torch",
                            lambda *a, **kw: calls.append(kw) or plain(*a, **kw))
        monkeypatch.setattr(pool, "_access_cuda", lambda *a, **kw: pytest.fail("kernel route"))
        before = tier_access.launches
        st = pool.init(slow)
        for prefetch in (True, False):
            st, _ = pool.access(st, slow, torch.tensor([3, 9, 3], dtype=torch.int32),
                                prefetch=prefetch)
        assert calls == [{"prefetch": True}, {"prefetch": False}]
        assert tier_access.launches == before
    args = (st.cache, (st.slot_of_block, st.block_of_slot), st.spp, st.wfq,
            (st.hits, st.demand_misses, st.prefetch_hits, st.prefetches), slow, st.fast)
    kw = dict(page_span=16, degree=4, sig_bits=12, threshold=0.25, weight=2, quantum=1,
              max_deficit=8)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="cuda tensors.*_access_torch"):
            tier_access(*args, torch.tensor([1], dtype=torch.int32, device=device), **kw)
    with pytest.raises(TypeError, match="ids"):
        tier_access(*args, torch.tensor([1], dtype=torch.int64), **kw)
    with pytest.raises(ValueError, match="kernel backend"):
        TieredBlockPool(_cfg("pallas"), 64, 16, 8, device="cpu").access(
            st, slow, torch.tensor([1], dtype=torch.int32))
    meta = TieredBlockPool(_cfg(), 64, 16, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu tensors, not meta"):
        meta.access(st, slow, torch.tensor([1], dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# TieredKV.decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("window,Hq,Hkv,D,lengths", [
    (0, 4, 2, 16, (8, 24, 64, 63)),
    (2, 2, 1, 8, (40, 41, 17)),
])
def test_decode_step_matches_jax(window, Hq, Hkv, D, lengths, backend):
    """Outputs within 2e-5 of JAX's decode_step (Pallas paged attention in
    interpret mode) and the same TierState after every step, at the shapes
    of tests/test_tiering.py, full and windowed."""
    S, T = 64, 8
    rng = np.random.default_rng(window + D)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    jtk = JTieredKV(fam_replace(JFamConfig(), cache_ways=4),
                    JKVConfig(block_tokens=T, fast_blocks=16, window_blocks=window),
                    max_blocks=S // T, kv_heads=Hkv, head_dim=D)
    ttk = TieredKV(FamConfig(cache_ways=4, kernel_backend=backend),
                   TieredKVConfig(block_tokens=T, fast_blocks=16, window_blocks=window),
                   max_blocks=S // T, kv_heads=Hkv, head_dim=D, device="cpu")
    j_slow = jtk.pack(jnp.asarray(k), jnp.asarray(v))
    t_slow = ttk.pack(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(np.asarray(j_slow), t_slow.numpy())
    jst, tst = jtk.init(j_slow), ttk.init(t_slow)
    for length in lengths:
        q = rng.normal(size=(Hq, D)).astype(np.float32)
        jst, j_out = jtk.decode_step(jst, j_slow, jnp.asarray(q),
                                     jnp.asarray(length, jnp.int32))
        tst, t_out = ttk.decode_step(tst, t_slow, torch.from_numpy(q), length)
        assert t_out.shape == (Hq, D)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
        assert_state_equal(jst, tst)


# ---------------------------------------------------------------------------
# ExpertTier.gather_experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_experts_matches_jax(dtype):
    """Gathered slabs and the state equal JAX's bit for bit. The slow tier
    is float32, so in bfloat16 every fill rounds float32 -> bfloat16 as
    XLA does (to nearest, ties to even)."""
    L, E, elems, fast = 4, 8, 32, 16
    rng = np.random.default_rng(1)
    slow_np = rng.normal(size=(L * E, elems)).astype(np.float32)
    # values on bfloat16 rounding ties and near them
    slow_np[0, :4] = np.array([0x3F808000, 0x3F818000, 0x3F808001, 0xBF817FFF],
                              np.uint32).view(np.float32)
    jtier = JExpertTier(J_CFG, L, E, elems, fast, dtype=getattr(jnp, dtype))
    ttier = ExpertTier(_cfg(), L, E, elems, fast, dtype=getattr(torch, dtype),
                       device="cpu")
    j_slow, t_slow = jnp.asarray(slow_np), torch.from_numpy(slow_np)
    j_gather = jax.jit(jtier.gather_experts)
    jst, tst = jtier.init(j_slow), ttier.init(t_slow)
    for step in range(12):
        experts = rng.choice(E, size=2, replace=False).astype(np.int32)
        if step % 3 == 0:
            experts[0] = 0            # slab 0 of layer 0 carries the ties
        layer = step % L
        jst, j_slabs = j_gather(jst, j_slow, jnp.int32(layer), jnp.asarray(experts))
        tst, t_slabs = ttier.gather_experts(tst, t_slow, layer, torch.from_numpy(experts))
        assert t_slabs.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(j_slabs), _bits(t_slabs))
        ids = ttier.slab_ids(layer, torch.from_numpy(experts)).numpy()
        np.testing.assert_array_equal(
            _bits(t_slabs), _bits(torch.from_numpy(slow_np[ids]).to(getattr(torch, dtype))))
        assert_state_equal(jst, tst)


def test_bf16_cast_rounds_like_xla():
    """float32 -> bfloat16 in torch equals XLA's bit for bit on random
    values and on rounding ties, denormals and infinities; NaN stays NaN
    (the two pick different NaN payloads)."""
    rng = np.random.default_rng(5)
    special = np.array([0x3F808000, 0x3F818000, 0x00008000, 0x00018000, 0x7F7FFFFF,
                        0x7F800000, 0xFF800000], np.uint32).view(np.float32)
    x = np.concatenate([rng.normal(size=4096).astype(np.float32) * 1e3, special])
    want = _bits(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(want, _bits(torch.from_numpy(x).to(torch.bfloat16)))
    assert torch.tensor([np.nan]).to(torch.bfloat16).isnan().all()


# ---------------------------------------------------------------------------
# handover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handover_from_jax_mid_run(dtype):
    """A JAX TierState after 10 accesses, carried across by from_numpy
    (bfloat16 through a uint16 view), continues in the port to the same
    state and slots as JAX over 10 more."""
    jpool = JPool(J_CFG, num_blocks=64, fast_blocks=32, block_elems=8,
                  dtype=getattr(jnp, dtype))
    slow_np = np.random.default_rng(2).normal(size=(64, 8)).astype(np.float32)
    j_slow = jnp.asarray(slow_np)
    j_access = jax.jit(jpool.access)
    jst = jpool.init(j_slow)
    seq = np.concatenate([np.arange(40), np.random.default_rng(4).integers(0, 64, 40)])
    steps = [seq[i:i + 4].astype(np.int32) for i in range(0, 80, 4)]
    for ids in steps[:10]:
        jst, _ = j_access(jst, j_slow, jnp.asarray(ids))
    tst = from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    assert_state_equal(jst, tst)
    assert tst.fast.dtype == getattr(torch, dtype)
    pool = TieredBlockPool(_cfg(), 64, 32, 8, dtype=getattr(torch, dtype), device="cpu")
    slow = torch.from_numpy(slow_np)
    for ids in steps[10:]:
        jst, j_slots = j_access(jst, j_slow, jnp.asarray(ids))
        tst, t_slots = pool.access(tst, slow, torch.from_numpy(ids))
        np.testing.assert_array_equal(np.asarray(j_slots), t_slots.numpy())
        assert_state_equal(jst, tst)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: TieredBlockPool(_cfg(), 64, 16, 8),
                 lambda: TieredKV(_cfg(), TieredKVConfig(), 8, 2, 16),
                 lambda: ExpertTier(_cfg(), 2, 8, 32, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_pool_refuses_a_slow_tier_elsewhere():
    """init refuses a slow tier on another device or of another shape, and
    the pool a fast tier that is not whole sets."""
    with pytest.raises(ValueError, match="multiple of cache_ways"):
        TieredBlockPool(_cfg(), 64, 18, 8, device="cpu")
    pool = TieredBlockPool(_cfg(), 64, 16, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="slow is on meta"):
        pool.init(torch.zeros((64, 8), device="meta"))
    with pytest.raises(ValueError, match="slow must be"):
        pool.init(torch.zeros((64, 9)))
