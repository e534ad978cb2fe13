"""The port's nextline / bestoffset prefetchers and random replacement
against ``repro.policies``, on the same numpy inputs from a seed.

* Call for call: each policy's ``train`` / ``predict`` (prefetch) or
  ``evict`` (replacement) on L lanes, where JAX vmaps the per-lane policy,
  state bit for bit after every call. bestoffset is driven through a
  sequential stream (its candidate offsets tie: the first wins), random
  pages (no offset clears the threshold: the prefetcher disables itself)
  and short rounds (rollover every ``round_len`` trained accesses), and
  through a state whose scores tie exactly at a round's end.
* ``threefry.fold_in`` with one datum per key against ``jax.random.fold_in``.
* The whole simulator with ``prefetch=nextline|bestoffset`` and
  ``replacement=random`` (a cache small enough to evict) against
  ``repro.core.famsim.sweep``: counters exact, floats at RTOL
  (``tests/test_torch_famsim.py``).
* ``random`` has no mode in the CUDA cache step: ``kernel_backend="cuda"``
  with it raises, in the simulator and in the executor.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FamConfig as JFamConfig
from repro.core import famsim as jfam
from repro.core.fam_params import FamParams as JFamParams
from repro.core.fam_params import stack_params as j_stack_params
from repro.policies import PolicySet as JPolicySet
from repro.policies import get_policy as j_get_policy
from repro.traces import system_traces
from repro_torch import experiments as tx
from repro_torch.configs.base import FamConfig
from repro_torch.core import famsim as tfam
from repro_torch.policies import PolicySet, get_policy
from repro_torch.traces import threefry as tf

from test_torch_famsim import _assert_metrics

L = 12              # lanes per call-for-call check
DEGREE = 4
N, WL = 2, ["LU", "bfs"]


def _leaves(state):
    return [state] if isinstance(state, torch.Tensor) else list(state)


def _same_state(jstate, tstate, what=""):
    jl = jax.tree.leaves(jstate)
    tl = _leaves(tstate)
    assert len(jl) == len(tl), what
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def _pair(kind, name):
    return j_get_policy(kind, name), get_policy(kind, name)


@functools.lru_cache(maxsize=None)
def _j_train_fn(jp):
    return jax.jit(jax.vmap(lambda pp, s, pg, b, e: jp.train(JFamConfig(), pp, s, pg, b, e)))


@functools.lru_cache(maxsize=None)
def _j_predict_fn(jp, bpp):
    return jax.jit(jax.vmap(lambda pp, s, pg, b: jp.predict(
        JFamConfig(), pp, s, pg, b, jnp.int32(0), DEGREE, bpp)))


def _j_train(jp, params, state, page, block, en):
    """The JAX policy's train, vmapped over the lanes."""
    return _j_train_fn(jp)(params, state, page, block, en)


def _j_predict(jp, params, state, page, block, bpp):
    return _j_predict_fn(jp, bpp)(params, state, page, block)


def _check_predict(jp, tp, jparams, tparams, js, ts, page, block, bpp, what):
    jb, jv = _j_predict(jp, jparams, js, jnp.asarray(page), jnp.asarray(block), bpp)
    tb, tv = tp.predict(FamConfig(), tparams, ts, torch.from_numpy(page),
                        torch.from_numpy(block), None, DEGREE, bpp)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg=what)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy(), err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_nextline_matches_reference(seed):
    """Per-lane distances (0, fractional, negative) truncated to int32;
    candidates past either end of the page invalid."""
    jp, tp = _pair("prefetch", "nextline")
    rng = np.random.default_rng(seed)
    dist = np.array([1.0, 2.7, -1.0, 0.0, 3.0, -2.5] * 2, np.float32)
    jparams, tparams = {"distance": jnp.asarray(dist)}, {"distance": torch.from_numpy(dist)}
    js = jax.vmap(lambda _: jp.init(JFamConfig()))(jnp.arange(L))
    ts = tp.init(FamConfig(), (L,), "cpu")
    for step in range(20):
        page = rng.integers(0, 1 << 18, L).astype(np.int32)
        block = rng.integers(0, 16, L).astype(np.int32)
        en = rng.random(L) < 0.7
        js, _ = _j_train(jp, jparams, js, jnp.asarray(page), jnp.asarray(block),
                         jnp.asarray(en))
        ts, _ = tp.train(FamConfig(), tparams, ts, torch.from_numpy(page),
                         torch.from_numpy(block), torch.from_numpy(en))
        _same_state(js, ts, f"step {step}")
        _check_predict(jp, tp, jparams, tparams, js, ts, page, block, 16, f"step {step}")


def _bo_streams(rng, steps):
    """(pages, blocks, enable) of shape (steps, L): lanes 0-3 sequential
    within a page (every positive offset scores: a tie, won by the first),
    4-5 stride 2, 6-7 backwards, 8-9 random pages (below threshold: the
    prefetcher disables), 10-11 sequential with enable dropped at random."""
    pages = np.zeros((steps, L), np.int32)
    blocks = np.zeros((steps, L), np.int32)
    en = np.ones((steps, L), bool)
    t = np.arange(steps)
    for lane in range(L):
        kind = lane // 2
        if kind in (0, 1, 5):
            pages[:, lane] = 100 + lane + t // 16
            blocks[:, lane] = t % 16
        elif kind == 2:
            pages[:, lane] = 200 + lane + t // 8
            blocks[:, lane] = (2 * t) % 16
        elif kind == 3:
            pages[:, lane] = 300 + lane + t // 16
            blocks[:, lane] = 15 - t % 16
        else:
            pages[:, lane] = rng.integers(0, 1 << 20, steps)
            blocks[:, lane] = rng.integers(0, 16, steps)
    en[:, 10:] = rng.random((steps, 2)) < 0.6
    return pages, blocks, en


@pytest.mark.parametrize("round_len,threshold", [(64.0, 8.0), (8.0, 3.0), (5.0, 6.0)])
def test_bestoffset_matches_reference(round_len, threshold):
    """Call for call over 150 accesses: several round rollovers, ties
    among the candidate offsets, lanes below the threshold disabled, and
    masked accesses that change nothing; the whole BoState bit for bit
    after every call and every prediction."""
    jp, tp = _pair("prefetch", "bestoffset")
    steps = 150
    pages, blocks, en = _bo_streams(np.random.default_rng(3), steps)
    rl = np.full(L, round_len, np.float32)
    th = np.full(L, threshold, np.float32)
    jparams = {"round_len": jnp.asarray(rl), "score_threshold": jnp.asarray(th)}
    tparams = {"round_len": torch.from_numpy(rl), "score_threshold": torch.from_numpy(th)}
    js = jax.vmap(lambda _: jp.init(JFamConfig()))(jnp.arange(L))
    ts = tp.init(FamConfig(), (L,), "cpu")
    bests = set()
    for step in range(steps):
        args = [pages[step], blocks[step], en[step]]
        js, _ = _j_train(jp, jparams, js, *map(jnp.asarray, args))
        ts, _ = tp.train(FamConfig(), tparams, ts, *map(torch.from_numpy, args))
        _same_state(js, ts, f"step {step}")
        _check_predict(jp, tp, jparams, tparams, js, ts, pages[step], blocks[step],
                       16, f"step {step}")
        bests.update(ts.best.tolist())
    # the streams reach a disabled lane and, where a round can clear the
    # threshold, a winning offset
    assert 0 in bests and (len(bests) > 1) == (threshold <= round_len), bests


def test_bestoffset_score_tie_takes_the_first_offset():
    """At a round's end with scores tied between offsets 2 and 3 (and
    between -1 and -2 on another lane), the first of the tied offsets wins,
    as ``jnp.argmax`` picks it; a tie below the threshold disables."""
    jp, tp = _pair("prefetch", "bestoffset")
    K = 8
    scores = np.zeros((3, K), np.int32)
    scores[0, [1, 2]] = 9             # offsets 2, 3
    scores[1, [6, 7]] = 12            # offsets -1, -2
    scores[2, [0, 5]] = 2             # offsets 1, 8, below the threshold
    rnd = np.full(3, 63, np.int32)
    z = lambda *s: np.zeros((3,) + s, np.int32)
    state = (z(16), z(16), z(), scores, z(), rnd)
    jstate = type(jp.init(JFamConfig()))(*map(jnp.asarray, state))
    tstate = type(tp.init(FamConfig(), (3,), "cpu"))(*map(torch.from_numpy, state))
    ones = lambda v: np.full(3, v, np.float32)
    jparams = {"round_len": jnp.asarray(ones(64)), "score_threshold": jnp.asarray(ones(8))}
    tparams = {"round_len": torch.from_numpy(ones(64)),
               "score_threshold": torch.from_numpy(ones(8))}
    page = np.array([5, 6, 7], np.int32)
    block = np.array([9, 9, 9], np.int32)
    en = np.ones(3, bool)
    js, _ = _j_train(jp, jparams, jstate, *map(jnp.asarray, (page, block, en)))
    ts, _ = tp.train(FamConfig(), tparams, tstate, *map(torch.from_numpy, (page, block, en)))
    _same_state(js, ts)
    assert ts.best.tolist() == [2, -1, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_with_tensor_data_matches_jax(seed):
    """One datum per key (int32 stamps, set indices, uint32-range values),
    against ``jax.random.fold_in`` vmapped; the int path is unchanged."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, (L, 2), dtype=np.uint64).astype(np.uint32)
    data = rng.integers(-(1 << 31), 1 << 31, L).astype(np.int32)
    data[:3] = [0, 1, 2 ** 31 - 1]
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data))
    tkeys = torch.from_numpy(keys.astype(np.int64))
    got = tf.fold_in(tkeys, torch.from_numpy(data))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
    # a scalar tensor broadcasts over the keys like the int
    np.testing.assert_array_equal(tf.fold_in(tkeys, torch.tensor(7)).numpy(),
                                  tf.fold_in(tkeys, 7).numpy())


@pytest.mark.parametrize("w_pad", [16, 40])
def test_random_evict_matches_reference(w_pad):
    """``_RandomBound``: the victim drawn from fold_in(fold_in(key, stamp),
    set) at per-lane stamps and sets, over each lane's effective ways
    (below ``w_pad``, and 0 taken as 1); on_hit keeps the old value and
    insert_value is the stamp."""
    jb = j_get_policy("replacement", "random").bind({})
    tb = get_policy("replacement", "random").bind({})
    rng = np.random.default_rng(w_pad)
    lanes = 64
    row = rng.integers(0, 1000, (lanes, w_pad)).astype(np.int32)
    stamp = rng.integers(0, 1 << 30, lanes).astype(np.int32)
    stamp[:4] = [0, 1, 2, 2]
    sets = rng.integers(0, 4096, lanes).astype(np.int32)
    eff = rng.integers(0, w_pad + 1, lanes).astype(np.int32)
    eff[:3] = [0, 1, w_pad]
    wmask = np.arange(w_pad)[None, :] < eff[:, None]
    jrow, jway = jax.vmap(jb.evict)(*map(jnp.asarray, (row, wmask, stamp, sets, eff)))
    trow, tway = tb.evict(*map(torch.from_numpy, (row, wmask, stamp, sets, eff)))
    np.testing.assert_array_equal(np.asarray(jrow), trow.numpy())
    np.testing.assert_array_equal(np.asarray(jway), tway.numpy())
    assert (tway.numpy() < np.maximum(eff, 1)).all()
    old = torch.from_numpy(row[:, 0])
    assert torch.equal(tb.on_hit(old, torch.from_numpy(stamp)), old)
    assert torch.equal(tb.insert_value(torch.from_numpy(stamp)), torch.from_numpy(stamp))


# (PolicySet fields, kernel backend, FamConfig fields, T): a 16 KB cache
# (4 sets x 16 ways) fills, so the random victim decides evictions
SIM_CASES = {
    "nextline": (dict(prefetch="nextline"), "torch", {}, 400),
    "nextline_cuda_route": (dict(prefetch="nextline"), "cuda", {}, 400),
    "bestoffset": (dict(prefetch="bestoffset"), "torch", {}, 400),
    "bestoffset_strict_small_cache": (dict(prefetch="bestoffset", scheduler="strict"),
                                      "torch", dict(dram_cache_bytes=16 << 10), 400),
    "random": (dict(replacement="random"), "torch", dict(dram_cache_bytes=16 << 10), 300),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulator_with_new_policies_matches_reference(case):
    """build_sim against the JAX sweep (2 nodes, LU + bfs); the random
    case evicts."""
    fields, backend, cfg_fields, T = SIM_CASES[case]
    addrs, gaps = system_traces(WL, T, 7)
    jcfg = JFamConfig(sample_interval=64, **cfg_fields)
    jps = JPolicySet(**fields)
    jflags = jfam.SimFlags(bw_adapt=True)
    jout = jfam.sweep(jcfg, j_stack_params([JFamParams.of(jcfg, jflags, jps)]), None,
                      addrs[None], gaps[None], policies=jps)
    tcfg = FamConfig(sample_interval=64, kernel_backend=backend, **cfg_fields)
    run = tfam.build_sim(tcfg, tfam.SimFlags(bw_adapt=True), N,
                         policies=PolicySet(**fields), device="cpu")
    tout = run(addrs, gaps)
    _assert_metrics({k: np.asarray(v)[0] for k, v in jout.items()},
                    {k: v.numpy() for k, v in tout.items()}, err=case)
    if "dram_cache_bytes" in cfg_fields:
        # the cache filled: lines were evicted
        assert float(tout["cache_occupancy"].max()) > 0.9


def test_random_replacement_refuses_the_cuda_cache_step():
    """The CUDA cache step has no mode for ``random``: the simulator raises
    when it builds the step, and so does the executor, before running."""
    addrs, gaps = system_traces(WL, 50, 0)
    run = tfam.build_sim(FamConfig(kernel_backend="cuda"), tfam.SimFlags(), N,
                         policies=PolicySet(replacement="random"), device="cpu")
    with pytest.raises(ValueError, match="'random'"):
        run(addrs, gaps)
    exp = tx.Experiment(name="random_cuda", T=50, base=FamConfig(kernel_backend="cuda"),
                        nodes=N, trace_backend="numpy",
                        axes=(tx.workload_axis(["LU"]),
                              tx.policy_axis({"random": PolicySet(replacement="random")})))
    with pytest.raises(ValueError, match="'random'"):
        exp.run(device="cpu")
