"""The port's fused cache step against the JAX reference ``cache_step_ref``.

On the CPU the CUDA wrapper runs its plain version, so these tests hold
that version (and the dispatcher around it) to the JAX reference bit for
bit over random padded geometries, fill counts C, probe counts P and both
replacement modes. The kernel itself is held to the same plain version on
the card by ``chip_smoke.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import dram_cache as jdc
from repro.kernels.famsim_step import cache_step_ref as j_cache_step_ref
from repro.policies.replacement import SRRIP as J_SRRIP
from repro_torch.core import dram_cache as tdc
from repro_torch.kernels.famsim_step import (FUSED_REPLACEMENT_MODES,
                                             cache_step, fused_cache_step,
                                             fused_replacement_mode)
from repro_torch.policies.replacement import SRRIP as T_SRRIP

LANES = 3


@functools.lru_cache(maxsize=None)
def _jax_ref(srrip):
    """The JAX reference, vmapped over lanes and jitted once per mode."""
    policy = J_SRRIP.bind(None) if srrip else None
    return jax.jit(jax.vmap(functools.partial(j_cache_step_ref, policy=policy)))


@settings(max_examples=12, deadline=None)
@given(pad_sets=st.sampled_from([4, 8, 16]),
       pad_ways=st.sampled_from([2, 4, 8]),
       sets_frac=st.lists(st.floats(0.25, 1.0), min_size=LANES, max_size=LANES),
       ways_frac=st.lists(st.floats(0.25, 1.0), min_size=LANES, max_size=LANES),
       srrip=st.booleans(), c=st.integers(1, 4), p=st.integers(1, 6),
       backend=st.sampled_from(["cuda", "torch"]),
       seed=st.integers(0, 2 ** 16))
def test_cache_step_matches_reference(pad_sets, pad_ways, sets_frac,
                                      ways_frac, srrip, c, p, backend, seed):
    """State and outputs equal the JAX reference's after every step of a
    random op stream; each lane has its own effective geometry strictly
    inside the padding."""
    eff_sets = np.array([max(1, int(pad_sets * f)) for f in sets_frac], np.int32)
    eff_ways = np.array([max(1, int(pad_ways * f)) for f in ways_frac], np.int32)
    tpol = T_SRRIP.bind(None) if srrip else None
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(lambda x: np.broadcast_to(x, (LANES,) + x.shape),
                       jdc.init_cache(pad_sets, pad_ways))
    port = tdc.init_cache(pad_sets, pad_ways, batch=(LANES,))
    for _ in range(3):
        fills = rng.integers(0, 120, (LANES, c)).astype(np.int32)
        fen = rng.random((LANES, c)) < 0.7
        demand = rng.integers(0, 120, LANES).astype(np.int32)
        den = rng.random(LANES) < 0.8
        probes = rng.integers(0, 120, (LANES, p)).astype(np.int32)
        port, hit, phits = cache_step(
            port, torch.from_numpy(fills), torch.from_numpy(fen),
            torch.from_numpy(demand), torch.from_numpy(den),
            torch.from_numpy(probes), torch.from_numpy(eff_sets),
            torch.from_numpy(eff_ways), policy=tpol, backend=backend)
        ref, rhit, rphits = _jax_ref(srrip)(ref, fills, fen, demand, den,
                                            probes, eff_sets, eff_ways)
        np.testing.assert_array_equal(np.asarray(rhit), hit.numpy())
        np.testing.assert_array_equal(np.asarray(rphits), phits.numpy())
        for a, b in zip(ref, port):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _wrapper_args(lanes=(2,), sets=8, ways=4, C=2, P=3):
    i32 = torch.int32
    return dict(
        tags=torch.zeros(lanes + (sets, ways), dtype=i32),
        lru=torch.zeros(lanes + (sets, ways), dtype=i32),
        stamp=torch.zeros(lanes, dtype=i32),
        fill_blocks=torch.tensor([3, 9], dtype=i32).expand(lanes + (C,)).contiguous(),
        fill_enable=torch.ones(lanes + (C,), dtype=torch.bool),
        demand_block=torch.full(lanes, 3, dtype=i32),
        demand_enable=torch.ones(lanes, dtype=torch.bool),
        probe_blocks=torch.tensor([3, 5, 9], dtype=i32).expand(lanes + (P,)).contiguous(),
        num_sets=torch.full(lanes, sets, dtype=i32),
        ways=torch.full(lanes, ways, dtype=i32))


def test_raw_wrapper_shapes():
    """State keeps its padded shape and is updated in place; hit is (lanes,)
    bool, probe hits (lanes, P) bool; no launch is counted on the CPU."""
    args = _wrapper_args()
    before = fused_cache_step.launches
    hit, phits = fused_cache_step(**args, mode="lru", max_rrpv=0)
    assert fused_cache_step.launches == before
    assert args["tags"].shape == (2, 8, 4) and args["lru"].shape == (2, 8, 4)
    assert hit.shape == (2,) and hit.dtype == torch.bool
    assert phits.shape == (2, 3) and phits.dtype == torch.bool
    assert hit.all()                          # block 3 was just filled
    np.testing.assert_array_equal(phits.numpy(), [[True, False, True]] * 2)
    assert args["stamp"].tolist() == [3, 3]    # 2 fills + 1 touch, in place


@pytest.mark.parametrize("field,bad,err", [
    ("fill_enable", lambda t: t.to(torch.int32), TypeError),
    ("tags", lambda t: t.to(torch.int64), TypeError),
    ("num_sets", lambda t: t[:1], ValueError),
    ("probe_blocks", lambda t: t.t().contiguous().t(), ValueError),
    ("stamp", lambda t: t.reshape(2, 1), ValueError),
])
def test_raw_wrapper_rejects_bad_inputs(field, bad, err):
    args = _wrapper_args()
    args[field] = bad(args[field])
    with pytest.raises(err, match=field):
        fused_cache_step(**args, mode="lru")


def test_unsupported_modes_and_backends_raise():
    args = _wrapper_args()
    with pytest.raises(ValueError, match="mode"):
        fused_cache_step(**args, mode="random")
    state = tdc.CacheState(args["tags"], args["lru"], args["stamp"])
    with pytest.raises(ValueError, match="kernel backend"):
        cache_step(state, args["fill_blocks"], args["fill_enable"],
                   args["demand_block"], args["demand_enable"],
                   args["probe_blocks"], args["num_sets"], args["ways"],
                   backend="pallas")
    assert FUSED_REPLACEMENT_MODES == ("lru", "srrip")
    assert fused_replacement_mode(None) == ("lru", 0)
    assert fused_replacement_mode(T_SRRIP.bind(None)) == ("srrip", 3)

    class Random:
        name = "random"
    with pytest.raises(ValueError, match="kernel_backend='cuda'"):
        fused_replacement_mode(Random())
