"""The port's prefetch, queue, throttle, controller and parameter modules
against the JAX reference, on the same numpy inputs from a seed.

Integer state (SPP tables, prefetch queue, token grants) and the token
bucket's float arithmetic must match bit for bit. The service-chain
timings are held at RTOL: both sides sum the chain in the same sequential
float32 order, but a timing is a sum of products that either compiler may
contract or reorder, which can move the last bit.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FamConfig as JFamConfig
from repro.core import addresses as jaddr
from repro.core import famsim as jfam
from repro.core import prefetch_queue as jpq
from repro.core import spp as jspp
from repro.core import throttle as jthr
from repro.core.fam_params import FamParams as JFamParams
from repro.policies import PolicySet as JPolicySet
from repro_torch.configs.base import FamConfig
from repro_torch.core import addresses as taddr
from repro_torch.core import famsim as tfam
from repro_torch.core import prefetch_queue as tpq
from repro_torch.core import spp as tspp
from repro_torch.core import throttle as tthr
from repro_torch.core.fam_params import FamParams, from_numpy, stack_params
from repro_torch.policies import PolicySet, get_policy

RTOL = 1e-6
L = 16          # lanes per randomized check
REPO = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(
        ttree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def _random_spp(rng, cfg):
    ST, PT = cfg.spp_signature_entries, cfg.spp_pattern_entries
    return jspp.SppState(
        st_tag=rng.integers(0, 40, (L, ST)).astype(np.int32),
        st_last=rng.integers(0, 64, (L, ST)).astype(np.int32),
        st_sig=rng.integers(0, 1 << cfg.spp_signature_bits, (L, ST)).astype(np.int32),
        pt_delta=rng.integers(-8, 9, (L, PT, 4)).astype(np.int32),
        pt_weight=rng.integers(0, 16, (L, PT, 4)).astype(np.int32),
        pt_sigw=rng.integers(0, 64, (L, PT)).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spp_update_and_predict_exact(seed):
    cfg = JFamConfig(spp_signature_entries=64, spp_pattern_entries=32)
    tcfg = FamConfig(spp_signature_entries=64, spp_pattern_entries=32)
    rng = np.random.default_rng(seed)
    state = _random_spp(rng, cfg)
    # pages that hit the table's tags half the time
    page = rng.integers(0, 40, L).astype(np.int32)
    block = rng.integers(0, 64, L).astype(np.int32)
    en = rng.random(L) < 0.8
    bpp = np.int32(64)
    thr = np.float32(0.25)

    def j_step(s, pg, b, e):
        s2, sig = jspp.update(cfg, s, pg, b, enable=e)
        blocks, valid = jspp.predict(cfg, s2, pg, b, sig, 4, bpp, thr)
        return s2, sig, blocks, valid

    js, jsig, jblocks, jvalid = jax.jit(jax.vmap(j_step))(state, page, block, en)
    ts = tspp.SppState(*(torch.from_numpy(x.copy()) for x in state))
    ts, tsig = tspp.update(tcfg, ts, torch.from_numpy(page),
                           torch.from_numpy(block), enable=torch.from_numpy(en))
    tblocks, tvalid = tspp.predict(tcfg, ts, torch.from_numpy(page),
                                   torch.from_numpy(block), tsig, 4,
                                   torch.tensor(bpp), torch.tensor(thr))
    _assert_tree_equal(js, ts)
    np.testing.assert_array_equal(np.asarray(jsig), tsig.numpy())
    np.testing.assert_array_equal(np.asarray(jblocks), tblocks.numpy())
    np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_prefetch_queue_exact(seed):
    rng = np.random.default_rng(seed)
    Q = 16
    # queues from nearly empty to full, so the 0.95 cap (15) and the
    # full-queue path both occur
    occupied = rng.random((L, Q)) < np.linspace(0.1, 1.0, L)[:, None]
    block = np.where(occupied, rng.integers(1, 30, (L, Q)), 0).astype(np.int32)
    finish = rng.random((L, Q)).astype(np.float32) * 100
    blk = rng.integers(0, 30, L).astype(np.int32)
    cands = rng.integers(0, 30, (L, 4)).astype(np.int32)
    fin = rng.random(L).astype(np.float32) * 100
    en = rng.random(L) < 0.8
    jq = jpq.PrefetchQueue(block, finish)

    def j_ops(q, b, c, f, e):
        inflight, ifin = jpq.contains(q, b)
        cand_in = jax.vmap(lambda x: jpq.contains(q, x)[0])(c)
        q2, ok = jpq.try_insert(q, b, f, 0.95, enable=e)
        return inflight, ifin, cand_in, q2, ok

    ji, jf, jc, jq2, jok = jax.jit(jax.vmap(j_ops))(jq, blk, cands, fin, en)
    tq = tpq.PrefetchQueue(torch.from_numpy(block.copy()), torch.from_numpy(finish.copy()))
    ti, tf = tpq.contains(tq, torch.from_numpy(blk))
    tc = tpq.contains(tq, torch.from_numpy(cands))[0]
    tq2, tok = tpq.try_insert(tq, torch.from_numpy(blk), torch.from_numpy(fin),
                              0.95, enable=torch.from_numpy(en))
    for a, b in ((ji, ti), (jf, tf), (jc, tc), (jok, tok)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_tree_equal(jq2, tq2)
    assert int(0.95 * Q) == 15 and not tok[-1]   # the full queue refuses


@pytest.mark.parametrize("seed", [0, 1])
def test_prefetch_queue_complete_until_exact(seed):
    """``complete_until`` retires the entries finished by each lane's
    ``now``: the queue, the completed blocks and the mask bit for bit."""
    rng = np.random.default_rng(seed)
    Q = 16
    occupied = rng.random((L, Q)) < 0.6
    block = np.where(occupied, rng.integers(1, 30, (L, Q)), 0).astype(np.int32)
    finish = rng.random((L, Q)).astype(np.float32) * 100
    now = (rng.random(L) * 100).astype(np.float32)
    now[0] = finish[0, 0]                        # finish == now retires
    jq, jb, jd = jax.jit(jax.vmap(jpq.complete_until))(
        jpq.PrefetchQueue(block, finish), now)
    tq = tpq.PrefetchQueue(torch.from_numpy(block.copy()), torch.from_numpy(finish.copy()))
    tq2, tb, td = tpq.complete_until(tq, torch.from_numpy(now))
    _assert_tree_equal(jq, tq2)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert td.any() and (~td & (tq.block > 0)).any()


def test_spp_storage_bits_equal_reference():
    for kw in (dict(), dict(spp_signature_entries=64, spp_pattern_entries=256),
               dict(spp_signature_bits=8)):
        assert tspp.storage_bits(FamConfig(**kw)) == jspp.storage_bits(JFamConfig(**kw)), kw


def _random_throttle(rng):
    f = lambda lo, hi: (lo + (hi - lo) * rng.random(L)).astype(np.float32)
    return jthr.ThrottleState(
        issue_rate=f(0.05, 1.0), tokens=f(0.0, 8.0), min_latency=f(200, 400),
        lat_sum=f(0, 5e5), lat_cnt=f(0, 600), lat_ema=np.where(
            rng.random(L) < 0.2, 0, f(200, 900)).astype(np.float32),
        pf_issued=f(0, 900), pf_useful=f(0, 600), acc_ema=f(0, 1),
        events=rng.integers(500, 530, L).astype(np.int32))


def _throttle_inputs(seed):
    rng = np.random.default_rng(seed)
    return (_random_throttle(rng), rng.integers(0, 5, L).astype(np.int32),
            rng.random(L) < 0.7, rng.random(L).astype(np.float32) * 900,
            rng.random(L) < 0.5, rng.random(L) < 0.5,
            rng.integers(0, 5, L).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_token_bucket_exact(seed):
    s, want, gate, lat, fam, hit, n_pf = _throttle_inputs(seed)

    def j_ops(st, w, g, la, fa, h, n):
        st, grant = jthr.take_tokens(st, w, g)
        return jthr.observe(st, la, fa, h, n, enable=g), grant

    js, jgrant = jax.jit(jax.vmap(j_ops))(s, want, gate, lat, fam, hit, n_pf)
    ts = tthr.ThrottleState(*(torch.from_numpy(x.copy()) for x in s))
    tg = torch.from_numpy(gate)
    ts, tgrant = tthr.take_tokens(ts, torch.from_numpy(want), tg)
    ts = tthr.observe(ts, torch.from_numpy(lat), torch.from_numpy(fam),
                      torch.from_numpy(hit), torch.from_numpy(n_pf), enable=tg)
    np.testing.assert_array_equal(np.asarray(jgrant), tgrant.numpy())
    _assert_tree_equal(js, ts)


@pytest.mark.parametrize("seed", [0, 1])
def test_adaptation_matches_reference(seed):
    """The sampling-cycle MIMD update. Held at RTOL, not bit for bit: in
    this standalone program XLA contracts the EMA's ``(1-a)*ema + a*x``
    into a fused multiply-add, which moves the last bit of ``lat_ema`` /
    ``acc_ema`` (and of what derives from them) against PyTorch's two
    rounded steps. The whole simulation, where XLA fuses differently, still
    matches bit for bit (test_torch_famsim.py)."""
    s, _, gate, *_ = _throttle_inputs(seed)
    pol = JPolicySet().numeric_params(JFamConfig())["adaptation"]
    tpol = {k: v.reshape(1) for k, v in PolicySet().numeric_params(FamConfig())[
        "adaptation"].items()}
    js = jax.jit(jax.vmap(lambda st, g: jthr.maybe_adapt(
        _j_adapt_view(pol), st, enabled=g)))(s, gate)
    ts = get_policy("adaptation", "token_bucket").adapt(
        None, tpol, tthr.ThrottleState(*(torch.from_numpy(x.copy()) for x in s)),
        torch.from_numpy(gate))
    for name, a, b in zip(js._fields, js, ts):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL, err_msg=name)


def _j_adapt_view(pol):
    from repro.policies.adaptation import _AdaptCfg
    return _AdaptCfg(pol["sample_interval"], pol["latency_noise_threshold"],
                     pol["mimd_increase"], pol["ema_alpha"], pol["min_issue_rate"])


def _arrivals(rng, S, K):
    arr = np.sort(rng.random((S, K)).astype(np.float32) * 500, axis=-1)
    # ties in arrival order exercise the stable FIFO sort
    arr[:, 1] = arr[:, 0]
    return arr, rng.random((S, K)) < 0.7


@pytest.mark.parametrize("scheduler", ["fifo", "wfq", "strict"])
def test_arbitrate_matches_reference(scheduler):
    rng = np.random.default_rng(3)
    S, N, D, CPF = 8, 3, 4, 2
    cfg, tcfg = JFamConfig(), FamConfig()
    jp = JFamParams.of(cfg, policies=JPolicySet(scheduler=scheduler))
    tp = stack_params([FamParams.of(tcfg, policies=PolicySet(scheduler=scheduler),
                                    device="cpu")] * S)
    tpn = tfam._per_node(tp)
    busy0 = (rng.random((S, 2)) * 600).astype(np.float32)
    d_arr, d_valid = _arrivals(rng, S, N)
    p_arr, p_valid = _arrivals(rng, S, N * (D + CPF))
    d_bytes = np.full((S, N), 64, np.float32)
    p_bytes = np.concatenate([np.full((S, N * D), 256, np.float32),
                              np.full((S, N * CPF), 64, np.float32)], -1)
    jimpl = jfam._resolve(JPolicySet(scheduler=scheduler)).impls().scheduler
    timpl = get_policy("scheduler", scheduler)
    jt = jax.jit(jax.vmap(lambda b, da, dv, db, pa, pv, pb: jimpl.arbitrate(
        jp, jp.policy["scheduler"], b, da, dv, db, pa, pv, pb)))(
        busy0, d_arr, d_valid, d_bytes, p_arr, p_valid, p_bytes)
    tt = timpl.arbitrate(tpn, tpn.policy["scheduler"],
                         *(torch.from_numpy(x) for x in (
                             busy0, d_arr, d_valid, d_bytes, p_arr, p_valid, p_bytes)))
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL)
    jok = jax.vmap(lambda b, c: jimpl.backlog_ok(jp, jp.policy["scheduler"], b, c))(
        busy0, d_arr)
    tok = timpl.backlog_ok(tpn, tpn.policy["scheduler"], torch.from_numpy(busy0),
                           torch.from_numpy(d_arr))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())


def test_address_split_and_fam_page_hash():
    b = np.array([0, 1, 64, 256, 4096, 1000, 2 ** 31 - 1, -5], np.int32)
    np.testing.assert_array_equal(np.asarray(jaddr.dyn_block_bits(b)),
                                  taddr.dyn_block_bits(torch.from_numpy(b)).numpy())
    addr = np.random.default_rng(0).integers(0, 2 ** 31 - 1, 500).astype(np.int32)
    for bb in (6, 7, 8, 9, 10, 12):
        bbt = torch.tensor(bb, dtype=torch.int32)
        jp, jb = jaddr.dyn_split(jnp.asarray(addr), jnp.int32(bb))
        tp_, tb_ = taddr.dyn_split(torch.from_numpy(addr), bbt)
        np.testing.assert_array_equal(np.asarray(jp), tp_.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb_.numpy())
        np.testing.assert_array_equal(
            np.asarray(jaddr.dyn_block_addr(jnp.asarray(addr), jnp.int32(bb))),
            taddr.dyn_block_addr(torch.from_numpy(addr), bbt).numpy())
    for bytes_ in (64, 128, 256, 512, 1024, 4096):
        assert taddr.blocks_per_page(bytes_) == jaddr.blocks_per_page(bytes_)
        jp, jb = jaddr.split(jnp.asarray(addr), bytes_)
        tp_, tb_ = taddr.split(torch.from_numpy(addr), bytes_)
        np.testing.assert_array_equal(np.asarray(jp), tp_.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb_.numpy())
        np.testing.assert_array_equal(np.asarray(jaddr.block_addr(jnp.asarray(addr), bytes_)),
                                      taddr.block_addr(torch.from_numpy(addr), bytes_).numpy())
        np.testing.assert_array_equal(
            np.asarray(jaddr.from_page_block(jp, jb, bytes_)),
            taddr.from_page_block(tp_, tb_, bytes_).numpy())
        assert taddr.split(int(addr[0]), bytes_) == jaddr.split(int(addr[0]), bytes_)
    page = addr >> 12
    for ratio in (1, 3, 8):
        np.testing.assert_array_equal(
            np.asarray(jfam._is_fam_page(jnp.int32(ratio), jnp.asarray(page))),
            tfam._is_fam_page(torch.tensor(ratio, dtype=torch.int32),
                              torch.from_numpy(page)).numpy())


@pytest.mark.parametrize("flags", [dict(), dict(wfq=True, wfq_weight=4),
                                   dict(bw_adapt=True, dram_prefetch=False)])
def test_params_from_numpy_match_port_params(flags):
    """JAX FamParams carried across with from_numpy equal the port's own
    FamParams.of, field by field (policy params included)."""
    jp = JFamParams.of(JFamConfig(block_bytes=512), jfam.SimFlags(**flags))
    tp = FamParams.of(FamConfig(block_bytes=512), tfam.SimFlags(**flags),
                      device="cpu")
    carried = from_numpy(_np_tree(jp), device="cpu")
    assert isinstance(carried, FamParams)
    assert carried.policy.keys() == tp.policy.keys()
    for k in tp.policy:
        assert carried.policy[k].keys() == tp.policy[k].keys()
    _assert_tree_equal(jp, tp)
    _assert_tree_equal(jp, carried)
    base = FamParams.of(FamConfig(block_bytes=512), device="cpu")
    _assert_tree_equal(jp, base.with_flags(tfam.SimFlags(**flags)))


def test_port_imports_no_jax_and_nothing_of_repro():
    """No module of the port, no ``examples/torch_*.py`` nor chip_smoke.py
    imports jax or the JAX package, by source and at run time (the
    simulator, the traces, the search with its objectives and fig_search,
    parallel/ with the sharded run, the launchers, the expert-parallel MoE,
    the model zoo and the train steps with the buffered decode and the
    abstract state, the analyzer with its runtime half, and the four
    examples)."""
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s,]|$)", re.M)
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = list((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] + \
        examples
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
    code = ("import sys, importlib.util, pathlib, repro_torch.core.famsim, "
            "repro_torch.traces, repro_torch.search, "
            "repro_torch.search.loop, repro_torch.tenants.search, "
            "repro_torch.benchmarks.fig_search, repro_torch.parallel, "
            "repro_torch.parallel.compat, repro_torch.parallel.compression, "
            "repro_torch.parallel.pipeline, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.models.moe, "
            "repro_torch.models.model_zoo, repro_torch.train.steps, "
            "repro_torch.analysis, repro_torch.analysis.runtime; "
            "specs = [importlib.util.spec_from_file_location(p.stem, p) "
            "for p in sorted(pathlib.Path(sys.argv[1]).glob('torch_*.py'))]; "
            "[s.loader.exec_module(importlib.util.module_from_spec(s)) for s in specs]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert len(specs) == 4 and not bad, bad")
    subprocess.run([sys.executable, "-c", code, str(REPO / "examples")], check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


def test_cuda_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfam.build_sim(FamConfig(), tfam.SimFlags(), 1)


def test_parallel_entry_points_default_to_cuda():
    """The parallel context, the model and the executor run on the card
    unless told otherwise; without one, the one-rank context refuses
    "cuda" rather than fall back to the CPU."""
    import inspect

    from repro_torch.experiments import executor
    from repro_torch.models import build_model
    from repro_torch.parallel import device_mesh, shard_params, single_device_context
    from repro_torch.parallel.sharding import distribute
    for fn in (single_device_context, build_model, executor.execute,
               executor.group_cache_keys, shard_params, device_mesh, distribute):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_device_context("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_device_context()
    ctx = single_device_context("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mesh(ctx.mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_params({"w": torch.zeros(2, 2)}, ctx)
