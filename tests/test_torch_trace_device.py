"""The port's threefry draws and device trace generator against JAX.

* ``repro_torch.traces.threefry`` against ``jax.random`` (threefry2x32,
  partitionable): ``fold_in``, ``split``, ``bits``, ``randint`` and
  ``uniform`` bit for bit; ``normal``'s uniform bit for bit and its values
  within NORMAL_RTOL (``torch.erfinv`` is not XLA's ``erf_inv``).
* ``repro_torch.traces.device`` against ``repro.traces.device``, every
  workload at T 1,000 and 1,536, seeds 0 and 1: every threefry draw and
  every address the zipf tail does not set bit for bit; tail addresses
  differ in at most TAIL_SHARE of the trace (the tail's float32 ``log`` and
  ``exp`` are torch's, not XLA's, so a rank's floor can land on the other
  integer); gaps within GAP_RTOL. Measured on the CPU at these sizes: at
  most 3.2 % (XSBench, a = 1.05), 2.1 % (657.xz_s, 1.1), 0.39 % (cc, 1.2),
  0.10 % (bc, 1.4); gaps 1.3e-5.
* ``src/repro_torch/testdata/trace_digests.json`` holds SHA-256 digests of
  JAX's draws for every workload at T 12,000, seed 0 (``chip_smoke.py``
  holds the card's draws to them); the port's CPU draws match them here.
  Regenerate it with ``python tests/test_torch_trace_device.py``.
"""
import hashlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.traces import device as jdev
from repro_torch.traces import backend as tbackend
from repro_torch.traces import device as tdev
from repro_torch.traces import threefry as tf
from repro_torch.traces.specs import (MIN_TILE_LINES, STREAMS_MAX, WORKLOAD_NAMES,
                                      WORKLOADS)

NORMAL_RTOL = 2e-5     # measured 5.4e-6 over 4 x 100,000 draws
GAP_RTOL = 5e-5        # measured 1.3e-5
#: the largest share of a trace whose zipf-tail address may differ from
#: JAX's, by skew exponent (a <= 1 has no tail)
TAIL_SHARE = {1.05: 0.06, 1.1: 0.05, 1.2: 0.01, 1.3: 0.005, 1.4: 0.005}
KEYS = [0, 1, 123456789, 2 ** 32 - 1]
DIGESTS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "testdata" / "trace_digests.json"
DIGEST_T, DIGEST_SEED = 12_000, 0
DRAWS = ("raw", "u", "uni", "starts", "bases", "spans")


def _jkey(seed):
    return jnp.array([0, seed], jnp.uint32)


def _tkey(seed):
    return torch.tensor([0, seed], dtype=torch.int64)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64))


@pytest.mark.parametrize("seed", KEYS)
def test_fold_in_split_bits_bit_exact(seed):
    k = _tkey(seed)
    for d in (0, 1, 6, 2 ** 31 + 7):
        _same(jax.random.fold_in(_jkey(seed), d), tf.fold_in(k, d))
    _same(jax.random.split(_jkey(seed), 3), tf.split(k, 3))
    _same(jax.random.bits(_jkey(seed), (7, 5)), tf.random_bits(k, (7, 5)))


@pytest.mark.parametrize("seed", KEYS)
def test_randint_bit_exact(seed):
    k = _tkey(seed)
    # span 1, maxval <= minval, the trace generator's 1 << 30, spans above
    # and below 2**16 (the multiplier wraps above it), the int32 extremes
    for lo, hi in [(0, 1), (5, 5), (7, 3), (0, 1 << 30), (-100, 100),
                   (0, 70_000), (-2 ** 31, 2 ** 31 - 1)]:
        _same(jax.random.randint(_jkey(seed), (1000,), lo, hi),
              tf.randint(k, (1000,), lo, hi))
    # a per-element maxval (some <= minval)
    mx = np.random.default_rng(seed % 2 ** 31).integers(-5, 10 ** 7, 1000).astype(np.int32)
    _same(jax.random.randint(_jkey(seed), (1000,), 0, jnp.asarray(mx)),
          tf.randint(k, (1000,), 0, torch.as_tensor(mx)))


def test_randint_batched_keys():
    """Keys with leading batch dims draw as JAX's vmap does, with a
    per-key bound."""
    keys = np.stack([np.array([0, s], np.uint32) for s in range(6)]).reshape(2, 3, 2)
    n = np.arange(1, 7, dtype=np.int32).reshape(2, 3) * 1000
    want = jax.vmap(jax.vmap(lambda k, m: jax.random.randint(k, (50,), 0, m)))(
        jnp.asarray(keys), jnp.asarray(n))
    _same(want, tf.randint(torch.as_tensor(keys.astype(np.int64)), (50,), 0,
                           torch.as_tensor(n)[..., None]))


@pytest.mark.parametrize("seed", KEYS)
def test_uniform_bit_exact(seed):
    k = _tkey(seed)
    for lo, hi in [(0.0, 1.0), (-3.5, 7.25), (0.1, 0.3), (2.0, 1e6)]:
        want = np.asarray(jax.random.uniform(_jkey(seed), (20_000,), jnp.float32, lo, hi))
        got = tf.uniform(k, (20_000,), lo, hi).numpy()
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed", KEYS)
def test_normal(seed):
    k = _tkey(seed)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want_u = np.asarray(jax.random.uniform(_jkey(seed), (20_000,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(want_u.view(np.int32),
                                  tf.uniform(k, (20_000,), float(lo), 1.0).numpy().view(np.int32))
    np.testing.assert_allclose(tf.normal(k, (20_000,)).numpy(),
                               np.asarray(jax.random.normal(_jkey(seed), (20_000,))),
                               rtol=NORMAL_RTOL, atol=0)


def _jax_draws(name, seed, T):
    """The reference generator's draws (``repro/traces/device.py``
    ``node_generator``), from its own key."""
    tp = jdev.trace_params(name, seed)
    sub = lambda i: jax.random.fold_in(jnp.asarray(tp.key), i)
    n, tile = int(tp.n_lines), int(tp.tile)
    K = T // (MIN_TILE_LINES // 2) + 2
    return {"raw": jax.random.randint(sub(0), (T,), 0, 1 << 30),
            "u": jax.random.uniform(sub(1), (T,)),
            "uni": jax.random.randint(sub(2), (T,), 0, n),
            "starts": jax.random.randint(sub(3), (STREAMS_MAX,), 0, n),
            "bases": jax.random.randint(sub(4), (K,), 0, max(n - tile, 1)),
            "spans": jax.random.randint(sub(5), (K,), tile // 2, tile)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("T", [1000, 1536])
def test_generator_against_jax(T, seed):
    for name in WORKLOAD_NAMES:
        tp = tdev.to_tensors(tdev.system_params((name,), seed), "cpu")
        addrs, gaps, parts = tdev.generate(tp, T, parts=True)
        for k, want in _jax_draws(name, seed, T).items():
            want = np.asarray(want)
            got = parts[k][0].numpy()
            np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32),
                                          err_msg=f"{name} {k}")
        ja, jg = jdev.system_traces([name], T, seed)
        addrs, tail = addrs[0].numpy(), parts["tail"][0].numpy()
        np.testing.assert_array_equal(ja[0][~tail], addrs[~tail], err_msg=name)
        share = float(np.mean(ja[0] != addrs))
        a = WORKLOADS[name].zipf_a
        assert share <= TAIL_SHARE.get(a, 0.0), (name, share)
        np.testing.assert_allclose(gaps[0].numpy(), jg[0], rtol=GAP_RTOL, atol=0,
                                   err_msg=name)


def test_trace_prefix_at_padded_length():
    """The draws are counter-based (element i hashes counter i whatever the
    shape), so a trace generated at a padded length begins with the trace
    at the true length, in JAX 0.9.0 (``jax_threefry_partitionable``) as in
    the port. The executor generates at the group's t_pad all the same, as
    the reference does."""
    for name in ("LU", "XSBench", "cc"):
        tp = tdev.to_tensors(tdev.system_params((name,), 0), "cpu")
        short, long = tdev.generate(tp, 1000), tdev.generate(tp, 1536)
        for a, b in zip(short, long):
            np.testing.assert_array_equal(a[0].numpy(), b[0].numpy()[:1000])
        j_short, j_long = jdev.system_traces([name], 1000, 0), jdev.system_traces([name], 1536, 0)
        for a, b in zip(j_short, j_long):
            np.testing.assert_array_equal(a[0], b[0][:1000])


def test_batched_generation_equals_per_system():
    """One (S, N) batch generates what each system does alone (the
    executor's group call), and the backend's system_traces is that."""
    systems = [("LU", "bfs"), ("XSBench", "mg"), ("cc", "is")]
    tp = tdev.to_tensors(tdev.stack_system_params(
        [tdev.system_params(w, s) for s, w in enumerate(systems)]), "cpu")
    addrs, gaps = tdev.node_generator(700)(tp)
    assert addrs.shape == gaps.shape == (3, 2, 700) and addrs.dtype == torch.int32
    for s, w in enumerate(systems):
        a, g = tbackend.system_traces(w, 700, s, backend="device", device="cpu")
        np.testing.assert_array_equal(a, addrs[s].numpy())
        np.testing.assert_array_equal(g, gaps[s].numpy())
    assert tbackend.get_backend("device").generate("LU", 700, 0, device="cpu")[0].dtype \
        == np.int64


def test_device_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.system_traces(["LU"], 100, 0)


def _digest(x) -> str:
    """SHA-256 of an array's values: integers as little-endian int64,
    floats as their float32 bits."""
    x = np.asarray(x)
    x = x.view(np.int32) if x.dtype == np.float32 else x
    return hashlib.sha256(x.astype("<i8").tobytes()).hexdigest()


def digests_from_jax():
    out = {"jax": jax.__version__, "T": DIGEST_T, "seed": DIGEST_SEED,
           "workloads": {}}
    for name in WORKLOAD_NAMES:
        tp = jdev.trace_params(name, DIGEST_SEED)
        draws = {k: np.asarray(v) for k, v in _jax_draws(name, DIGEST_SEED, DIGEST_T).items()}
        d = {k: _digest(v) for k, v in draws.items()}
        addrs = jdev.system_traces([name], DIGEST_T, DIGEST_SEED)[0][0]
        d["addrs_outside_tail"] = _digest(np.where(
            _tail_mask(int(tp.pattern), float(tp.zipf_a), float(tp.seq_frac),
                       draws["raw"], draws["u"], np.float32(tp.zipf_head_cdf[-1])),
            -1, addrs))
        out["workloads"][name] = d
    return out


def _tail_mask(pattern, zipf_a, seq_frac, raw, u, head_mass):
    """The reference's zipf-tail positions (``repro/traces/device.py``
    lines 196-221) from its exact draws."""
    take_seq = ((raw >> 6) & 1023).astype(np.float32) * np.float32(1.0 / 1024.0) < \
        np.float32(seq_frac)
    zipf_used = (pattern == 3) | ((pattern >= 4) & ~take_seq)
    return zipf_used & (np.float32(zipf_a) > 1.0) & ~(u <= head_mass)


def test_committed_digests_match_port():
    """The port's CPU draws at T 12,000 (and its addresses outside the tail,
    its own tail mask equal to the reference's) hash to the committed JAX
    digests."""
    gold = json.loads(DIGESTS.read_text())
    assert (gold["T"], gold["seed"]) == (DIGEST_T, DIGEST_SEED)
    assert list(gold["workloads"]) == list(WORKLOAD_NAMES)
    for name, want in gold["workloads"].items():
        tp = tdev.to_tensors(tdev.system_params((name,), DIGEST_SEED), "cpu")
        addrs, _, parts = tdev.generate(tp, DIGEST_T, parts=True)
        got = {k: _digest(parts[k][0].numpy()) for k in DRAWS}
        tail = parts["tail"][0].numpy()
        ref = tdev.trace_params(name, DIGEST_SEED)
        np.testing.assert_array_equal(tail, _tail_mask(
            int(ref.pattern), float(ref.zipf_a), float(ref.seq_frac),
            parts["raw"][0].numpy(), parts["u"][0].numpy(),
            np.float32(ref.zipf_head_cdf[-1])))
        got["addrs_outside_tail"] = _digest(np.where(tail, -1, addrs[0].numpy()))
        assert got == want, name


if __name__ == "__main__":
    DIGESTS.write_text(json.dumps(digests_from_jax(), indent=1) + "\n")
    print(f"wrote {DIGESTS}", file=sys.stderr)
