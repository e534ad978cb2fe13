"""The port's tiled attention against the JAX package's Pallas kernel.

On the CPU the CUDA wrapper runs its plain version, so these tests hold
that version (and the dispatcher) to the Pallas ``flash_attention`` run in
interpret mode, as ``tests/test_kernels.py`` runs it, over the same
shape/dtype/causal grid at the reference's tolerances: 2e-5 in float32 and
2e-2 in bfloat16 (the kernel takes the softmax online, tile by tile, the
plain version in one pass). Lengths the Pallas wrapper does not take
(Sq != Sk, lengths that are no tile multiple) are held to the JAX plain
version. They also check the wrapper's input checks, that it counts no
launch on CPU tensors, and that the CUDA source is built with the others.
Two kernels sit behind the wrapper, picked by type and head dim alone
(:func:`kernel.variant`): the tensor-core kernel for bfloat16 at D 64 and
128, the CUDA-core kernel for everything else; these tests check that
choice, the per-variant launch counts and that the wrapper's constants are
the source's. The kernels themselves are held to the same plain version on
the card by ``chip_smoke.py``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_attention_ref
from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention import (attention, flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel as fa_kernel

REPO = Path(__file__).resolve().parents[1]
TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, Hq, Hkv, D, bf16, seed=0):
    """numpy inputs, and the same values for JAX and for torch."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    if bf16:
        jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
        tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    else:
        jx = [jnp.asarray(a) for a in arrs]
        tx = [torch.from_numpy(a) for a in arrs]
    return jx, tx


def _close(got, want, bf16):
    tol = TOL["bfloat16" if bf16 else np.float32]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk", [
    (2, 64, 4, 2, 32, 16, 16),
    (1, 128, 8, 1, 16, 32, 32),     # MQA
    (2, 64, 4, 4, 64, 16, 32),      # MHA, rectangular tiles
    (1, 256, 2, 2, 8, 64, 64),
])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(B, S, Hq, Hkv, D, bq, bk, bf16, causal):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, S, Hq, Hkv, D, bf16)
    want = j_flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk, interpret=True)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (B, S, Hq, D)
    _close(got, want, bf16)


@pytest.mark.parametrize("Sq,Sk", [(32, 64), (64, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_unequal_lengths_match_pallas(Sq, Sk, causal):
    """Sq != Sk: causal rows are aligned top-left (row i sees keys 0..i)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, Sq, Sk, 4, 2, 16, False, seed=1)
    want = j_flash_attention(jq, jk, jv, causal=causal, bq=16, bk=16, interpret=True)
    _close(flash_attention(q, k, v, causal=causal), want, False)


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (37, 37), (37, 53), (70, 9)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_any_length_matches_jax_ref(Sq, Sk, bf16, causal):
    """Lengths that end mid-tile (the Pallas wrapper takes tile multiples
    only): held to the JAX plain version."""
    (jq, jk, jv), (q, k, v) = _inputs(1, Sq, Sk, 6, 3, 24, bf16, seed=2)
    want = j_flash_attention_ref(jq, jk, jv, causal=causal)
    _close(flash_attention(q, k, v, causal=causal), want, bf16)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 6])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_shapes_match_jax_ref(D, G, causal):
    """bf16 at the tensor-core head dims, G query heads per kv head and
    lengths that end mid-tile: the CPU wrapper (the plain version) against
    the JAX plain version."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 37, 53, 2 * G, 2, D, True, seed=5)
    assert fa_kernel.variant(q.dtype, D) == "tensor_core"
    want = j_flash_attention_ref(jq, jk, jv, causal=causal)
    _close(flash_attention(q, k, v, causal=causal), want, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 64, 128, 256])
def test_variant_is_chosen_by_type_and_head_dim(dtype, D):
    """bf16 at D 64 or 128 runs on the tensor cores; float32 (which needs
    true float32 products for its 2e-5) and bf16 at other D on the CUDA
    cores."""
    want = "tensor_core" if dtype == torch.bfloat16 and D in (64, 128) else "cuda_core"
    assert fa_kernel.variant(dtype, D) == want
    assert want in fa_kernel.VARIANTS


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                     (torch.float32, 64), (torch.bfloat16, 32)])
def test_cpu_wrapper_counts_no_launch_of_either_variant(dtype, D):
    _, (q, k, v) = _inputs(1, 9, 9, 4, 2, D, False, seed=6)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = dict(flash_attention.variant_launches)
    assert set(before) == set(fa_kernel.VARIANTS)
    flash_attention(q, k, v)
    assert flash_attention.variant_launches == before


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    _, (q, k, v) = _inputs(2, 40, 40, 8, 2, 16, False, seed=3)
    before = flash_attention.launches
    for causal in (True, False):
        want = flash_attention_ref(q, k, v, causal=causal)
        assert torch.equal(flash_attention(q, k, v, causal=causal), want)
        for backend in ("cuda", "torch"):
            assert torch.equal(attention(q, k, v, causal=causal, backend=backend), want)
    assert flash_attention.launches == before


def test_strided_views_are_taken():
    """q, k and v may be views along B, S and H (D contiguous)."""
    _, (q, k, v) = _inputs(2, 24, 24, 4, 2, 16, False, seed=4)
    kv = torch.stack([k, v], dim=2)          # (B, S, 2, Hkv, D)
    got = flash_attention(q[:, ::2], kv[:, ::2, 0], kv[:, ::2, 1])
    want = flash_attention_ref(q[:, ::2].contiguous(), k[:, ::2].contiguous(),
                               v[:, ::2].contiguous())
    assert torch.equal(got, want)


def _args():
    _, (q, k, v) = _inputs(1, 8, 8, 4, 2, 16, False)
    return {"q": q, "k": k, "v": v}


@pytest.mark.parametrize("field,bad,err,match", [
    ("q", lambda t: t.to(torch.float16), TypeError, "q must be"),
    ("q", lambda t: t.to(torch.int32), TypeError, "q must be"),
    ("k", lambda t: t.to(torch.bfloat16), TypeError, "k must be"),
    ("q", lambda t: t[0], ValueError, "q must have shape"),
    ("k", lambda t: t[..., :8], ValueError, "k must have shape"),
    ("k", lambda t: torch.cat([t, t]), ValueError, "k must have shape"),
    ("v", lambda t: t[:, :4], ValueError, "v must have shape"),
    ("k", lambda t: t.transpose(2, 3).contiguous().transpose(2, 3), ValueError,
     "k must be contiguous along D"),
    ("k", lambda t: torch.cat([t, t[:, :, :1]], dim=2), ValueError, "kv heads"),
    ("v", lambda t: t.to("meta"), ValueError, "v is on meta"),
])
def test_wrapper_rejects_bad_inputs(field, bad, err, match):
    args = _args()
    args[field] = bad(args[field])
    if field == "k" and match == "kv heads":
        args["v"] = args["k"]
    with pytest.raises(err, match=match):
        flash_attention(**args)


@pytest.mark.parametrize("D", [4, 12, 264])
def test_wrapper_rejects_head_dims_the_kernel_does_not_take(D):
    _, (q, k, v) = _inputs(1, 4, 4, 2, 1, D, False)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, k, v)


def test_wrapper_rejects_other_devices_and_backends():
    args = {k: v.to("meta") for k, v in _args().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(**args)
    with pytest.raises(ValueError, match="kernel backend"):
        attention(**_args(), backend="pallas")


@pytest.mark.parametrize("name,constant", [("ROWS", "kRows"), ("MAX_D", "kMaxD")])
def test_wrapper_limits_are_the_source_constants(name, constant):
    """The wrapper checks head dims and the grid against the source's own
    constants."""
    found = re.search(rf"constexpr int {constant} = (\d+);", fa_kernel.SOURCE.read_text())
    assert found and int(found.group(1)) == getattr(fa_kernel, name)


@pytest.mark.parametrize("name,constant", [
    ("TC_ROWS", "kTcRows"), ("TC_KEYS", "kTcKeys"),
    ("TC_STAGES[64]", "kTcStages64"), ("TC_STAGES[128]", "kTcStages128")])
def test_tensor_core_constants_are_the_source_constants(name, constant):
    """Rows per CTA, keys per tile and ring stages of the tensor-core kernel
    are the source's constexprs."""
    found = re.search(rf"constexpr int {constant} = (\d+);", fa_kernel.SOURCE.read_text())
    attr, _, key = name.partition("[")
    value = getattr(fa_kernel, attr)
    if key:
        value = value[int(key[:-1])]
    assert found and int(found.group(1)) == value


def test_tensor_core_entry_takes_the_wrapper_head_dims_and_arguments():
    """The C entry launches the tensor-core kernel for exactly TC_DIMS, and
    the wrapper's ctypes signature has one type per C parameter."""
    text = fa_kernel.SOURCE.read_text()
    dims = re.findall(r"if \(D == (\d+)\) return launch_wgmma<(\d+)>", text)
    assert [(int(a), int(b)) for a, b in dims] == [(d, d) for d in fa_kernel.TC_DIMS]
    for symbol, entry in (("flash_attention_wgmma", fa_kernel._wgmma_entry),
                          ("flash_attention", fa_kernel._entry)):
        sig = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*{{', text, re.S).group(1)
        assert entry.symbol == symbol and len(entry.argtypes) == sig.count(",") + 1


def test_source_holds_both_kernels():
    """The tensor-core kernel (wgmma fed by TMA through mbarriers, a
    producer warpgroup giving its registers to the consumers) sits beside
    the CUDA-core kernel (cp.async tiles), under names the profiler tells
    apart."""
    text = fa_kernel.SOURCE.read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "setmaxnreg.dec", "setmaxnreg.inc", "cuTensorMapEncodeTiled",
                   "__pipeline_memcpy_async", "flash_attention_wgmma_kernel(",
                   "flash_attention_kernel("):
        assert needle in text, needle
    assert "flash_attention_kernel" not in "flash_attention_wgmma_kernel"


def test_source_exists_and_is_built_with_the_others():
    """chip_smoke.py lists the source beside the other five, and nvcc.build_all
    compiles that list: one library per source under its package's build/."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    src, replaces = chip_smoke.KERNELS["flash_attention"]
    assert (REPO / src) == fa_kernel.SOURCE and fa_kernel.SOURCE.is_file()
    assert replaces == "src/repro/kernels/flash_attention/kernel.py:66"
    assert "def flash_attention" in (REPO / replaces.split(":")[0]).read_text() \
        .splitlines()[65]
    text = fa_kernel.SOURCE.read_text()
    assert 'extern "C" int flash_attention(' in text
    assert "__pipeline_memcpy_async" in text
    assert len(chip_smoke.KERNELS) == 6
    assert nvcc.library_path(fa_kernel.SOURCE).parent == fa_kernel.SOURCE.parent.parent / "build"


def test_build_all_runs_nvcc_on_the_source(tmp_path, monkeypatch):
    """With a stand-in nvcc on PATH, build_all compiles the kernel's source
    for sm_90a into the library named by its hash."""
    log = tmp_path / "args"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$@\" > " + str(log) + "\n"
                    "while [ $# -gt 1 ]; do if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    src = tmp_path / "flash_attention" / "csrc" / "flash_attention.cu"
    src.parent.mkdir(parents=True)
    src.write_bytes(fa_kernel.SOURCE.read_bytes())
    (lib, _), = nvcc.build_all([src])
    assert lib == nvcc.library_path(src) and lib.exists()
    args = log.read_text()
    assert "arch=compute_90a,code=sm_90a" in args and str(src) in args


def test_new_modules_import_no_jax_at_run_time():
    code = ("import sys, repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.configs.registry, repro_torch.kernels.flash_attention; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
