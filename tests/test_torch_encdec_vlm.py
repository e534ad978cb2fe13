"""The port's audio (whisper: encoder-decoder, learned positions) and vlm
(qwen2-vl: M-RoPE) families against the JAX package, on the CPU, and the
serving launcher over the four families this slice adds.

Same inputs from numpy seeds through ``repro.models.layers`` /
``attention`` / ``encdec`` / ``transformer`` and their ports; the JAX
params (``Model.init``) are carried across with ``params_from_numpy``.
Tolerances, as in ``tests/test_torch_models.py``:

* float32 compute: atol 1e-5 x max|reference|, rtol 1e-5;
* bfloat16 compute (the configs' type): the teacher-forcing tolerance,
  atol 0.05 x max|reference|, rtol 0.05;
* integer outputs (greedy tokens) exactly.

M-RoPE equals RoPE when its three planes are equal, so its cases use
planes that differ: a text span, an image grid at one t, then text.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import attention as JA
from repro.models import build_model as j_build_model
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import pad_cache as j_pad_cache
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention as A
from repro_torch.models import build_model, pad_cache, params_from_numpy
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig

F32 = dict(scale=1e-5, rtol=1e-5)
BF16 = dict(scale=0.05, rtol=0.05)
AUDIO, VLM = "whisper-base-smoke", "qwen2-vl-72b-smoke"
ARCHS = (AUDIO, VLM)


def _close(got, want, scale, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, atol=scale * (np.abs(want).max() + 1e-3),
                               rtol=rtol)


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch), dtype=dtype),
            dataclasses.replace(get_config(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jfns(jc):
    """The reference's entry points for ``jc``, jitted once a config."""
    m = j_build_model(jc, None)
    if jc.is_encoder_decoder:
        fwd = jax.jit(lambda p, b: JE.forward(jc, None, p, b["tokens"], b["frames"])[0])
    else:
        fwd = jax.jit(lambda p, b: JT.forward(jc, None, p, b["tokens"], b["positions"])[0])
    return dict(init=jax.jit(m.init), prefill=jax.jit(m.prefill), decode=jax.jit(m.decode),
                forward=fwd, loss=jax.jit(jax.value_and_grad(m.loss, has_aux=True)))


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32", seed=1):
    jc, tc = _cfgs(arch, dtype)
    params = _jfns(jc)["init"](jax.random.PRNGKey(seed))
    module = params_from_numpy(tc, jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, module


def _x(shape, dtype="float32", seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _mrope_positions(B, S, grid=3, text=4):
    """(3, B, S) int32 (t, h, w) planes: ``text`` text tokens, a grid x grid
    image at one t (h and w walk its rows and columns), then text from
    past the image's largest position; sequence b starts at b."""
    pos = np.zeros((3, B, S), np.int32)
    for b in range(B):
        for i in range(S):
            j = i - text
            if i < text:
                pos[:, b, i] = b + i
            elif j < grid * grid:
                pos[:, b, i] = (b + text, b + text + j // grid, b + text + j % grid)
            else:
                pos[:, b, i] = b + text + grid + (j - grid * grid)
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    return pos


def _batch(arch, tc, B, S, seed=0):
    """(JAX batch, port batch): tokens, and frames (audio) or distinct M-RoPE
    planes (vlm)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if arch == AUDIO:
        fr = rng.standard_normal((B, tc.encoder_seq, tc.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    else:
        pos = _mrope_positions(B, S)
        jb["positions"], tb["positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    return jb, tb


def _prefix(b, n):
    """A batch cut to its first n tokens (frames whole, positions cut)."""
    out = dict(b, tokens=b["tokens"][:, :n])
    if "positions" in b:
        out["positions"] = b["positions"][:, :, :n]
    return out


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_learned_positions_match(dtype):
    """whisper's embedding: ``pos_embedding`` (max(encoder_seq, 65536),
    d_model) and token rows plus position rows, in the compute type;
    without positions the token rows alone."""
    jc, tc = _cfgs(AUDIO, dtype)
    _, _, params, module = _setup(AUDIO)
    assert module.embed.pos_embedding.shape == (65536, tc.d_model)
    tok = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 7)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 100, 4000, 65535, 7, 7, 0]], np.int32)
    got = L.embed_tokens(tc, module.embed, torch.from_numpy(tok), torch.from_numpy(pos))
    want = JL.embed_tokens(jc, params["embed"], jnp.asarray(tok), jnp.asarray(pos))
    assert got.dtype == L.torch_dtype(dtype)
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    plain = L.embed_tokens(tc, module.embed, torch.from_numpy(tok))
    np.testing.assert_array_equal(
        plain.detach().float().numpy(),
        np.asarray(JL.embed_tokens(jc, params["embed"], jnp.asarray(tok)), np.float32))
    assert not torch.equal(plain, got)


def test_mrope_matches_with_distinct_planes():
    """M-RoPE on (3, B, S) planes that differ, against JAX's: each frequency
    pair rotates by its section's plane (16 / 24 / 24 at qwen2-vl's D 128,
    4 / 6 / 6 at the smoke's D 32). Equal planes give RoPE of that plane,
    and distinct planes do not."""
    for arch in ("qwen2-vl-72b", VLM):
        jc, tc = j_get_config(arch), get_config(arch)
        jx, tx = _x((2, 22, 3, tc.head_dim), seed=6)
        pos = _mrope_positions(2, 22, grid=4, text=3) * 37
        got = L.apply_rope(tc, tx, torch.from_numpy(pos))
        _close(got, JL.apply_rope(jc, jx, jnp.asarray(pos)), **F32)
        rope = dataclasses.replace(tc, position="rope")
        same = np.broadcast_to(pos[1], pos.shape)
        np.testing.assert_array_equal(L.apply_rope(tc, tx, torch.from_numpy(same.copy())).numpy(),
                                      L.apply_rope(rope, tx, torch.from_numpy(pos[1])).numpy())
        assert not torch.allclose(got, L.apply_rope(rope, tx, torch.from_numpy(pos[0])))
    with pytest.raises(ValueError, match="mrope_sections"):
        L.apply_rope(dataclasses.replace(tc, mrope_sections=(4, 6, 5)), tx,
                     torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches(dtype):
    """Decoder queries (S 5) against precomputed encoder K/V (24 frames),
    unmasked, through both attention backends, and the K/V projection of
    the encoder's output."""
    jc, tc = _cfgs(AUDIO, dtype)
    _, _, params, module = _setup(AUDIO)
    jp, tp = params["decoder"]["xattn"], module.decoder[0].xattn
    jp = jax.tree.map(lambda a: a[0], jp)
    jx, tx = _x((2, 5, tc.d_model), dtype, seed=3)
    je, te = _x((2, tc.encoder_seq, tc.d_model), dtype, seed=4)
    _, jk, jv = JA.qkv_proj(jc, jp, jx, kv_x=je)
    k, v = A.kv_proj(tc, tp, te)
    _close(k, jk, **_tol(dtype))
    _close(v, jv, **_tol(dtype))
    want = JA.cross_attention(jc, jp, jx, (jk, jv))
    for backend in ("cuda", "torch"):
        with torch.no_grad():
            got = A.cross_attention(tc, tp, tx, (k, v), backend=backend)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _close(got, want, **_tol(dtype))


# ---------------------------------------------------------------------------
# the assemblies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keys_and_shapes(arch):
    """Every key of the reference's tree with its shape and values: whisper's
    ``encoder`` and ``decoder`` stacks (each its own count), ``enc_pos`` and
    ``embed.pos_embedding`` unstacked; qwen2-vl's ``layers``."""
    jc, tc, params, module = _setup(arch)
    names = dict(module.named_parameters())
    tree = jax.tree.map(np.asarray, params)
    stacks = ({"encoder": tc.encoder_layers, "decoder": tc.num_layers} if arch == AUDIO
              else {"layers": tc.num_layers})
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in stacks:
            assert leaf.shape[0] == stacks[keys[0]]
            for i in range(stacks[keys[0]]):
                got = names[".".join([keys[0], str(i)] + keys[1:])]
                np.testing.assert_array_equal(got.detach().numpy(), leaf[i])
                n += 1
        else:
            np.testing.assert_array_equal(names[".".join(keys)].detach().numpy(), leaf)
            n += 1
    assert n == len(names)
    if arch == AUDIO:
        assert names["enc_pos"].shape == (tc.encoder_seq, tc.d_model)
        assert "decoder.1.xattn.wk" in names and "embed.unembed" not in names
        bad = dict(tree, encoder=jax.tree.map(lambda a: a[:1], tree["encoder"]))
        with pytest.raises(ValueError, match="1 stacked, config has 2"):
            params_from_numpy(tc, bad, "cpu")
    bad = dict(tree, final_norm={})
    with pytest.raises(KeyError, match="final_norm"):
        params_from_numpy(tc, bad, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype):
    jc, tc, params, module = _setup(AUDIO, dtype)
    jb, tb = _batch(AUDIO, tc, 2, 6, seed=5)
    want = jax.jit(lambda p, f: JE.encode(jc, None, p, f))(params, jb["frames"])
    with torch.no_grad():
        got = E.encode(tc, module, tb["frames"])
    assert got.dtype == L.torch_dtype(dtype)
    _close(got, want, **_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(arch, dtype):
    """Teacher-forced logits: whisper over its frames, qwen2-vl over
    distinct M-RoPE planes; both attention backends."""
    jc, tc, params, module = _setup(arch, dtype)
    jb, tb = _batch(arch, tc, 2, 16, seed=6)
    want = _jfns(jc)["forward"](params, jb)
    with torch.no_grad():
        for backend in ("cuda", "torch"):
            if arch == AUDIO:
                logits, aux = E.forward(tc, module, tb["tokens"], tb["frames"],
                                        backend=backend)
            else:
                logits, aux = T.forward(tc, module, tb["tokens"], tb["positions"],
                                        backend=backend)
            assert float(aux) == 0.0
            _close(logits, want, **_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match(arch, dtype):
    """Model.prefill's last logits and cache (whisper: self K/V and the
    cross ``xk`` / ``xv``; qwen2-vl: K/V rotated by the M-RoPE planes),
    then 3 decode steps (positions broadcast from the index, as the
    reference's Engine decodes) against JAX's Model."""
    jc, tc, params, module = _setup(arch, dtype)
    jm, tm = _jfns(jc), build_model(tc, device="cpu")
    jb, tb = _batch(arch, tc, 2, 19, seed=7)
    PRE = 16
    jl, jcache = jm["prefill"](params, _prefix(jb, PRE))
    tl, tcache = tm.prefill(module, _prefix(tb, PRE))
    tol = _tol(dtype)
    _close(tl, jl, **tol)
    assert tcache.keys() == jcache.keys()
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], **tol)
    jcache, tcache = j_pad_cache(jcache, 19), pad_cache(tcache, 19)
    if arch == AUDIO:
        assert tcache["xk"].shape[2] == tc.encoder_seq and tcache["k"].shape[2] == 19
    for t in range(PRE, 19):
        jl, jcache = jm["decode"](params, jcache, {"tokens": jb["tokens"][:, t:t + 1],
                                                   "index": jnp.asarray(t, jnp.int32)})
        tl, tcache = tm.decode(module, tcache, {"tokens": tb["tokens"][:, t:t + 1],
                                                "index": t})
        _close(tl, jl, **tol)
        for key in jcache:
            _close(tcache[key], jcache[key], **tol)


def test_decode_matches_teacher_forcing():
    """Port only, bfloat16, whisper: prefill + step-by-step decode logits ==
    the full forward's (the property of tests/test_models.py:62)."""
    _, tc, _, module = _setup(AUDIO, "bfloat16")
    model = build_model(tc, device="cpu")
    _, tb = _batch(AUDIO, tc, 2, 12, seed=8)
    with torch.no_grad():
        full = E.forward(tc, module, tb["tokens"], tb["frames"])[0].float()
    PRE = 6
    logits, cache = model.prefill(module, _prefix(tb, PRE))
    cache = pad_cache(cache, 12)
    scale = float(full.abs().max()) + 1e-3
    for t in range(PRE, 12):
        np.testing.assert_allclose(logits.float().numpy(), full[:, t - 1].numpy(),
                                   atol=0.05 * scale, rtol=0.05)
        logits, cache = model.decode(module, cache, {"tokens": tb["tokens"][:, t:t + 1],
                                                     "index": t})


def test_routing_decoder_self_attention_only_reaches_the_kernel(monkeypatch):
    """whisper's prefill sends each encoder layer's bidirectional attention
    and each decoder layer's causal self-attention and cross-attention to
    the flash-attention wrapper; decode and the loss do not. qwen2-vl: one
    a layer."""
    calls = []
    real = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    for arch in ARCHS:
        _, tc, _, module = _setup(arch)
        model = build_model(tc, device="cpu")
        _, tb = _batch(arch, tc, 2, 8)
        calls.clear()
        _, cache = model.prefill(module, tb)
        want = tc.encoder_layers + 2 * tc.num_layers if arch == AUDIO else tc.num_layers
        assert len(calls) == want
        model.decode(module, pad_cache(cache, 9), {"tokens": tb["tokens"][:, :1], "index": 8})
        model.loss(module, dict(tb, labels=tb["tokens"]))
        assert len(calls) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    """Model.loss (whisper: the reference's mean xent over the decoder;
    qwen2-vl: lm_loss with its M-RoPE positions) and every parameter's
    gradient against jax.value_and_grad of the reference's."""
    from repro_torch.models.model_zoo import per_layer_arrays
    jc, tc, params, module = _setup(arch)
    jb, tb = _batch(arch, tc, 2, 16, seed=9)
    lab = np.random.default_rng(10).integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    jb, tb = dict(jb, labels=jnp.asarray(lab)), dict(tb, labels=torch.from_numpy(lab))
    (jloss, jm), jgrads = _jfns(jc)["loss"](params, jb)
    loss, m = build_model(tc, device="cpu").loss(module, tb)
    names, leaves = zip(*module.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    for got, want in ((loss, jloss), (m["xent"], jm["xent"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want = per_layer_arrays(tc, jax.tree.map(np.asarray, jgrads))
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * (np.abs(w).max() + 1e-6),
                                   rtol=1e-3, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_generated(arch):
    jc, tc, params, _ = _setup(arch)
    jb, _ = _batch(arch, tc, 3, 10, seed=11)
    return JEngine(j_build_model(jc, None), params,
                   JServeConfig(max_new_tokens=6)).generate(jb)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_greedy_tokens_equal_reference(arch, backend):
    """Engine.generate passes frames / positions to the prefill and decodes
    from any family's cache: the greedy tokens equal JAX's."""
    _, tc, _, module = _setup(arch)
    _, tb = _batch(arch, tc, 3, 10, seed=11)
    want, jstats = _jax_generated(arch)
    got, stats = Engine(build_model(tc, device="cpu", kernel_backend=backend), module,
                        ServeConfig(max_new_tokens=6)).generate(tb)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats


@pytest.mark.parametrize("arch", ["zamba2-2.7b-smoke", "xlstm-350m-smoke",
                                  "whisper-base-smoke", "qwen2-vl-72b-smoke"])
def test_serve_launcher_runs_every_new_family_on_cpu(arch, capsys):
    """``launch.serve`` builds the family's inputs (frames for audio, (3,
    B, S) positions for M-RoPE) and serves on the CPU."""
    serve_launch.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                       "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} generated 2x3 tokens in ")
    rows = [eval(line) for line in out[1:]]
    assert len(rows) == 2 and all(len(r) == 3 for r in rows)
    assert all(0 <= t < get_config(arch).vocab_size for r in rows for t in r)
