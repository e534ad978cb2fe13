"""Unified model API: config -> Model with init/loss/prefill/decode/init_cache.

Counterpart of ``repro.models.model_zoo``. Every architecture is served by
one of four assemblies:

    dense / moe / vlm -> transformer.py      hybrid -> zamba.py
    ssm (xlstm)       -> xlstm.py            audio  -> encdec.py

``Model.init`` returns the parameters as the assembly's ``nn.Module``
(trainable parameters), which ``loss``, ``prefill`` and ``decode`` take
where the reference takes its param pytree. :func:`params_from_numpy`
loads the reference's param pytree, as numpy arrays with each stack of
layers on a leading axis, into that module, so both packages compute the
same thing.

``kernel_backend``: ``"cuda"`` sends the prefill's attention (causal
self-attention, and the audio family's encoder and cross-attention) to
the hand-written kernel (its plain version on CPU tensors); ``"torch"``
runs the reference's chunked attention in torch on any device. ``loss``
runs the ``"torch"`` attention whatever the backend: the kernel has no
backward.

``ctx`` (``Model.ctx``) is the model's parallel context
(:class:`repro_torch.parallel.ParallelContext`, or None), passed down as
the reference passes it: MoE layers take ``moe_sharded`` under a context
with ``use_ep``, attention its chunk and schedule, training its ``remat``.
:func:`batch_specs` and :func:`cache_specs` give the partition specs of a
batch and a cache by their keys (``model_zoo.py:198-223``), and
:func:`batch_placements` / :func:`cache_placements` their DTensor
placements.

The sharded run: :meth:`Model.shard` turns the parameters into DTensors
placed by the reference's ``param_shardings`` over the context's mesh
(:func:`repro_torch.parallel.sharding.shard_params`); a batch distributed
by :func:`batch_placements` then runs through the same ``loss``,
``prefill`` and ``forward`` functions, whose activations the context
constrains where the reference constrains them. ``loss`` returns a
plain (replicated) loss, so ``torch.autograd`` takes it as it is; the
gradients are DTensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import KERNEL_BACKENDS, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer, xlstm, zamba
from repro_torch.models.layers import torch_dtype
from repro_torch.parallel.sharding import ParallelContext, is_dtensor, shard_params, spmd

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def init_params(gen, cfg: ModelConfig, device=None) -> nn.Module:
    """The assembly's module for ``cfg``, weights from ``gen``
    (uninitialised when ``gen`` is None)."""
    if cfg.xlstm is not None:
        return xlstm.init_xlstm_lm(gen, cfg, device)
    if cfg.ssm is not None:
        return zamba.init_zamba(gen, cfg, device)
    if cfg.is_encoder_decoder:
        return encdec.init_encdec(gen, cfg, device)
    return transformer.init_lm(gen, cfg, device)


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    kernel_backend: str = "cuda"
    ctx: Optional[ParallelContext] = None

    # -- construction -------------------------------------------------------
    def init(self, seed) -> nn.Module:
        """Weights drawn on the model's device from ``seed`` (an int, or a
        ``torch.Generator`` on that device)."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        return init_params(gen, self.cfg, self.device)

    def shard(self, params: nn.Module) -> nn.Module:
        """``params`` as DTensors over the context's mesh on the model's
        device, placed by ``param_shardings`` (in place; returned)."""
        if self.ctx is None:
            raise ValueError("Model.shard needs a parallel context (build_model(cfg, ctx))")
        return shard_params(params, self.ctx, self.device)

    # -- training -----------------------------------------------------------
    def loss(self, params: nn.Module, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"xent", "aux"}) of ``batch`` (``tokens``, ``labels``; the
        transformer also takes ``mask`` and ``positions``, the audio family
        needs ``frames``), differentiable in ``params``. Attention runs
        through the ``"torch"`` backend, as the reference trains through
        its jnp attention. On a sharded model the loss and its metrics are
        returned replicated, as plain tensors."""
        loss, metrics = self._loss(params, batch)
        if is_dtensor(loss):
            loss = loss.full_tensor()
            metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return loss, metrics

    @spmd
    def _loss(self, params: nn.Module, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        c, ctx = self.cfg, self.ctx
        if c.xlstm is not None:
            logits, aux, _ = xlstm.xlstm_forward(c, params, batch["tokens"], ctx=ctx)
        elif c.ssm is not None:
            logits, aux, _ = zamba.zamba_forward(c, params, batch["tokens"],
                                                 backend="torch", ctx=ctx)
        elif c.is_encoder_decoder:
            logits, aux = encdec.forward(c, params, batch["tokens"], batch["frames"],
                                         backend="torch", ctx=ctx)
        else:
            return transformer.lm_loss(c, params, batch, ctx=ctx)
        labels = batch["labels"].to(torch.int64)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        xent = -torch.gather(logp, -1, labels[..., None])[..., 0].mean()
        return xent + aux, {"xent": xent, "aux": aux}

    # -- serving ------------------------------------------------------------
    def prefill(self, params: nn.Module, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Any]:
        """(last logits (B, V), cache) of ``batch["tokens"]`` (and
        ``positions`` for M-RoPE, ``frames`` for the audio family)."""
        c, be, ctx = self.cfg, self.kernel_backend, self.ctx
        if c.xlstm is not None:
            return xlstm.xlstm_prefill(c, params, batch["tokens"], ctx=ctx)
        if c.ssm is not None:
            return zamba.zamba_prefill(c, params, batch["tokens"], backend=be, ctx=ctx)
        if c.is_encoder_decoder:
            return encdec.prefill(c, params, batch["tokens"], batch["frames"], backend=be,
                                  ctx=ctx)
        return transformer.prefill(c, params, batch["tokens"], batch.get("positions"),
                                   backend=be, ctx=ctx)

    def decode(self, params: nn.Module, cache, batch) -> Tuple[torch.Tensor, Any]:
        """batch: ``tokens`` (B, 1) and ``index`` (an int: tokens already
        cached)."""
        c = self.cfg
        tokens, index = batch["tokens"], int(batch["index"])
        if c.xlstm is not None:
            return xlstm.xlstm_decode_step(c, params, cache, tokens, index, ctx=self.ctx)
        if c.ssm is not None:
            return zamba.zamba_decode_step(c, params, cache, tokens, index)
        if c.is_encoder_decoder:
            return encdec.decode_step(c, params, cache, tokens, index)
        return transformer.decode_step(c, params, cache, tokens, index,
                                       batch.get("positions"), ctx=self.ctx)

    # -- a cell's inputs (the dry run's) --------------------------------------
    def batch_struct(self, shape) -> Dict[str, Any]:
        """The batch of a ``ShapeSpec`` cell, as zeros on the model's device
        (under a fake-tensor mode nothing is allocated): the reference's
        ``batch_struct`` keys and types. A decode batch's ``index`` is the
        int the port's decode takes: the cache's last slot."""
        c, dev = self.cfg, self.device
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "train":
            out = {"tokens": torch.zeros((B, S), dtype=i32, device=dev),
                   "labels": torch.zeros((B, S), dtype=i32, device=dev)}
        elif shape.kind == "prefill":
            out = {"tokens": torch.zeros((B, S), dtype=i32, device=dev)}
        else:
            out = {"tokens": torch.zeros((B, 1), dtype=i32, device=dev), "index": S - 1}
        if c.position == "mrope" and shape.kind != "decode":
            out["positions"] = torch.zeros((3, B, S), dtype=i32, device=dev)
        if c.is_encoder_decoder and shape.kind != "decode":
            out["frames"] = torch.zeros((B, c.encoder_seq, c.d_model),
                                        dtype=torch_dtype(c.dtype), device=dev)
        return out

    def cache_struct(self, shape):
        """The cache of a decode cell: ``shape.seq_len`` entries for
        ``shape.global_batch`` sequences (:meth:`init_cache`)."""
        return self.init_cache(shape.global_batch, shape.seq_len)

    def init_cache(self, batch: int, max_len: int):
        c, dev = self.cfg, self.device
        if c.xlstm is not None:
            return xlstm.init_xlstm_state(c, batch, dev)
        if c.ssm is not None:
            return zamba.init_zamba_cache(c, batch, max_len, dev)
        cache = transformer.init_kv_cache(c, batch, max_len, device=dev)
        if c.is_encoder_decoder:
            xshape = (c.num_layers, batch, c.encoder_seq, c.num_kv_heads, c.head_dim)
            dt = cache["k"].dtype
            cache["xk"] = torch.zeros(xshape, dtype=dt, device=dev)
            cache["xv"] = torch.zeros(xshape, dtype=dt, device=dev)
        return cache


def build_model(cfg: ModelConfig, ctx: Optional[ParallelContext] = None, device="cuda",
                kernel_backend: str = "cuda") -> Model:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; expected one of "
                         f"{FAMILIES}")
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {kernel_backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    return Model(cfg, resolve_device(device), kernel_backend, ctx)


# ---------------------------------------------------------------------------
# Logical-axis annotation for batch / cache trees (the reference's
# launch/dryrun reads these)
# ---------------------------------------------------------------------------

_BATCH_LOGICAL = {
    "tokens": ("batch", None), "labels": ("batch", None),
    "mask": ("batch", None), "frames": ("batch", None, None),
    "index": (),
}
_CACHE_LOGICAL = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "xk": ("layers", "batch", None, "kv_heads", None),
    "xv": ("layers", "batch", None, "kv_heads", None),
    "attn_k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "attn_v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "ssm": ("layers", "batch", "q_heads", None, None),
    "conv": ("layers", "batch", None, "inner"),
    "C": ("layers", "batch", None, None, None),
    "n": ("layers", "batch", None, None),
    "m": ("layers", "batch", None),
    "c": ("layers", "batch", None, None),
    "h": ("layers", "batch", None, None),
}


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, Mapping) else fn(k, v)
            for k, v in tree.items()}


def batch_specs(ctx: ParallelContext, struct, is_mrope: bool = False):
    """Partition specs of a batch (a dict of tensors or anything with
    ``shape``), by key."""
    return _map_leaves(lambda k, leaf: ctx.spec_for(tuple(leaf.shape),
                                                    _batch_logical(k, leaf)), struct)


def _batch_logical(key, leaf):
    nd = len(leaf.shape)
    if key == "positions":
        logical = (None, "batch", None) if nd == 3 else ("batch", None)
    else:
        logical = _BATCH_LOGICAL.get(key, (None,) * nd)
    return logical if len(logical) == nd else (None,) * nd


def _cache_logical(key, leaf):
    nd = len(leaf.shape)
    logical = _CACHE_LOGICAL.get(key, (None,) * nd)
    # slstm/mlstm "m"/"n" collide across dicts; fix rank mismatches
    return logical if len(logical) == nd else ("layers", "batch") + (None,) * (nd - 2)


def cache_specs(ctx: ParallelContext, struct):
    """Partition specs of a cache (nested dicts of tensors), by key."""
    return _map_leaves(lambda k, leaf: ctx.spec_for(tuple(leaf.shape),
                                                    _cache_logical(k, leaf)), struct)


def batch_placements(ctx: ParallelContext, struct) -> Dict[str, tuple]:
    """``{dotted key: DTensor placements}`` of a batch, by key, as
    :func:`batch_specs` (for :func:`repro_torch.parallel.sharding.distribute`)."""
    return dict(_flatten(_map_leaves(lambda k, leaf: ctx.placements_for(
        tuple(leaf.shape), _batch_logical(k, leaf)), struct)))


def cache_placements(ctx: ParallelContext, struct) -> Dict[str, tuple]:
    """``{dotted key: DTensor placements}`` of a cache, by key, as
    :func:`cache_specs`."""
    return dict(_flatten(_map_leaves(lambda k, leaf: ctx.placements_for(
        tuple(leaf.shape), _cache_logical(k, leaf)), struct)))


SEQ_KEYS = ("k", "v", "attn_k", "attn_v")   # caches that grow along axis 2


def pad_cache(cache, max_len: int):
    """Grow prefill-emitted KV caches (``k`` / ``v``, zamba's ``attn_k`` /
    ``attn_v``) to ``max_len`` along the seq axis so decode can continue
    appending. Recurrent states and the cross K/V (``xk`` / ``xv``) pass
    through."""
    out = {}
    for key, leaf in cache.items():
        if isinstance(leaf, Mapping):
            leaf = pad_cache(leaf, max_len)
        elif key in SEQ_KEYS and leaf.shape[2] < max_len:
            grown = leaf.new_zeros(leaf.shape[:2] + (max_len,) + leaf.shape[3:])
            grown[:, :, :leaf.shape[2]] = leaf
            leaf = grown
        out[key] = leaf
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def stacked_prefixes(cfg: ModelConfig) -> Dict[str, int]:
    """The param tree's stacks of layers and their leading counts."""
    if cfg.xlstm is not None:
        return {"pairs": xlstm.n_pairs(cfg)}
    if cfg.ssm is not None:
        return {"mamba_layers": cfg.num_layers}
    if cfg.is_encoder_decoder:
        return {"encoder": cfg.encoder_layers, "decoder": cfg.num_layers}
    return {"layers": cfg.num_layers}


def per_layer_arrays(cfg: ModelConfig, tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A reference pytree of numpy arrays, each stack of layers on a
    leading axis -> ``{port name: array}`` with that axis split
    (``layers.attn.wq`` (L, ...) -> ``layers.0.attn.wq``, ...; zamba's
    ``mamba_layers``, xLSTM's ``pairs``, the encoder-decoder's ``encoder``
    and ``decoder`` alike)."""
    stacks = stacked_prefixes(cfg)
    flat = {}
    for name, arr in _flatten(tree):
        top, _, rest = name.partition(".")
        if top in stacks and rest:
            arr = np.asarray(arr)
            if arr.shape[0] != stacks[top]:
                raise ValueError(f"{name}: {arr.shape[0]} stacked, config has "
                                 f"{stacks[top]}")
            for i in range(stacks[top]):
                flat[f"{top}.{i}.{rest}"] = arr[i]
        else:
            flat[name] = arr
    return flat


def check_keys(what: str, got, want) -> None:
    if got.keys() != want.keys():
        raise KeyError(f"{what} keys differ: missing {sorted(want.keys() - got.keys())}, "
                       f"unexpected {sorted(got.keys() - want.keys())}")


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device="cuda") -> nn.Module:
    """The reference's param pytree (``Model.init``'s) as numpy arrays ->
    the port's module on ``device``, every key and shape checked. Stacks
    of layers (:func:`stacked_prefixes`) are split; the embeddings,
    zamba's ``shared_attn`` and the encoder's ``enc_pos`` are not
    stacked."""
    dev = resolve_device(device)
    module = init_params(None, cfg, dev)
    flat = per_layer_arrays(cfg, tree)
    params = dict(module.named_parameters())
    check_keys("param", flat, params)
    for name, p in params.items():
        a = np.asarray(flat[name], dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
        p.copy_(torch.tensor(a).to(p.dtype))
    return module
