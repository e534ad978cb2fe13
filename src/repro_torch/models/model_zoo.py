"""Unified model API: config -> Model with init/loss/prefill/decode/init_cache.

Counterpart of ``repro.models.model_zoo`` for the dense and MoE families,
the ones the port runs so far (``transformer.py``); the other families
raise (ROADMAP A14). ``Model.init`` returns the parameters as a
:class:`repro_torch.models.transformer.LM` module (trainable parameters),
which ``loss``, ``prefill`` and ``decode`` take where the reference takes
its param pytree. :func:`params_from_numpy` loads the reference's param
pytree, as numpy arrays with the layer axis stacked, into that module, so
both packages compute the same thing.

``kernel_backend``: ``"cuda"`` sends the prefill's causal attention to the
hand-written kernel (its plain version on CPU tensors); ``"torch"`` runs
the reference's chunked attention in torch on any device. ``loss`` runs
the ``"torch"`` attention whatever the backend (see
:func:`repro_torch.models.transformer.lm_loss`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import KERNEL_BACKENDS, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import LM, Cache


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    kernel_backend: str = "cuda"

    # -- construction -------------------------------------------------------
    def init(self, seed) -> LM:
        """Weights drawn on the model's device from ``seed`` (an int, or a
        ``torch.Generator`` on that device)."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        return transformer.init_lm(gen, self.cfg, self.device)

    # -- training -----------------------------------------------------------
    def loss(self, params: LM, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"xent", "aux"}) of ``batch`` (``tokens``, ``labels`` and
        optionally ``mask``), differentiable in ``params``. Attention runs
        through the ``"torch"`` backend, as the reference trains through
        its jnp attention: the hand-written kernel has no backward."""
        return transformer.lm_loss(self.cfg, params, batch)

    # -- serving ------------------------------------------------------------
    def prefill(self, params: LM, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
        return transformer.prefill(self.cfg, params, batch["tokens"],
                                   batch.get("positions"), backend=self.kernel_backend)

    def decode(self, params: LM, cache: Cache, batch) -> Tuple[torch.Tensor, Cache]:
        """batch: ``tokens`` (B, 1) and ``index`` (an int: tokens already
        cached)."""
        return transformer.decode_step(self.cfg, params, cache, batch["tokens"],
                                       int(batch["index"]), batch.get("positions"))

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return transformer.init_kv_cache(self.cfg, batch, max_len, device=self.device)


def build_model(cfg: ModelConfig, device="cuda", kernel_backend: str = "cuda") -> Model:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported "
                                  f"(ROADMAP A14)")
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {kernel_backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    return Model(cfg, resolve_device(device), kernel_backend)


def pad_cache(cache: Cache, max_len: int) -> Cache:
    """Grow prefill-emitted KV caches to ``max_len`` along the seq axis so
    decode can continue appending."""
    out = {}
    for key, leaf in cache.items():
        if key in ("k", "v") and leaf.shape[2] < max_len:
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


def per_layer_arrays(cfg: ModelConfig, tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A reference pytree of numpy arrays, layers stacked on a leading axis
    -> ``{port name: array}`` with the layer axis split
    (``layers.attn.wq`` (L, ...) -> ``layers.0.attn.wq``, ...)."""
    flat = {}
    for name, arr in _flatten(tree):
        if name.startswith("layers."):
            arr = np.asarray(arr)
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: {arr.shape[0]} layers, config has "
                                 f"{cfg.num_layers}")
            for i in range(cfg.num_layers):
                flat[f"layers.{i}.{name[len('layers.'):]}"] = arr[i]
        else:
            flat[name] = arr
    return flat


def check_keys(what: str, got, want) -> None:
    if got.keys() != want.keys():
        raise KeyError(f"{what} keys differ: missing {sorted(want.keys() - got.keys())}, "
                       f"unexpected {sorted(got.keys() - want.keys())}")


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device="cuda") -> LM:
    """The reference's param pytree (``transformer.init_lm``: ``embed``,
    ``layers`` stacked on a leading layer axis, ``final_norm``) as numpy
    arrays -> the port's LM on ``device``, every key and shape checked.
    MoE layers carry ``layers.moe.router`` / ``w_gate`` / ``w_up`` /
    ``w_down`` and, with a dense residual, ``layers.dense_mlp.*``."""
    dev = resolve_device(device)
    lm = transformer.init_lm(None, cfg, dev)
    flat = per_layer_arrays(cfg, tree)
    params = dict(lm.named_parameters())
    check_keys("param", flat, params)
    for name, p in params.items():
        a = np.asarray(flat[name], dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
        p.copy_(torch.tensor(a).to(p.dtype))
    return lm
