"""xLSTM blocks: mLSTM (matrix memory, exponential gating, stabilised) and
sLSTM (scalar memory with recurrent gating), per arXiv:2405.04517.

Counterpart of ``repro.models.xlstm``. Both recurrences run token by
token in float32 (a Python loop in place of ``lax.scan``); decode is the
same cell for one step. With ``cfg.xlstm.parallel_mlstm`` (the ``-fast``
variants) a sequence longer than one token takes the chunked-parallel
mLSTM (:func:`apply_mlstm_chunked`): within a chunk decay-masked
attention, across chunks the matrix memory updated once a chunk; exact,
stabilisers included.

State of an mLSTM block: C (B, H, Dk, Dv), n (B, H, Dk), m (B, H); of an
sLSTM block: c, n, h, m (B, H, Dh); ``m`` starts at -1e9.

On DTensors (the model's sharded run) whose model axis does not divide
the heads but is a multiple of them (xlstm-350m's 4 heads on 8 ranks),
the mLSTM recurrence is split along Dv: each rank keeps the block of
``main @ wv``'s columns it holds, which lies within one head, and runs
:func:`mlstm_cell` / :func:`_mlstm_chunk` on that head's q, k and gates
(gathered whole, as before) and its own Dv columns of v, C and h
(:func:`_split_scan`). Every term that touches v, C or h works column by
column, and the denominators use only n, q and m, so no rank exchanges
anything. h, C, n and m are DTensors on the model axis unflattened into
(heads, Dv blocks) (:func:`_head_mesh`): h and C sharded along Dv, n and
m by head; ``_merge_heads`` hands h on in ``main @ wv``'s own placement.
The sLSTM is not split this way: its block-diagonal recurrent matrix
mixes the columns of a head, so its input projection is gathered whole
along the heads.

The LM
(:class:`XLSTMLM`: ``embed``, ``pairs`` of ``norm_m`` / ``mlstm`` /
``norm_s`` / ``slstm``, ``final_norm``) stacks them per pair:
``{"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "h", "m"}}`` with a
leading pair axis.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import _whole, _WholeGrad, split_heads
from repro_torch.models.layers import dense_init, normal, param, torch_dtype
from repro_torch.parallel.sharding import is_dtensor, spmd

State = Dict[str, torch.Tensor]
F32 = torch.float32


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor it runs on each rank's shard (a
    ``Partial`` input reduced first): DTensor has no sharding rule for
    its backward."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import DTensor, Replicate
    placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = x.redistribute(x.device_mesh, placements)
    return DTensor.from_local(F.logsigmoid(x.to_local()), x.device_mesh, placements,
                              run_check=False)


def _mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    H = cfg.num_heads
    return d_in, H, d_in // H


class MLSTM(nn.Module):
    """``up`` (d_model, 2 d_in), ``wq`` / ``wk`` / ``wv`` (d_in, d_in),
    ``wif`` (d_in, 2 H), ``down`` (d_in, d_model), ``skip_scale``
    (d_in,)."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        d_in, H, _ = _mlstm_dims(cfg)
        pdt = torch_dtype(cfg.param_dtype)
        self.up = param(dense_init(gen, cfg.d_model, 2 * d_in, pdt, device))
        self.wq = param(dense_init(gen, d_in, d_in, pdt, device))
        self.wk = param(dense_init(gen, d_in, d_in, pdt, device))
        self.wv = param(dense_init(gen, d_in, d_in, pdt, device))
        self.wif = param(dense_init(gen, d_in, 2 * H, pdt, device))
        self.down = param(dense_init(gen, d_in, cfg.d_model, pdt, device,
                                     scale=1.0 / np.sqrt(d_in * 2 * cfg.num_layers)))
        self.skip_scale = param(torch.ones((d_in,), dtype=pdt, device=device))


def mlstm_cell(q, k, v, log_i, log_f, state):
    """One step. q/k/v: (B, H, Dk|Dv); log_i/log_f: (B, H); state = (C, n,
    m). Returns (h (B, H, Dv), new state)."""
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    f_ = torch.exp(log_f + m - m_new)[..., None]
    i_ = torch.exp(log_i - m_new)[..., None]
    C = f_[..., None] * C + i_[..., None] * (k[..., :, None] * v[..., None, :])
    n = f_ * n + i_ * k
    denom = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                          torch.exp(-m_new)) + 1e-6
    h = torch.einsum("bhkv,bhk->bhv", C, q) / denom[..., None]
    return h, (C, n, m_new)


def _mlstm_inputs(cfg: ModelConfig, p: MLSTM, x: torch.Tensor):
    """(main, z, q, k (B, S, H, dk), v (B, S, H * dk), its heads not yet
    split, all of x's type, log_i, log_f (B, S, H) float32)."""
    d_in, H, dk = _mlstm_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    up = x @ p.up.to(dt)
    if is_dtensor(up):
        up = _GradAs.apply(up)
    main, z = up.chunk(2, dim=-1)
    q = split_heads(main @ p.wq.to(dt), H, dk) / np.sqrt(dk)
    k = split_heads(main @ p.wk.to(dt), H, dk) / np.sqrt(dk)
    v = main @ p.wv.to(dt)
    gif = split_heads((main @ p.wif.to(dt)).to(F32), H, 2)
    log_f = _logsigmoid(gif[..., 1] + 3.0)   # bias toward remembering
    return main, z, q, k, v, gif[..., 0], log_f


def _merge_heads(h: torch.Tensor, heads: int, flat: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """(B, S, heads, D) -> (B, S, heads * D). On a DTensor the backward
    gathers the cotangent's last dim where the model axis does not divide
    ``heads``, so it splits back into the heads (as ``attention.out_proj``
    does). An h split along D by :func:`_split_scan` holds, on each rank,
    the columns of ``flat`` (``main @ wv``) that rank holds: it takes
    ``flat``'s mesh and placements, and its cotangent comes back in them."""
    if flat is not None and is_dtensor(h) and h.device_mesh != flat.device_mesh:
        from torch.distributed.tensor import DTensor
        local = h.to_local()
        shape = h.shape[:2] + flat.shape[-1:]
        return DTensor.from_local(local.reshape(local.shape[:2] + (-1,)), flat.device_mesh,
                                  flat.placements, run_check=False, shape=shape,
                                  stride=_contiguous(shape))
    h = h.reshape(h.shape[:2] + (-1,))
    return _WholeGrad.apply(h, -1, heads) if is_dtensor(h) else h


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    return tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))


class _GradAs(torch.autograd.Function):
    """The identity on a DTensor, whose backward hands on the cotangent in
    the forward's placements. On the up projection: ``chunk`` gathers main
    and z, whose cotangents come back partial and split by columns, and
    DTensor would join them whole, taking the weight gradient whole on
    every rank; pinned, each rank takes its own columns'."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


class _SplitGrad(torch.autograd.Function):
    """The identity, whose backward hands on the cotangent divided by
    ``parts``: for an output that ``parts`` ranks compute alike from
    inputs whose gradients are then summed over those ranks."""

    @staticmethod
    def forward(ctx, x, parts):
        ctx.parts = parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.parts, None


def _dv_axis(v: torch.Tensor, heads: int, head_dim: int) -> Optional[int]:
    """The mesh axis along which DTensor ``v`` (B, S, heads * head_dim) is
    split into blocks that each lie within one head: the one axis that
    shards its last dim, of a size that ``heads`` does not divide but
    divides, with ``head_dim`` a multiple of the blocks a head. None where
    there is none (the heads then split as a whole, or are gathered)."""
    axes = [i for i, pl in enumerate(v.placements)
            if pl.is_shard() and pl.dim % v.ndim == v.ndim - 1]
    if len(axes) != 1:
        return None
    size = v.device_mesh.size(axes[0])
    if size <= heads or size % heads or head_dim % (size // heads):
        return None
    others = [pl for i, pl in enumerate(v.placements) if i != axes[0]]
    if not all(pl.is_replicate() or (pl.is_shard() and pl.dim == 0) for pl in others):
        return None
    return axes[0]


@functools.lru_cache(maxsize=None)
def _head_mesh(mesh, axis: int, heads: int):
    """``mesh`` with ``axis`` unflattened into (heads, ranks a head): the
    mesh of :func:`_split_scan`'s outputs. Made once a mesh (a collective:
    every rank makes it, in the same order), with every dispatch mode off:
    its rank arithmetic is no work of the program (the dry run's fake
    tensors and op counter)."""
    name = mesh.mesh_dim_names[axis] if mesh.mesh_dim_names else f"dim{axis}"
    with _disable_current_modes():
        return mesh._unflatten(axis, (heads, mesh.size(axis) // heads),
                               (f"{name}_heads", f"{name}_dv"))


def _split_scan(scan, q, k, v, log_i, log_f, state, axis: int):
    """``scan`` on this rank's Dv columns (module docstring): q, k (B, S, H,
    Dk) and the gates (B, S, H) whole along ``axis``, v (B, S, H * Dv)
    sharded along it, ``state`` None, :func:`_split_scan`'s own outputs or
    whole along ``axis`` (DTensors or plain tensors). Returns (h (B, S, H,
    Dv), (C, n, m)), DTensors on :func:`_head_mesh`. Each rank's backward
    gives its Dv columns' share of the gradients of the whole inputs, which
    are marked partial sums along ``axis``; n and m, computed alike by the
    ranks of a head, split their cotangent among them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, S, H, dk = q.shape
    mesh = v.device_mesh
    per = mesh.size(axis) // H
    head, block = divmod(mesh.get_local_rank(axis), per)
    w = dk // per
    sub = _head_mesh(mesh, axis, H)
    hd, cols = slice(head, head + 1), slice(block * w, (block + 1) * w)

    def whole(t):
        """Placements of a tensor whole along ``axis``, batch as v's."""
        return tuple(Replicate() if i == axis else pl for i, pl in enumerate(v.placements))

    def on_sub(*inner):
        """Placements on ``sub``: the other axes as v's, ``axis``'s two
        given."""
        out = list(v.placements)
        out[axis:axis + 1] = inner
        return tuple(out)

    def local(t, partial=None):
        """The local tensor of ``t``, whole along ``axis``; its backward a
        partial sum along ``partial`` (default ``axis``) of ``t``'s mesh."""
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if t.device_mesh != sub:
            t = t.redistribute(mesh, whole(t))
        at = axis if partial is None else partial
        return t.to_local(grad_placements=tuple(Partial() if i == at else pl
                                                for i, pl in enumerate(t.placements)))

    q_, k_ = (local(t)[:, :, hd].to(F32) for t in (q, k))
    li, lf = (local(t)[:, :, hd] for t in (log_i, log_f))
    v_ = v.to_local().to(F32)
    v_ = v_.reshape(v_.shape[:2] + (1, w))
    if state is None:
        b = v_.shape[0]
        st = (torch.zeros((b, 1, dk, w), dtype=F32, device=v_.device),
              torch.zeros((b, 1, dk), dtype=F32, device=v_.device),
              torch.full((b, 1), -1e9, dtype=F32, device=v_.device))
    else:
        C, n, m = state["C"], state["n"], state["m"]
        if is_dtensor(C) and C.device_mesh == sub:
            # this rank's blocks; n and m alike on the ranks of a head
            st = (C.to_local(), local(n, axis + 1), local(m, axis + 1))
        else:
            st = (local(C)[:, hd, :, cols], local(n)[:, hd], local(m)[:, hd])
    h, (C, n, m) = scan(q_, k_, v_, li, lf, st)

    def out(t, shape, *inner):
        return DTensor.from_local(t, sub, on_sub(*inner), run_check=False, shape=shape,
                                  stride=_contiguous(shape))
    return (out(h, (B, S, H, dk), Shard(2), Shard(3)),
            (out(C, (B, H, dk, dk), Shard(1), Shard(3)),
             out(_SplitGrad.apply(n, per), (B, H, dk), Shard(1), Replicate()),
             out(_SplitGrad.apply(m, per), (B, H), Shard(1), Replicate())))


def _mlstm_scan(cfg: ModelConfig, scan, q, k, v, log_i, log_f, state, batch, device):
    """(h (B, S, H, Dv), (C, n, m)) of ``scan(q, k, v, log_i, log_f, (C, n,
    m))``, q / k / v (B, S, H, D) in float32, from ``state`` (the initial
    state when None); v comes flat (B, S, H * Dv). Split along Dv where
    the model axis does not divide the heads (:func:`_split_scan`)."""
    d_in, H, dk = _mlstm_dims(cfg)
    axis = _dv_axis(v, H, dk) if is_dtensor(v) else None
    if axis is not None:
        return _split_scan(scan, q, k, v, log_i, log_f, state, axis)
    v = split_heads(v, H, dk)
    if state is None:
        state = init_mlstm_state(cfg, batch, device)
    st = (state["C"], state["n"], state["m"])
    return scan(q.to(F32), k.to(F32), v.to(F32), log_i, log_f, st)


def _scan_tokens(q, k, v, log_i, log_f, st):
    """The mLSTM token by token: (h (B, S, H, Dv), the state after the
    last token)."""
    hs = []
    for t in range(q.shape[1]):
        h, st = mlstm_cell(q[:, t], k[:, t], v[:, t], log_i[:, t], log_f[:, t], st)
        hs.append(h)
    return torch.stack(hs, dim=1), st


def _mlstm_out(cfg: ModelConfig, p: MLSTM, h, main, z):
    dt = main.dtype
    h = h.to(dt) + main * p.skip_scale.to(dt)
    return (h * F.silu(z)) @ p.down.to(dt)


def apply_mlstm(cfg: ModelConfig, p: MLSTM, x: torch.Tensor, state: Optional[State] = None):
    """x: (B, S, d_model) -> (y, new state); the recurrence in float32."""
    if cfg.xlstm.parallel_mlstm and x.shape[1] > 1:
        return apply_mlstm_chunked(cfg, p, x, state)
    d_in, H, dk = _mlstm_dims(cfg)
    main, z, q, k, v, log_i, log_f = _mlstm_inputs(cfg, p, x)
    h, st = _mlstm_scan(cfg, _scan_tokens, q, k, v, log_i, log_f, state, x.shape[0], x.device)
    h = _merge_heads(h, H, v)
    return _mlstm_out(cfg, p, h, main, z), {"C": st[0], "n": st[1], "m": st[2]}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> State:
    d_in, H, dk = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, H, dk, dk), dtype=F32, device=device),
            "n": torch.zeros((batch, H, dk), dtype=F32, device=device),
            "m": torch.full((batch, H), -1e9, dtype=F32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    return H, cfg.d_model // H, int(cfg.d_model * cfg.xlstm.proj_factor_slstm)


class SLSTM(nn.Module):
    """``wx`` (d_model, 4 d_model), ``r`` (4, H, Dh, Dh) block-diagonal
    recurrent weights (one block a gate and head), ``up`` (d_model, 2
    d_up), ``down`` (d_up, d_model)."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        H, dh, d_up = _slstm_dims(cfg)
        pdt = torch_dtype(cfg.param_dtype)
        self.wx = param(dense_init(gen, cfg.d_model, 4 * cfg.d_model, pdt, device))
        self.r = param(normal(gen, (4, H, dh, dh), 1.0 / np.sqrt(dh), pdt, device))
        self.up = param(dense_init(gen, cfg.d_model, 2 * d_up, pdt, device))
        self.down = param(dense_init(gen, d_up, cfg.d_model, pdt, device,
                                     scale=1.0 / np.sqrt(d_up * 2 * cfg.num_layers)))


def slstm_cell(gx, r, state):
    """gx: (B, 4, H, Dh) pre-activations from the input; r: (4, H, Dh, Dh).
    Returns (h (B, H, Dh), new state (c, n, h, m))."""
    c, n, h, m = state
    rec = torch.einsum("bhd,ghde->bghe", h, r)             # (B,4,H,Dh)
    zi, ii, fi, oi = (gx[:, g] + rec[:, g] for g in range(4))
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_f = _logsigmoid(fi + 3.0)
    m_new = torch.maximum(log_f + m, ii)
    i_ = torch.exp(ii - m_new)
    f_ = torch.exp(log_f + m - m_new)
    c = f_ * c + i_ * z
    n = f_ * n + i_
    h_new = o * c / torch.maximum(n, n.new_ones(()))
    return h_new, (c, n, h_new, m_new)


def apply_slstm(cfg: ModelConfig, p: SLSTM, x: torch.Tensor, state: Optional[State] = None):
    H, dh, d_up = _slstm_dims(cfg)
    B, S, d = x.shape
    dt = x.dtype
    gx = (x @ p.wx.to(dt)).to(F32)
    if is_dtensor(gx):
        gx = _whole(gx, -1, 4)
    gx = gx.reshape(B, S, 4, H, dh)
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    st = (state["c"], state["n"], state["h"], state["m"])
    r = p.r.to(F32)
    hs = []
    for t in range(S):
        h, st = slstm_cell(gx[:, t], r, st)
        hs.append(h)
    h = _merge_heads(torch.stack(hs, dim=1), H).to(dt)
    a, b = (h @ p.up.to(dt)).chunk(2, dim=-1)
    # jax.nn.gelu is the tanh approximation
    y = (F.gelu(a, approximate="tanh") * b) @ p.down.to(dt)
    return y, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H, dh, _ = _slstm_dims(cfg)
    shape = (batch, H, dh)
    return {"c": torch.zeros(shape, dtype=F32, device=device),
            "n": torch.zeros(shape, dtype=F32, device=device),
            "h": torch.zeros(shape, dtype=F32, device=device),
            "m": torch.full(shape, -1e9, dtype=F32, device=device)}


# ---------------------------------------------------------------------------
# The LM: pairs of an mLSTM and an sLSTM block
# ---------------------------------------------------------------------------

def n_pairs(cfg: ModelConfig) -> int:
    if cfg.num_layers % 2:
        raise ValueError(f"xLSTM stacks pairs of blocks: {cfg.num_layers} layers")
    return cfg.num_layers // 2


class Pair(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.norm_m = L.init_norm(cfg, device=device)
        self.mlstm = MLSTM(cfg, gen, device)
        self.norm_s = L.init_norm(cfg, device=device)
        self.slstm = SLSTM(cfg, gen, device)


class XLSTMLM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.embed = L.init_embedding(gen, cfg, device)
        self.pairs = nn.ModuleList(Pair(cfg, gen, device) for _ in range(n_pairs(cfg)))
        self.final_norm = L.init_norm(cfg, device=device)


def init_xlstm_lm(gen, cfg: ModelConfig, device=None) -> XLSTMLM:
    return XLSTMLM(cfg, gen, device)


def init_xlstm_state(cfg: ModelConfig, batch: int, device=None):
    P_ = n_pairs(cfg)

    def stack(one):
        return {k: t[None].repeat((P_,) + (1,) * t.dim()) for k, t in one.items()}
    return {"mlstm": stack(init_mlstm_state(cfg, batch, device)),
            "slstm": stack(init_slstm_state(cfg, batch, device))}


def _pair(cfg: ModelConfig, pair, x, m_st, s_st, ctx=None):
    h, m_st = apply_mlstm(cfg, pair.mlstm, L.apply_norm(cfg, pair.norm_m, x), m_st)
    x = x + h
    h, s_st = apply_slstm(cfg, pair.slstm, L.apply_norm(cfg, pair.norm_s, x), s_st)
    x = x + h
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    return x, m_st, s_st


@spmd
def xlstm_forward(cfg: ModelConfig, params: XLSTMLM, tokens: torch.Tensor, state=None,
                  ctx=None):
    """(logits (B, S, V), aux = 0, new state) from ``state`` (the initial
    state when None); ``state`` is not written. Under a parallel context
    with ``remat="layer"`` each (mLSTM, sLSTM) pair is checkpointed under
    grad mode (none is without a context, as in the reference)."""
    run = (functools.partial(checkpoint, _pair, use_reentrant=False,
                             preserve_rng_state=False)
           if ctx is not None and ctx.remat == "layer" and torch.is_grad_enabled()
           else _pair)
    x = L.embed_tokens(cfg, params.embed, tokens)
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    ms, ss = [], []
    for i, pair in enumerate(params.pairs):
        m_st = None if state is None else {k: t[i] for k, t in state["mlstm"].items()}
        s_st = None if state is None else {k: t[i] for k, t in state["slstm"].items()}
        x, m_st, s_st = run(cfg, pair, x, m_st, s_st, ctx)
        ms.append(m_st)
        ss.append(s_st)
    x = L.apply_norm(cfg, params.final_norm, x)
    logits = L.unembed(cfg, params.embed, x)
    if ctx:
        # as the transformer's: the loss's cotangent comes back split by vocab
        logits = ctx.constrain(logits, ("batch", "seq", "vocab"))
    new_state = {"mlstm": {k: torch.stack([s[k] for s in ms]) for k in ms[0]},
                 "slstm": {k: torch.stack([s[k] for s in ss]) for k in ss[0]}}
    return logits, torch.zeros((), dtype=F32, device=x.device), new_state


@torch.no_grad()
@spmd
def xlstm_prefill(cfg: ModelConfig, params: XLSTMLM, tokens: torch.Tensor, ctx=None):
    """(last logits (B, V), the state after the prompt)."""
    logits, _, state = xlstm_forward(cfg, params, tokens, ctx=ctx)
    return logits[:, -1, :], state


@torch.no_grad()
@spmd
def xlstm_decode_step(cfg: ModelConfig, params: XLSTMLM, state, tokens: torch.Tensor,
                      index: int, ctx=None):
    """One-token decode (``index`` unused: the recurrent state carries no
    position) -> (logits (B, V), new state)."""
    del index
    logits, _, new_state = xlstm_forward(cfg, params, tokens, state, ctx=ctx)
    return logits[:, 0, :], new_state


# ---------------------------------------------------------------------------
# Chunked-parallel mLSTM: the matrix memory updated once a chunk
# ---------------------------------------------------------------------------

def _mlstm_chunk(carry, q, k, v, li, lf):
    """One chunk. q/k/v: (B, H, Q, D); li/lf: (B, H, Q); carry: C (B, H, D,
    D), n (B, H, D), m (B, H). Returns (new carry, h (B, H, Q, D))."""
    C, n, m0 = carry
    Q = q.shape[2]
    b = torch.cumsum(lf, dim=-1)                                 # (B,H,Q)
    # pairwise log-weights w[t, s] = b_t - b_s + li_s for s <= t
    W = b[..., :, None] - b[..., None, :] + li[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    W = torch.where(mask, W, float("-inf"))
    m_intra = W.amax(dim=-1)                                     # (B,H,Q)
    m_t = torch.maximum(m0[..., None] + b, m_intra)
    Dmat = torch.where(mask, torch.exp(W - m_t[..., None]), 0.0)

    scores = (q @ k.transpose(-1, -2)) * Dmat                   # (B,H,Q,Q)
    h_intra = scores @ v
    n_intra = Dmat @ k
    inter_scale = torch.exp(m0[..., None] + b - m_t)             # (B,H,Q)
    h_inter = (q @ C) * inter_scale[..., None]
    n_t = n[..., None, :] * inter_scale[..., None] + n_intra
    denom = torch.maximum((n_t * q).sum(-1).abs(), torch.exp(-m_t)) + 1e-6
    h = (h_intra + h_inter) / denom[..., None]

    # end-of-chunk state
    m_new = m_t[..., -1]
    bQ = b[..., -1]
    dec = torch.exp(m0 + bQ - m_new)                             # (B,H)
    E = torch.exp(bQ[..., None] - b + li - m_new[..., None])     # (B,H,Q)
    Ek = E[..., None] * k
    C_new = dec[..., None, None] * C + Ek.transpose(-1, -2) @ v
    n_new = dec[..., None] * n + Ek.sum(dim=-2)
    return (C_new, n_new, m_new), h


def apply_mlstm_chunked(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                        state: Optional[State] = None):
    """Chunked-parallel mLSTM; the interface and semantics of
    :func:`apply_mlstm`."""
    d_in, H, dk = _mlstm_dims(cfg)
    B, S, _ = x.shape
    Q = min(cfg.xlstm.chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    main, z, q, k, v, li, lf = _mlstm_inputs(cfg, p, x)
    h, carry = _mlstm_scan(cfg, functools.partial(_scan_chunks, Q), q, k, v, li, lf, state,
                           B, x.device)
    h = _merge_heads(h, H, v)
    return _mlstm_out(cfg, p, h, main, z), {"C": carry[0], "n": carry[1], "m": carry[2]}


def _scan_chunks(Q, q, k, v, li, lf, carry):
    """The mLSTM a chunk of Q tokens at a time (:func:`_mlstm_chunk`): (h
    (B, S, H, Dv), the state after the last chunk)."""
    def heads_first(t):  # (B, S, H, ...) -> (B, H, S, ...)
        return t.movedim(2, 1)
    q, k, v, li, lf = (heads_first(t) for t in (q, k, v, li, lf))
    hs = []
    for c in range(q.shape[2] // Q):
        sl = slice(c * Q, (c + 1) * Q)
        carry, h = _mlstm_chunk(carry, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                li[:, :, sl], lf[:, :, sl])
        hs.append(h)
    return torch.cat(hs, dim=2).movedim(1, 2), carry
