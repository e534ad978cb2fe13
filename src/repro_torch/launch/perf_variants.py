"""The perf hillclimb's variants of three cells, on the dry run's fake
mesh: hypothesis -> change -> before -> after, one record a variant.

Counterpart of ``repro.launch.perf_variants`` (its ``perf_variants.py:
67-282``). The reference sets its variants by patching module globals
(``DR.get_config``, ``ParallelContext.__post_init__``,
``DR._pick_microbatches``); the port passes each to
:func:`repro_torch.launch.dryrun.lower_cell` as an argument (``cfg=``,
``capacity_factor=``, ``microbatches=``, ``schedule=``), so nothing
global is patched. Variants:

  qwen2 decode:  buffered    read-only cache + write buffer (W 64), with
                             the amortised flush step counted apart
                 int8kv      the same over an int8 KV cache (dequantized
                             by 1/64 before the step, as the reference)
                 f32probe    float32 activations and cache
  arctic train:  cf10        MoE capacity factor 1.25 -> 1.0
                 gradsync    microbatches 4 (against the picked 16)
                 combined    cf 1.0 + microbatches 8
  prefill:       grouped     the triangular attention schedule (qwen2-vl-72b)
  xlstm train:   chunked     chunked-parallel mLSTM, chunk 128

Records are written only under ``--out`` (``<cell>__<variant>.json``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.perf_variants --which cf10 --device cpu --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun as DR
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model, cache_placements, init_params
from repro_torch.parallel.sharding import distribute, spmd
from repro_torch.roofline.analysis import analyze
from repro_torch.train.steps import greedy_tokens

WHICH = ("qwen-buffered", "qwen-buffered-int8", "qwen-f32probe", "cf10", "gradsync",
         "combined", "xlstm-chunked", "grouped-prefill")


def _write(out: Optional[Path], name: str, info: dict) -> None:
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.json").write_text(json.dumps(info, indent=2))


def record(out, cell: str, variant: str, counter, chips, model_flops, memory, extra=None):
    terms = analyze(counter, chips, model_flops)
    info = {"cell": cell, "variant": variant, "roofline": terms.to_dict(),
            "peak_device_bytes": memory["peak_device_bytes"], **(extra or {})}
    _write(out, f"{cell}__{variant}", info)
    r = info["roofline"]
    print(f"{cell} [{variant}] compute={r['compute_s']:.3f} "
          f"memory={r['memory_s']:.3f} coll={r['collective_s']:.3f} "
          f"bottleneck={r['bottleneck']} mfu_bound={r['mfu_bound']:.4f}", flush=True)
    return info


# ---------------------------------------------------------------------------
# qwen2-vl-72b decode_32k variants
# ---------------------------------------------------------------------------

def qwen_buffered(window: int = 64, kv_dtype: str = "bfloat16", *, out=None, cfg=None,
                  mesh_shape: Optional[Sequence[int]] = None, device="cuda"):
    """One buffered decode step over a read-only (B, S) cache of
    ``kv_dtype`` and a W-slot bfloat16 buffer (its batch over the data
    axes), then the flush, each counted once; the flush's memory term is
    also given per decode step (amortised over W)."""
    from torch.distributed.tensor import Replicate, Shard
    arch, shape_name = "qwen2-vl-72b", "decode_32k"
    cfg = cfg or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_shape = tuple(mesh_shape or DR.POD1[0])
    dev = resolve_device(device)
    mesh = DR.fake_mesh(mesh_shape, dev)
    chips = DR.chips_of(mesh_shape)
    ctx = DR.make_context(cfg, shape, mesh)
    model = build_model(cfg, ctx, device=dev, kernel_backend="torch")
    B, S = shape.global_batch, shape.seq_len
    kvdt = getattr(torch, kv_dtype)
    kv = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    t0 = time.perf_counter()
    with DR.fake_mode(), DR.sharding_cached():
        params = model.shard(init_params(None, cfg, dev))
        raw = {"k": torch.zeros(kv, dtype=kvdt, device=dev),
               "v": torch.zeros(kv, dtype=kvdt, device=dev)}
        cache = distribute(raw, cache_placements(ctx, raw), ctx, dev)
        buf = T.init_kv_buffer(cfg, B, window, dtype=torch.bfloat16, device=dev)
        on_batch = tuple(Shard(1) if a in ctx.dp_axes else Replicate()
                         for a in mesh.axis_names)
        buffer = distribute(buf, {"k": on_batch, "v": on_batch}, ctx, dev)
        tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        base_len, buf_len = S - window, 0

        @spmd
        def serve_step():
            c = cache
            if kvdt == torch.int8:
                # int8 KV: dequantize by 1/64 before the step
                c = {k: (t.to(torch.bfloat16) * (1.0 / 64.0)).to(torch.bfloat16)
                     for k, t in cache.items()}
            logits, new_buf = T.decode_step_buffered(cfg, params, c, buffer, tokens,
                                                     base_len, buf_len, ctx=ctx)
            return greedy_tokens(logits), new_buf

        counter, _, memory = DR.count_step(serve_step, [params, cache, buffer, tokens])
        flushed, _, _ = DR.count_step(lambda: T.flush_buffer(cfg, cache, buffer, base_len),
                                      [cache, buffer])
    f_terms = analyze(flushed, chips, 0.0)
    variant = f"buffered_w{window}" + ("_int8" if kvdt == torch.int8 else "")
    return record(out, f"{arch}__{shape_name}", variant, counter, chips,
                  DR.model_flops_for(cfg, shape), memory,
                  extra={"seconds": round(time.perf_counter() - t0, 1),
                         "flush_memory_s": f_terms.memory_s,
                         "flush_amortized_memory_s": f_terms.memory_s / window})


def qwen_f32probe(*, out=None, cfg=None, mesh_shape=None, device="cuda"):
    cfg = dataclasses.replace(cfg or get_config("qwen2-vl-72b"), dtype="float32")
    _, info = DR.lower_cell("qwen2-vl-72b", "decode_32k", cfg=cfg, mesh_shape=mesh_shape,
                            device=device)
    _write(out, "qwen2-vl-72b__decode_32k__f32probe", info)
    r = info["roofline"]
    print(f"qwen2-vl-72b__decode_32k [f32probe] memory={r['memory_s']:.3f} "
          f"(bf16-projected ~{r['memory_s'] / 2:.3f})", flush=True)
    return info


# ---------------------------------------------------------------------------
# arctic-480b train_4k variants
# ---------------------------------------------------------------------------

#: variant -> lower_cell's overrides
ARCTIC = {"cf10": {"capacity_factor": 1.0},
          "gradsync": {"microbatches": 4},
          "combined": {"capacity_factor": 1.0, "microbatches": 8}}


def arctic_variant(variant: str, *, out=None, cfg=None, mesh_shape=None, device="cuda"):
    if variant not in ARCTIC:
        raise ValueError(f"unknown arctic variant {variant!r}; expected one of {tuple(ARCTIC)}")
    _, info = DR.lower_cell("arctic-480b", "train_4k", cfg=cfg, mesh_shape=mesh_shape,
                            device=device, **ARCTIC[variant])
    _write(out, f"arctic-480b__train_4k__{variant}", info)
    r = info["roofline"]
    print(f"arctic-480b__train_4k [{variant}] compute={r['compute_s']:.2f} "
          f"memory={r['memory_s']:.2f} coll={r['collective_s']:.2f} "
          f"peak={info['memory']['peak_device_bytes'] / 2**30:.1f}GiB", flush=True)
    return info


def grouped_prefill(arch: str = "qwen2-vl-72b", *, out=None, cfg=None, mesh_shape=None,
                    device="cuda"):
    """The triangular attention schedule for a prefill cell (predicts
    about 0.56x on the attention flops; see attention.attend_grouped)."""
    _, info = DR.lower_cell(arch, "prefill_32k", schedule="grouped", cfg=cfg,
                            mesh_shape=mesh_shape, device=device)
    _write(out, f"{arch}__prefill_32k__grouped", info)
    r = info["roofline"]
    print(f"{arch}__prefill_32k [grouped] compute={r['compute_s']:.3f} "
          f"memory={r['memory_s']:.3f} coll={r['collective_s']:.3f} "
          f"mfu_bound={r['mfu_bound']:.4f}", flush=True)
    return info


def xlstm_chunked(chunk: int = 128, *, out=None, cfg=None, mesh_shape=None,
                  seq_len=None, device="cuda"):
    """``seq_len`` cuts train_4k's sequence: the sLSTM runs one Python step
    a token."""
    cfg0 = cfg or get_config("xlstm-350m")
    cfg = dataclasses.replace(cfg0, xlstm=dataclasses.replace(cfg0.xlstm, chunk=chunk,
                                                              parallel_mlstm=True))
    _, info = DR.lower_cell("xlstm-350m", "train_4k", cfg=cfg, mesh_shape=mesh_shape,
                            seq_len=seq_len, device=device)
    _write(out, f"xlstm-350m__train_4k__chunked{chunk}", info)
    r = info["roofline"]
    print(f"xlstm-350m__train_4k [chunked{chunk}] "
          f"compute={r['compute_s']:.3f} memory={r['memory_s']:.3f} "
          f"coll={r['collective_s']:.3f} mfu_bound={r['mfu_bound']:.4f}", flush=True)
    return info


def run(which: str, window: int = 64, **kw):
    """One ``--which`` variant (``kw``: ``out``, ``cfg``, ``mesh_shape``,
    ``device``)."""
    if which == "qwen-buffered":
        return qwen_buffered(window, **kw)
    if which == "qwen-buffered-int8":
        return qwen_buffered(window, kv_dtype="int8", **kw)
    if which == "qwen-f32probe":
        return qwen_f32probe(**kw)
    if which in ARCTIC:
        return arctic_variant(which, **kw)
    if which == "xlstm-chunked":
        return xlstm_chunked(window if window != 64 else 128, **kw)
    if which == "grouped-prefill":
        return grouped_prefill(**kw)
    raise ValueError(f"unknown variant {which!r}; expected one of {WHICH}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.perf_variants")
    ap.add_argument("--which", required=True, choices=WHICH)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default: cuda; cpu needs no card)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the record to DIR/<cell>__<variant>.json")
    args = ap.parse_args(argv)
    run(args.which, args.window, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
