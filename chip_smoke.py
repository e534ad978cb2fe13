#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # the checks below, ~16 min on an H100
    python3 chip_smoke.py --profile  # also the profiler's table of the grid's ops

Phases, in order (each prints its seconds; any failed check raises, exit
code != 0):

1. the card's name and power limit; build the six CUDA sources from
   ``src/repro_torch/kernels/*/csrc`` (one nvcc per source, all at once,
   sm_90a); HGMMA (wgmma) in the SASS of the tensor-core attention kernel
   at each of its head dims (64, 80, 128, 256), its registers there and no
   spills (ptxas -v) and UTMALDG (TMA loads) in every instantiation of the
   paged attention kernel (cuobjdump);
2. ``fused_cache_step`` vs its plain version on the card: random op streams
   over padded geometries (effective sets/ways below the padding, ways
   above 32 too), streams whose fills, demand and probes all fall into 1
   or 2 effective sets (ways_pad 16 and 40: every row of an event shares a
   few shared-memory slots) and a populated fig08-sized state (72 lanes,
   16384 x 16), LRU and SRRIP, exact equality of tags, lru, stamp, hit and
   probe hits; times per launch and per plain step and the byte bound;
3. ``cache_lookup``, ``block_gather`` and ``paged_attention`` vs their plain
   versions on the card: lookups exact on random tags and a populated
   32 x 16 state (K 1..260), gathers exact in bf16 at the 3 MB expert-slab
   width and in f32 at the 64 KB KV-block width, attention within
   PAGED_TOL (f32) / PAGED_TOL_BF16 at Hq 32, Hkv 8, D 64, T 16, NB 256 on
   strided views of the fast tier at lengths 4,003, 3,001, 17, 4,096, 1 and
   0 (exact zeros), at G 6 and G 8 / D 128, and on views one element past
   16-byte alignment (the cp.async and element copies); device time per
   launch, the plain version's time, the bound and the library call's
   time; paged attention timed in f32 and bf16 with every kernel a call
   launches counted (one), and a 1-element add_ (the card's floor for a
   small kernel) beside cache_lookup;
3b. ``tier_access`` (the chain and copy kernels of one
   ``TieredBlockPool.access``) vs the plain loop on the card: (a) the
   tiered-KV stream (K 256 over 256 blocks, fast 512 in 32 x 16, f32, 4
   steps: misses, then hits), (b) sliding then random ids (K 96, 512
   blocks, fast 64, f32 -> bf16: evictions and slots filled twice in one
   access; the routes swap states mid-run), (c) the expert router of phase
   6 (bf16, K 8, fast 192: prefetches filled and valid predictions not
   filled), (d) and (e) (b)'s ids on rows the 16-byte copies cannot take
   (4,099 f32 a row; a slow tier 4 bytes past alignment, f32 -> bf16), so
   each of the copy kernel's four kinds runs; through a ``"torch"`` and a
   ``"cuda"`` pool on one slow tier, the whole TierState (fast tier
   included) and the slots bit for bit after every access; the kernel
   route under ``set_sync_debug_mode("error")`` (no host sync); misses,
   evictions, prefetches filled and not filled; then timed at stream (a):
   chain and copy us a launch (all hits, all misses; every kernel record
   present), SM cycles an id, the plain loop's ms a call and the byte
   bounds;
4. ``flash_attention`` vs its plain version on the card, both kernels
   (the tensor-core kernel for bf16 at D 64 / 80 / 128 / 256, the CUDA-core
   kernel for the rest): the shapes of ``tests/test_kernels.py`` and
   lengths that end mid-tile (Sq = Sk in 1, 1,000, 4,000 at D 64, 80, 128,
   256; Sq != Sk at D 64 and 80),
   f32 and bf16, causal and not, within 2e-5 / 2e-2; bf16 at D 64, 80, 128
   and 256 over G in 1, 4, 6, 7, 8, 32 on strided views of a fused q/k/v
   tensor, within 2e-2; each case launches the variant its type and D name; the
   serving prefill's shape (B 4, Hq 32, Hkv 8, D 64, S 4,000, bf16,
   causal) within FLASH_PATH_TOL; device time per launch there (and of
   the CUDA-core kernel in f32 at that shape), the plain version's time,
   the bound (bf16 tensor-core rate) and
   ``scaled_dot_product_attention``'s time; then every shape the serving
   phases of PATH_SHAPE_PHASES give the kernel (gemma-2b's MQA at D 256,
   yi-9b's G 8, internlm2-20b's G 6 and arctic-480b's G 7 at D 128,
   zamba2-2.7b's D 80, whisper-base's encoder, decoder self-attention and
   cross-attention, qwen2-vl-72b's GQA at D 128) within FLASH_PATH_TOL,
   each timed the same way;
5. tiered-KV decode at granite-3-2b's attention (Hq 32, Hkv 8, D 64, 16-token
   blocks, 4,096-token context, 512 fast blocks in 32 sets x 16 ways):
   2 requests x 40 layers, each with its own ``TieredKV`` state, prompts of
   4,000 and 3,000 tokens, 4 decode steps; every output within 3e-4 of
   dense attention over the raw K/V; one ``tier_access``, one
   ``cache_lookup`` and one ``paged_attention`` launch per decode step;
   hit rate, prefetches, wall per decode step, decode tokens/s; then 20
   warm calls of one (request, layer) profiled: device busy share,
   hand-written launches a call (from the launch counters, each of their
   kernels' records present) and device kernels a call;
6. expert tiering at granite-moe-1b-a400m (24 layers x 32 experts, top-8,
   3 MB bf16 slabs, 192 fast slabs in 12 sets x 16 ways): 96 gathers from a
   seeded skewed router, every slab exact; one ``tier_access``, one
   ``cache_lookup`` and one ``block_gather`` launch per gather; hit rate,
   gathers/s, GB/s;
7. serving granite-3-2b at its published widths (40 layers, d_model
   2048, Hq 32, Hkv 8, D 64, SwiGLU 8192, vocab 49155; f32 params, bf16
   compute, random weights from a seed): ``Engine.generate`` on 4 prompts
   of 4,000 random tokens with 16 new tokens, one ``flash_attention``
   launch per layer of the prefill and none in decode; the same params
   teacher-forced on the generated tokens under ``kernel_backend="cuda"``
   and ``"torch"``, the prefill's logits and K/V cache and every decode
   step's logits within SERVE_TOL; prefill and decode walls and tokens/s,
   the kernel's share of a profiled prefill's device time (all 40 launches
   the tensor-core kernel), device kernels
   per decode step, greedy agreement of the two backends;
7b. serving granite-moe-1b-a400m at its published widths (24 layers,
   d_model 1024, Hq 16, Hkv 8, D 64, 32 experts top-8 at d_ff 512, vocab
   49155, tied embeddings; f32 params, bf16 compute, random weights from a
   seed): ``Engine.generate`` on 2 prompts of 2,048 random tokens with 8
   new tokens, one tensor-core ``flash_attention`` launch per layer of the
   prefill (24, counted apart from phase 7's 40) and none in decode; the
   same params teacher-forced under ``"cuda"`` and ``"torch"``: the
   prefill's logits and K/V cache and every decode step's logits within
   SERVE_TOL, the (token, layer) top-8 routing choices that differ between
   the two printed; prefill tokens/s and wall per decode step, the
   experts' work a prefill, peak memory;
7b'. ``arctic_serving``: arctic-480b at its published widths (d_model
   7,168, Hq 56, Hkv 8, D 128, 128 experts top-2 at d_ff 4,864 beside a
   dense residual of 4,864, vocab 32,000), its 35 layers cut to 2 and its
   params in bf16 (MOE_SERVING) through the same function, 1 x 1,024 + 8,
   2 tensor-core launches a prefill at G 7: held by (1), each layer given
   the kernel run's input and expert choices; (2) is left out (f32
   experts do not fit), the distances with free routing printed;
7c-7f. serving gemma-2b, yi-9b, internlm2-20b and the other four families
   at their published widths (FAMILY_SERVING; f32 params, bf16 compute,
   random weights from a seed), one phase each: ``gemma_serving``
   (gemma-2b: 18 layers, d_model 2,048, Hq 8, Hkv 1, D 256, GeGLU 16,384,
   vocab 256,000, tied and scaled embeddings; 4 x 4,000 + 16, phase
   serving's shape; 18 tensor-core ``flash_attention`` launches a
   prefill), ``yi_serving`` (yi-9b: 48 layers, d_model 4,096, Hq 32, Hkv
   4, D 128, SwiGLU 11,008, vocab 64,000, nothing cut; 4 x 4,000 + 8; 48
   tensor-core launches a prefill), ``internlm2_serving`` (internlm2-20b:
   d_model 6,144, Hq 48, Hkv 8, D 128, SwiGLU 16,384, vocab 92,544, rope
   theta 1e6, its 48 layers cut to 24 to fit one card; 4 x 4,000 + 8; 24
   tensor-core launches a prefill), ``hybrid_serving`` (zamba2-2.7b: 54 Mamba2 layers and
   one shared attention block after every 6, D 80; 2 x 2,048 prompt
   tokens + 8 new; 9 tensor-core ``flash_attention`` launches a prefill),
   ``ssm_serving`` (xlstm-350m at its published widths, its 12 mLSTM +
   sLSTM pairs cut to 4 for time; 2 x 1,024 + 8; no kernel), ``audio_serving`` (whisper-base: 6 + 6 layers over 1,500
   frames of a seeded generator; 8 x 128 + 32; 18 tensor-core launches:
   the encoder's 6 unmasked, the decoder's 6 causal self-attention and 6
   cross-attention) and ``vlm_serving`` (qwen2-vl-72b cut from 80 to 8 layers to
   fit one card, M-RoPE over (t, h, w) planes of a text span, a 32 x 32
   image grid at one t and text; 1 x 4,096 + 8; 8 tensor-core launches;
   then the buffered decode: 8 steps of ``decode_step_buffered`` with W 8
   from base_len 4,096 against ``decode_step`` on the same tokens and
   positions, each step's logits within SERVE_TOL, then ``flush_buffer``:
   rows 4,096 .. 4,103 equal the buffer bit for bit, layer 0's the plain
   decode's bit for bit and every layer's within SERVE_TOL; ms a buffered
   step and the flush's beside the plain decode's):
   the param count against the config's where the reference holds it;
   ``Engine.generate`` with the launches counted (none in decode, no
   other kernel); the same params teacher-forced on the generated tokens
   under ``"cuda"`` and, where the kernel is on the path, ``"torch"``:
   the prefill's last logits, its whole cache (KV caches, recurrent
   states, cross K/V) and every decode step's logits within SERVE_TOL
   (xLSTM runs the same code under both, so it runs ``"cuda"`` alone and
   is held by its chunked prefill); zamba2's decode against one forward over
   prompt and generated tokens (the bf16 gap printed; held block by block
   in bf16, each block given the forward's input, and end to end in f32,
   within SERVE_TOL); xLSTM's chunked-parallel
   prefill (``xlstm-350m-fast``) against the sequential one within
   SERVE_TOL; prefill tokens/s, decode ms a step and peak memory beside
   the card's name and power limit;
7g. training granite-moe-1b-a400m through ``repro_torch.train``: (a) at
   its published widths, ``build_train_step`` (AdamW, f32 moments) on
   SyntheticLM batches of 4 x 2,048, 2 warm-up and 8 timed steps: losses
   finite and falling (last 3 below first 3), every parameter's moment
   non-zero (each got a gradient), no hand-written kernel launched; step
   ms, tokens/s, peak memory, the device's busy share over one profiled
   step and FLOP/s against the bf16 rate for all 32 experts as computed
   and top-8 as routed; then 3 ``adamw_q8`` steps, finite, the optimizer
   state's bytes beside f32's; (b) restart exactness through the
   ``Trainer`` with async checkpoints every 3 of 6 steps at published
   widths cut to 2 layers, in a temporary directory: crash after 3,
   ``maybe_restore``, resume, losses equal to the uninterrupted run's
   within RESTART_TOL; (c) one f32 step of the smoke config from the same
   ``train_state_from_numpy`` state on the card and on the CPU, within
   CARD_CPU_TOL; (d) the CUDA ``flash_attention`` wrapper refuses inputs
   that require grad;
7h. ``parallel/`` on a one-rank NCCL group (``single_device_context
   ("cuda")``) at granite-moe-1b-a400m's published widths: (a) one MoE
   layer at 4 x 2,048 tokens in bf16, ``moe_sharded`` at a capacity
   factor of E / k (no slot can drop) against ``moe_dense`` within
   SERVE_TOL; at the context's 1.25 the slots dropped, the expert rows
   computed (E x C against moe_dense's tokens x E) and both layers' ms by
   CUDA events; (b) 3 AdamW steps at 4 x 2,048 through
   ``build_train_step`` on a model built with the context (the launcher's
   path; losses finite, no hand-written kernel): step ms, tokens/s and
   peak memory beside phase 7g's dense step, step 0's dropped slots by
   layer; then ``launch.train.main`` itself on the smoke config; (c)
   ``Engine.generate`` on a model built with the context at 2 x 2,048 + 8,
   24 tensor-core ``flash_attention`` launches (counted apart), prefill
   tokens/s beside the context-free model's; held in float32 at a
   no-drop capacity against the context-free prefill with the routing
   pinned: last logits and K/V cache within SERVE_TOL (the bf16 gap
   printed); (d) ``ef_compress_allreduce`` (out + err == g) and a
   one-stage ``pipeline_forward`` (== layer_fn per microbatch); (e) the
   model's sharded run: (c)'s prefill with the parameters from
   ``Model.shard`` (DTensors by the reference's ``param_shardings`` on
   the context's one-rank ``DeviceMesh``) and the tokens distributed by
   ``batch_placements``: 24 tensor-core ``flash_attention`` launches
   (counted apart), the last logits within SERVE_TOL of (c)'s, tokens/s
   beside (c)'s; one warm-up and one timed AdamW step of (b) on the
   sharded model;
8. the simulator's path: the fig08 quick grid (6 block sizes x 6 workloads
   x {base, dram} = 72 systems, 1 node, T = 12,000, numpy traces, cache
   padded to 16384 x 16; the traces are the figure golden's inputs, put
   in the executor's trace memo first: the ones numpy draws through
   ``Generator.zipf`` from ``figures_numpy_traces.npz``, which numpy
   releases sample differently, the rest generated here and held to the
   golden's digests) through ``repro_torch.core.famsim.sweep``, which
   replays a CUDA graph of ``GRAPH_EVENTS`` steps, the kernel launched once
   per event; per-block-size ipc_gain / rel_fam_latency geomeans, simulated
   events/s/device and the graph's capture time and memory pool;
9. the same grid at T = 2,000 three ways: graphed with
   ``kernel_backend="cuda"``, graphed with ``"torch"``, and step by step on
   the card (``GroupRunner(eager=True)``) with ``"cuda"``: every metric
   bit-identical, the eager and graphed events/s side by side; the golden
   configuration against ``src/repro_torch/testdata/famsim_golden.json``;
10. a torch.profiler window of a graphed 200-event sweep of the grid:
   exactly 200 ``cache_step_kernel`` launches; over the replays, device
   kernels per event and the device's busy share; then the same with
   TELEMETRY_WINDOWS telemetry windows (phase 15 prints the two side by
   side);
11. device traces: the threefry generator (``repro_torch.traces.device``)
   for all 19 workloads at T = 12,000, seed 0, on the card and on the CPU:
   every draw (raw, u, uni, starts, bases, spans) and every address the
   zipf tail does not set bit for bit between the two and against the
   SHA-256 digests of JAX's in ``src/repro_torch/testdata/trace_digests.json``;
   the share of tail addresses and the largest relative gap difference
   between the card and the CPU; the card's generation seconds;
12. the figure sweeps: fig08, fig14 and fig16 at their quick size and full
   T (12,000, 10,000, 16,000) through their drivers' ``run_figure`` (one
   ``repro_torch.experiments`` call each) on the card, with numpy and
   with device traces, the counts read around these six runs alone: one
   graph capture per figure (or a replay of the graph an earlier run of its
   runner key left in the executor's runner cache: captures + cache hits ==
   groups, captures == misses, here and in every later phase),
   ``fused_cache_step`` launched ``t_pad`` times
   per group; numpy traces: every ``derived`` string equal to JAX's
   (``src/repro_torch/testdata/figures_golden.json``), per-point
   cache_occupancy bit for bit and ipc / fam_latency within the golden's
   rtol, fig08 equal to phase 8's grid bit for bit; device traces: every
   printed ratio within FIG_LOG_TOL of JAX's; wall, capture and trace
   generation seconds and events/s/device (for numpy traces also their
   host generation, which the memo keeps out of the wall); then each
   run's engine row through the driver's ``engine``: the per-point check
   (FIG_ENGINE_POINTS point a figure at full T, cut for time) exact, and on
   the numpy-trace run (EAGER_BACKENDS) the grid at XCHECK_EVENTS events
   (``benchmarks.common.XCHECK_T``, 1,000, cut to 500 for time)
   graphed and re-run step by step, bit-exact (``eager_check``), and for
   fig08 / fig16 (SHARD_FIGURES) re-run as ``("shard", 1)``, the
   reference's ``shard_check`` key for key;
13. fig10, fig12 and fig15 the same way (T 10,000; 3, 2 and 1 compile
   groups; device traces for fig15 only, cut for
   time: NEW_FIG_BACKENDS), the counts read around their four runs
   alone, every check of phase 12 against the golden; on the numpy-trace
   run the engine row's graph-vs-eager check at XCHECK_EVENTS and a
   per-point check of NEW_FIG_ENGINE_POINTS point;
13b. the executor's sharded mode (``shard_executor``): the fig08 quick grid
   at SHARD_T events on numpy traces through ``execute(cross_check_shard=
   True)``: the batched mode (``"vmap"``) and its re-run as ``("shard",
   1)`` (a runner of its own), every metric bit for bit, ``shard_check``
   with the reference's keys and values; both modes' events/s/device and
   the cache-step launches (t_pad a runner); with more than one card
   visible, also ``("shard", device_count())``;
14. fig12's policy matrix from the golden file (numpy traces, T 2,000):
   {fifo, wfq, strict} x {spp, nextline, bestoffset} on the ``cuda`` cache
   step, every row equal to JAX's and every point's counters exact, floats
   within the golden's rtol; the matrix's ``spp+wfq`` rows and points
   equal to a plain fig12 run's ``w2`` ones at that T; the golden's
   ``random`` replacement combo (6 workloads x 4 nodes, the cache cut to
   64 KB) on the ``torch`` cache step, every point against JAX's the same
   way; ``random`` with ``kernel_backend="cuda"`` refused before any
   launch;
15. telemetry: fig12's quick grid at T 2,000 on numpy traces with 8
   telemetry windows (``repro_torch.obs``; the accumulator in the carry of
   the graphed step): rows, ``derived`` and the JSON-only
   ``windowed_tail`` equal to JAX's
   (``src/repro_torch/testdata/obs_tenants_golden.json``), every point's
   windows equal to JAX's (counts exact, the float gauges within the
   golden's rtol), every shared metric bit-identical to phase 14's run of
   the same grid with telemetry off, t_pad launches a group; the fig08
   grid at warmup 0, its windows summing to the run totals; phase 10's
   profiled windows with and without telemetry: device kernels and time
   an event;
16. the Pond fleets: ``python -m repro_torch.benchmarks.run pond`` (quick:
   {16, 64, 256} tenants x {uniform, zipf} x {none, load_shed}, T 1,024,
   1,386 single-node lanes in one group, 256 x 16 caches) on the stored
   numpy traces (``pond_numpy_traces.npz``; every fleet summary and tenant
   record equal to JAX's golden) and on device traces (percentiles within
   POND_BUCKETS histogram bucket, slowdown geomeans within |log|
   POND_LOG_SLOWDOWN); each one planned group, t_pad launches;
   lanes, events/s/device, capture seconds and replay ms an event;
17. the throughput benchmark (``bench_famsim``): the quick grid on both
   backends, BENCH_REPEATS executions each, digests equal; then the full
   grid (fig08 over all 19 workloads, 228 systems x 12,000 events) on
   ``cuda`` once; events/s/device, best replay seconds and captures; each
   run's roofline record (``roofline/famsim_step.json`` under a
   temporary ``--out``);
18. the design-space search (``repro_torch.search``) through
   ``fig_search``'s driver at its quick defaults (the evolutionary
   proposer over the traced-only default space, population 6, 3
   generations, seed 0, fig14's 4 quick mixes on 4 nodes at T 10,000, 28
   systems a generation, then the winner's two-candidate replay): on
   numpy traces (the figures' stored ones, none generated on the host)
   every ``trajectory.jsonl`` line and ``best.json`` equal to JAX's
   (``src/repro_torch/testdata/search_golden.json``) but for the kernel
   backend's name: byte for byte but for the lines that hold a result of
   the SEARCH_DRIFT candidates, whose results (objectives, fitnesses,
   per-mix uplifts) are held to |log| SEARCH_DRIFT_TOL (with controls
   that the check fails a drift float moved by 1.5 times the bound and
   any other result moved by one ulp), and the best's derived string
   exactly; on
   device traces (cut for time to SEARCH_DEVICE_GENERATIONS generations)
   generation 1's samples equal to JAX's and its per-mix uplifts
   and objectives within FIG_LOG_TOL; both runs: every generation
   after the first with no capture and a runner-cache hit a group, the
   replay matching byte for byte, the best above 1.0, ``fused_cache_step``
   launched ``t_pad`` times a group; then ``pond_tail`` over
   ``qos_space()`` on ``default_search_fleet()`` (16 tenants, zipf;
   POND_SEARCH), its second generation capturing nothing; per generation
   wall, captures, replay ms an event and events/s/device; the runner
   cache's runners, bytes and the captures it saved over the whole run
   (the phases before empty it before each counted run, so their rates
   include their own captures);
   then a plan of one runner key with other traced params than the plan
   that cached it (WFQ weight, backlog cap, ``bw_adapt``, the token
   bucket's rates), with telemetry off and on, replayed from the cached
   graph: every metric equal to a fresh capture's bit for bit;
19. roofline (``repro_torch.roofline``): counted work against the H100's
   peaks (bounds, not measurements) beside times the phases above
   measured, none timed again: (a) one granite-moe-1b-a400m train step at
   TRAIN_BATCH x TRAIN_SEQ under the op counter: counted FLOPs and bytes,
   model flops, compute / memory seconds, ``mfu_bound``, the measured MFU
   and the counted FLOP/s against phase train's hand count; (b)
   granite-3-2b's prefill at SERVE_BATCH x SERVE_PROMPT through the
   ``cuda`` backend (the ``flash_attention`` charge) and the ``torch``
   backend: the charge equal to the ``torch`` attention's dots, the terms
   and the measured MFU at phase serving's prefill; (c) phase bench's
   records: bytes and the memory bound an event against the measured
   time an event. (d), a dry-run cell at 256 fake ranks, is left out
   (ROOFLINE_DRYRUN_LEFT_OUT);
20. analysis (``repro_torch.analysis``): (a) the static analyzer strict
   over ``src/repro_torch``, no finding reported; (b) the sync guard live
   on the card: ``.item()`` of a CUDA tensor inside
   ``no_implicit_transfers()`` (``torch.cuda.set_sync_debug_mode
   ("error")``) raises, inside ``explicit_fetch()`` it fetches, and the
   mode is restored; (c) ``xla_compiles`` (the CompileWatcher's count of
   the captures reported at ``famsim._capture``), ``compiles`` and
   ``planned_groups`` of every figure, policy-matrix, telemetry, Pond,
   bench and search run above, each run with ``assert_compiles=True``
   under the guard and held equal by ``check_captures`` (GUARDED_RUNS
   must be among them);
21. examples: the four ``examples/torch_*.py`` as subprocesses on the
   card, started together, at the cut sizes of EXAMPLES: each exits 0 with
   its closing line.

Each path runs with every launch count set to 0 just before it and read
just after. The last two lines of standard output are the kernel table
(JSON) and ``{"ok": true, "device": {...}}``; the card's name and power
limit come earlier. Without a CUDA device it exits non-zero before
printing results. Bulk data (K/V, expert slabs) comes from a seeded
generator on the card; queries and routing from numpy seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FIG08_BLOCKS = (64, 128, 256, 512, 1024, 4096)
QUICK_WORKLOADS = ("603.bwaves_s", "628.pop2_s", "LU", "bfs", "canneal", "mg")
T_MAIN = 12_000
T_CHECK = 2_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published HBM3 rate
F32_FLOPS = 67e12              # H100 SXM published float32 rate (no tensor cores)
DEVICE = "cuda"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "fused_cache_step": ("src/repro_torch/kernels/famsim_step/csrc/famsim_step.cu",
                         "src/repro/kernels/famsim_step/kernel.py:138"),
    "cache_lookup": ("src/repro_torch/kernels/cache_lookup/csrc/cache_lookup.cu",
                     "src/repro/kernels/cache_lookup/kernel.py:40"),
    "tier_access": ("src/repro_torch/kernels/cache_lookup/csrc/tier_access.cu",
                    "src/repro/kernels/cache_lookup/kernel.py:40 with "
                    "src/repro/core/tiering.py:117 (TieredBlockPool.access)"),
    "block_gather": ("src/repro_torch/kernels/block_gather/csrc/block_gather.cu",
                     "src/repro/kernels/block_gather/kernel.py:24"),
    "paged_attention": ("src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:74"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:66"),
}
# tiered-KV decode at granite-3-2b's attention (src/repro/configs/granite_3_2b.py)
KV_HQ, KV_HKV, KV_D, KV_LAYERS = 32, 8, 64, 40
KV_CONTEXT, KV_BLOCK, KV_FAST, KV_WAYS = 4096, 16, 512, 16   # ways: FamConfig()'s
KV_PROMPTS = (4000, 3000)
KV_STEPS = 4
KV_TOL = 3e-4                  # tests/test_tiering.py:76, tiered vs dense attention
PAGED_TOL = 2e-5               # tests/test_kernels.py:67, online vs one-pass softmax (f32)
PAGED_TOL_BF16 = 3e-2          # tests/test_kernels.py:67, bf16
# expert tiering at granite-moe-1b-a400m (src/repro/configs/granite_moe_1b_a400m.py)
MOE_LAYERS, MOE_EXPERTS, MOE_TOP_K = 24, 32, 8
MOE_SLAB = 3 * 1024 * 512      # w_gate + w_up + w_down of one expert, bf16
MOE_FAST, MOE_TOKENS = 192, 4
# flash_attention vs plain: the shapes of tests/test_kernels.py:25-30 at its
# tolerances (:41), lengths that end mid-tile, every head dim of the dense
# configs, and 96 and 192, which keep bf16 on the CUDA-core kernel's
# D 65-128 and D 129-256 instances; the path's shape comes from the
# serving configuration
FLASH_SHAPES = ((2, 64, 4, 2, 32), (1, 128, 8, 1, 16), (2, 64, 4, 4, 64), (1, 256, 2, 2, 8))
FLASH_LENGTHS = (1, 1000, 4000)
FLASH_UNEQUAL = ((1000, 3000), (3000, 1000))
FLASH_DIMS = (64, 80, 96, 128, 192, 256)     # 80: zamba2-2.7b's shared attention
FLASH_UNEQUAL_DIMS = (64, 80)
# the tensor-core kernel's own cases: bf16 at its head dims, lengths that end
# mid-tile and Sq != Sk, every group size of the dense configs and more
# (G 6 fills no power-of-two tile), on strided views of a fused q/k/v tensor
FLASH_TC_DIMS = (64, 80, 128, 256)
FLASH_TC_LENGTHS = ((1, 1), (1000, 1000), (4000, 4000), (1000, 3000), (3000, 1000))
FLASH_TC_GROUPS = (1, 4, 6, 7, 8, 32)     # 7: arctic-480b's 56 / 8, a divisor of no tile
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# at the path's shape: bf16's 2e-2 as rtol (over 2 ulps), atol cut to 1e-3,
# 1/40 of the typical |out| of 0.04 at S 4,000, so an error at the scale
# of the outputs fails
FLASH_PATH_TOL = {"rtol": 2e-2, "atol": 1e-3}
BF16_FLOPS = 989e12            # H100 SXM published dense bf16 rate (tensor cores)
# serving at granite-3-2b (src/repro/configs/granite_3_2b.py), full width
SERVE_ARCH = "granite-3-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_SEED = 4, 4000, 16, 0
SERVE_TOL = 0.05               # tests/test_models.py:89-101: atol 0.05 max|ref|, rtol 0.05
# MoE serving at granite-moe-1b-a400m (src/repro/configs/granite_moe_1b_a400m.py)
MOE_SERVE_ARCH = "granite-moe-1b-a400m"
MOE_SERVE_BATCH, MOE_SERVE_PROMPT, MOE_SERVE_NEW = 2, 2048, 8
# the MoE serving phases (moe_serving_path): granite-moe-1b-a400m whole, and
# arctic-480b (src/repro/configs/arctic_480b.py) at its published widths, its
# 35 layers cut to 2 and its params in bf16, the reference's rule for
# arctic-class models (src/repro/launch/dryrun.py:93-100): 2 layers are
# 51.56 GiB; f32 params would not fit one layer beside its transients.
# ``f32`` names the phases held end to end in f32 compute too: arctic's
# bf16 experts cast to f32 a call would be 17.8 GB a weight
MOE_SERVING = {
    "moe_serving": dict(arch=MOE_SERVE_ARCH, batch=MOE_SERVE_BATCH, prompt=MOE_SERVE_PROMPT,
                        new=MOE_SERVE_NEW, flash=24, variant="tensor_core", f32=True),
    "arctic_serving": dict(arch="arctic-480b", batch=1, prompt=1024, new=8, flash=2,
                           variant="tensor_core", f32=False, layers=2,
                           param_dtype="bfloat16"),
}
# serving gemma-2b and the hybrid, ssm, audio and vlm families (phases
# 7c-7f) at their published widths (src/repro/configs/gemma_2b.py,
# zamba2_2_7b.py, xlstm_350m.py, whisper_base.py, qwen2_vl_72b.py; gemma-2b
# at phase serving's batch and prompt, ~10 GB of f32 params, nothing cut):
# the batch, prompt and new tokens, the
# flash_attention launches a prefill and their variant; qwen2-vl-72b's 80
# layers cut to 8 to fit one card; xlstm-350m's 24 layers (12 pairs) cut to
# 8 (4 pairs) for time (its token loops took 29.9-45.7 s of the run);
# yi-9b (src/repro/configs/yi_9b.py, 32.89 GiB of f32 params, nothing cut)
# and internlm2-20b (internlm2_20b.py, its 48 layers cut to 24, 39.11 GiB, so
# the activations, the KV cache and the torch backend's score chunks fit
# beside them) at phase serving's batch and prompt with 8 new tokens, as
# their decode steps are host-bound
FAMILY_SERVING = {
    "gemma_serving": dict(arch="gemma-2b", batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                          new=SERVE_NEW, flash=18, variant="tensor_core"),
    "yi_serving": dict(arch="yi-9b", batch=SERVE_BATCH, prompt=SERVE_PROMPT, new=8,
                       flash=48, variant="tensor_core"),
    "internlm2_serving": dict(arch="internlm2-20b", batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                              new=8, flash=24, variant="tensor_core", layers=24),
    "hybrid_serving": dict(arch="zamba2-2.7b", batch=2, prompt=2048, new=8, flash=9,
                           variant="tensor_core"),
    "ssm_serving": dict(arch="xlstm-350m", batch=2, prompt=1024, new=8, flash=0,
                        variant=None, layers=8),
    "audio_serving": dict(arch="whisper-base", batch=8, prompt=128, new=32, flash=18,
                          variant="tensor_core"),
    "vlm_serving": dict(arch="qwen2-vl-72b", batch=1, prompt=4096, new=8, flash=8,
                        variant="tensor_core", layers=8),
}
# the serving phases whose prefill shapes phase flash_attention_vs_plain
# holds and times: the family phases that launch the kernel, and arctic's G 7
PATH_SHAPE_PHASES = tuple(p for p, s in FAMILY_SERVING.items() if s["flash"]) + (
    "arctic_serving",)
# qwen2-vl's (t, h, w) planes: VLM_TEXT text tokens, a VLM_GRID x VLM_GRID
# image at one t, then text from past the image's largest position
VLM_TEXT, VLM_GRID = 1024, 32
# vlm_serving's buffered decode: W slots, as many steps from the prefill's
# length, then one flush; the timed calls of each step kind
VLM_BUFFER, VLM_BUFFER_REPEATS = 8, 10
# the param count is held where the reference holds it: equal for the
# transformer families, within 25 % for zamba2 (tests/test_models.py:116);
# printed beside the analytic count for xLSTM and whisper
PARAM_COUNT_REL = {"dense": 0.0, "moe": 0.0, "vlm": 0.0, "hybrid": 0.25}
# training granite-moe-1b-a400m (phase 7g): full width, SyntheticLM batches
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_Q8_STEPS = 2, 8, 3
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_TOP_KERNELS = 6          # the profiled step's largest kernels printed
MOE_PREFILL_REPEATS = 3        # timed prefills a backend (the median printed)
# restart exactness: published widths cut to 2 layers (~1.9 GB of state a
# checkpoint), at the reference's own bound (tests/test_train_integration.py:58)
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY = 2, 6, 3
RESTART_TOL = dict(rtol=1e-4, atol=1e-5)
# card vs CPU, one float32 step of the smoke config from a carried state at
# step 7: the metrics within float32 summation order; a param may differ by
# up to 2 lr where the update's sign flips on a rounding-level gradient, at
# most 1 % of a leaf's elements by more than 1e-6; the moments within 1e-4
CARD_CPU_STEP = 7
CARD_CPU_TOL = dict(metric_rtol=1e-5, param_atol=1e-6, param_share=0.01, moment_rtol=1e-4)
# the figure sweeps (phases 12-13) against JAX's golden values
FIGURES = ("fig08_blocksize", "fig14_mixes", "fig16_cachesize")
NEW_FIGURES = ("fig10_bw_adaptation", "fig12_wfq", "fig15_allocation")
FIG_GROUPS = {"fig10_bw_adaptation": 3, "fig12_wfq": 2}   # one per node count; else 1
FIG_LOG_TOL = 0.01             # device traces: |log(port / JAX)| of every printed ratio
# per-point engine check (the reference: 12 / 4; cut for time: 2 until PR 25's
# phases parallel and shard_executor)
FIG_ENGINE_POINTS = 1
# phase 13's per-point check: 1 point a figure, on its numpy-trace run (the
# reference checks none for these three)
NEW_FIG_ENGINE_POINTS = 1
# phase 13's trace backends: device traces for fig15 only, cut for time
# (fig10's and fig12's would add ~90 s: ~800 s the run)
NEW_FIG_BACKENDS = {"fig10_bw_adaptation": ("numpy",), "fig12_wfq": ("numpy",),
                    "fig15_allocation": ("numpy", "device")}
# the engine rows' graph-vs-eager check (phases 12-13) runs on the
# numpy-trace run of each figure: the device-trace run steps the same
# grid on other inputs, and phase 9 holds graph == eager on fig08's grid
EAGER_BACKENDS = ("numpy",)
# the events of that check and of the shard check
# (benchmarks.common.XCHECK_T, 1,000): cut to 500 for time, which the
# buffered decode and the sharded run need (phases figures and
# figures_10_12_15, see PERF.md section 5)
XCHECK_EVENTS = 500
# the figures whose engine row also carries the reference's shard check
# (its fig08 / fig16 run with cross_check_shard), at XCHECK_T on the
# numpy-trace run
SHARD_FIGURES = ("fig08_blocksize", "fig16_cachesize")
# the throughput benchmark (phase 15): executions a backend on the quick grid
BENCH_REPEATS = 3
TRACE_T = 12_000               # phase 11's trace length
TELEMETRY_WINDOWS = 8          # phase 15's golden windows, and phase 10's second window
PROFILE_MARGIN_S = 0.1         # idle seconds at each end of a profiler window
# spin kernels opening a window, ~1 ms each: 16 of ~0.5 ms were once all
# lost in one window of a run where the MoE and train phases ran first
LEAD_IN, LEAD_IN_CYCLES = 64, 2_000_000
LEAD_IN_KERNEL = "spin_kernel"            # torch.cuda._sleep's kernel
lead_in_lost = []              # lead-in records each profiler window lost


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


class Phases:
    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {self.seconds[name]:.3f} s", flush=True)
        return out


# --------------------------------------------------------------------------
# phase 2: kernel vs plain version
# --------------------------------------------------------------------------

def check_captures(what, info):
    """Each group captured its graph (a runner-cache miss) or replayed the
    graph an earlier group of its key left in the cache (a hit): captures
    + hits == groups, captures == misses. ``info`` is a RunInfo or its
    ``as_dict()``."""
    get = info.get if isinstance(info, dict) else lambda k: getattr(info, k)
    captures, hits, misses = (get(k) for k in ("compiles", "exec_cache_hits",
                                               "exec_cache_misses"))
    check(captures == misses and captures + hits == get("planned_groups"),
          f"{what}: {captures} captures, {hits} cache hits, {misses} misses for "
          f"{get('planned_groups')} groups")
    # a run under assert_compiles: the CompileWatcher's count of captures
    # reported at the capture site (the reference's xla_compiles)
    watched = get("xla_compiles")
    if watched is not None and watched >= 0:
        check(watched == captures <= get("planned_groups"),
              f"{what}: the CompileWatcher saw {watched} captures, the executor "
              f"counted {captures}, for {get('planned_groups')} groups")
        compile_records.append((what, watched, captures, get("planned_groups")))


#: (run, xla_compiles, compiles, planned_groups) of every run checked above
#: that ran under ``assert_compiles`` (the sync guard on): phase analysis
compile_records = []


#: over the run: runner-cache hits of the runners emptied from the cache,
#: and the most bytes the cache held before an emptying
cache_tally = {"hits": 0, "bytes": 0}


def empty_runner_cache():
    """Empty the executor's runner cache before a counted figure, matrix,
    telemetry, Pond or bench run, so its wall and events/s include its own
    captures whatever ran before it (the search phase alone replays cached
    graphs across runs); the hits and bytes of the emptied runners are
    tallied first."""
    from repro_torch.experiments import executor
    cache_tally["hits"] += sum(r.calls - 1 for r in executor._EXEC_CACHE.values())
    cache_tally["bytes"] = max(cache_tally["bytes"], executor.exec_cache_bytes())
    executor._clear_exec_cache()


def _populate(torch, tags, lru, num_sets, ways, mode, gen):
    """Fill each lane's effective region with blocks that hash to their set
    (about 90 % of the ways), with random recency values."""
    from repro_torch.core.dram_cache import _set_index
    dev = tags.device
    for lane in range(tags.shape[0]):
        ns, ew = int(num_sets[lane]), int(ways[lane])
        pool = torch.randint(0, 1 << 26, (ns * ew * 2,), generator=gen,
                             device="cpu").to(dev, torch.int32)
        si = _set_index(pool, ns).to(torch.int64)
        order = torch.argsort(si, stable=True)
        si, pool = si[order], pool[order]
        rank = torch.arange(si.numel(), device=dev) - torch.searchsorted(si, si)
        keep = (rank < ew) & (torch.rand(si.shape, generator=gen).to(dev) < 0.9)
        tags[lane, si[keep], rank[keep]] = pool[keep] + 1
    if mode == "lru":
        lru.copy_(torch.randint(0, 1 << 20, lru.shape, generator=gen).to(dev, torch.int32))
    else:
        lru.copy_(torch.randint(0, 4, lru.shape, generator=gen).to(dev, torch.int32))
    lru.mul_((tags > 0).to(torch.int32))


def _ops(torch, tags, C, P, gen):
    """One event's inputs per lane: fills, demand and probes drawn half
    from blocks present in the state, half fresh."""
    dev = tags.device
    L = tags.shape[0]
    present = []
    for lane in range(L):
        t = tags[lane][tags[lane] > 0]
        present.append(t[torch.randint(0, t.numel(), (C + 1 + P,), generator=gen).to(dev)] - 1)
    present = torch.stack(present).to(torch.int32)
    fresh = torch.randint(0, 1 << 26, (L, C + 1 + P), generator=gen).to(dev, torch.int32)
    pick = torch.rand((L, C + 1 + P), generator=gen).to(dev) < 0.5
    blocks = torch.where(pick, present, fresh)
    fills, demand, probes = blocks[:, :C], blocks[:, C], blocks[:, C + 1:]
    fen = torch.rand((L, C), generator=gen).to(dev) < 0.7
    den = torch.rand((L,), generator=gen).to(dev) < 0.8
    return (fills.contiguous(), fen, demand.contiguous(), den, probes.contiguous())


def _compare_stream(torch, lanes, pad_sets, pad_ways, num_sets, ways, mode,
                    steps, C, P, gen, populate, blocks=None):
    """Kernel and plain version on the card from the same state; exact.
    Unpopulated streams draw block ids below ``blocks`` (default 4 x the
    padded entries)."""
    from repro_torch.kernels.famsim_step import cache_step_ref, fused_cache_step
    from repro_torch.core.dram_cache import CacheState
    from repro_torch.policies.replacement import _SrripBound
    from repro_torch.core.dram_cache import init_cache
    dev = torch.device(DEVICE)
    ns = torch.tensor(num_sets, dtype=torch.int32, device=dev)
    ew = torch.tensor(ways, dtype=torch.int32, device=dev)
    k = init_cache(pad_sets, pad_ways, batch=(lanes,), device=dev)
    if populate:
        _populate(torch, k.tags, k.lru, num_sets, ways, mode, gen)
    r = CacheState(k.tags.clone(), k.lru.clone(), k.stamp.clone())
    policy = _SrripBound(3) if mode == "srrip" else None
    max_err = 0
    for _ in range(steps):
        if populate:
            args = _ops(torch, k.tags, C, P, gen)
        else:
            hi = blocks or 4 * pad_sets * pad_ways
            args = (torch.randint(0, hi, (lanes, C), generator=gen).to(dev, torch.int32),
                    torch.rand((lanes, C), generator=gen).to(dev) < 0.7,
                    torch.randint(0, hi, (lanes,), generator=gen).to(dev, torch.int32),
                    torch.rand((lanes,), generator=gen).to(dev) < 0.8,
                    torch.randint(0, hi, (lanes, P), generator=gen).to(dev, torch.int32))
        khit, kph = fused_cache_step(k.tags, k.lru, k.stamp, *args, ns, ew,
                                     mode=mode, max_rrpv=3 if mode == "srrip" else 0)
        _, rhit, rph = cache_step_ref(r, *args, ns, ew, policy=policy)
        torch.cuda.synchronize()
        for a, b, name in ((k.tags, r.tags, "tags"), (k.lru, r.lru, "lru"),
                           (k.stamp, r.stamp, "stamp"), (khit, rhit, "hit"),
                           (kph, rph, "probe_hits")):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"kernel != plain ({mode}, {name}, pad {pad_sets}x{pad_ways})")
    return max_err, k, r, ns, ew, policy


def _cache_step_bytes(torch, state, args, ns, ew, policy):
    """Bytes one call must move on this state and these inputs.

    Replays the step on a copy of ``state`` to see which rows the data
    needs, each counted once: a tag row per enabled fill, per enabled
    demand and per probe; an lru row only per enabled fill that evicts
    (no present block, no vacant way). Writes are the tag and lru
    elements whose value changes. Plus the per-lane inputs and outputs
    (fills, enables, demand, probes, geometry, stamp; hit, probe hits)."""
    from repro_torch.core import dram_cache as dc
    from repro_torch.kernels.famsim_step import cache_step_ref
    copy = lambda: dc.CacheState(state.tags.clone(), state.lru.clone(), state.stamp.clone())
    fills, fen, demand, den, probes = args
    L, C = fills.shape
    P = probes.shape[1]
    row = 4 * state.tags.shape[-1]
    lane = torch.arange(L, device=fills.device)
    # (lane, set) of each row, one pair per query: si is (L,) or (L, P)
    key = lambda si: torch.stack([lane.view(-1, *[1] * (si.dim() - 1)).expand(si.shape),
                                  si.to(torch.int64)], -1).reshape(-1, 2)
    s = copy()
    wmask = dc._way_mask(s, ew)
    tag_rows, lru_rows = [], []
    for c in range(C):
        present, si, _ = dc.lookup(s, fills[:, c], ns, ew)
        vacant = ((s.tags[lane, si.to(torch.int64)] == 0) & wmask).any(-1)
        en = fen[:, c]
        tag_rows.append(key(si)[en])
        lru_rows.append(key(si)[en & ~present & ~vacant])
        dc.insert(s, fills[:, c], enable=en, num_sets=ns, ways=ew, policy=policy)
    tag_rows.append(key(dc.lookup(s, demand, ns, ew)[1])[den])
    tag_rows.append(key(dc.lookup(s, probes, ns, ew)[1]))   # a touch leaves tags alone
    n_rows = lambda rows: int(torch.unique(torch.cat(rows), dim=0).shape[0])
    reads = (n_rows(tag_rows) + n_rows(lru_rows)) * row
    after = copy()
    cache_step_ref(after, *args, ns, ew, policy=policy)
    writes = 4 * int((after.tags != state.tags).sum() + (after.lru != state.lru).sum())
    io = L * (C * 5 + 5 + P * 4 + 8 + 4) + L * (1 + P + 4)
    return reads + writes + io


def kernel_vs_plain(torch, gen):
    from repro_torch.configs.base import FamConfig
    from repro_torch.kernels.famsim_step import cache_step_ref, fused_cache_step
    max_err = 0
    # random op streams: small padded geometries, effective below the
    # padding, W_pad = 40 for the chunked path over more than 32 ways
    for pad_sets, pad_ways in ((16, 4), (64, 8), (32, 40)):
        lanes = 8
        num_sets = [max(1, pad_sets * (i + 1) // lanes) for i in range(lanes)]
        ways = [max(1, pad_ways * ((i * 3) % lanes + 1) // lanes) for i in range(lanes)]
        for mode in ("lru", "srrip"):
            e, *_ = _compare_stream(torch, lanes, pad_sets, pad_ways, num_sets,
                                    ways, mode, 25, 4, 6, gen, populate=False)
            max_err = max(max_err, e)
    # the fig08 geometry: 72 lanes, 16384 x 16, C = 8, P = 6, populated
    cfg = FamConfig()
    C, P = cfg.completions_per_step, cfg.prefetch_degree + cfg.core_pf_degree
    num_sets = [FamConfig(block_bytes=b).num_sets for b in FIG08_BLOCKS for _ in range(12)]
    ways = [cfg.cache_ways] * len(num_sets)
    pad_sets = FamConfig(block_bytes=FIG08_BLOCKS[0]).num_sets
    timing = {}
    for mode in ("lru", "srrip"):
        e, k, r, ns, ew, policy = _compare_stream(
            torch, len(num_sets), pad_sets, cfg.cache_ways, num_sets, ways,
            mode, 20, C, P, gen, populate=True)
        max_err = max(max_err, e)
        if mode == "lru":      # the main path's mode
            args = _ops(torch, k.tags, C, P, gen)
            launch = lambda: fused_cache_step(k.tags, k.lru, k.stamp, *args, ns, ew, mode=mode)
            call_ms = _time(torch, launch, 200)
            plain_ms = _time(torch, lambda: cache_step_ref(r, *args, ns, ew, policy=policy), 20)
            # the timed launches repeat these inputs, so after the first one
            # every launch sees a state like k's now: the bound is taken there
            nbytes = _cache_step_bytes(torch, k, args, ns, ew, policy)
            timing = dict(ms=_device_ms(torch, launch, 100, "cache_step_kernel"), call_ms=call_ms,
                          plain_ms=plain_ms, bytes=nbytes,
                          bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    # every row of an event in 1 or 2 effective sets, so fills, demand and
    # probes alias a few shared-memory slots; block ids from 3 x ways_pad,
    # so redundant fills, hits and evictions all occur (drawn after the
    # timed state, whose inputs the generator then gives as before)
    for pad_ways in (16, 40):
        lanes = 8
        num_sets = [1 + i % 2 for i in range(lanes)]
        ways = [pad_ways - (i * 5) % pad_ways for i in range(lanes)]
        for mode in ("lru", "srrip"):
            e, *_ = _compare_stream(torch, lanes, 4, pad_ways, num_sets, ways,
                                    mode, 40, C, P, gen, populate=False,
                                    blocks=3 * pad_ways)
            max_err = max(max_err, e)
    print(f"fused_cache_step @ 72 lanes x 16384 x 16, C={C}, P={P}, lru: "
          f"kernel {timing['ms'] * 1e3:.2f} us device time/launch "
          f"({timing['call_ms'] * 1e3:.2f} us per wrapper call, back to back), "
          f"plain {timing['plain_ms'] * 1e3:.1f} us/step, bound "
          f"{timing['bound_ms'] * 1e3:.4f} us ({timing['bytes']} B)", flush=True)
    return max_err, timing


@contextlib.contextmanager
def _profiled(torch):
    """torch.profiler (CPU and CUDA) over the block. The profiler drops
    kernel records whose device timestamps, taken to the host's clock,
    fall outside its window (Kineto counts them "out of range"): windows
    that began or ended on a launch lost some (8 of 100, 43 of 200, 1 of
    100 in three runs on the card), and windows opened after a long run of
    unprofiled launches lost their first records whatever the kernel.
    So the card idles PROFILE_MARGIN_S at each end of the window, and the
    window opens with LEAD_IN spin kernels (``torch.cuda._sleep``) that
    :func:`_device_events` leaves out; how many of them each window lost
    goes to ``lead_in_lost``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(LEAD_IN):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    from torch.autograd import DeviceType
    kept = sum(e.device_type() == DeviceType.CUDA and LEAD_IN_KERNEL in e.name()
               for e in prof.profiler.kineto_results.events())
    check(kept > 0, f"the profiler kept none of the {LEAD_IN} lead-in kernels")
    lead_in_lost.append(LEAD_IN - kept)


def _raw_device_events(prof):
    """(name, start ns, end ns) of the card's records of a _profiled
    window, its lead-in left out, read from the profiler's raw results:
    unlike ``prof.events()`` this builds no Python event tree, which for a
    window of ~150,000 records takes tens of seconds."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and LEAD_IN_KERNEL not in e.name()]


def _device_events(prof):
    """The kernel records of a _profiled window, its lead-in left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and LEAD_IN_KERNEL not in e.name]


def _device_ms(torch, fn, n, kernel=None):
    """Mean device time per call over n calls, from torch.profiler's
    kernel events (the host's work excluded): of the kernel whose name
    contains ``kernel`` (each call must launch it once), or of every kernel
    the call launches."""
    fn()
    with _profiled(torch) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    if kernel is not None:
        events = [e for e in events if kernel in e.name]
        check(len(events) == n, f"profiler saw {len(events)} of {n} {kernel} launches")
    check(events, "profiler saw no kernel")
    return sum(e.time_range.elapsed_us() for e in events) / n / 1e3


def _device_ms_beside(torch, fn, kernel, lib, n):
    """:func:`_device_ms` of ``fn`` (the kernel whose name contains
    ``kernel``, once a call) and of ``lib`` (every kernel it launches), n
    calls of each in one profiler window."""
    fn()
    lib()
    with _profiled(torch) as prof:
        for _ in range(n):
            fn()
        for _ in range(n):
            lib()
        torch.cuda.synchronize()
    events = _device_events(prof)
    mine = [e.time_range.elapsed_us() for e in events if kernel in e.name]
    rest = [e.time_range.elapsed_us() for e in events if kernel not in e.name]
    check(len(mine) == n, f"profiler saw {len(mine)} of {n} {kernel} launches")
    check(rest, "profiler saw no kernel of the library call")
    return sum(mine) / n / 1e3, sum(rest) / n / 1e3


def _time(torch, fn, n):
    """Time per call on the stream: CUDA events around n back-to-back
    calls after a warm-up (host-bound when the host issues slower than the
    device runs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# --------------------------------------------------------------------------
# launch counts
# --------------------------------------------------------------------------

def _wrappers():
    from repro_torch.kernels.block_gather import block_gather
    from repro_torch.kernels.cache_lookup import cache_lookup, tier_access
    from repro_torch.kernels.famsim_step import fused_cache_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    return {"fused_cache_step": fused_cache_step, "cache_lookup": cache_lookup,
            "tier_access": tier_access, "block_gather": block_gather,
            "paged_attention": paged_attention, "flash_attention": flash_attention}


def reset_counts():
    for wrapper in _wrappers().values():
        wrapper.launches = 0
    variants = _wrappers()["flash_attention"].variant_launches
    for name in variants:
        variants[name] = 0


def counts():
    return {name: wrapper.launches for name, wrapper in _wrappers().items()}


def flash_variants():
    """flash_attention's launches by variant ("tensor_core", "cuda_core")."""
    return dict(_wrappers()["flash_attention"].variant_launches)


def build_all():
    from repro_torch.kernels.nvcc import build_all as nvcc_build_all
    return nvcc_build_all([ROOT / src for src, _ in KERNELS.values()])


def _sass_counts(source, kernel, mnemonic):
    """{function: count of ``mnemonic``} over the functions whose name holds
    ``kernel`` in the SASS of ``source``'s built library (cuobjdump)."""
    from repro_torch.kernels.nvcc import library_path, nvcc
    lib = library_path(ROOT / source)
    sass = subprocess.run([str(Path(nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = fn if kernel in fn else None
            if name is not None:
                found[name] = 0
        elif name is not None and mnemonic in line:
            found[name] += 1
    return found


def tensor_core_sass():
    """HGMMA (wgmma) instructions in the SASS of each instantiation of the
    tensor-core attention kernel, by head dim; every instantiation must
    have some."""
    from repro_torch.kernels.flash_attention.kernel import TC_DIMS
    counts = _sass_counts(KERNELS["flash_attention"][0], "flash_attention_wgmma_kernel", "HGMMA")
    # the mangled template argument: ...wgmma_kernelILi64EE...
    found = {fn.split("flash_attention_wgmma_kernelILi")[1].split("E")[0]: n
             for fn, n in counts.items()}
    check(set(found) == {str(d) for d in TC_DIMS} and all(found.values()),
          f"HGMMA in the tensor-core kernel's instantiations: {found}")
    return found


def tensor_core_registers(built):
    """{D: (registers, spill store bytes, spill load bytes)} of each
    instantiation of the tensor-core attention kernel, from the ptxas -v
    lines of flash_attention.cu's log in ``built`` (build_all's (library,
    log) pairs; a library built before this run gives the log kept beside
    it); every head dim of TC_DIMS must be there and none may spill."""
    import re
    from repro_torch.kernels.flash_attention.kernel import TC_DIMS
    from repro_torch.kernels.nvcc import library_path
    log = dict(built)[library_path(ROOT / KERNELS["flash_attention"][0])]
    found, d = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            d = (int(line.split("flash_attention_wgmma_kernelILi")[1].split("E")[0])
                 if "flash_attention_wgmma_kernelILi" in line else None)
        elif d is not None and "spill stores" in line:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            found[d] = [None, int(spills.group(1)), int(spills.group(2))]
        elif d is not None and "registers" in line:
            found[d][0] = int(re.search(r"Used (\d+) registers", line).group(1))
            d = None
    found = {k: tuple(v) for k, v in found.items()}
    check(set(found) == set(TC_DIMS) and not any(st or ld for _, st, ld in found.values()),
          f"registers and spills of the tensor-core kernel's instantiations (ptxas -v): "
          f"{found}{'' if log else ' (no log: remove the build/ beside the source and rerun)'}")
    return found


def paged_tma_sass():
    """UTMALDG (TMA load) instructions in the SASS of each instantiation of
    the paged attention kernel; every instantiation must have some."""
    found = _sass_counts(KERNELS["paged_attention"][0], "paged_attention_kernel", "UTMALDG")
    check(found and all(found.values()), f"UTMALDG in the paged attention kernel: {found}")
    return found


# --------------------------------------------------------------------------
# phase 3: the tiering kernels vs their plain versions
# --------------------------------------------------------------------------

def _bound(nbytes, flops=0.0, flops_per_s=F32_FLOPS):
    """(bound ms, what bounds it): bytes over the HBM rate vs operations
    over the card's rate for their type (float32 unless told)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lookup_vs_plain(torch, gen):
    """cache_lookup: exact on random tags and on a populated 32 x 16 state
    (the decode's geometry), K from 1 to 260; timed at K = 256, beside the
    device time of a 1-element add_ (the card's floor for a small kernel)."""
    from repro_torch.kernels.cache_lookup import (cache_lookup, cache_lookup_ref,
                                                  set_index_ref)
    dev = torch.device(DEVICE)
    states = [torch.randint(0, 200, shape, generator=gen).to(dev, torch.int32)
              for shape in ((8, 4), (64, 16), (32, 40))]
    sets, ways = KV_FAST // KV_WAYS, KV_WAYS
    tags = torch.zeros((1, sets, ways), dtype=torch.int32, device=dev)
    _populate(torch, tags, torch.zeros_like(tags), [sets], [ways], "lru", gen)
    populated = tags[0].contiguous()
    states.append(populated)

    def queries(t, K):
        present = t[t > 0] - 1
        pick = present[torch.randint(0, present.numel(), (K,), generator=gen).to(dev)]
        fresh = torch.randint(-8, 1 << 20, (K,), generator=gen).to(dev, torch.int32)
        use = (torch.rand(K, generator=gen) < 0.5).to(dev)
        return torch.where(use, pick, fresh).to(torch.int32)

    max_err = 0
    for t in states:
        for K in (1, 7, 33, 256, 260):
            qs = queries(t, K)
            got, want = cache_lookup(t, qs), cache_lookup_ref(t, qs)
            torch.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
            check(err == 0, f"cache_lookup != plain at {tuple(t.shape)}, K={K}")
            max_err = max(max_err, err)
    qsets = [queries(populated, 256) for _ in range(8)]
    q = itertools.cycle(qsets).__next__
    rows = np.mean([torch.unique(set_index_ref(x, sets)).numel() for x in qsets])
    nbytes = 256 * 4 + rows * ways * 4 + 256 * (1 + 4 + 4)
    bound_ms, bound_by = _bound(nbytes)
    one = torch.zeros(1, device=dev)
    return dict(max_abs_err=max_err,
                floor_ms=_device_ms(torch, lambda: one.add_(1.0), 200),
                ms=_device_ms(torch, lambda: cache_lookup(populated, q()), 200,
                              "cache_lookup_kernel"),
                plain_ms=_time(torch, lambda: cache_lookup_ref(populated, q()), 50),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=f"tags {sets}x{ways}, K=256", bytes=nbytes)


def gather_vs_plain(torch, gen):
    """block_gather: exact in bf16 at the 3 MB slab width (K = 8), in f32 at
    the 64 KB KV-block width (K = 256) and on an odd row width (the byte
    path); timed on the expert fast tier, cycling over slab sets that do
    not fit in L2, beside torch.index_select."""
    from repro_torch.kernels.block_gather import block_gather, block_gather_ref
    dev = torch.device(DEVICE)
    cgen = torch.Generator(device=dev).manual_seed(1)
    slabs = torch.randn((MOE_FAST, MOE_SLAB), generator=cgen, device=dev,
                        dtype=torch.bfloat16)
    kv = torch.randn((KV_FAST, 2 * KV_BLOCK * KV_HKV * KV_D), generator=cgen, device=dev)
    odd = torch.randn((50, 1001), generator=cgen, device=dev, dtype=torch.bfloat16)
    max_err = 0.0
    for pool, K in ((slabs, 8), (kv, 256), (odd, 13)):
        idx = torch.randint(0, pool.shape[0], (K,), generator=gen).to(dev, torch.int32)
        got, want = block_gather(pool, idx), block_gather_ref(pool, idx)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"block_gather != plain at {tuple(pool.shape)} {pool.dtype}")
        max_err = max(max_err, err)
    idx_sets = [torch.randperm(MOE_FAST, generator=gen)[:MOE_TOP_K].to(dev, torch.int32)
                for _ in range(8)]
    nxt = itertools.cycle(idx_sets).__next__
    nbytes = 2 * MOE_TOP_K * MOE_SLAB * 2 + MOE_TOP_K * 4
    bound_ms, bound_by = _bound(nbytes)
    return dict(max_abs_err=max_err,
                ms=_device_ms(torch, lambda: block_gather(slabs, nxt()), 64,
                              "block_gather_kernel"),
                plain_ms=_time(torch, lambda: block_gather_ref(slabs, nxt()), 32),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=_device_ms(torch, lambda: torch.index_select(slabs, 0, nxt()), 64),
                shape=f"bf16 {MOE_FAST}x{MOE_SLAB}, K={MOE_TOP_K}", bytes=nbytes)


def _fast_pool(torch, cgen, dtype):
    """A tiered-KV fast tier and its K and V halves as strided views."""
    fast = torch.randn((KV_FAST, 2, KV_BLOCK, KV_HKV, KV_D), generator=cgen,
                       device=DEVICE, dtype=dtype)
    return fast, fast[:, 0], fast[:, 1]


def _attention_bytes(length, itemsize):
    """Bytes one decode step's paged attention must move: q read and the
    output written, each live token's K and V rows of every kv head read
    once, the live table entries and the length."""
    live = -(-length // KV_BLOCK)
    return (2 * KV_HQ * KV_D * itemsize + length * KV_HKV * KV_D * itemsize * 2
            + live * 4 + 4)


def attention_vs_plain(torch, gen):
    """paged_attention: within PAGED_TOL (f32) and PAGED_TOL_BF16 (bf16) at
    the decode's widths on strided views of the fast tier, at lengths that
    end mid-block, fill the table, are 1 and are 0 (exact zeros, as the TPU
    kernel gives); at G 6 (internlm2-20b) and G 8 / D 128 (yi-9b); and on
    views one element past 16-byte alignment, which take the cp.async (f32)
    and element (bf16) copies instead of TMA. Each check is one launch.
    Timed at one decode step's shape, f32 and bf16, cycling over 4 fast
    tiers (128 MB in f32, past L2), with every kernel a call launches
    counted; the launch plan and the time at length 0 (what the design
    costs with nothing to read) are printed beside."""
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
    dev = torch.device(DEVICE)
    cgen = torch.Generator(device=dev).manual_seed(2)
    nb = KV_CONTEXT // KV_BLOCK
    max_err = 0.0

    def compare(q, k, v, table, lengths, tol, what):
        before = paged_attention.launches
        got, want = paged_attention(q, k, v, table, lengths), paged_attention_ref(q, k, v, table, lengths)
        torch.cuda.synchronize()
        check(paged_attention.launches == before + 1, f"paged_attention ({what}) did not launch once")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"paged_attention != plain ({what}): max abs err {err}")
        for i in (lengths == 0).nonzero().flatten().tolist():
            check(bool((got[i] == 0).all()), f"paged_attention ({what}): length 0 is not exact zeros")
        return err

    for dtype, tol in ((torch.float32, PAGED_TOL), (torch.bfloat16, PAGED_TOL_BF16)):
        name = "f32" if dtype == torch.float32 else "bf16"
        fast, k, v = _fast_pool(torch, cgen, dtype)
        check(pk.copy_path(k, v)[0] == "tma", f"the fast tier's views ({name}) do not take TMA")
        lengths = torch.tensor([4003, 3001, 17, KV_CONTEXT, 0, 1], dtype=torch.int32, device=dev)
        table = torch.stack([torch.randperm(KV_FAST, generator=gen)[:nb]
                             for _ in range(len(lengths))]).to(dev, torch.int32)
        q = torch.randn((len(lengths), KV_HQ, KV_D), generator=cgen, device=dev, dtype=dtype)
        err = compare(q, k, v, table, lengths, tol, f"{name}, decode widths")
        if dtype == torch.float32:
            max_err = err
        # one element past 16-byte alignment: cp.async (f32, 4 bytes) or element copies (bf16)
        flat = torch.empty(fast.numel() + 1, device=dev, dtype=dtype)
        off = flat[1:].view(fast.shape)
        off.copy_(fast)
        path = pk.copy_path(off[:, 0], off[:, 1])[0]
        check(path == ("cp_async" if dtype == torch.float32 else "element"),
              f"a misaligned view ({name}) takes the {path} path")
        err = compare(q, off[:, 0], off[:, 1], table, lengths, tol, f"{name}, {path} copies")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        del flat, off, fast
        for hq, hkv, d in ((48, 8, 128), (32, 4, 128)):   # G 6 (internlm2-20b), G 8 / D 128 (yi-9b)
            pool = torch.randn((KV_FAST // 2, 2, KV_BLOCK, hkv, d), generator=cgen, device=dev,
                               dtype=dtype)
            lengths = torch.tensor([4003, 1], dtype=torch.int32, device=dev)
            table = torch.stack([torch.randperm(KV_FAST // 2, generator=gen)[:nb]
                                 for _ in range(2)]).to(dev, torch.int32)
            q = torch.randn((2, hq, d), generator=cgen, device=dev, dtype=dtype)
            err = compare(q, pool[:, 0], pool[:, 1], table, lengths, tol,
                          f"{name}, G {hq // hkv}, D {d}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            del pool
    length = KV_PROMPTS[0] + 3
    lengths = torch.tensor([length], dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    table = torch.randperm(KV_FAST, generator=gen)[:nb].to(dev, torch.int32)[None]
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        pools = [_fast_pool(torch, cgen, dtype) for _ in range(4)]
        q = torch.randn((1, KV_HQ, KV_D), generator=cgen, device=dev, dtype=dtype)
        nxt = itertools.cycle(pools).__next__

        def call(fn, ln=lengths):
            _, k, v = nxt()
            return fn(q, k, v, table, ln)
        with _profiled(torch) as prof:
            for _ in range(100):
                call(paged_attention)
            torch.cuda.synchronize()
        events = _device_events(prof)
        check(len(events) == 100 and all("paged_attention_kernel" in e.name for e in events),
              f"a paged_attention call launched {len(events) / 100} kernels: "
              f"{sorted({e.name[:60] for e in events})}")
        isz = torch.tensor([], dtype=dtype).element_size()
        nbytes = _attention_bytes(length, isz)
        timed[dtype] = dict(
            ms=_device_ms(torch, lambda: call(paged_attention), 100, "paged_attention_kernel"),
            call_ms=sum(e.time_range.elapsed_us() for e in events) / 100 / 1e3,
            zero_ms=_device_ms(torch, lambda: call(paged_attention, zero), 100,
                               "paged_attention_kernel"),
            plain_ms=_time(torch, lambda: call(paged_attention_ref), 20),
            bytes=nbytes, bound=_bound(nbytes, 4.0 * KV_HQ * KV_D * length),
            plan=pk.plan(KV_HQ // KV_HKV, KV_D, KV_BLOCK, KV_HKV, dtype))
        del pools
    f32, bf16 = timed[torch.float32], timed[torch.bfloat16]
    for dtype, t in timed.items():
        print(f"paged_attention {str(dtype).split('.')[1]} @ length {length}: "
              f"{t['ms'] * 1e3:.2f} us device time/call, 1 kernel a call "
              f"({t['call_ms'] * 1e3:.2f} us all kernels), bound {t['bound'][0] * 1e3:.4f} us "
              f"({t['bytes']} B, {t['bound'][1]}), plain {t['plain_ms'] * 1e3:.1f} us, "
              f"at length 0 {t['zero_ms'] * 1e3:.2f} us; plan {t['plan']}", flush=True)
    return dict(max_abs_err=max_err, ms=f32["ms"], plain_ms=f32["plain_ms"],
                bound_ms=f32["bound"][0], bound_by=f32["bound"][1], library_ms=None,
                bf16_ms=bf16["ms"], bf16_bound_ms=bf16["bound"][0],
                shape=f"B=1, Hq {KV_HQ}, Hkv {KV_HKV}, D {KV_D}, T {KV_BLOCK}, "
                      f"NB {nb}, length {length}, f32 strided views", bytes=f32["bytes"])


def tiering_kernels_vs_plain(torch, gen):
    out = {"cache_lookup": lookup_vs_plain(torch, gen),
           "block_gather": gather_vs_plain(torch, gen),
           "paged_attention": attention_vs_plain(torch, gen)}
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"{name} @ {r['shape']}: kernel {r['ms'] * 1e3:.2f} us device time/launch, "
              f"plain {r['plain_ms'] * 1e3:.1f} us/call, bound {r['bound_ms'] * 1e3:.4f} us "
              f"({r['bytes']:.0f} B, {r['bound_by']}), library {lib}, "
              f"max abs err {r['max_abs_err']}", flush=True)
    print(f"launch floor: a 1-element add_ takes {out['cache_lookup']['floor_ms'] * 1e3:.2f} us "
          f"device time beside cache_lookup's {out['cache_lookup']['ms'] * 1e3:.2f} us; "
          f"paged_attention bf16 {out['paged_attention']['bf16_ms'] * 1e3:.2f} us, bound "
          f"{out['paged_attention']['bf16_bound_ms'] * 1e3:.4f} us", flush=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 3b: the tier access kernel vs the plain loop
# --------------------------------------------------------------------------

def _state_leaves(st, prefix=""):
    """[(name, tensor)] of a TierState, nested states flattened."""
    out = []
    for name, x in zip(st._fields, st):
        if isinstance(x, tuple):
            out += _state_leaves(x, f"{prefix}{name}.")
        else:
            out.append((prefix + name, x))
    return out


def _same_state(torch, a, b, what):
    """Every tensor of two TierStates bit for bit (raises otherwise)."""
    la, lb = _state_leaves(a), _state_leaves(b)
    check(len(la) == len(lb) == 19, f"{what}: {len(la)} / {len(lb)} state tensors")
    raw = lambda x: x.reshape(-1).view({4: torch.int32, 2: torch.int16}[x.element_size()])
    for (name, x), (_, y) in zip(la, lb):
        check(x.dtype == y.dtype and x.shape == y.shape and torch.equal(raw(x), raw(y)),
              f"{what}: {name} differs between tier_access and the plain loop")


def _expert_routing(torch, dev):
    """MOE_TOKENS x MOE_LAYERS top-k expert sets from a seeded skewed
    router: per layer a Zipf-like popularity over the experts in a seeded
    order, so the hot experts repeat across tokens."""
    rng = np.random.default_rng(4)
    pop = 1.0 / np.arange(1, MOE_EXPERTS + 1) ** 1.2
    pop /= pop.sum()
    order = [rng.permutation(MOE_EXPERTS) for _ in range(MOE_LAYERS)]
    return [[torch.from_numpy(order[l][rng.choice(MOE_EXPERTS, MOE_TOP_K, replace=False,
                                                  p=pop)].astype(np.int32)).to(dev)
             for l in range(MOE_LAYERS)] for _ in range(MOE_TOKENS)]


def _access_streams(torch, dev):
    """The five streams of the access check: (name, pool arguments, slow
    tier, id lists, the access at which the two routes swap states, the
    fill copy's kind). (d) and (e) take (b)'s ids on rows that leave the
    16-byte copies: rows of 4,099 float32 (byte copies) and a float32
    slow tier one element past 16-byte alignment (element-wise bf16)."""
    cgen = torch.Generator(device=dev).manual_seed(6)
    nb = KV_CONTEXT // KV_BLOCK
    elems = 2 * KV_BLOCK * KV_HKV * KV_D
    pos = torch.arange(nb, dtype=torch.int32, device=dev)
    kv_ids = [torch.where(pos < -(-(KV_PROMPTS[0] + s + 1) // KV_BLOCK), pos, 0)
              for s in range(KV_STEPS)]
    rng = np.random.default_rng(6)
    small = [((np.arange(96) + 24 * i) % 512) if i < 6 else rng.integers(0, 512, 96)
             for i in range(12)]
    small = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in small]
    routing = _expert_routing(torch, dev)
    return [
        ("a: tiered-KV, K 256, 256 blocks, fast 512 (32 x 16), f32",
         dict(num_blocks=nb, fast_blocks=KV_FAST, block_elems=elems, page_span=16,
              dtype=torch.float32),
         torch.randn((nb, elems), generator=cgen, device=dev), kv_ids, None, "vector"),
        ("b: sliding then random, K 96, 512 blocks, fast 64 (4 x 16), f32 -> bf16",
         dict(num_blocks=512, fast_blocks=64, block_elems=4096, page_span=16,
              dtype=torch.bfloat16),
         torch.randn((512, 4096), generator=cgen, device=dev), small, 6, "bf16x4"),
        ("c: expert router, K 8, 768 slabs of 3 MB, fast 192 (12 x 16), bf16",
         dict(num_blocks=MOE_LAYERS * MOE_EXPERTS, fast_blocks=MOE_FAST, block_elems=MOE_SLAB,
              page_span=MOE_EXPERTS, dtype=torch.bfloat16),
         torch.randn((MOE_LAYERS * MOE_EXPERTS, MOE_SLAB), generator=cgen, device=dev,
                     dtype=torch.bfloat16),
         [layer * MOE_EXPERTS + experts for tok in routing
          for layer, experts in enumerate(tok)], None, "vector"),
        ("d: b's ids, rows of 4,099 f32 (16,396 B)",
         dict(num_blocks=512, fast_blocks=64, block_elems=4099, page_span=16,
              dtype=torch.float32),
         torch.randn((512, 4099), generator=cgen, device=dev), small, None, "bytes"),
        ("e: b's ids, f32 slow tier 4 bytes past 16-byte alignment -> bf16",
         dict(num_blocks=512, fast_blocks=64, block_elems=4096, page_span=16,
              dtype=torch.bfloat16),
         torch.randn(512 * 4096 + 1, generator=cgen, device=dev)[1:].view(512, 4096), small,
         None, "bf16"),
    ]


def _kernel_times(torch, fn, n):
    """{kernel name: mean device us a launch} over n calls of fn under the
    profiler (after one warm-up call); every kernel must have exactly n
    records."""
    fn()
    with _profiled(torch) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in _device_events(prof):
        seen.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for name, us in seen.items():
        check(len(us) == n, f"profiler saw {len(us)} {name} records in {n} calls")
    return {name: sum(us) / n for name, us in seen.items()}


def _access_bytes(torch, before, after, ids, row_bytes, pool):
    """Bytes one access must move, from the states before and after it:
    the ids; the tag and lru rows of the sets the ids hash to (read) and
    the elements that change (written); the signature-table entries of the
    ids' pages and the changed pattern rows (read and written); the
    changed side-table entries and stamp; each changed fast row written
    and its slow row read; the counters and the WFQ state."""
    from repro_torch.kernels.cache_lookup import set_index_ref
    la, lb = dict(_state_leaves(before)), dict(_state_leaves(after))
    changed = lambda k: int((la[k] != lb[k]).sum())
    sets, ways = la["cache.tags"].shape
    rows = torch.unique(set_index_ref(ids, sets)).numel()
    pages = torch.unique(torch.div(ids, pool.page_span, rounding_mode="floor")).numel()
    pt_rows = int((la["spp.pt_weight"] != lb["spp.pt_weight"]).any(1).sum())
    fast_rows = int((la["fast"] != lb["fast"]).any(1).sum())
    meta = sum(changed(k) for k in ("cache.tags", "cache.lru", "slot_of_block",
                                    "block_of_slot", "spp.st_tag", "spp.st_last",
                                    "spp.st_sig", "spp.pt_sigw"))
    return (4 * ids.numel() + rows * ways * 8 + pages * 12 + pt_rows * 36 * 2
            + pool.degree * 36 + 4 * meta + 8 + fast_rows * 2 * row_bytes
            + 2 * (16 + 12))


def access_vs_plain(torch):
    """tier_access against the plain loop on the card: five id streams
    through a ``kernel_backend="torch"`` pool and a ``"cuda"`` pool on the
    same slow tier, the whole TierState (fast tier included) and the slots
    bit for bit after every access. (b), (d) and (e) must evict and fill a
    slot twice within one access, (c) must have prefetches filled and
    valid predictions not filled; the routes swap states mid-run in (b);
    each of the copy kernel's four kinds runs in some stream. The kernel
    route makes no host sync (set_sync_debug_mode("error"))."""
    from repro_torch.configs.base import FamConfig, fam_replace
    from repro_torch.core import tiering
    from repro_torch.core.tiering import TieredBlockPool
    from repro_torch.kernels.cache_lookup import kernel as ck
    from repro_torch.kernels.cache_lookup import tier_access
    dev = torch.device(DEVICE)
    cfg = FamConfig()
    recorded = []
    host_schedule = tiering.schedule_batch_host

    def recording(state, nd, npf, **kw):     # the plain route's DWRR inputs and grants
        out = host_schedule(state, nd, npf, **kw)
        recorded.append((npf, out[1].count(2)))
        return out
    tiering.schedule_batch_host = recording
    stats = {}
    try:
        for name, kw, slow, streams, swap, kind in _access_streams(torch, dev):
            plain = TieredBlockPool(fam_replace(cfg, kernel_backend="torch"), device=DEVICE, **kw)
            kern = TieredBlockPool(cfg, device=DEVICE, **kw)
            sp, sk = plain.init(slow), kern.init(slow)
            check(ck.copy_path(slow, sk.fast)[0] == kind,
                  f"{name}: the fill copy takes {ck.copy_path(slow, sk.fast)}, not {kind}")
            recorded.clear()
            n = dict(misses=0, evictions=0, twice=0, filled=0, valid=0, granted=0)
            for i, ids in enumerate(streams):
                if i == swap:
                    sp, sk = sk, sp
                before = [(k, x.clone()) for k, x in _state_leaves(sp)]
                launches = tier_access.launches
                torch.cuda.set_sync_debug_mode("error")     # a host sync raises
                try:
                    sk, slots_k = kern.access(sk, slow, ids)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                check(tier_access.launches == launches + 1, f"{name}: tier_access did not launch once")
                sp, slots_p = plain.access(sp, slow, ids)
                torch.cuda.synchronize()
                _same_state(torch, sk, sp, f"{name}, access {i}")
                check(torch.equal(slots_k, slots_p), f"{name}, access {i}: slots differ")
                b = dict(before)
                fills = int(float(sp.demand_misses) - float(b["demand_misses"])
                            + float(sp.prefetches) - float(b["prefetches"]))
                grown = int((sp.cache.tags > 0).sum() - (b["cache.tags"] > 0).sum())
                moved = int((sp.block_of_slot != b["block_of_slot"]).sum())
                n["misses"] += int(float(sp.demand_misses) - float(b["demand_misses"]))
                n["filled"] += int(float(sp.prefetches) - float(b["prefetches"]))
                n["evictions"] += fills - grown
                n["twice"] += fills > moved        # some slot filled at least twice
            n["valid"] = sum(v for v, _ in recorded)
            n["granted"] = sum(g for _, g in recorded)
            stats[name[0]] = n
            print(f"access_vs_plain {name}: {len(streams)} accesses bit-identical (state, "
                  f"fast tier, slots; copy kind {kind})"
                  f"{'; routes swapped at access ' + str(swap) if swap else ''}: "
                  f"{n['misses']} misses, {n['evictions']} evictions, {n['twice']} accesses "
                  f"filling a slot twice; predictions valid {n['valid']}, DWRR grants "
                  f"{n['granted']}, prefetches filled {n['filled']}, not filled "
                  f"{n['valid'] - n['filled']} (already resident or not granted)", flush=True)
            del plain, kern, sp, sk, slow
            torch.cuda.empty_cache()
    finally:
        tiering.schedule_batch_host = host_schedule
    for k in "bde":
        check(stats[k]["evictions"] > 0 and stats[k]["twice"] > 0,
              f"stream {k} evicted {stats[k]['evictions']} times, filled a slot twice in "
              f"{stats[k]['twice']} accesses")
    check(stats["c"]["filled"] > 0 and stats["c"]["valid"] > stats["c"]["filled"],
          f"stream c: {stats['c']['filled']} prefetches filled of {stats['c']['valid']} valid")
    return dict(max_abs_err=0.0, library_ms=None)   # every state bit-identical


def access_timing(torch, mhz):
    """tier_access timed at stream (a) of access_vs_plain (see
    _time_access)."""
    from repro_torch.configs.base import FamConfig, fam_replace
    from repro_torch.core.tiering import TieredBlockPool
    cfg = FamConfig()
    _, kw, slow, streams, _, _ = _access_streams(torch, torch.device(DEVICE))[0]
    plain = TieredBlockPool(fam_replace(cfg, kernel_backend="torch"), device=DEVICE, **kw)
    kern = TieredBlockPool(cfg, device=DEVICE, **kw)
    out = _time_access(torch, kern, plain, slow, streams, mhz)
    del slow
    torch.cuda.empty_cache()
    return out


def _time_access(torch, kern, plain, slow, streams, mhz):
    """The chain and copy kernels per launch at stream (a), every kernel
    record held to the launch count: steady state (every id resident: all
    hits) and all misses, on fresh states; the plain loop per call (CUDA
    events); the byte bound of each from the states before and after; the
    chain's cycles an id at ``mhz``, the card's top SM clock."""
    ids = streams[-1]
    pst = plain.init(slow)
    for x in streams:
        pst, _ = plain.access(pst, slow, x)

    def plain_call():
        nonlocal pst
        pst, _ = plain.access(pst, slow, ids)
    plain_ms = _time(torch, plain_call, 3)
    del pst
    st = kern.init(slow)
    for x in streams:
        st = kern._access_cuda(st, slow, x)
    chain, copy = "tier_access_kernel", "tier_copy_kernel"

    def times(fn, n):
        t = _kernel_times(torch, fn, n)
        check(len(t) == 2, f"a tier_access call launched {sorted(t)}")
        (c_us,) = (v for k, v in t.items() if chain in k)
        (k_us,) = (v for k, v in t.items() if copy in k)
        return c_us, k_us

    def steady():
        nonlocal st
        st = kern._access_cuda(st, slow, ids)
    hit_chain, hit_copy = times(steady, 50)
    fresh = iter([kern.init(slow) for _ in range(21)])
    miss_chain, miss_copy = times(lambda: kern._access_cuda(next(fresh), slow, streams[0]), 20)
    row = slow.shape[1] * slow.element_size()
    before = kern.init(slow)
    snap = [(k, x.clone()) for k, x in _state_leaves(before)]
    after = kern._access_cuda(before, slow, streams[0])
    miss_bytes = _access_bytes(torch, _rebuild(snap, before), after, streams[0], row, kern)
    snap = [(k, x.clone()) for k, x in _state_leaves(st)]
    after = kern._access_cuda(st, slow, ids)
    hit_bytes = _access_bytes(torch, _rebuild(snap, st), after, ids, row, kern)
    del fresh
    steps = ids.numel() + kern.degree
    hit_bound, hit_by = _bound(hit_bytes)
    miss_bound, _ = _bound(miss_bytes)
    print(f"tier_access @ stream a, K {ids.numel()} + degree {kern.degree}: all hits chain "
          f"{hit_chain:.2f} us + copy {hit_copy:.2f} us a launch (50 of 50 records each), "
          f"{hit_chain * mhz / steps:.1f} SM cycles an id at {mhz:.0f} MHz; all misses chain "
          f"{miss_chain:.2f} us + copy {miss_copy:.2f} us (20 of 20); bound "
          f"{hit_bound * 1e3:.4f} us all hits ({hit_bytes} B, "
          f"{hit_by}), {miss_bound * 1e3:.4f} us all misses ({miss_bytes} B); plain loop "
          f"{plain_ms:.3f} ms a call (CUDA events, all hits)", flush=True)
    return dict(ms=(hit_chain + hit_copy) / 1e3, plain_ms=plain_ms, bound_ms=hit_bound,
                bound_by=hit_by, miss_ms=(miss_chain + miss_copy) / 1e3, miss_bound_ms=miss_bound,
                cycles_per_id=hit_chain * mhz / steps)


def _rebuild(snap, like):
    """A TierState shaped like ``like`` from [(name, tensor)] leaves."""
    vals = iter(x for _, x in snap)

    def rec(st):
        return type(st)(*(rec(x) if isinstance(x, tuple) else next(vals) for x in st))
    return rec(like)


# --------------------------------------------------------------------------
# phase 4: flash_attention vs its plain version
# --------------------------------------------------------------------------

def _serving_attention_shape():
    """(B, S, Hq, Hkv, D) of the serving path's prefill attention."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(SERVE_ARCH)
    return SERVE_BATCH, SERVE_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim


def _attention_flops(B, Sq, Sk, Hq, D, causal):
    """Operations of q.k and p.v over the (query, key) pairs the inputs
    need; under ``causal`` query i sees keys 0..i (top-left aligned)."""
    if not causal:
        pairs = Sq * Sk
    elif Sq <= Sk:
        pairs = Sq * (Sq + 1) // 2
    else:
        pairs = Sk * (Sk + 1) // 2 + (Sq - Sk) * Sk
    return 4.0 * B * Hq * D * pairs


def _fused_qkv(torch, rnd, B, Sq, Sk, Hq, Hkv, D):
    """q, k and v as strided views of one tensor, the layout a fused q/k/v
    projection gives: q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) slices
    along the heads of (B, max(Sq, Sk), Hq + 2 Hkv, D)."""
    qkv = rnd((B, max(Sq, Sk), Hq + 2 * Hkv, D), torch.bfloat16)
    return qkv[:, :Sq, :Hq], qkv[:, :Sk, Hq:Hq + Hkv], qkv[:, :Sk, Hq + Hkv:]


def flash_vs_plain(torch):
    """flash_attention: within FLASH_TOL of the plain version on the shapes
    of tests/test_kernels.py, on lengths that end mid-tile (Sq = Sk and
    Sq != Sk) at every dense head dim, f32 and bf16, causal and not; bf16
    at the tensor-core head dims over FLASH_TC_GROUPS on strided views;
    each case launches the variant ``variant`` names. Then the serving
    prefill's shape (bf16, causal) against the plain version within
    FLASH_PATH_TOL, timed there beside the library call and the CUDA-core
    kernel in f32, and the shapes of the serving phases of
    PATH_SHAPE_PHASES (:func:`_flash_path_shape`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import variant
    dev = torch.device(DEVICE)
    cgen = torch.Generator(device=dev).manual_seed(5)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=cgen, device=dev, dtype=dtype)
    cases = [(b, s, s, hq, hkv, d, dtype) for b, s, hq, hkv, d in FLASH_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1, s, s, 8, 2, d, dtype) for s in FLASH_LENGTHS for d in FLASH_DIMS
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1, sq, sk, 8, 2, d, dtype) for sq, sk in FLASH_UNEQUAL
              for d in FLASH_UNEQUAL_DIMS for dtype in (torch.float32, torch.bfloat16)]
    tc_cases = [(1, sq, sk, g * (1 if g == 32 else 2), 1 if g == 32 else 2, d, torch.bfloat16)
                for d in FLASH_TC_DIMS for sq, sk in FLASH_TC_LENGTHS for g in FLASH_TC_GROUPS]
    errs, n, instances = {}, {}, {}
    for i, (b, sq, sk, hq, hkv, d, dtype) in enumerate(cases + tc_cases):
        name = str(dtype).split(".")[1]
        tol = FLASH_TOL[name]
        if i < len(cases):
            q, k, v = rnd((b, sq, hq, d), dtype), rnd((b, sk, hkv, d), dtype), rnd((b, sk, hkv, d), dtype)
        else:
            q, k, v = _fused_qkv(torch, rnd, b, sq, sk, hq, hkv, d)
        which = variant(dtype, d)
        for causal in (True, False):
            before = flash_variants()
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            after = flash_variants()
            err = float((got.float() - want.float()).abs().max())
            what = (f"B {b}, Sq {sq}, Sk {sk}, Hq {hq}, Hkv {hkv}, D {d}, {name}, "
                    f"causal {causal}, {'strided' if i >= len(cases) else 'contiguous'}")
            check(after[which] == before[which] + 1 and sum(after.values()) == sum(before.values()) + 1,
                  f"flash_attention at {what} launched {after} (before {before}), expected {which}")
            check(got.shape == want.shape and got.dtype == dtype
                  and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                  f"flash_attention ({which}) != plain at {what}: max abs err {err}")
            key = f"{which} {name}"
            errs[key] = max(errs.get(key, 0.0), err)
            n[key] = n.get(key, 0) + 1
            if which == "cuda_core":     # its instances: D <= 64, 65-128, 129-256
                instances.setdefault(name, set()).add((d > 64) + (d > 128))
    B, S, Hq, Hkv, D = _serving_attention_shape()
    q, k, v = (rnd((B, S, h, D), torch.bfloat16) for h in (Hq, Hkv, Hkv))
    check(variant(q.dtype, D) == "tensor_core", "the serving prefill runs the tensor-core kernel")
    got, want = flash_attention(q, k, v).float(), flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    path_err = float(diff.max())
    path_used = float((diff / (FLASH_PATH_TOL["atol"] + FLASH_PATH_TOL["rtol"] * want.abs())).max())
    check(torch.allclose(got, want, **FLASH_PATH_TOL),
          f"flash_attention != plain at the serving prefill's shape: max abs err {path_err}, "
          f"{path_used:.3g} of the allowance")
    mean_abs = float(want.abs().mean())
    del got, want, diff
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)     # q, out; k, v in bf16
    flops = _attention_flops(B, S, S, Hq, D, True)
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = dict(max_abs_err=path_err,
               ms=_device_ms(torch, lambda: flash_attention(q, k, v), 20,
                             "flash_attention_wgmma_kernel"),
               plain_ms=_time(torch, lambda: flash_attention_ref(q, k, v), 3),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=_device_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True), 20),
               shape=f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, causal",
               bytes=nbytes, flops=flops)
    qf, kf, vf = (x.float() for x in (q, k, v))
    f32_ms = _device_ms(torch, lambda: flash_attention(qf, kf, vf), 3, "flash_attention_kernel")
    f32_bound, _ = _bound(2 * nbytes, flops, F32_FLOPS)
    del qf, kf, vf
    check(all(instances.get(name) == {0, 1, 2} for name in ("float32", "bfloat16")),
          f"each type runs every CUDA-core instance: {instances}")
    print("flash_attention cases within tolerance, by variant and type: " +
          ", ".join(f"{key} {n[key]} (max abs err {errs[key]:.3g})" for key in sorted(n)),
          flush=True)
    print(f"flash_attention at the serving prefill ({out['shape']}): max abs err vs plain "
          f"{path_err:.3g} (mean |out| {mean_abs:.3g}; {path_used:.3g} of the allowance atol "
          f"{FLASH_PATH_TOL['atol']} + rtol {FLASH_PATH_TOL['rtol']} |ref| used); tensor-core "
          f"kernel {out['ms']:.4f} ms device time/launch, {flops / out['ms'] / 1e9:.2f} TFLOP/s, "
          f"{bound_ms / out['ms']:.2%} of the bound {bound_ms:.4f} ms ({flops:.4g} operations at "
          f"{BF16_FLOPS:.4g}/s, {nbytes} B; {bound_by}); library (scaled_dot_product_attention) "
          f"{out['library_ms']:.4f} ms, kernel / library {out['ms'] / out['library_ms']:.3f}; "
          f"plain {out['plain_ms']:.4f} ms/call; CUDA-core kernel in f32 at that shape "
          f"{f32_ms:.4f} ms ({flops / f32_ms / 1e9:.2f} TFLOP/s, bound {f32_bound:.4f} ms at "
          f"{F32_FLOPS:.4g}/s)", flush=True)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    for phase in PATH_SHAPE_PHASES:
        _flash_path_shape(torch, rnd, phase)
    return out


def _serving_config(spec):
    """A serving phase's config: the arch's, with the phase's ``layers``
    and ``param_dtype`` cuts."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(spec["arch"])
    cut = {k: spec[k] for k in ("layers", "param_dtype") if k in spec}
    if "layers" in cut:
        cut["num_layers"] = cut.pop("layers")
    return dataclasses.replace(cfg, **cut)


def _cut_line(spec):
    """The cuts of a serving phase's config against its arch's, printed."""
    from repro_torch.configs.registry import get_config
    full, cfg = get_config(spec["arch"]), _serving_config(spec)
    cuts = []
    if cfg.num_layers != full.num_layers:
        cuts.append(f"layers cut from {full.num_layers} to {cfg.num_layers}")
    if cfg.param_dtype != full.param_dtype:
        cuts.append(f"params in {cfg.param_dtype}, not {full.param_dtype}")
    return "; ".join(cuts) or "nothing cut"


def _path_attention_shapes(cfg, spec):
    """[(what, launches a prefill, B, Sq, Sk, Hq, Hkv, D, causal)] of the
    flash_attention calls a prefill of a serving phase makes (``cfg`` the
    phase's cut config)."""
    from repro_torch.models import zamba
    B, S, H = spec["batch"], spec["prompt"], (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    if cfg.is_encoder_decoder:
        E = cfg.encoder_seq
        return [("encoder", cfg.encoder_layers, B, E, E, *H, False),
                ("decoder self-attention", cfg.num_layers, B, S, S, *H, True),
                ("cross-attention", cfg.num_layers, B, S, E, *H, False)]
    if cfg.ssm is not None:
        return [("shared attention", zamba.n_groups(cfg), B, S, S, *H, True)]
    return [("self-attention", cfg.num_layers, B, S, S, *H, True)]


def _flash_path_shape(torch, rnd, phase):
    """flash_attention at each shape the prefill of serving phase ``phase``
    (one of PATH_SHAPE_PHASES) gives it (:func:`_path_attention_shapes`, in the config's
    compute type), launching the phase's variant, against the plain
    version within FLASH_PATH_TOL; device time a launch beside the bound
    (operations at the bf16 tensor-core rate, or bytes),
    scaled_dot_product_attention's time and the plain version's. The
    shapes' launches add up to the phase's a prefill."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import variant
    spec = FAMILY_SERVING.get(phase) or MOE_SERVING[phase]
    cfg = _serving_config(spec)
    shapes = _path_attention_shapes(cfg, spec)
    check(sum(s[1] for s in shapes) == spec["flash"],
          f"{phase}: the shapes' launches {shapes} add up to {spec['flash']}")
    which = spec["variant"]
    kernel = "flash_attention_wgmma_kernel" if which == "tensor_core" else "flash_attention_kernel"
    dt = getattr(torch, cfg.dtype)
    outs = []
    for what, _, B, Sq, Sk, Hq, Hkv, D, causal in shapes:
        shape = (f"B {B}, Sq {Sq}, Sk {Sk}, Hq {Hq}, Hkv {Hkv}, D {D}, {cfg.dtype}, "
                 f"{'causal' if causal else 'unmasked'}")
        q, k, v = rnd((B, Sq, Hq, D), dt), rnd((B, Sk, Hkv, D), dt), rnd((B, Sk, Hkv, D), dt)
        check(variant(q.dtype, D) == which, f"{phase} {what} ({shape}) runs the {which} kernel")
        before = flash_variants()
        got = flash_attention(q, k, v, causal=causal).float()
        want = flash_attention_ref(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        after = flash_variants()
        check(after[which] == before[which] + 1 and sum(after.values()) == sum(before.values()) + 1,
              f"{phase} {what} launched {after} (before {before}), expected {which}")
        diff = (got - want).abs()
        err = float(diff.max())
        used = float((diff / (FLASH_PATH_TOL["atol"] + FLASH_PATH_TOL["rtol"] * want.abs())).max())
        check(torch.allclose(got, want, **FLASH_PATH_TOL),
              f"flash_attention != plain at {phase}'s {what} ({shape}): max abs err {err}, "
              f"{used:.3g} of the allowance")
        mean_abs = float(want.abs().mean())
        del got, want, diff
        isz = q.element_size()
        nbytes = isz * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D)     # q, out; k, v
        flops = _attention_flops(B, Sq, Sk, Hq, D, causal)
        bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, library_ms = _device_ms_beside(
            torch, lambda: flash_attention(q, k, v, causal=causal), kernel,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=True), 20)
        out = dict(phase=phase, what=what, shape=shape, max_abs_err=err, ms=ms,
                   plain_ms=_time(torch, lambda: flash_attention_ref(q, k, v, causal=causal), 3),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        print(f"flash_attention at {phase}'s {what} ({shape}; {cfg.name}): max abs err vs plain "
              f"{err:.3g} (mean |out| {mean_abs:.3g}; {used:.3g} of the allowance); {which} "
              f"kernel {out['ms']:.4f} ms device time/launch, {flops / out['ms'] / 1e9:.2f} "
              f"TFLOP/s, {bound_ms / out['ms']:.2%} of the bound {bound_ms:.4f} ms ({flops:.4g} "
              f"operations at {BF16_FLOPS:.4g}/s, {nbytes} B; {bound_by}); library "
              f"(scaled_dot_product_attention) {out['library_ms']:.4f} ms, kernel / library "
              f"{out['ms'] / out['library_ms']:.3f}; plain {out['plain_ms']:.4f} ms/call",
              flush=True)
        outs.append(out)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return outs


# --------------------------------------------------------------------------
# phase 5: tiered-KV decode at granite-3-2b's attention
# --------------------------------------------------------------------------

def _dense_attention(torch, q, k, v):
    """Plain GQA attention of one query token over raw K/V (S, Hkv, D)."""
    G = q.shape[0] // k.shape[1]
    qg = q.reshape(k.shape[1], G, -1)
    s = torch.einsum("hgd,shd->hgs", qg, k) / np.sqrt(q.shape[-1])
    return torch.einsum("hgs,shd->hgd", torch.softmax(s, -1), v).reshape(q.shape)


def _kernel_events(torch, fn, steps=1):
    """(wall seconds, device kernel events) of ``steps`` calls ``fn(i)``
    under torch.profiler."""
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, _device_events(prof)


def tiered_kv_path(torch):
    from repro_torch.configs.base import FamConfig
    from repro_torch.serve.tiered_kv import TieredKV, TieredKVConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    tk = TieredKV(FamConfig(), TieredKVConfig(block_tokens=KV_BLOCK, fast_blocks=KV_FAST),
                  max_blocks=KV_CONTEXT // KV_BLOCK, kv_heads=KV_HKV, head_dim=KV_D,
                  device=DEVICE)
    cgen = torch.Generator(device=dev).manual_seed(3)
    keys = [(r, l) for r in range(len(KV_PROMPTS)) for l in range(KV_LAYERS)]
    raw, slow, st = {}, {}, {}
    for key in keys:
        raw[key] = [torch.randn((KV_CONTEXT, KV_HKV, KV_D), generator=cgen, device=dev)
                    for _ in range(2)]
        slow[key] = tk.pack(*raw[key])
        st[key] = tk.init(slow[key])
    qs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (KV_STEPS, len(KV_PROMPTS), KV_LAYERS, KV_HQ, KV_D)).astype(np.float32)).to(dev)
    outs, step_s = {}, []
    reset_counts()
    for step in range(KV_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r, l in keys:
            st[r, l], outs[step, r, l] = tk.decode_step(
                st[r, l], slow[r, l], qs[step, r, l], KV_PROMPTS[r] + step + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launched = counts()
    n = KV_STEPS * len(keys)
    path = ("tier_access", "cache_lookup", "paged_attention")
    for name in path:
        check(launched[name] == n, f"{name} launched {launched[name]} times, expected {n}")
    check(all(v == 0 for k, v in launched.items() if k not in path),
          f"unexpected launches on the decode path: {launched}")
    max_err = 0.0
    for (step, r, l), out in outs.items():
        length = KV_PROMPTS[r] + step + 1
        k, v = raw[r, l]
        want = _dense_attention(torch, qs[step, r, l], k[:length], v[:length])
        check(out.shape == (KV_HQ, KV_D) and bool(torch.isfinite(out).all()), "decode output")
        max_err = max(max_err, float((out - want).abs().max()))
        check(torch.allclose(out, want, rtol=KV_TOL, atol=KV_TOL),
              f"decode step {step}, request {r}, layer {l}: max abs err vs dense "
              f"{float((out - want).abs().max())}")
    hits = sum(float(s.hits) for s in st.values())
    misses = sum(float(s.demand_misses) for s in st.values())
    prefetches = sum(float(s.prefetches) for s in st.values())
    wall = sum(step_s)
    print(f"tiered-KV decode: {len(KV_PROMPTS)} requests x {KV_LAYERS} layers x "
          f"{KV_STEPS} steps = {n} decode_step calls in {wall:.3f} s "
          f"({wall / n * 1e3:.3f} ms per call; per step round "
          f"{', '.join(f'{x:.3f}' for x in step_s)} s), "
          f"{len(KV_PROMPTS) * KV_STEPS / wall:.3f} decode tokens/s over all "
          f"{KV_LAYERS} layers; hit rate {hits / max(hits + misses, 1):.4f} "
          f"({hits:.0f} hits, {misses:.0f} misses), {prefetches:.0f} prefetches; "
          f"max abs err vs dense {max_err:.3g} (tol {KV_TOL})", flush=True)
    del raw, slow, st
    torch.cuda.empty_cache()
    return launched, wall / n


def tiered_kv_profile(torch, call_s, calls=20):
    """``calls`` warm decode_step calls of one (request, layer) of the
    tiered-KV decode (after KV_STEPS steps, at prompt KV_PROMPTS[0]) under
    torch.profiler: wall, device busy and device kernels a call, beside
    ``call_s``, the decode phase's unprofiled mean wall a call."""
    from repro_torch.configs.base import FamConfig
    from repro_torch.serve.tiered_kv import TieredKV, TieredKVConfig
    dev = torch.device(DEVICE)
    tk = TieredKV(FamConfig(), TieredKVConfig(block_tokens=KV_BLOCK, fast_blocks=KV_FAST),
                  max_blocks=KV_CONTEXT // KV_BLOCK, kv_heads=KV_HKV, head_dim=KV_D,
                  device=DEVICE)
    cgen = torch.Generator(device=dev).manual_seed(3)
    slow = tk.pack(*(torch.randn((KV_CONTEXT, KV_HKV, KV_D), generator=cgen, device=dev)
                     for _ in range(2)))
    q = torch.randn((KV_HQ, KV_D), generator=cgen, device=dev)
    state = {"st": tk.init(slow)}

    def one(i):
        state["st"], _ = tk.decode_step(state["st"], slow, q, KV_PROMPTS[0] + 1 + i)
    for i in range(KV_STEPS):
        one(i)
    reset_counts()
    wall, events = _kernel_events(torch, lambda i: one(KV_STEPS + i), calls)
    launched = counts()
    # the hand-written launches a call (launch counters) and their kernels'
    # records, held exact, so the window's record count is complete
    ours = {"tier_access": ("tier_access_kernel", "tier_copy_kernel"),
            "cache_lookup": ("cache_lookup_kernel",),
            "paged_attention": ("paged_attention_kernel",)}
    for name, kernels in ours.items():
        check(launched[name] == calls, f"{name} launched {launched[name]} times in {calls} calls")
        for k in kernels:
            seen = sum(k in e.name for e in events)
            check(seen == calls, f"profiler saw {seen} {k} records in {calls} calls")
    per_step = wall / calls
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6 / calls
    print(f"tiered-KV profile: {calls} warm decode_step calls, {per_step * 1e3:.3f} ms wall "
          f"a call under the profiler, device busy {busy * 1e3:.4f} ms a call "
          f"({busy / per_step:.2%} of that wall, {busy / call_s:.2%} of the decode phase's "
          f"unprofiled mean); {sum(launched[k] for k in ours) / calls:.0f} hand-written "
          f"launches a call (launch counters: tier_access, cache_lookup, paged_attention; "
          f"{sum(len(v) for v in ours.values())} kernels, every record present), "
          f"{len(events) / calls:.1f} device kernels a call in all", flush=True)
    del slow, state
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 6: expert tiering at granite-moe-1b-a400m
# --------------------------------------------------------------------------

def expert_path(torch):
    from repro_torch.configs.base import FamConfig
    from repro_torch.serve.expert_tiering import ExpertTier
    dev = torch.device(DEVICE)
    tier = ExpertTier(FamConfig(), MOE_LAYERS, MOE_EXPERTS, MOE_SLAB, MOE_FAST,
                      dtype=torch.bfloat16, device=DEVICE)
    cgen = torch.Generator(device=dev).manual_seed(4)
    slow = torch.randn((MOE_LAYERS * MOE_EXPERTS, MOE_SLAB), generator=cgen,
                       device=dev, dtype=torch.bfloat16)
    st = tier.init(slow)
    routing = _expert_routing(torch, dev)
    gathered = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tok in range(MOE_TOKENS):
        for layer in range(MOE_LAYERS):
            st, slabs = tier.gather_experts(st, slow, layer, routing[tok][layer])
            gathered.append((layer, routing[tok][layer], slabs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    n = MOE_TOKENS * MOE_LAYERS
    path = ("tier_access", "cache_lookup", "block_gather")
    for name in path:
        check(launched[name] == n, f"{name} launched {launched[name]} times, expected {n}")
    check(all(v == 0 for k, v in launched.items() if k not in path),
          f"unexpected launches on the expert path: {launched}")
    for layer, experts, slabs in gathered:
        ids = tier.slab_ids(layer, experts).to(torch.int64)
        check(slabs.shape == (MOE_TOP_K, MOE_SLAB) and torch.equal(slabs, slow[ids]),
              f"expert slabs of layer {layer} differ from the slow tier")
    rate = float(tier.pool.hit_rate(st))
    nbytes = n * MOE_TOP_K * MOE_SLAB * 2
    print(f"expert tiering: {n} gathers of {MOE_TOP_K} x {MOE_SLAB * 2 / 2**20:.0f} MiB "
          f"slabs in {wall:.3f} s = {n / wall:.2f} gathers/s, {nbytes / wall / 1e9:.3f} GB/s "
          f"gathered; hit rate {rate:.4f}, {float(st.prefetches):.0f} prefetches; "
          f"every slab exact", flush=True)
    del slow, st, gathered
    torch.cuda.empty_cache()
    return launched


# --------------------------------------------------------------------------
# phase 7: serving granite-3-2b at full width
# --------------------------------------------------------------------------

def _teacher_forced(torch, model, params, tokens, fed, extra=None, snapshot=False):
    """Prefill ``tokens`` (B, S) (with ``extra`` prefill inputs: M-RoPE
    positions, audio frames), its cache grown to S + N positions, then N - 1
    decode steps fed ``fed[:, t - 1]``, each synchronised and timed. The
    logits (float32) of the prefill's last token and of every step, the
    cache, with ``snapshot`` a copy of it as the prefill left it, the walls,
    and the launch counts after the prefill and at the end (all set to 0
    first)."""
    from repro_torch.models import pad_cache
    B, S = tokens.shape
    N = fed.shape[1]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens, **(extra or {})})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    at_prefill = counts()
    prefill_cache = _tree_leaves(cache, S, clone=True) if snapshot else None
    cache = pad_cache(cache, S + N)
    out, step_s = [logits.float()], []
    for t in range(1, N):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, cache, {"tokens": fed[:, t - 1:t],
                                                     "index": S + t - 1})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out.append(logits.float())
    return dict(logits=out, cache=cache, prefill_cache=prefill_cache, prefill_s=prefill_s,
                step_s=step_s, at_prefill=at_prefill, at_end=counts())


def _tree_leaves(tree, S, clone=False, prefix=""):
    """{dotted name: tensor} of a cache or recurrent state (nested dicts),
    the KV caches (``k`` / ``v`` / ``attn_k`` / ``attn_v``) cut to their
    first S positions; copies with ``clone``."""
    from repro_torch.models.model_zoo import SEQ_KEYS
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_tree_leaves(leaf, S, clone, f"{prefix}{key}."))
        else:
            leaf = leaf[:, :, :S] if key in SEQ_KEYS else leaf
            out[prefix + key] = leaf.clone() if clone else leaf
    return out


def _within(torch, got, want, what):
    """Check got against want at SERVE_TOL (atol SERVE_TOL x max|want|,
    rtol SERVE_TOL). Returns (max abs err / max|want|, the largest share
    of its allowance an element uses: |got - want| / (atol + rtol |want|),
    at most 1 when the check passes)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    err = float(diff.max())
    used = float((diff / (SERVE_TOL * scale + SERVE_TOL * want.abs())).max())
    check(torch.allclose(got, want, atol=SERVE_TOL * scale, rtol=SERVE_TOL),
          f"{what}: max abs err {err} vs max|ref| {scale} (tol {SERVE_TOL})")
    return err / max(scale, 1e-30), used


def serving_path(torch):
    """granite-3-2b at its published widths, random weights from a seed:
    Engine.generate on SERVE_BATCH prompts of SERVE_PROMPT random tokens
    with SERVE_NEW new tokens (the main path: one flash_attention launch
    per layer of the prefill, none in decode); then the same model and
    params teacher-forced on the generated tokens with the kernel backend
    (timed per stage) and the torch backend, every logit and the prefill's
    K/V cache within SERVE_TOL; one profiled prefill and decode step.
    Returns (the launches, the kernel backend's prefill seconds)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg, device=DEVICE)
    check(model.kernel_backend == "cuda", "the serving path runs the kernel backend")
    t0 = time.perf_counter()
    params = model.init(SERVE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(), f"{n_params} params, config says {cfg.param_count()}")
    prompts = torch.Generator().manual_seed(SERVE_SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=prompts).to(DEVICE)
    engine = Engine(model, params, ServeConfig(max_new_tokens=SERVE_NEW, seed=SERVE_SEED))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, stats = engine.generate({"tokens": tokens})
    wall = time.perf_counter() - t0
    launched = counts()
    launched_variants = flash_variants()
    L = cfg.num_layers
    check(launched["flash_attention"] == L,
          f"flash_attention launched {launched['flash_attention']} times, expected {L}")
    check(all(v == 0 for k, v in launched.items() if k != "flash_attention"),
          f"unexpected launches on the serving path: {launched}")
    check(gen.shape == (SERVE_BATCH, SERVE_NEW) and gen.dtype == np.int32
          and gen.min() >= 0 and gen.max() < cfg.vocab_size, f"generated tokens {gen}")
    check(stats == {"prefill_len": SERVE_PROMPT, "new_tokens": SERVE_NEW}, f"stats {stats}")
    check(launched_variants == {"tensor_core": L, "cuda_core": 0},
          f"flash_attention variants launched {launched_variants}, expected {L} tensor_core")
    print(f"serving {cfg.name}: {n_params} params ({cfg.param_dtype}, {cfg.dtype} compute, "
          f"random from seed {SERVE_SEED}, {init_s:.3f} s to draw); Engine.generate on "
          f"{SERVE_BATCH} x {SERVE_PROMPT} prompt tokens + {SERVE_NEW} new in {wall:.3f} s; "
          f"flash_attention launches {launched['flash_attention']} ({L} layers, 1 prefill; "
          f"by variant {launched_variants})",
          flush=True)

    fed = torch.from_numpy(gen).to(DEVICE)
    kern = _teacher_forced(torch, model, params, tokens, fed)
    check(kern["at_prefill"]["flash_attention"] == L and kern["at_end"]["flash_attention"] == L,
          f"flash_attention launches after prefill / at the end: "
          f"{kern['at_prefill']['flash_attention']} / {kern['at_end']['flash_attention']}, "
          f"expected {L} / {L} (none in decode)")
    ref = _teacher_forced(torch, build_model(cfg, device=DEVICE, kernel_backend="torch"),
                          params, tokens, fed)
    check(not any(ref["at_end"].values()), f"the torch backend launched {ref['at_end']}")
    S = SERVE_PROMPT
    rel = {"prefill logits": _within(torch, kern["logits"][0], ref["logits"][0],
                                     "prefill last-token logits")}
    for key in ("k", "v"):
        rel[f"{key} cache"] = _within(torch, kern["cache"][key][:, :, :S],
                                      ref["cache"][key][:, :, :S], f"prefill {key} cache")
    dec = [_within(torch, kern["logits"][t], ref["logits"][t], f"decode step {t} logits")
           for t in range(1, SERVE_NEW)]
    rel["decode logits"] = (max(e for e, _ in dec), max(u for _, u in dec))
    for lg in kern["logits"] + ref["logits"]:
        check(lg.shape == (SERVE_BATCH, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
              "logits finite, (B, vocab)")
    ref_tokens = torch.stack([lg.argmax(-1) for lg in ref["logits"]], 1).cpu().numpy()
    agree = float((ref_tokens == gen).mean())
    same = float((torch.stack([lg.argmax(-1) for lg in kern["logits"]], 1).cpu().numpy()
                  == gen).mean())
    steps = kern["step_s"]
    step = float(np.mean(steps))
    print(f"serving prefill: {kern['prefill_s']:.4f} s wall, "
          f"{SERVE_BATCH * S / kern['prefill_s']:.1f} prefill tokens/s (torch backend "
          f"{ref['prefill_s']:.4f} s); decode: {step * 1e3:.3f} ms wall per step "
          f"(min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f} over {len(steps)} steps), "
          f"{SERVE_BATCH / step:.1f} decode tokens/s (torch backend "
          f"{np.mean(ref['step_s']) * 1e3:.3f} ms per step)", flush=True)
    print(f"serving vs torch backend (max abs err / max|ref|, share of the allowance "
          f"atol + rtol |ref| used): " +
          ", ".join(f"{k} {v[0]:.4g} / {v[1]:.4g}" for k, v in rel.items()) +
          f" (tol {SERVE_TOL}); greedy tokens agreeing with the torch backend "
          f"{agree:.4f}, with the kernel backend's own teacher-forced argmax {same:.4f}",
          flush=True)

    p_wall, p_events = _kernel_events(torch, lambda i: model.prefill(params, {"tokens": tokens}))
    busy = sum(e.time_range.elapsed_us() for e in p_events) / 1e3
    fa = [e.time_range.elapsed_us() for e in p_events if "flash_attention_wgmma_kernel" in e.name]
    old = [e for e in p_events if "flash_attention_kernel" in e.name]
    check(len(fa) == L and not old,
          f"profiler saw {len(fa)} flash_attention_wgmma_kernel and {len(old)} "
          f"flash_attention_kernel launches in a prefill, expected {L} and 0")
    d_wall, d_events = _kernel_events(torch, lambda i: model.decode(
        params, kern["cache"], {"tokens": fed[:, -1:], "index": S + SERVE_NEW - 1}))
    d_busy = sum(e.time_range.elapsed_us() for e in d_events) / 1e3
    print(f"serving profile: one prefill {p_wall * 1e3:.3f} ms wall under the profiler, "
          f"device busy {busy:.3f} ms ({busy / 1e3 / p_wall:.2%} of that wall), "
          f"{len(p_events)} device kernels, flash_attention_wgmma_kernel {sum(fa) / 1e3:.3f} ms "
          f"= {sum(fa) / 1e3 / busy:.2%} of the prefill's device time; one decode step "
          f"{d_wall * 1e3:.3f} ms wall, device busy {d_busy:.3f} ms "
          f"({d_busy / 1e3 / d_wall:.2%}), {len(d_events)} device kernels", flush=True)
    prefill_s = kern["prefill_s"]
    del params, kern, ref
    torch.cuda.empty_cache()
    return launched, prefill_s


# --------------------------------------------------------------------------
# phase 7b: serving granite-moe-1b-a400m at full width
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _routing_recorded(torch, pinned=None):
    """Record every ``repro_torch.models.moe.route`` call's top-k expert
    indices, in call order (one per MoE layer a forward). With ``pinned``
    (an earlier recording of the same forwards) each call takes the
    pinned call's experts instead of its own top-k, weighted by its own
    router probabilities renormalised over them: the routing decisions of
    that run, the arithmetic of this one."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def route(cfg, p, x):
        top_w, top_i, aux = real(cfg, p, x)
        if pinned is not None:
            top_i = pinned[len(seen)]
            probs = torch.softmax((x @ p.router.to(x.dtype)).to(torch.float32), dim=-1)
            top_w = probs.gather(-1, top_i)
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
        seen.append(top_i)
        return top_w, top_i, aux
    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def _routing_differences(a, b, layers):
    """Per layer, the (token, layer) choices whose top-k expert sets differ
    between two recordings of the same forwards (``layers`` calls a
    forward), and how many choices there were in all."""
    check(len(a) == len(b), f"routing recorded {len(a)} and {len(b)} calls")
    per_layer, total = [0] * layers, 0
    for i, (x, y) in enumerate(zip(a, b)):
        per_layer[i % layers] += int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
        total += x[..., 0].numel()
    return per_layer, total


def _layerwise(torch, cfg, params, tokens, backend, inputs=None, pinned=None):
    """The prefill layer by layer (``transformer.apply_layer``); with
    ``inputs`` each layer takes ``inputs[i]`` instead of the layer before's
    output. Returns (the inputs taken, each layer's update in float32, the
    routing recorded or pinned)."""
    from repro_torch.models import layers as Lyr
    from repro_torch.models import transformer as T
    positions = T._positions_for(cfg, tokens, None)
    x = Lyr.embed_tokens(cfg, params.embed, tokens)
    xs, updates = [], []
    with torch.no_grad(), _routing_recorded(torch, pinned) as routes:
        for i, layer in enumerate(params.layers):
            x = x if inputs is None else inputs[i]
            nxt, _ = T.apply_layer(cfg, layer, x, positions, backend=backend)
            xs.append(x)
            updates.append(nxt.float() - x.float())
            x = nxt
    return xs, updates, routes


def _gap(pairs):
    """(max abs err / max|want|, the largest share of SERVE_TOL's allowance an
    element uses) over (got, want) pairs, unchecked."""
    err = used = 0.0
    for got, want in pairs:
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        d = (got - want).abs()
        err = max(err, float(d.max()) / max(scale, 1e-30))
        used = max(used, float((d / (SERVE_TOL * scale + SERVE_TOL * want.abs())).max()))
    return err, used


def _end_to_end(kern, ref, what, S):
    """(max abs err / max|ref|, share of SERVE_TOL's allowance used) of
    the teacher-forced logits (prefill and every decode step) and the
    prefill's K/V cache (its S positions) of two runs, unchecked."""
    pairs = [(k, r) for k, r in zip(kern["logits"], ref["logits"])]
    pairs += [(kern["cache"][c][:, :, :S], ref["cache"][c][:, :, :S]) for c in ("k", "v")]
    err, used = _gap(pairs)
    return f"{what}: max abs err / max|ref| {err:.4g}, share of the allowance {used:.4g}"


def moe_serving_path(torch, phase="moe_serving"):
    """A MoE config at its published widths (MOE_SERVING[phase]:
    granite-moe-1b-a400m whole, or arctic-480b cut to 2 layers with bf16
    params), random weights from a seed: Engine.generate on the phase's
    batch of random prompts with its new tokens (the main path: one
    tensor-core flash_attention launch per layer of the prefill, none in
    decode), then the same params teacher-forced under the kernel and the
    torch backends.

    Routing is a discontinuity: a router logit that moves by one bfloat16
    ulp can swap an expert, which moves the token's output by a whole
    expert's share, and every later layer then routes another input. In
    bfloat16 the two backends' choices part more with every layer (the
    counts are printed), and even with the kernel run's choices pinned
    (:func:`_routing_recorded`) 24 layers of bfloat16 rounding carry the
    last logits past SERVE_TOL; in float32 a few choices still part, and
    the K/V of the tokens they touch with them. So the held comparisons are: (1) in
    bfloat16, every layer's update given the kernel run's input to that
    layer and its expert choices, within SERVE_TOL; (2) end to end in
    float32 compute (the CUDA-core kernel) with the kernel run's choices
    pinned, the prefill's logits and K/V cache and every decode step's
    logits within SERVE_TOL. The end-to-end distances with free routing
    (and in bfloat16 pinned) are printed. (2) is left out where the spec's
    ``f32`` is false (arctic: its bf16 experts cast to f32 a call would be
    17.8 GB a weight, which does not fit beside the params); its distances
    with free routing are printed all the same. Prints the experts' work
    a prefill (moe_dense computes every expert for every token) beside the
    routed work, and peak memory."""
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = MOE_SERVING[phase]
    cfg = _serving_config(spec)
    B, S, N = spec["batch"], spec["prompt"], spec["new"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{phase} {cfg.name}: {_cut_line(spec)}; "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated at the start", flush=True)
    model = build_model(cfg, device=DEVICE)
    params = model.init(SERVE_SEED)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(), f"{n_params} params, config says {cfg.param_count()}")
    prompts = torch.Generator().manual_seed(SERVE_SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=prompts).to(DEVICE)
    engine = Engine(model, params, ServeConfig(max_new_tokens=N, seed=SERVE_SEED))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, stats = engine.generate({"tokens": tokens})
    wall = time.perf_counter() - t0
    launched, variants = counts(), flash_variants()
    L = cfg.num_layers
    check(L == spec["flash"], f"{phase}: {L} layers, {spec['flash']} launches expected")
    check(launched["flash_attention"] == L and variants == {spec["variant"]: L, "cuda_core": 0},
          f"{phase}: flash_attention launched {launched['flash_attention']} times ({variants}), "
          f"expected {L} {spec['variant']}")
    check(all(v == 0 for k, v in launched.items() if k != "flash_attention"),
          f"unexpected launches on {phase}'s path: {launched}")
    check(gen.shape == (B, N) and gen.min() >= 0 and gen.max() < cfg.vocab_size,
          f"{phase}: generated tokens {gen}")
    check(stats == {"prefill_len": S, "new_tokens": N}, f"{phase}: stats {stats}")
    residual = (f", a dense residual at d_ff {cfg.moe.dense_d_ff or cfg.d_ff}"
                if cfg.moe.dense_residual else "")
    print(f"{phase} {cfg.name}: {n_params} params ({cfg.num_layers} layers, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} at d_ff {cfg.moe.d_ff}{residual}; "
          f"{cfg.param_dtype}, {cfg.dtype} compute, random from seed {SERVE_SEED}); "
          f"Engine.generate on {B} x {S} prompt tokens + {N} new in {wall:.3f} s; "
          f"flash_attention launches {launched['flash_attention']} ({L} layers, by variant "
          f"{variants}; counted apart from dense serving's)", flush=True)

    # bfloat16 end to end: timed kernel run, the torch backend free and pinned
    fed = torch.from_numpy(gen).to(DEVICE)
    with _routing_recorded(torch) as kern_routes:
        kern = _teacher_forced(torch, model, params, tokens, fed)
    check(kern["at_prefill"]["flash_attention"] == L and kern["at_end"]["flash_attention"] == L,
          f"flash_attention launches after prefill / at the end: "
          f"{kern['at_prefill']['flash_attention']} / {kern['at_end']['flash_attention']}, "
          f"expected {L} / {L} (none in decode)")
    torch_model = build_model(cfg, device=DEVICE, kernel_backend="torch")
    with _routing_recorded(torch) as free_routes:
        free = _teacher_forced(torch, torch_model, params, tokens, fed)
    with _routing_recorded(torch, pinned=kern_routes):
        pinned = _teacher_forced(torch, torch_model, params, tokens, fed)
    check(not any(free["at_end"].values()) and not any(pinned["at_end"].values()),
          f"the torch backend launched {free['at_end']} / {pinned['at_end']}")
    for lg in kern["logits"] + free["logits"] + pinned["logits"]:
        check(lg.shape == (B, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
              f"{phase}: logits finite, (B, vocab)")
    prefill_differ, prefill_total = _routing_differences(kern_routes[:L],
                                                         free_routes[:L], L)
    decode_differ, decode_total = _routing_differences(kern_routes[L:],
                                                       free_routes[L:], L)
    print(f"{phase} routing in bfloat16, kernel vs torch backend end to end: "
          f"{sum(prefill_differ)} of {prefill_total} (token, layer) top-{cfg.moe.top_k} "
          f"choices differ in the prefill (by layer {prefill_differ}), {sum(decode_differ)} "
          f"of {decode_total} in decode (by layer {decode_differ}); unchecked "
          + _end_to_end(kern, free, "routing freely", S) + "; "
          + _end_to_end(kern, pinned, "the kernel run's routing pinned", S)
          + f" (SERVE_TOL {SERVE_TOL})", flush=True)
    steps = kern["step_s"]
    step = float(np.mean(steps))
    prefill_s = {}
    for name, m in (("cuda", model), ("torch", torch_model)):
        walls = []
        for _ in range(MOE_PREFILL_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prefill_s[name] = float(np.median(walls))
    print(f"{phase} prefill (median of {MOE_PREFILL_REPEATS} after the teacher-forced "
          f"runs): {prefill_s['cuda']:.4f} s wall, "
          f"{B * S / prefill_s['cuda']:.1f} prefill tokens/s "
          f"(torch backend {prefill_s['torch']:.4f} s; the teacher-forced runs' first "
          f"prefills {kern['prefill_s']:.4f} / {free['prefill_s']:.4f} s); decode: "
          f"{step * 1e3:.3f} ms wall per "
          f"step (min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f} over {len(steps)} "
          f"steps), {B / step:.1f} decode tokens/s (torch backend "
          f"{np.mean(free['step_s']) * 1e3:.3f} ms per step)", flush=True)
    m = cfg.moe
    expert_flops = 2 * B * S * L * 3 * cfg.d_model * m.d_ff     # one expert, every token
    print(f"{phase} experts' work a prefill: moe_dense computes all {m.num_experts} experts "
          f"for every token, {expert_flops * m.num_experts:.4g} operations "
          f"({expert_flops * m.num_experts / prefill_s['cuda'] / 1e12:.2f} TFLOP/s over the "
          f"prefill's wall), {m.num_experts // m.top_k} times the {expert_flops * m.top_k:.4g} "
          f"of the top-{m.top_k} routing", flush=True)
    del kern, free, pinned

    # (1) bfloat16, layer by layer: the same input and expert choices
    xs, kern_updates, layer_routes = _layerwise(torch, cfg, params, tokens, "cuda")
    _, ref_updates, _ = _layerwise(torch, cfg, params, tokens, "torch", inputs=xs,
                                   pinned=layer_routes)
    _, _, free_layer_routes = _layerwise(torch, cfg, params, tokens, "torch", inputs=xs)
    layer_differ, _ = _routing_differences(layer_routes, free_layer_routes, L)
    rel = [_within(torch, a, b, f"{phase} layer {i} update (bfloat16, same input and experts)")
           for i, (a, b) in enumerate(zip(kern_updates, ref_updates))]
    print(f"{phase} layer by layer in bfloat16 (each layer the kernel run's input and expert "
          f"choices), kernel vs torch backend: every layer's update within SERVE_TOL, worst "
          f"max abs err / max|ref| {max(e for e, _ in rel):.4g} (layer "
          f"{int(np.argmax([e for e, _ in rel]))}), share of the allowance "
          f"{max(u for _, u in rel):.4g}; with the same inputs but free routing the choices "
          f"differ by layer {layer_differ} of {B * S}", flush=True)
    del xs, kern_updates, ref_updates
    if spec["f32"]:
        _moe_f32_end_to_end(torch, cfg, params, tokens, fed, S, N)
    peak = torch.cuda.max_memory_allocated()
    print(f"{phase} {cfg.name} on {_card()}: peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    del params, engine, model
    torch.cuda.empty_cache()
    return launched


def _moe_f32_end_to_end(torch, cfg, params, tokens, fed, S, N):
    """moe_serving_path's comparison (2): float32 compute end to end (the
    CUDA-core kernel), the kernel run's routing pinned."""
    import dataclasses
    from repro_torch.models import build_model
    L = cfg.num_layers
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with _routing_recorded(torch) as r32:
        k32 = _teacher_forced(torch, build_model(cfg32, device=DEVICE), params, tokens, fed)
    v32 = flash_variants()
    check(k32["at_end"]["flash_attention"] == L and v32 == {"tensor_core": 0, "cuda_core": L},
          f"float32 prefill: flash_attention {k32['at_end']['flash_attention']} ({v32}), "
          f"expected {L} cuda_core")
    torch32 = build_model(cfg32, device=DEVICE, kernel_backend="torch")
    with _routing_recorded(torch) as free32_routes:
        free32 = _teacher_forced(torch, torch32, params, tokens, fed)
    differ32, total32 = _routing_differences(r32, free32_routes, L)
    free32_line = _end_to_end(k32, free32, "routing freely", S)
    del free32
    with _routing_recorded(torch, pinned=r32):
        t32 = _teacher_forced(torch, torch32, params, tokens, fed)
    rel32 = {"prefill logits": _within(torch, k32["logits"][0], t32["logits"][0],
                                       "moe float32 prefill last-token logits")}
    for key in ("k", "v"):
        rel32[f"{key} cache"] = _within(torch, k32["cache"][key][:, :, :S],
                                        t32["cache"][key][:, :, :S],
                                        f"moe float32 prefill {key} cache")
    dec = [_within(torch, k32["logits"][t], t32["logits"][t],
                   f"moe float32 decode step {t} logits") for t in range(1, N)]
    rel32["decode logits"] = (max(e for e, _ in dec), max(u for _, u in dec))
    print(f"moe float32 end to end (CUDA-core kernel), kernel vs torch backend with the "
          f"kernel run's routing pinned: "
          + ", ".join(f"{k} {v[0]:.4g} / {v[1]:.4g}" for k, v in rel32.items()) +
          f" (max abs err / max|ref|, share of the allowance; tol {SERVE_TOL}); routing "
          f"freely {sum(differ32)} of {total32} (token, layer) choices differ (by layer "
          f"{differ32}), unchecked {free32_line}", flush=True)


# --------------------------------------------------------------------------
# phases 7c-7f: serving the hybrid, ssm, audio and vlm families
# --------------------------------------------------------------------------

_CARD = []


def _card():
    """The card's name and power limit as nvidia-smi prints them."""
    if not _CARD:
        _CARD.append(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip())
    return _CARD[0]


def _vlm_positions(torch, B, S):
    """(3, B, S) int32 M-RoPE planes (t, h, w): VLM_TEXT text tokens (all
    three planes the index), a VLM_GRID x VLM_GRID image at one t (h and w
    walk its rows and columns), then text from past the image's largest
    position, so the three planes differ."""
    i = torch.arange(S, dtype=torch.int64)
    j = (i - VLM_TEXT).clamp(min=0)
    image = (i >= VLM_TEXT) & (j < VLM_GRID * VLM_GRID)
    after = VLM_TEXT + VLM_GRID + (j - VLM_GRID * VLM_GRID)
    t = torch.where(i < VLM_TEXT, i, torch.where(image, VLM_TEXT, after))
    h = torch.where(image, VLM_TEXT + j // VLM_GRID, t)
    w = torch.where(image, VLM_TEXT + j % VLM_GRID, t)
    pos = torch.stack([t, h, w]).to(torch.int32)[:, None].expand(3, B, S)
    check(bool((pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()),
          "the M-RoPE planes differ")
    return pos.contiguous().to(DEVICE)


def _family_inputs(torch, cfg, B, S):
    """The prompt tokens (random ids, seed SERVE_SEED + 1, drawn on the
    CPU) and the family's other prefill inputs: whisper's frames (standard
    normals, seed SERVE_SEED + 2) or qwen2-vl's M-RoPE planes."""
    prompts = torch.Generator().manual_seed(SERVE_SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=prompts).to(DEVICE)
    extra = {}
    if cfg.is_encoder_decoder:
        frames = torch.Generator().manual_seed(SERVE_SEED + 2)
        extra["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=frames).to(DEVICE)
    if cfg.position == "mrope":
        extra["positions"] = _vlm_positions(torch, B, S)
    return tokens, extra


def _hold(torch, what, pairs):
    """_within over (name, got, want) -> {name: (rel err, share used)},
    decode steps merged into one entry; ``what`` leads each failure."""
    out = {}
    for name, got, want in pairs:
        r = _within(torch, got, want, f"{what} {name}")
        key = "decode logits" if name.startswith("decode step") else name
        old = out.get(key, (0.0, 0.0))
        out[key] = (max(old[0], r[0]), max(old[1], r[1]))
    return out


def _rel_line(rel):
    return ", ".join(f"{k} {v[0]:.4g} / {v[1]:.4g}" for k, v in rel.items())


def _vlm_buffered(torch, cfg, model, params, prefill_cache, fed):
    """vlm_serving's buffered decode: VLM_BUFFER steps of
    ``decode_step_buffered`` (W VLM_BUFFER) from base_len S, the prefill's
    length, against a read-only copy of the prefill's cache, each step's
    logits against ``decode_step`` on the same tokens and positions (index
    S + i on every plane, not the engine's M-RoPE text positions) within
    SERVE_TOL, no kernel launched; then ``flush_buffer`` at S: rows S ..
    S + W - 1 equal the buffer bit for bit, layer 0's equal the plain
    decode's bit for bit (its K/V come from the token and its position
    alone), every layer's within SERVE_TOL (the later layers' inputs went
    through the two-source softmax, which rounds otherwise), the rows
    below S untouched. Prints ms a buffered step and the flush's (CUDA
    events) beside decode_step's."""
    from repro_torch.models import pad_cache
    from repro_torch.models import transformer as T
    t_start = time.perf_counter()
    W = VLM_BUFFER
    B, S = prefill_cache["k"].shape[1], prefill_cache["k"].shape[2]
    cache = pad_cache({k: prefill_cache[k] for k in ("k", "v")}, S + W)
    plain = {k: v.clone() for k, v in cache.items()}
    buf = T.init_kv_buffer(cfg, B, W, device=DEVICE)
    reset_counts()
    rel = {}
    for i in range(W):
        tok = fed[:, i:i + 1]
        want, plain = model.decode(params, plain, {"tokens": tok, "index": S + i})
        got, buf = T.decode_step_buffered(cfg, params, cache, buf, tok, S, i)
        check(bool(torch.isfinite(got).all()), f"vlm_serving buffered step {i}: logits finite")
        r = _within(torch, got, want, f"vlm_serving buffered step {i} logits")
        rel["logits"] = tuple(max(a, b) for a, b in zip(rel.get("logits", (0, 0)), r))
    launched = counts()
    check(not any(launched.values()), f"the buffered decode launched {launched}")
    for k in ("k", "v"):
        check(torch.equal(cache[k][:, :, :S], prefill_cache[k]) and
              not bool(cache[k][:, :, S:].any()), f"the buffered decode wrote the {k} cache")
    T.flush_buffer(cfg, cache, buf, S)
    same_layers = []
    for k in ("k", "v"):
        new, ref = cache[k][:, :, S:], plain[k][:, :, S:]
        check(torch.equal(new, buf[k].to(new.dtype)), f"flushed {k} rows != the buffer")
        check(torch.equal(cache[k][:, :, :S], prefill_cache[k]), f"the flush moved {k} rows < S")
        check(torch.equal(new[0], ref[0]), f"flushed layer 0 {k} rows != the plain decode's")
        rel[f"flushed {k}"] = _within(torch, new, ref, f"vlm_serving flushed {k} rows")
        same_layers.append(sum(bool(torch.equal(new[l], ref[l])) for l in range(new.shape[0])))
    step_ms = _time(torch, lambda: T.decode_step_buffered(cfg, params, cache, buf,
                                                          fed[:, :1], S, 0), VLM_BUFFER_REPEATS)
    flush_ms = _time(torch, lambda: T.flush_buffer(cfg, cache, buf, S), VLM_BUFFER_REPEATS)
    plain_ms = _time(torch, lambda: model.decode(params, plain, {"tokens": fed[:, :1],
                                                                 "index": S}),
                     VLM_BUFFER_REPEATS)
    print(f"vlm_serving buffered decode (W {W}, base_len {S}, {W} steps, positions S + i on "
          f"every plane): each step's logits against decode_step's, then the flush's rows "
          f"against the plain decode's: {_rel_line(rel)} (max abs err / max|ref|, share of the "
          f"allowance; tol {SERVE_TOL}); flushed rows equal the buffer bit for bit, layer 0's "
          f"the plain decode's (layers bit-identical of {cfg.num_layers}: k {same_layers[0]}, "
          f"v {same_layers[1]}); no kernel launched; {step_ms:.3f} ms a buffered step, flush "
          f"{flush_ms:.3f} ms, decode_step {plain_ms:.3f} ms in this run (CUDA events, "
          f"{VLM_BUFFER_REPEATS} calls each); {time.perf_counter() - t_start:.3f} s", flush=True)
    del cache, plain, buf


def family_serving_path(torch, phase):
    """One family at its published widths (FAMILY_SERVING[phase]), random
    weights from a seed: Engine.generate (the main path: its
    flash_attention launches a prefill, none in decode, no other kernel),
    then the same params teacher-forced on the generated tokens under the
    ``"cuda"`` backend and, where the kernel is on the path, the
    ``"torch"`` one: the prefill's last logits, its whole cache (KV
    caches, recurrent states, cross K/V) and every decode step's logits
    within SERVE_TOL. With no kernel on the path (ssm_serving) the two
    backends run the same code, so the ``"torch"`` run is not made;
    ssm_serving holds the chunked-parallel prefill (``xlstm-350m-fast``)
    against the sequential one within SERVE_TOL instead. hybrid_serving
    also holds decode against one forward over prompt and generated
    tokens (:func:`_hybrid_teacher_forcing`: block by block in bf16, end
    to end in f32). Prints prefill tokens/s, decode ms a step and peak
    memory."""
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = FAMILY_SERVING[phase]
    cfg = _serving_config(spec)
    B, S, N, flash = spec["batch"], spec["prompt"], spec["new"], spec["flash"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{phase} {cfg.name}: {_cut_line(spec)}; "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated at the start", flush=True)
    model = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(SERVE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, analytic = sum(p.numel() for p in params.parameters()), cfg.param_count()
    if cfg.family in PARAM_COUNT_REL:
        check(abs(n_params - analytic) <= PARAM_COUNT_REL[cfg.family] * n_params,
              f"{cfg.name}: {n_params} params, the config counts {analytic}")
    tokens, extra = _family_inputs(torch, cfg, B, S)
    engine = Engine(model, params, ServeConfig(max_new_tokens=N, seed=SERVE_SEED))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, stats = engine.generate({"tokens": tokens, **extra})
    wall = time.perf_counter() - t0
    launched, variants = counts(), flash_variants()
    want_variants = {"tensor_core": 0, "cuda_core": 0}
    if spec["variant"]:
        want_variants[spec["variant"]] = flash
    check(launched["flash_attention"] == flash and variants == want_variants,
          f"{phase}: flash_attention launched {launched['flash_attention']} times "
          f"({variants}), expected {flash} ({want_variants})")
    check(all(v == 0 for k, v in launched.items() if k != "flash_attention"),
          f"{phase}: unexpected launches {launched}")
    check(gen.shape == (B, N) and gen.dtype == np.int32 and gen.min() >= 0
          and gen.max() < cfg.vocab_size, f"{phase}: generated tokens {gen}")
    check(stats == {"prefill_len": S, "new_tokens": N}, f"{phase}: stats {stats}")
    print(f"{phase} {cfg.name}: {n_params} params (the config counts {analytic}; "
          f"{cfg.param_dtype}, {cfg.dtype} compute, {cfg.num_layers} layers, random from seed "
          f"{SERVE_SEED}, {init_s:.3f} s to draw); Engine.generate on {B} x {S} prompt tokens "
          f"+ {N} new in {wall:.3f} s; flash_attention launches {launched['flash_attention']} "
          f"(by variant {variants}; counted apart from phase serving's)", flush=True)

    fed = torch.from_numpy(gen).to(DEVICE)
    kern = _teacher_forced(torch, model, params, tokens, fed, extra, snapshot=True)
    check(kern["at_prefill"]["flash_attention"] == flash and
          kern["at_end"]["flash_attention"] == flash,
          f"{phase}: flash_attention launches after prefill / at the end "
          f"{kern['at_prefill']['flash_attention']} / {kern['at_end']['flash_attention']}, "
          f"expected {flash} / {flash} (none in decode)")
    for lg in kern["logits"]:
        check(lg.shape == (B, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
              f"{phase}: logits finite, (B, vocab)")
    ref_line = ("", "")       # the torch backend's prefill and decode walls, where run
    if flash:
        ref = _teacher_forced(torch, build_model(cfg, device=DEVICE, kernel_backend="torch"),
                              params, tokens, fed, extra, snapshot=True)
        check(not any(ref["at_end"].values()),
              f"{phase}: the torch backend launched {ref['at_end']}")
        for lg in ref["logits"]:
            check(lg.shape == (B, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
                  f"{phase}: torch backend logits finite, (B, vocab)")
        check(kern["prefill_cache"].keys() == ref["prefill_cache"].keys(), f"{phase}: cache keys")
        pairs = [("prefill logits", kern["logits"][0], ref["logits"][0])]
        pairs += [(f"cache {k}", kern["prefill_cache"][k], ref["prefill_cache"][k])
                  for k in kern["prefill_cache"]]
        pairs += [(f"decode step {t} logits", kern["logits"][t], ref["logits"][t])
                  for t in range(1, N)]
        rel = _hold(torch, phase, pairs)
        ref_tokens = torch.stack([lg.argmax(-1) for lg in ref["logits"]], 1).cpu().numpy()
        print(f"{phase} vs the torch backend (max abs err / max|ref|, share of the allowance): "
              f"{_rel_line(rel)} (tol {SERVE_TOL}); greedy tokens agreeing with the torch "
              f"backend {float((ref_tokens == gen).mean()):.4f}", flush=True)
        ref_line = (f" (torch backend {ref['prefill_s']:.4f} s)",
                    f" (torch backend {np.mean(ref['step_s']) * 1e3:.3f} ms)")
        del ref
    steps = kern["step_s"]
    step = float(np.mean(steps))
    extra_line = ""
    if cfg.ssm is not None:
        extra_line = _hybrid_teacher_forcing(torch, cfg, params, tokens, fed, kern)
    if cfg.xlstm is not None:
        extra_line = _ssm_chunked(torch, cfg, params, tokens, kern)
    if phase == "vlm_serving":
        _vlm_buffered(torch, cfg, model, params, kern["prefill_cache"], fed)
    peak = torch.cuda.max_memory_allocated()
    print(f"{phase} {cfg.name} on {_card()}: prefill {kern['prefill_s']:.4f} s wall, "
          f"{B * S / kern['prefill_s']:.1f} prefill tokens/s{ref_line[0]}; decode "
          f"{step * 1e3:.3f} ms wall per step (min {min(steps) * 1e3:.3f}, max "
          f"{max(steps) * 1e3:.3f} over {len(steps)} steps), {B / step:.1f} decode "
          f"tokens/s{ref_line[1]}; peak device memory {peak / 2**30:.3f} GiB" + extra_line,
          flush=True)
    del params, kern, engine, model
    torch.cuda.empty_cache()
    return launched


def _worst(rel):
    return max(e for e, _ in rel.values()), max(u for _, u in rel.values())


def _padded_sequence(torch, cfg, tokens, fed):
    """The prompt and the fed tokens, padded with zeros to a multiple of the
    SSD chunk (the model is causal, so the padding moves no earlier
    position)."""
    N = fed.shape[1]
    seq = torch.cat([tokens, fed[:, :N - 1]], 1)
    return torch.nn.functional.pad(seq, (0, -seq.shape[1] % cfg.ssm.chunk))


def _hybrid_teacher_forcing(torch, cfg, params, tokens, fed, kern):
    """zamba's prefill and decode logits against one forward over the
    prompt and the fed tokens (tests/test_models.py:62's identity). In
    bfloat16 through 54 layers the decode form (a recurrence a token) and
    the forward (the chunked SSD) part by more than SERVE_TOL's allowance,
    so, as phase moe_serving does: (1) in bfloat16 each block given the
    forward's input to it, (2) the whole model in float32 compute, both
    within SERVE_TOL; the bfloat16 end-to-end gap printed."""
    import dataclasses
    from repro_torch.models import build_model, zamba
    S, N = tokens.shape[1], fed.shape[1]
    seq = _padded_sequence(torch, cfg, tokens, fed)
    with torch.no_grad():
        full, _, _ = zamba.zamba_forward(cfg, params, seq)
    bf16_gap = _gap((kern["logits"][t], full[:, S - 1 + t]) for t in range(N))
    del full
    blocks = _hybrid_blocks(torch, cfg, params, seq, S, N)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    k32 = _teacher_forced(torch, build_model(cfg32, device=DEVICE), params, tokens, fed)
    with torch.no_grad():
        full32, _, _ = zamba.zamba_forward(cfg32, params, seq)
    rel32 = _hold(torch, "hybrid_serving float32 vs the forward",
                  [(f"position {S - 1 + t}", k32["logits"][t], full32[:, S - 1 + t])
                   for t in range(N)])
    del full32, k32
    return ("; prefill and decode logits vs one forward over "
            f"{seq.shape[1]} tokens (unchecked in bf16) {bf16_gap[0]:.4g} / {bf16_gap[1]:.4g}; "
            "bf16 block by block (the forward's input; decode form vs the forward) "
            + ", ".join(f"{k} {v[0]:.4g} / {v[1]:.4g}" for k, v in blocks.items())
            + f"; float32 end to end {_worst(rel32)[0]:.4g} / {_worst(rel32)[1]:.4g}")


def _hybrid_blocks(torch, cfg, params, seq, S, N):
    """bfloat16, block by block along one forward over ``seq``: each
    Mamba2 layer's update at positions S - 1 .. S + N - 2 in decode form (a
    prefill over the first S positions, then single steps) against the
    forward's (all positions at once), and each shared attention block's
    (the prefill's kernel attention, then ``decode_attend`` over a KV
    cache) likewise, every block given the forward's input to it; within
    SERVE_TOL. Returns {"mamba layers", "shared attention": worst (rel
    err, share of the allowance)}."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as Lyr
    from repro_torch.models import mamba2, zamba
    B = seq.shape[0]
    positions = torch.arange(seq.shape[1], dtype=torch.int32, device=seq.device).expand(seq.shape)
    sa, per = params.shared_attn, cfg.attn_every
    window = slice(S - 1, S + N - 1)
    mamba_pairs, attn_pairs = [], []
    with torch.no_grad():
        x = Lyr.embed_tokens(cfg, params.embed, seq)
        for g in range(zamba.n_groups(cfg)):
            for i in range(g * per, (g + 1) * per):
                lp = params.mamba_layers[i]
                h = Lyr.apply_norm(cfg, lp.norm, x)
                full, _ = mamba2.apply_mamba2(cfg, lp.mixer, h)
                out, st = mamba2.apply_mamba2(cfg, lp.mixer, h[:, :S])
                steps = [out[:, S - 1:S]]
                for p in range(S, S + N - 1):
                    out, st = mamba2.apply_mamba2(cfg, lp.mixer, h[:, p:p + 1], st,
                                                  single_step=True)
                    steps.append(out)
                mamba_pairs.append((f"mamba layer {i}", torch.cat(steps, 1), full[:, window]))
                x = x + full
            h = Lyr.apply_norm(cfg, sa.norm1, x)
            q, k, v = A.qkv_proj(cfg, sa.attn, h)
            q, k = Lyr.apply_rope(cfg, q, positions), Lyr.apply_rope(cfg, k, positions)
            full = A.out_proj(cfg, sa.attn, A.attend(cfg, q, k, v, causal=True))
            kc = k.new_zeros((B, S + N) + tuple(k.shape[2:]))
            vc = torch.zeros_like(kc)
            A.cache_update(kc, vc, k[:, :S], v[:, :S], 0)
            outs = [A.attend(cfg, q[:, :S], k[:, :S], v[:, :S], causal=True)[:, S - 1:S]]
            for p in range(S, S + N - 1):
                A.cache_update(kc, vc, k[:, p:p + 1], v[:, p:p + 1], p)
                outs.append(A.decode_attend(cfg, q[:, p:p + 1], kc, vc, p + 1))
            dec = A.out_proj(cfg, sa.attn, torch.cat(outs, 1))
            attn_pairs.append((f"shared attention after group {g}", dec, full[:, window]))
            x = zamba._shared_mlp(cfg, sa, x + full)
    out = {}
    for kind, pairs in (("mamba layers", mamba_pairs), ("shared attention", attn_pairs)):
        out[kind] = _worst(_hold(torch, "hybrid_serving block by block (bf16)", pairs))
    return out


def _ssm_chunked(torch, cfg, params, tokens, kern):
    """xlstm-350m-fast (the chunked-parallel mLSTM) prefill against the
    sequential one: last logits and every pair's state within SERVE_TOL
    (tests/test_mamba_xlstm.py:102's identity on the whole model)."""
    import dataclasses
    from repro_torch.models import build_model
    fast = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, parallel_mlstm=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = build_model(fast, device=DEVICE).prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    leaves = _tree_leaves(state, tokens.shape[1])
    pairs = [("prefill logits", logits.float(), kern["logits"][0])]
    pairs += [(f"state {k}", leaves[k], kern["prefill_cache"][k]) for k in kern["prefill_cache"]]
    rel = _hold(torch, "ssm_serving chunked vs sequential", pairs)
    worst = (max(e for e, _ in rel.values()), max(u for _, u in rel.values()))
    return (f"; chunked-parallel mLSTM prefill (chunk {cfg.xlstm.chunk}) {fast_s:.4f} s, "
            f"{tokens.numel() / fast_s:.1f} tokens/s, vs the sequential one {worst[0]:.4g} / "
            f"{worst[1]:.4g} (logits and states)")


# --------------------------------------------------------------------------
# phase 7g: training granite-moe-1b-a400m
# --------------------------------------------------------------------------

def _train_flops(cfg, B, S, experts):
    """Matmul FLOPs of one train step as the port runs it: the layers'
    forward 4 times (forward, recompute under the per-layer checkpoint,
    and the backward's two products) and the unembedding's 3 times; the
    attention as the torch path computes it (every query against every key,
    chunked), ``experts`` expert FFNs a token (all of them as moe_dense
    computes, or top_k as routed)."""
    d, m = cfg.d_model, cfg.moe
    proj = 2 * d * (2 * cfg.q_dim + 2 * cfg.kv_dim)
    scores = 4 * S * cfg.q_dim
    ffn = experts * 3 * 2 * d * m.d_ff + 2 * d * m.num_experts + 2 * m.num_experts * d
    layer = proj + scores + ffn
    return B * S * (4 * cfg.num_layers * layer + 3 * 2 * d * cfg.vocab_size)


def _reference_layout(cfg, named):
    """``{port name: tensor}`` -> the reference's nested tree of numpy
    arrays with the layers stacked (the input of train_state_from_numpy)."""
    tree, layers = {}, {}
    for name, t in named.items():
        a = t.detach().cpu().numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(rest, [None] * cfg.num_layers)[int(i)] = a
            continue
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    for rest, per in layers.items():
        node = tree.setdefault("layers", {})
        *path, leaf = rest.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(per)
    return tree


def _train_full_width(torch):
    """(a): TRAIN_WARMUP + TRAIN_TIMED adamw steps at full width through
    build_train_step, then TRAIN_Q8_STEPS with adamw_q8."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, state_bytes
    from repro_torch.train.steps import build_train_step, init_train_state
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=DEVICE)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    opt = AdamWConfig(**TRAIN_OPT)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, SERVE_SEED)
    names = [n for n, _ in state["params"].named_parameters()]
    step = build_train_step(model, opt)
    reset_counts()
    losses, walls = [], []
    n = TRAIN_WARMUP + TRAIN_TIMED
    for i in range(n):
        batch = data.batch(i, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    launched = counts()
    check(not any(launched.values()), f"a train step launched hand-written kernels: {launched}")
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"the loss did not fall: first 3 {losses[:3]}, last 3 {losses[-3:]}")
    silent = [k for k in names if float(state["opt"]["mu"][k].abs().max()) == 0.0]
    check(not silent, f"parameters that got no gradient: {silent}")
    peak = torch.cuda.max_memory_allocated()
    timed = walls[TRAIN_WARMUP:]
    step_s = float(np.mean(timed))
    flops_all = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ, cfg.moe.num_experts)
    flops_routed = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ, cfg.moe.top_k)
    batch = data.batch(n, DEVICE)
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    events = _raw_device_events(prof)
    busy = sum(e - s for _, s, e in events) / 1e9
    by_name = {}
    for name, s0, s1 in events:
        by_name[name] = by_name.get(name, 0) + s1 - s0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TRAIN_TOP_KERNELS]
    split = _train_split(torch, model, state, data.batch(n + 1, DEVICE), opt)
    print(f"train {cfg.name} (full width, {cfg.num_layers} layers, adamw f32 moments, "
          f"B {TRAIN_BATCH} x S {TRAIN_SEQ}, {opt}): losses {[round(x, 4) for x in losses]}; "
          f"{TRAIN_TIMED} timed steps {step_s * 1e3:.1f} ms a step (min {min(timed) * 1e3:.1f}, "
          f"max {max(timed) * 1e3:.1f}) = {tokens / step_s:.1f} tokens/s; peak memory "
          f"{peak} B ({peak / 2**30:.2f} GiB); hand-written launches {launched}", flush=True)
    print(f"train FLOPs a step (matmuls, with the per-layer recompute): all "
          f"{cfg.moe.num_experts} experts as computed {flops_all:.4e} = "
          f"{flops_all / step_s / 1e12:.1f} TFLOP/s = {flops_all / step_s / BF16_FLOPS:.2%} of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; top-{cfg.moe.top_k} as routed "
          f"{flops_routed:.4e} = {flops_routed / step_s / 1e12:.1f} TFLOP/s = "
          f"{flops_routed / step_s / BF16_FLOPS:.2%}; profiled step {p_wall * 1e3:.1f} ms wall, "
          f"device busy {busy * 1e3:.1f} ms ({busy / p_wall:.2%}), {len(events)} device kernels",
          flush=True)
    print(f"train step split (CUDA events, one step): forward and loss {split[0]:.1f} ms, "
          f"backward (with the recompute) {split[1]:.1f} ms, AdamW update {split[2]:.1f} ms; "
          f"the profiled step's largest kernels by device time: " +
          "; ".join(f"{name[:70]} {t / 1e6:.1f} ms ({t / 1e9 / busy:.1%})" for name, t in top),
          flush=True)
    f32_bytes = state_bytes(state["opt"])
    del state, metrics, batch, prof, events
    torch.cuda.empty_cache()
    state = init_train_state(model, SERVE_SEED, optimizer="adamw_q8")
    step = build_train_step(model, opt, optimizer="adamw_q8")
    q8_losses = []
    for i in range(TRAIN_Q8_STEPS):
        state, metrics = step(state, data.batch(i, DEVICE))
        q8_losses.append(float(metrics["loss"]))
    check(all(np.isfinite(q8_losses)), f"adamw_q8 losses {q8_losses}")
    q8_bytes = state_bytes(state["opt"])
    print(f"train adamw_q8: losses {[round(x, 4) for x in q8_losses]}; optimizer state "
          f"{q8_bytes} B ({q8_bytes / 2**30:.2f} GiB) against f32's {f32_bytes} B "
          f"({f32_bytes / 2**30:.2f} GiB)", flush=True)
    del state, metrics
    torch.cuda.empty_cache()
    return dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s, peak=peak,
                busy=busy / p_wall, flops_all=flops_all, flops_routed=flops_routed,
                split_ms=split)


def _train_split(torch, model, state, batch, opt):
    """Device ms of one train step's three parts, by CUDA events around
    them: the forward and the loss, the backward (``torch.autograd.grad``,
    the per-layer recompute included), the AdamW update (which it applies
    to ``state``)."""
    from repro_torch.optim.adamw import adamw_update
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss, _ = model.loss(params, batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    state["params"], state["opt"], _ = adamw_update(opt, dict(zip(names, grads)), params,
                                                    state["opt"])
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def _train_restart(torch):
    """(b): the Trainer, async checkpoints every RESTART_EVERY of
    RESTART_STEPS steps at published widths cut to RESTART_LAYERS layers:
    crash after RESTART_EVERY steps, restore, resume; the resumed losses
    equal the uninterrupted run's within RESTART_TOL."""
    import dataclasses
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import build_train_step, init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=RESTART_LAYERS)
    model = build_model(cfg, device=DEVICE)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    opt = AdamWConfig(**dict(TRAIN_OPT, total_steps=RESTART_STEPS))

    def trainer(directory, total):
        return Trainer(TrainerConfig(total_steps=total, checkpoint_every=RESTART_EVERY,
                                     checkpoint_dir=directory, async_checkpoint=True),
                       build_train_step(model, opt), init_train_state(model, SERVE_SEED), None)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = trainer(f"{tmp}/full", RESTART_STEPS)
        full.data_iter = (data.batch(i, DEVICE) for i in range(RESTART_STEPS))
        full_losses = full.run().losses
        full_s = time.perf_counter() - t0
        del full
        crashed = trainer(f"{tmp}/run", RESTART_STEPS)
        crashed.cfg.total_steps = RESTART_EVERY
        crashed.data_iter = (data.batch(i, DEVICE) for i in range(RESTART_STEPS))
        crashed.run()
        del crashed
        resumed = trainer(f"{tmp}/run", RESTART_STEPS)
        start = resumed.maybe_restore()
        check(start == RESTART_EVERY, f"restored step {start}, expected {RESTART_EVERY}")
        resumed.data_iter = (data.batch(i, DEVICE) for i in range(start, RESTART_STEPS))
        resumed_losses = resumed.run().losses
        ckpt = sum(f.stat().st_size for f in Path(f"{tmp}/run").rglob("*") if f.is_file())
        del resumed
    torch.cuda.empty_cache()
    check(np.allclose(resumed_losses, full_losses[RESTART_EVERY:], **RESTART_TOL),
          f"resumed losses {resumed_losses} vs uninterrupted {full_losses[RESTART_EVERY:]}")
    diff = float(np.max(np.abs(np.asarray(resumed_losses) -
                               np.asarray(full_losses[RESTART_EVERY:]))))
    print(f"train restart ({cfg.name} cut to {RESTART_LAYERS} layers, {cfg.param_count()} "
          f"params, async checkpoint every {RESTART_EVERY} of {RESTART_STEPS} steps): "
          f"uninterrupted {[round(x, 5) for x in full_losses]} in {full_s:.3f} s; resumed from "
          f"step {start} {[round(x, 5) for x in resumed_losses]}, largest difference {diff:.3g} "
          f"(tol {RESTART_TOL}); the last checkpoint held {ckpt} B on disk", flush=True)


def _train_card_vs_cpu(torch):
    """(c): one adamw step of the smoke config in float32 (TF32 off) from
    the same train_state_from_numpy state (random moments at step
    CARD_CPU_STEP) on the card and on the CPU: loss, grad norm, every new
    param and moment within CARD_CPU_TOL."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import build_train_step, init_train_state, train_state_from_numpy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN_ARCH + "-smoke"), dtype="float32")
    cpu_model = build_model(cfg, device="cpu")
    init = init_train_state(cpu_model, SERVE_SEED)
    rng = np.random.default_rng(SERVE_SEED)
    named = dict(init["params"].named_parameters())
    moments = {m: {k: torch.from_numpy((rng.standard_normal(tuple(p.shape)) * 1e-3
                                        if m == "mu" else rng.random(tuple(p.shape)) * 1e-5)
                                       .astype(np.float32)) for k, p in named.items()}
               for m in ("mu", "nu")}
    tree = {"params": _reference_layout(cfg, named),
            "opt": {m: _reference_layout(cfg, moments[m]) for m in moments} |
            {"step": np.asarray(CARD_CPU_STEP, np.int32)}}
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
                        )._batch_np(0)
    out = {}
    for dev in ("cpu", DEVICE):
        model = build_model(cfg, device=dev)
        state = train_state_from_numpy(cfg, tree, "adamw", dev)
        step = build_train_step(model, AdamWConfig(**TRAIN_OPT))
        state, metrics = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[dev] = (state, metrics)
    (cs, cm), (gs, gm) = out["cpu"], out[DEVICE]
    worst = {}
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        a, b = float(gm[k]), float(cm[k])
        check(np.isclose(a, b, rtol=CARD_CPU_TOL["metric_rtol"], atol=1e-7),
              f"card vs CPU train step {k}: {a} vs {b}")
        worst[k] = abs(a - b) / max(abs(b), 1e-30)
    lr = float(cm["lr"])
    p_err = m_err = 0.0
    for name, p in cs["params"].named_parameters():
        g = dict(gs["params"].named_parameters())[name].detach().cpu()
        d = (g - p.detach()).abs()
        check(float(d.max()) <= 2 * lr, f"card vs CPU param {name}: {float(d.max())} > 2 lr")
        share = float((d > CARD_CPU_TOL["param_atol"]).float().mean())
        check(share <= CARD_CPU_TOL["param_share"],
              f"card vs CPU param {name}: {share:.4f} of the elements off by more than "
              f"{CARD_CPU_TOL['param_atol']}")
        p_err = max(p_err, float(d.max()))
        for moment in ("mu", "nu"):
            a, b = gs["opt"][moment][name].cpu(), cs["opt"][moment][name]
            scale = float(b.abs().max())
            check(torch.allclose(a, b, rtol=CARD_CPU_TOL["moment_rtol"],
                                 atol=CARD_CPU_TOL["moment_rtol"] * scale),
                  f"card vs CPU {moment} {name}: {float((a - b).abs().max())} (max|cpu| {scale})")
            m_err = max(m_err, float((a - b).abs().max()) / max(scale, 1e-30))
    print(f"train card vs CPU ({cfg.name}, float32, TF32 off, one adamw step from step "
          f"{CARD_CPU_STEP} with random moments): relative differences "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }, params max abs "
          f"{p_err:.3g} (lr {lr:.3g}), moments max abs / max|cpu| {m_err:.3g}; tol "
          f"{CARD_CPU_TOL}", flush=True)


def _train_guard(torch):
    """(d): the CUDA flash_attention wrapper refuses inputs that require
    grad, before any launch."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = (torch.randn((1, 128, 4, 64), device=DEVICE, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    before = flash_attention.launches
    try:
        flash_attention(q, k, v, causal=True)
    except RuntimeError as e:
        check("no backward" in str(e), f"flash_attention raised {e}")
    else:
        check(False, "flash_attention took CUDA inputs that require grad")
    check(flash_attention.launches == before, "the refused call launched")
    with torch.no_grad():
        flash_attention(q, k, v, causal=True)
    check(flash_attention.launches == before + 1, "flash_attention under no_grad did not launch")
    print("train guard: flash_attention on CUDA inputs that require grad raises (no launch); "
          "under no_grad it launches", flush=True)


def train_path(torch):
    out = _train_full_width(torch)
    _train_restart(torch)
    _train_card_vs_cpu(torch)
    _train_guard(torch)
    return out


# --------------------------------------------------------------------------
# phase 7h: parallel/ on a one-rank NCCL group
# --------------------------------------------------------------------------

# granite-moe-1b-a400m at its published widths (src/repro/configs/granite_moe_1b_a400m.py)
PARALLEL_ARCH = "granite-moe-1b-a400m"
PARALLEL_LAYER = (4, 2048)        # (a) one MoE layer's batch and sequence
PARALLEL_LAYER_REPEATS = 20       # timed calls of each layer
PARALLEL_LAYER_PROFILED, PARALLEL_LAYER_TOP = 5, 6   # profiled calls, kernels printed
PARALLEL_TRAIN_WARMUP, PARALLEL_TRAIN_STEPS = 1, 3       # (b) at TRAIN_BATCH x TRAIN_SEQ
PARALLEL_PREFILL = (2, 2048)      # (c) the prefill's batch and prompt
PARALLEL_PREFILL_REPEATS = 3
# (b) the launcher itself on the smoke config, a few steps on the card
PARALLEL_LAUNCHER = ["--arch", "granite-moe-1b-a400m-smoke", "--steps", "3", "--batch", "4",
                     "--seq", "64", "--checkpoint-every", "100"]
PIPELINE_MICROBATCHES = 4         # (d) one-stage pipeline over (M, 2, d_model)
EF_ELEMENTS = 1 << 20             # (d) ef_compress_allreduce's gradient


def _no_drop(ctx, cfg):
    """``ctx`` at the capacity factor E / k, which makes every expert's
    capacity the whole chunk: no slot can drop."""
    import dataclasses
    return dataclasses.replace(ctx, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)


def _dispatch_line(rec, layers):
    """Slots dropped per layer (the first ``layers`` records of one
    forward), their total, and the expert rows computed a layer."""
    per = [int(r["dropped"]) for r in rec[:layers]]
    return per, sum(per), rec[0]["slots"], rec[0]["experts_rows"], rec[0]["capacity"]


def _parallel_layer(torch, cfg, ctx):
    """(a) One MoE layer at PARALLEL_LAYER in the compute type: moe_sharded
    at a no-drop capacity against moe_dense within SERVE_TOL (the same
    input routes alike); at the context's 1.25 the slots dropped and the
    expert rows computed; both layers' ms by CUDA events."""
    from repro_torch.models import layers as Lyr
    from repro_torch.models import moe
    B, S = PARALLEL_LAYER
    gen = torch.Generator(device=DEVICE).manual_seed(SERVE_SEED)
    p = moe.init_moe(gen, cfg, DEVICE)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=DEVICE).to(Lyr.torch_dtype(cfg.dtype))
    with torch.no_grad():
        dense, _ = moe.moe_dense(cfg, p, x)
        with moe.dispatch_record() as rec:
            nodrop, _ = moe.moe_apply(cfg, p, x, parallel=_no_drop(ctx, cfg))
        check(sum(int(r["dropped"]) for r in rec) == 0, "dropped slots at E / k capacity")
        rel = _within(torch, nodrop, dense, "moe_sharded at a no-drop capacity vs moe_dense "
                      "(one layer)")
        with moe.dispatch_record() as rec:
            y, _ = moe.moe_apply(cfg, p, x, parallel=ctx)
        check(bool(torch.isfinite(y).all()) and y.shape == x.shape, "moe_sharded output")
        _, dropped, slots, rows, cap = _dispatch_line(rec, 1)
        reset_counts()
        sharded_ms = _time(torch, lambda: moe.moe_apply(cfg, p, x, parallel=ctx),
                           PARALLEL_LAYER_REPEATS)
        dense_ms = _time(torch, lambda: moe.moe_dense(cfg, p, x), PARALLEL_LAYER_REPEATS)
        launched = counts()
        with _profiled(torch) as prof:
            for _ in range(PARALLEL_LAYER_PROFILED):
                moe.moe_apply(cfg, p, x, parallel=ctx)
            torch.cuda.synchronize()
    check(not any(launched.values()), f"the MoE layer launched {launched}")
    by = {}
    for name, t0, t1 in _raw_device_events(prof):
        by[name] = by.get(name, 0) + (t1 - t0) / 1e6 / PARALLEL_LAYER_PROFILED
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:PARALLEL_LAYER_TOP]
    nccl = sum(t for name, t in by.items() if "nccl" in name.lower())
    dense_rows = B * S * cfg.moe.num_experts
    print(f"parallel (a) one MoE layer of {cfg.name} at {B} x {S} tokens ({cfg.dtype}): "
          f"moe_sharded at capacity factor {cfg.moe.num_experts / cfg.moe.top_k:g} (none "
          f"dropped) vs moe_dense {rel[0]:.4g} max abs err / max|ref|, share of the "
          f"allowance {rel[1]:.4g}; at {ctx.capacity_factor}: capacity {cap}, {dropped} of "
          f"{slots} (token, choice) slots dropped, {rows} expert rows computed (E x C) "
          f"against moe_dense's {dense_rows}; {sharded_ms:.3f} ms a layer against "
          f"moe_dense's {dense_ms:.3f} ms (CUDA events, {PARALLEL_LAYER_REPEATS} calls); "
          f"moe_sharded's device time {busy:.3f} ms a call over {PARALLEL_LAYER_PROFILED} "
          f"profiled calls, NCCL kernels {nccl:.3f} ms, largest: " +
          "; ".join(f"{name[:60]} {t:.3f} ms" for name, t in top), flush=True)
    del p, x, dense, nodrop, y
    return dict(sharded_ms=sharded_ms, dense_ms=dense_ms, dropped=dropped, rows=rows)


def _parallel_train(torch, cfg, ctx, dense):
    """(b) PARALLEL_TRAIN_STEPS AdamW steps at TRAIN_BATCH x TRAIN_SEQ
    through build_train_step on a model built with the context (the
    launcher's path): losses finite, no hand-written kernel; step ms,
    tokens/s and peak memory beside phase train's dense step; the slots
    dropped per layer at step 0; then ``launch.train.main`` itself on the
    smoke config."""
    import tempfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model, moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import build_train_step, init_train_state
    model = build_model(cfg, ctx, device=DEVICE)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, SERVE_SEED)
    step = build_train_step(model, AdamWConfig(**TRAIN_OPT))
    reset_counts()
    losses, walls = [], []
    for i in range(PARALLEL_TRAIN_WARMUP + PARALLEL_TRAIN_STEPS):
        batch = data.batch(i, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe.dispatch_record() as rec:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
        if i == 0:
            per, dropped, slots, rows, cap = _dispatch_line(rec, cfg.num_layers)
    launched = counts()
    check(not any(launched.values()), f"a train step launched hand-written kernels: {launched}")
    check(all(np.isfinite(losses)), f"train losses {losses}")
    step_s = float(np.mean(walls[PARALLEL_TRAIN_WARMUP:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"parallel (b) train {cfg.name} through build_train_step on a model built with "
          f"single_device_context: losses {[round(v, 4) for v in losses]}; "
          f"{step_s * 1e3:.1f} ms a step ({PARALLEL_TRAIN_STEPS} after "
          f"{PARALLEL_TRAIN_WARMUP} warm-up), {tokens / step_s:.1f} tokens/s, peak "
          f"{peak:.2f} GiB; phase train's moe_dense step in this run {dense['step_ms']:.1f} "
          f"ms, {dense['tokens_s']:.1f} tokens/s, peak {dense['peak'] / 2**30:.2f} GiB; step 0's "
          f"dispatch: capacity {cap}, {dropped} of {slots * cfg.num_layers} slots dropped "
          f"(by layer {per}), {rows} expert rows a layer", flush=True)
    del state, metrics, model, step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        report = launch_train.main(PARALLEL_LAUNCHER + ["--device", DEVICE, "--ckpt-dir", tmp])
    check(report.steps == 3 and all(np.isfinite(report.losses)),
          f"launch.train on the card: {report.steps} steps, losses {report.losses}")
    return dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s, peak=peak, dropped=dropped)


def _parallel_prefill(torch, cfg, ctx):
    """(c) Engine.generate on a model built with the context at
    PARALLEL_PREFILL (one tensor-core flash_attention launch a layer,
    counted apart); prefill tokens/s beside the context-free model's; the
    slots dropped a layer at 1.25; held: in float32 compute at a no-drop
    capacity against the context-free prefill with the routing pinned,
    the last logits and the K/V cache within SERVE_TOL (the bfloat16 gap
    printed: the MoE combine rounds differently, and routing is a
    discontinuity, see moe_serving)."""
    import dataclasses
    from repro_torch.models import build_model, moe
    from repro_torch.serve.engine import Engine, ServeConfig
    B, S = PARALLEL_PREFILL
    model = build_model(cfg, ctx, device=DEVICE)
    plain = build_model(cfg, device=DEVICE)
    params = model.init(SERVE_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(SERVE_SEED + 2)).to(DEVICE)
    engine = Engine(model, params, ServeConfig(max_new_tokens=MOE_SERVE_NEW, seed=SERVE_SEED))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, stats = engine.generate({"tokens": tokens})
    wall = time.perf_counter() - t0
    launched, variants = counts(), flash_variants()
    L = cfg.num_layers
    check(launched["flash_attention"] == L and variants == {"tensor_core": L, "cuda_core": 0},
          f"parallel prefill: flash_attention {launched['flash_attention']} ({variants}), "
          f"expected {L} tensor_core")
    check(not any(v for k, v in launched.items() if k != "flash_attention"),
          f"unexpected launches on the parallel serving path: {launched}")
    check(gen.shape == (B, MOE_SERVE_NEW) and gen.min() >= 0 and gen.max() < cfg.vocab_size,
          f"generated tokens {gen}")
    walls = {}
    for name, m in (("ctx", model), ("plain", plain)):
        w = []
        for _ in range(PARALLEL_PREFILL_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with moe.dispatch_record() as rec:
                m.prefill(params, {"tokens": tokens})
                torch.cuda.synchronize()
            w.append(time.perf_counter() - t0)
            if name == "ctx":
                per, dropped, slots, rows, cap = _dispatch_line(rec, L)
        walls[name] = float(np.median(w))
    with torch.no_grad(), _routing_recorded(torch) as routes:
        bf_ctx = build_model(cfg, _no_drop(ctx, cfg), device=DEVICE).prefill(
            params, {"tokens": tokens})
    with torch.no_grad(), _routing_recorded(torch, pinned=routes):
        bf_plain = plain.prefill(params, {"tokens": tokens})
    bf_gap = _gap([(bf_ctx[0], bf_plain[0])] + [(bf_ctx[1][k], bf_plain[1][k])
                                                for k in ("k", "v")])
    del bf_ctx, bf_plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad(), _routing_recorded(torch) as routes32:
        got = build_model(cfg32, _no_drop(ctx, cfg32), device=DEVICE).prefill(
            params, {"tokens": tokens})
    with torch.no_grad(), _routing_recorded(torch, pinned=routes32):
        want = build_model(cfg32, device=DEVICE).prefill(params, {"tokens": tokens})
    rel = {"logits": _within(torch, got[0], want[0], "parallel f32 prefill logits")}
    for k in ("k", "v"):
        rel[f"{k} cache"] = _within(torch, got[1][k], want[1][k], f"parallel f32 {k} cache")
    print(f"parallel (c) {cfg.name} served with single_device_context: Engine.generate on "
          f"{B} x {S} + {MOE_SERVE_NEW} new in {wall:.3f} s; flash_attention launches "
          f"{launched['flash_attention']} (by variant {variants}; counted apart); prefill "
          f"{walls['ctx']:.4f} s = {B * S / walls['ctx']:.1f} tokens/s (median of "
          f"{PARALLEL_PREFILL_REPEATS}), the context-free model (moe_dense) {walls['plain']:.4f} "
          f"s = {B * S / walls['plain']:.1f} tokens/s; at {ctx.capacity_factor}: capacity "
          f"{cap}, {dropped} of {slots * L} slots dropped (by layer {per}); held in float32 "
          f"at a no-drop capacity against the context-free prefill, routing pinned: "
          + ", ".join(f"{k} {v[0]:.4g} / {v[1]:.4g}" for k, v in rel.items()) +
          f" (max abs err / max|ref|, share of the allowance; tol {SERVE_TOL}); unchecked, "
          f"the same in bfloat16: {bf_gap[0]:.4g} / {bf_gap[1]:.4g}",
          flush=True)
    with torch.no_grad():
        logits = model.prefill(params, {"tokens": tokens})[0]
    del params, engine, model, plain, got, want
    torch.cuda.empty_cache()
    return launched, dict(prefill_s=walls["ctx"], plain_s=walls["plain"], dropped=dropped,
                          tokens=tokens, logits=logits)


def _parallel_sharded(torch, cfg, ctx, prefill, train):
    """(e) The model's sharded run on the context's one-rank DeviceMesh:
    the parameters from ``Model.shard`` (DTensors placed by the
    reference's ``param_shardings``), the tokens of (c) distributed by
    ``batch_placements``: the prefill at PARALLEL_PREFILL launches the
    hand-written tensor-core ``flash_attention`` once a layer on each
    rank's heads (counted apart; no plain version runs), its last logits
    within SERVE_TOL of (c)'s (the max difference printed), tokens/s beside
    (c)'s; then one warm-up and one timed AdamW step of (b) on the sharded
    model. Returns its launches and seconds."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import batch_placements
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import distribute, is_dtensor
    from repro_torch.train.steps import build_train_step, init_opt_state
    t_start = time.perf_counter()
    B, S = PARALLEL_PREFILL
    model = build_model(cfg, ctx, device=DEVICE)
    params = model.shard(model.init(SERVE_SEED))
    check(all(is_dtensor(p) for p in params.parameters()), "Model.shard left plain parameters")
    batch = distribute({"tokens": prefill["tokens"]},
                       batch_placements(ctx, {"tokens": prefill["tokens"]}), ctx, DEVICE)
    walls = []
    for i in range(PARALLEL_PREFILL_REPEATS):
        if i == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launched, variants = counts(), flash_variants()
    L = cfg.num_layers
    check(launched["flash_attention"] == L and variants == {"tensor_core": L, "cuda_core": 0},
          f"sharded prefill: flash_attention {launched['flash_attention']} ({variants}), "
          f"expected {L} tensor_core")
    check(not any(v for k, v in launched.items() if k != "flash_attention"),
          f"unexpected launches on the sharded prefill: {launched}")
    check(is_dtensor(logits) and is_dtensor(cache["k"]), "the sharded prefill's outputs")
    got = logits.full_tensor()
    check(bool(torch.isfinite(got).all()) and got.shape == (B, cfg.vocab_size),
          "sharded prefill logits finite, (B, vocab)")
    rel = _within(torch, got, prefill["logits"], "sharded prefill logits vs (c)")
    diff = float((got.float() - prefill["logits"].float()).abs().max())
    prefill_s = float(np.median(walls))
    prefill_seconds = time.perf_counter() - t_start
    del logits, cache, got, batch
    torch.cuda.empty_cache()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    state = {"params": params, "opt": init_opt_state(params)}
    step = build_train_step(model, AdamWConfig(**TRAIN_OPT))
    reset_counts()
    step_walls, losses = [], []
    for i in range(2):
        raw = data.batch(i, DEVICE)
        batch = distribute(raw, batch_placements(ctx, raw), ctx, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
    check(not any(counts().values()), f"the sharded train step launched {counts()}")
    check(all(np.isfinite(losses)), f"sharded train losses {losses}")
    check(all(is_dtensor(p) for p in state["params"].parameters()),
          "the sharded train step left plain parameters")
    train_seconds = time.perf_counter() - t_start - prefill_seconds
    print(f"parallel (e) {cfg.name} sharded as DTensors on single_device_context's one-rank "
          f"DeviceMesh {tuple(ctx.mesh.shape.items())}: prefill {B} x {S} launched "
          f"flash_attention {launched['flash_attention']} times (by variant {variants}; counted "
          f"apart); its last logits against (c)'s: max abs diff {diff:.6g}, "
          f"{rel[0]:.4g} / {rel[1]:.4g} (max abs err / max|ref|, share of the allowance; tol "
          f"{SERVE_TOL}); {prefill_s:.4f} s = {B * S / prefill_s:.1f} tokens/s (median of "
          f"{PARALLEL_PREFILL_REPEATS}; the first {walls[0]:.4f} s), (c) "
          f"{prefill['prefill_s']:.4f} s = {B * S / prefill['prefill_s']:.1f} tokens/s; one "
          f"AdamW step of (b) at {TRAIN_BATCH} x {TRAIN_SEQ} on the sharded model "
          f"{step_walls[1] * 1e3:.1f} ms (warm-up {step_walls[0] * 1e3:.1f} ms; (b) "
          f"{train['step_ms']:.1f} ms), losses {[round(v, 4) for v in losses]}; prefill "
          f"addition {prefill_seconds:.3f} s, train addition {train_seconds:.3f} s",
          flush=True)
    del state, params, model, step, metrics
    torch.cuda.empty_cache()
    return dict(launched=launched, prefill_s=prefill_s, step_ms=step_walls[1] * 1e3)


def _parallel_collectives(torch, ctx):
    """(d) ef_compress_allreduce and pipeline_forward on the one-rank
    group: out + err == g (tests/test_parallel.py:53-66), the error
    feedback carrying g + err exactly; one stage == layer_fn per
    microbatch."""
    from repro_torch.parallel.compression import ef_compress_allreduce
    from repro_torch.parallel.pipeline import pipeline_forward
    gen = torch.Generator(device=DEVICE).manual_seed(SERVE_SEED)
    g = torch.randn(EF_ELEMENTS, generator=gen, device=DEVICE)
    out, err = ef_compress_allreduce(g, torch.zeros_like(g), ctx.mesh, "data")
    gap = float((out + err - g).abs().max())
    check(gap <= 1e-6 * float(g.abs().max()), f"ef_compress_allreduce: out + err - g {gap}")
    carried = torch.randn(EF_ELEMENTS, generator=gen, device=DEVICE) * 1e-3
    out2, err2 = ef_compress_allreduce(g, carried, ctx.mesh, "data")
    gap2 = float((out2 + err2 - (g + carried)).abs().max())
    check(gap2 <= 1e-6 * float((g + carried).abs().max()), f"error feedback: {gap2}")
    d = 1024
    w = torch.randn(1, d, d, generator=gen, device=DEVICE) / d ** 0.5
    x = torch.randn(PIPELINE_MICROBATCHES, 2, d, generator=gen, device=DEVICE)
    layer = lambda p, h: torch.tanh(h @ p[0])
    got = pipeline_forward(layer, ctx.mesh, "model", 1, PIPELINE_MICROBATCHES)(w, x)
    want = torch.stack([layer(w, xm) for xm in x])
    check(torch.equal(got, want), "one-stage pipeline_forward != layer_fn per microbatch")
    print(f"parallel (d) on the one-rank group: ef_compress_allreduce over {EF_ELEMENTS} "
          f"floats, |out + err - g| {gap:.3g}, with a carried error {gap2:.3g}; a one-stage "
          f"pipeline over {PIPELINE_MICROBATCHES} microbatches equal to layer_fn", flush=True)


def parallel_path(torch, dense):
    """Phase 7h: ``single_device_context("cuda")`` (a one-rank NCCL group)
    and granite-moe-1b-a400m at its published widths: (a) one MoE layer,
    (b) the launcher's train path, (c) a prefill through the Engine, (d)
    the collectives, (e) the sharded run. ``dense`` is phase train's
    result. Returns (c)'s launches and (e)'s result."""
    from repro_torch.configs.registry import get_config
    from repro_torch.parallel import single_device_context
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = single_device_context(DEVICE)
    mesh = ctx.mesh
    backend = torch.distributed.get_backend(mesh.groups["model"])
    check(mesh.shape == {"data": 1, "model": 1} and backend == ("nccl" if DEVICE == "cuda"
                                                                else "gloo"),
          f"single_device_context: mesh {mesh.shape}, backend {backend}")
    print(f"parallel: single_device_context({DEVICE!r}): mesh {mesh.shape} over a one-rank "
          f"{backend} group; use_ep {ctx.use_ep}, capacity_factor {ctx.capacity_factor}, "
          f"moe_token_chunk {ctx.moe_token_chunk}, remat {ctx.remat!r}", flush=True)
    cfg = get_config(PARALLEL_ARCH)
    _parallel_layer(torch, cfg, ctx)
    train = _parallel_train(torch, cfg, ctx, dense)
    launched, prefill = _parallel_prefill(torch, cfg, ctx)
    _parallel_collectives(torch, ctx)
    sharded = _parallel_sharded(torch, cfg, ctx, prefill, train)
    return launched, sharded


# --------------------------------------------------------------------------
# phases 8-9: the simulator's path
# --------------------------------------------------------------------------

def fig08_grid(T, kernel_backend):
    """(donor cfg, stacked params, addrs (72, 1, T), gaps) for the fig08
    quick grid: block size x workload x {base, dram}."""
    from repro_torch.configs.base import FamConfig, fam_replace
    from repro_torch.core.fam_params import FamParams, stack_params
    from repro_torch.experiments import trace_arrays
    from repro_torch.policies import SimFlags
    base = fam_replace(FamConfig(), num_nodes=1, kernel_backend=kernel_backend)
    variants = {"base": SimFlags(core_prefetch=False, dram_prefetch=False),
                "dram": SimFlags()}
    # the executor's trace memo: at T_MAIN it holds JAX's golden inputs
    # (seed_golden_traces), so this grid and phase 12's fig08 share them
    traces = {w: trace_arrays([w], T, 0) for w in QUICK_WORKLOADS}
    params, addrs, gaps, keys = [], [], [], []
    for bs in FIG08_BLOCKS:
        for w in QUICK_WORKLOADS:
            for v, flags in variants.items():
                params.append(FamParams.of(fam_replace(base, block_bytes=bs), flags,
                                           device="cpu"))
                addrs.append(traces[w][0])
                gaps.append(traces[w][1])
                keys.append((bs, w, v))
    donor = fam_replace(base, block_bytes=FIG08_BLOCKS[0])
    return donor, stack_params(params), np.stack(addrs), np.stack(gaps), keys


def run_grid(T, kernel_backend, eager=False):
    """The grid through ``sweep`` (a CUDA graph replayed per window of
    events), or with ``eager`` through the same runner stepping each event
    from the host. Returns (metrics, keys, wall seconds)."""
    import torch
    from repro_torch.core import famsim
    from repro_torch.core.fam_params import tree_map
    donor, p, addrs, gaps, keys = fig08_grid(T, kernel_backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if eager:
        dev = torch.device(DEVICE)
        out = famsim._make_run(donor, 1, eager=True)(
            tree_map(lambda t: t.to(dev), p), torch.as_tensor(addrs, device=dev),
            torch.as_tensor(gaps, device=dev))
    else:
        out = famsim.sweep(donor, p, None, addrs, gaps, device=DEVICE)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    seconds = time.perf_counter() - t0
    return out, keys, seconds


def fig08_rows(out, keys):
    from repro_torch.core.ipc_model import geomean
    idx = {k: i for i, k in enumerate(keys)}
    rows = []
    for bs in FIG08_BLOCKS:
        gains, rels = [], []
        for w in QUICK_WORKLOADS:
            b, d = idx[(bs, w, "base")], idx[(bs, w, "dram")]
            gains.append(float(out["ipc"][d, 0] / max(out["ipc"][b, 0], 1e-9)))
            rels.append(float(out["fam_latency"][d, 0] / max(out["fam_latency"][b, 0], 1e-9)))
        rows.append(f"fig08_block{bs} ipc_gain={geomean(gains):.3f};"
                    f"rel_fam_latency={geomean(rels):.3f}")
    return rows


def main_path(torch):
    from repro_torch.core.famsim import last_graph
    reset_counts()
    out, keys, seconds = run_grid(T_MAIN, "cuda")
    launched = counts()
    launches = launched.pop("fused_cache_step")
    check(launches == T_MAIN, f"kernel launched {launches} times, expected {T_MAIN}")
    check(not any(launched.values()), f"unexpected launches on the fig08 path: {launched}")
    for k, v in out.items():
        check(v.shape == (len(keys), 1) and np.isfinite(v).all(), f"metric {k}")
    for row in fig08_rows(out, keys):
        print(row)
    events = len(keys) * T_MAIN
    print(f"main path: {len(keys)} systems x 1 node x {T_MAIN} events in "
          f"{seconds:.3f} s = {events / seconds:.1f} events/s/device "
          f"({seconds / T_MAIN * 1e3:.3f} ms/step)", flush=True)
    check(last_graph.get("replays") == -(-T_MAIN // last_graph.get("events", 1)),
          f"the main path replayed no graph per window: {last_graph}")
    replay = last_graph["replay_s"]
    print(f"CUDA graph: {last_graph['events']} events per graph, "
          f"{last_graph['replays']} replays, {last_graph['padded']} padded events, "
          f"captured in {last_graph['capture_s']:.3f} s, private pool "
          f"{last_graph['pool_bytes']} B; replays {replay:.3f} s = "
          f"{replay / T_MAIN * 1e3:.4f} ms/event = {events / replay:.1f} "
          f"events/s/device", flush=True)
    return launches, seconds, replay / T_MAIN * 1e3, out


def backends_and_golden(torch):
    from repro_torch.configs.base import FamConfig
    from repro_torch.core.famsim import SimFlags, build_sim
    a, keys, sa = run_grid(T_CHECK, "cuda")
    b, _, sb = run_grid(T_CHECK, "torch")
    c, _, sc = run_grid(T_CHECK, "cuda", eager=True)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"cuda and torch backends differ on {k}")
        check(np.array_equal(a[k], c[k]), f"graphed and eager cuda runs differ on {k}")
    events = len(keys) * T_CHECK
    print(f"graphed cuda, graphed torch and eager cuda bit-identical at T={T_CHECK}: "
          f"cuda graphed {sa:.3f} s = {events / sa:.1f} events/s/device, cuda eager "
          f"{sc:.3f} s = {events / sc:.1f} events/s/device, torch graphed {sb:.3f} s "
          f"= {events / sb:.1f} events/s/device")
    golden = json.loads((ROOT / "src/repro_torch/testdata/famsim_golden.json").read_text())
    # the stored traces, not this machine's numpy draws: the golden values
    # are the JAX reference's on exactly these inputs
    run = build_sim(FamConfig(), SimFlags(), len(golden["workloads"]), device=DEVICE)
    out = run(np.asarray(golden["addrs"], np.int64), np.asarray(golden["gaps"], np.float32))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for k, want in golden["metrics"].items():
        want = np.asarray(want, np.float32)
        if k in golden["counters"]:
            check(np.array_equal(out[k], want), f"golden {k}: {out[k]} != {want}")
        else:
            check(np.allclose(out[k], want, rtol=golden["rtol"], atol=0),
                  f"golden {k}: {out[k]} vs {want}")
    print(f"golden configuration matches at rtol {golden['rtol']}")


def profile_window(torch, table, replay_ms, steps=200, telemetry=0):
    """torch.profiler over a graphed sweep of ``steps`` events of the fig08
    grid (with ``telemetry`` windows when non-zero), after a short sweep of
    the same grid (which loads its kernels): exactly ``steps``
    cache_step_kernel launches; over the replays (from the first to the
    last of those launches) the device kernels per event, their device
    time per event, and that time's share of the profiled span and of
    ``replay_ms``, the main path's unprofiled replay wall per event
    (tracing each kernel slows the replays); with ``table`` the profiler's
    op table. Returns (device kernels per event, device ms per event)."""
    from repro_torch.configs.base import fam_replace
    from repro_torch.core import famsim
    donor, p, addrs, gaps, _ = fig08_grid(steps, "cuda")
    donor = fam_replace(donor, telemetry=telemetry)
    famsim.sweep(donor, p, None, addrs[..., :20], gaps[..., :20], device=DEVICE)
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        famsim.sweep(donor, p, None, addrs, gaps, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(_raw_device_events(prof), key=lambda e: e[1])
    ours = [e for e in kernels if "cache_step_kernel" in e[0]]
    check(len(ours) == steps, f"profiler saw {len(ours)} cache_step_kernel launches "
          f"in a graphed {steps}-event sweep, expected {steps}")
    t_first, t_last = ours[0][1] / 1e3, ours[-1][2] / 1e3          # us
    replayed = [e for e in kernels if e[1] / 1e3 >= t_first and e[2] / 1e3 <= t_last]
    busy = sum(e[2] - e[1] for e in replayed) / 1e3
    busy_ms = busy / (steps - 1) / 1e3
    print(f"profile (telemetry {telemetry}): graphed sweep of {steps} events in "
          f"{wall:.3f} s wall (capture "
          f"included); over the replays {len(replayed) / (steps - 1):.1f} device "
          f"kernels/event, device time {busy_ms:.4f} ms/event = "
          f"{busy / (t_last - t_first):.2%} of the profiled span "
          f"({(t_last - t_first) / (steps - 1) / 1e3:.4f} ms/event) and "
          f"{busy_ms / replay_ms:.2%} of the unprofiled replay wall "
          f"({replay_ms:.4f} ms/event, main path); cache_step_kernel "
          f"{np.mean([(e[2] - e[1]) / 1e3 for e in ours]):.2f} us/launch device "
          f"time over {len(ours)} launches", flush=True)
    if table:
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    return len(replayed) / (steps - 1), busy_ms


def graph_profiles(torch, table, replay_ms):
    """Phase 10: :func:`profile_window` without telemetry and with
    TELEMETRY_WINDOWS windows, one after the other early in the process
    (Kineto loses the first records of windows opened late in a process;
    phase 15 prints the comparison). Returns {windows: (device kernels an
    event, device ms an event)}."""
    return {n: profile_window(torch, table and not n, replay_ms, telemetry=n)
            for n in (0, TELEMETRY_WINDOWS)}


# --------------------------------------------------------------------------
# phases 11-12: device traces and the figure sweeps through the executor
# --------------------------------------------------------------------------

def _digest(x):
    """SHA-256 of an array's values (integers as little-endian int64,
    floats as their float32 bits), as tests/test_torch_trace_device.py
    computes JAX's."""
    import hashlib
    x = np.asarray(x)
    x = x.view(np.int32) if x.dtype == np.float32 else x
    return hashlib.sha256(x.astype("<i8").tobytes()).hexdigest()


def device_traces(torch):
    """The threefry generator on the card against the CPU and JAX's digests."""
    from repro_torch.traces import device as gen
    from repro_torch.traces.specs import WORKLOAD_NAMES
    want = json.loads((ROOT / "src/repro_torch/testdata/trace_digests.json").read_text())
    check((want["T"], want["seed"]) == (TRACE_T, 0), f"digests for {want['T']}, {want['seed']}")
    draws = ("raw", "u", "uni", "starts", "bases", "spans")
    tail_n = tail_diff = 0
    gap_rel, gen_s = 0.0, 0.0
    for name in WORKLOAD_NAMES:
        tp = gen.system_params((name,), 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ga, gg, gp = gen.generate(gen.to_tensors(tp, DEVICE), TRACE_T, parts=True)
        torch.cuda.synchronize()
        gen_s += time.perf_counter() - t0
        ca, cg, cp = gen.generate(gen.to_tensors(tp, "cpu"), TRACE_T, parts=True)
        for k in draws:
            a, b = gp[k].cpu().numpy(), cp[k].numpy()
            check(np.array_equal(a.view(np.int32), b.view(np.int32)),
                  f"{name}: draw {k} differs between the card and the CPU")
            check(_digest(a[0]) == want["workloads"][name][k],
                  f"{name}: draw {k} differs from JAX's (digest)")
        tail = gp["tail"].cpu().numpy()
        check(np.array_equal(tail, cp["tail"].numpy()), f"{name}: tail masks differ")
        ga, ca = ga.cpu().numpy(), ca.numpy()
        check(np.array_equal(ga[~tail], ca[~tail]),
              f"{name}: addresses outside the zipf tail differ between the card and the CPU")
        check(_digest(np.where(tail, -1, ga)[0]) == want["workloads"][name]["addrs_outside_tail"],
              f"{name}: addresses outside the zipf tail differ from JAX's (digest)")
        tail_n += int(tail.sum())
        tail_diff += int((ga != ca).sum())
        gg = gg.cpu().numpy()
        gap_rel = max(gap_rel, float(np.max(np.abs(gg - cg.numpy()) / cg.numpy())))
    print(f"device traces: {len(WORKLOAD_NAMES)} workloads x {TRACE_T} events, every draw "
          f"and every address outside the zipf tail bit-identical on the card, on the CPU "
          f"and to JAX's digests; zipf-tail addresses {tail_n}, of which "
          f"{tail_diff} ({tail_diff / max(tail_n, 1):.4%}) differ card vs CPU; largest "
          f"relative gap difference card vs CPU {gap_rel:.3e}; generation on the card "
          f"{gen_s:.3f} s ({len(WORKLOAD_NAMES) * TRACE_T / gen_s:.1f} events/s, one "
          f"workload a call)", flush=True)


def seed_golden_traces():
    """Hand the numpy traces JAX's figure golden ran on to the executor
    (``store_traces``): those numpy's ``Generator.zipf`` draws (zipf_a > 1)
    from ``figures_numpy_traces.npz`` (numpy releases sample zipf
    differently), the rest generated here and held to the golden's digests.
    Every trace is generated here once, cold; returns each one's host
    generation seconds, keyed as the executor's memo."""
    import hashlib
    from repro_torch.experiments import store_traces
    from repro_torch.traces import host
    data = ROOT / "src/repro_torch/testdata"
    golden = json.loads((data / "figures_golden.json").read_text())
    stored = np.load(data / "figures_numpy_traces.npz")
    keys = {k.rsplit(":", 1)[0] for k in stored.files}
    def digest(a, g):
        h = hashlib.sha256(np.asarray(a, np.int64).tobytes())
        h.update(np.asarray(g, np.float32).tobytes())
        return h.hexdigest()

    mismatched, redrawn, traces, gen_s = [], 0, {}, {}
    for key, want in golden["numpy_traces"].items():
        w, T, seed = key.split(":")
        k = (w, int(T), int(seed))
        t0 = time.perf_counter()
        a, g = host.generate(*k)
        gen_s[k] = time.perf_counter() - t0
        if key in keys:
            redrawn += digest(a, g) == want
            a = stored[key + ":lines"].astype(np.int64) * 64
            g = stored[key + ":gaps"]
        if digest(a, g) != want:
            mismatched.append(key)
        traces[k] = (a, g)
    check(not mismatched, f"numpy {np.__version__} draws other traces than JAX's golden "
          f"(numpy {golden['numpy']}) for {mismatched}")
    store_traces(traces)
    print(f"numpy traces of the figures: {len(golden['numpy_traces'])}, generated here in "
          f"{sum(gen_s.values()):.3f} s; {len(keys)} drawn through Generator.zipf come from "
          f"the golden's file (numpy {golden['numpy']}), and this machine's numpy "
          f"{np.__version__} redraws {redrawn} of them equal; the other "
          f"{len(golden['numpy_traces']) - len(keys)} are generated here, equal to JAX's "
          f"inputs", flush=True)
    return gen_s


def _ratios(derived):
    return [float(v.split("=")[1]) for v in derived.split(";")]


def _host_gen_s(res, gen_s):
    """Host generation seconds of the numpy traces a figure's points use."""
    from repro_torch.traces import node_seed
    keys = {(w, p.T, node_seed(p.seed, i)) for p in res.points
            for i, w in enumerate(p.workloads)}
    return sum(gen_s[k] for k in keys)


def _figure_checks(name, backend, mod, rows, res, wall, golden, grid_out, gen_s):
    """One figure's run held to JAX's golden, then its engine row (the
    per-point engine check and the graph-vs-eager check, outside the
    counted figure runs)."""
    info = res.info
    groups = FIG_GROUPS.get(name, 1)
    check(info.planned_groups == groups, f"{name} {backend}: {info.planned_groups} groups")
    check_captures(f"{name} {backend}", info)
    for g in info.groups:
        check(g["launches"] == g["T_pad"], f"{name} {backend}: fused_cache_step launched "
              f"{g['launches']} times in a group of t_pad {g['T_pad']}")
    from repro_torch.benchmarks.common import XCHECK_T
    if name in NEW_FIGURES:
        kw = {"check_points": NEW_FIG_ENGINE_POINTS if backend == "numpy" else 0}
    else:
        kw = {} if name == "fig14_mixes" else {"check_points": FIG_ENGINE_POINTS}
    # graph vs eager on the numpy-trace run only (EAGER_BACKENDS)
    kw["eager"] = backend in EAGER_BACKENDS
    t0 = time.perf_counter()
    row = mod.engine(res, device=DEVICE, **kw)
    engine_s = time.perf_counter() - t0
    if kw.get("check_points") and name in NEW_FIGURES:
        c = row["check"]
        check(c["points_checked"] == kw["check_points"] and c["max_rel_diff"] == 0.0,
              f"{name} {backend}: per-point check {c}")
    rows = rows + [row]
    sc = row.get("eager_check")
    check((sc is not None) == kw["eager"], f"{name} {backend}: eager check {sc}")
    if sc is not None:
        check(sc["primary"] == "graph" and sc["alt"] == "eager" and sc["bit_exact"],
              f"{name} {backend}: graph vs eager at T {sc['T']}: {sc}")
        check(sc["T"] == min(XCHECK_T, res.points[0].T) and sc["launches"] == sc["T"],
              f"{name} {backend}: the graph-vs-eager check's graphed group launched "
              f"fused_cache_step {sc['launches']} times at T {sc['T']}")
    # the reference's shard check, on the figures whose rows carry it
    shard = row.get("shard_check")
    check((shard is not None) == (kw["eager"] and name in SHARD_FIGURES),
          f"{name} {backend}: shard check {shard}")
    if shard is not None:
        check(shard == {"group": 0, "primary": "vmap", "alt": "('shard', 1)",
                        "systems": info.groups[0]["S_exec"], "bit_exact": True},
              f"{name} {backend}: shard check {shard}")
    want = golden["figures"][name][backend]
    got = {r["name"]: r["derived"] for r in rows}
    check(list(got) == list(want["derived"]), f"{name}: rows {list(got)}")
    exact = sum(got[k] == v for k, v in want["derived"].items())
    if backend == "numpy":
        check(got == want["derived"], f"{name} numpy: derived differ from JAX's: "
              f"{[(k, got[k], v) for k, v in want['derived'].items() if got[k] != v]}")
        for pt, gp in zip(res.points, want["points"]):
            m = res.metrics_for(pt)
            check([list(c) for c in pt.coords] == gp["coords"], f"{name}: point order")
            check(np.array_equal(m["cache_occupancy"], np.asarray(gp["cache_occupancy"], np.float32)),
                  f"{name} {pt.coords}: cache_occupancy differs from JAX's")
            for k in ("ipc", "fam_latency"):
                check(np.allclose(m[k], np.asarray(gp[k], np.float32), rtol=golden["rtol"], atol=0),
                      f"{name} {pt.coords}: {k} {m[k]} vs JAX's {gp[k]}")
        if name == "fig08_blocksize":
            for k, v in grid_out.items():
                got_k = np.stack([res.metrics_for(p)[k] for p in res.points])
                check(np.array_equal(got_k, v), f"fig08 through the executor differs from "
                      f"the main path's grid on {k}")
    else:
        worst = 0.0
        for k, v in want["derived"].items():
            if k.endswith("_engine") or "=" not in v:
                check(got[k] == v, f"{name} device: row {k} {got[k]} != {v}")
                continue
            for a, b in zip(_ratios(got[k]), _ratios(v)):
                worst = max(worst, abs(np.log(a / b)))
        check(worst <= FIG_LOG_TOL, f"{name} device: a ratio differs from JAX's by "
              f"|log| {worst:.4f} > {FIG_LOG_TOL}: {got} vs {want['derived']}")
    nodes = "/".join(str(g["N"]) for g in info.groups)
    if backend == "numpy":
        # the executor read the traces from its memo: host generation, timed
        # cold once when the memo was filled, is not in its wall
        host = _host_gen_s(res, gen_s)
        gen = (f"numpy traces from the memo, their host generation {host:.3f} s outside "
               f"the wall; with it {info.events / (info.wall_s + host):.1f} events/s/device")
    else:
        gen = f"trace generation on the card {info.trace_device_s:.3f} s inside the wall"
    print(f"figure {name} {backend}: {len(want['derived'])} rows, {exact} derived "
          f"strings equal to JAX's" + ("" if backend == "numpy" else
                                        f" (every ratio within |log| {worst:.4f})")
          + f"; {info.systems} systems x {nodes} nodes x {res.points[0].T} events; executor "
          f"wall {info.wall_s:.3f} s (capture {info.compile_s:.3f} s, replays "
          f"{info.run_s:.3f} s, host staging {info.trace_gen_s:.3f} s) = "
          f"{info.events / info.wall_s:.1f} events/s/device; {gen}; driver's figure run "
          f"{wall:.3f} s; engine row {engine_s:.3f} s (per-point check of "
          f"{row.get('check', {}).get('points_checked', 0)} points, " +
          (f"graph == eager at T {sc['T']} on {sc['systems']} systems" if sc else
           "graph vs eager left to the numpy-trace run") +
          (f"; shard_check {json.dumps(shard)})" if shard else ")"), flush=True)
    for r in rows:
        print(f"  {r['name']},{r['us_per_call']:.3f},\"{r['derived']}\"")


def figures_path(torch, grid_out, gen_s, names=FIGURES, backends=None):
    """Phases 12 and 13: the figures ``names`` through their drivers, each
    with the trace backends ``backends[name]`` (default: numpy and device),
    the counts read around these figure runs alone; then each run's checks
    and engine row. Returns the figure runs' launches of fused_cache_step."""
    import importlib

    from repro_torch.benchmarks import common
    common.XCHECK_T = XCHECK_EVENTS
    golden = json.loads((ROOT / "src/repro_torch/testdata/figures_golden.json").read_text())
    runs = []
    reset_counts()
    for name in names:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        for backend in (backends or {}).get(name, ("numpy", "device")):
            empty_runner_cache()
            t0 = time.perf_counter()
            rows, res = mod.run_figure(quick=True, trace_backend=backend, device=DEVICE)
            runs.append((name, backend, mod, rows, res, time.perf_counter() - t0))
    launched = counts()
    launches = launched.pop("fused_cache_step")
    planned = sum(g["T_pad"] for *_, res, _ in runs for g in res.info.groups)
    check(launches == planned, f"the {len(runs)} figure runs launched fused_cache_step "
          f"{launches} times, their groups' t_pad add to {planned}")
    check(not any(launched.values()), f"unexpected launches on the figure path: {launched}")
    print(f"figure path ({', '.join(names)}): fused_cache_step launched {launches} times "
          f"in the {len(runs)} figure runs (t_pad a group; the checks below are not "
          f"counted)", flush=True)
    for run in runs:
        _figure_checks(*run, golden, grid_out, gen_s)
    return launches


# --------------------------------------------------------------------------
# phase 13b: the executor's sharded mode
# --------------------------------------------------------------------------

SHARD_T = T_CHECK              # the fig08 quick grid's events in phase shard_executor


def shard_executor_path(torch):
    """Phase 13b: the fig08 quick grid (numpy traces) at SHARD_T events
    through ``execute(cross_check_shard=True)``: the batched mode
    (``"vmap"``, every visible card's count when there is one card) and
    its re-run as ``("shard", 1)``, one runner on the card each, bit for
    bit, ``shard_check`` with the reference's keys and values; both
    modes' events/s/device. With more than one card visible, also
    ``("shard", device_count())`` against ``"vmap"``."""
    import dataclasses
    from repro_torch.benchmarks import fig08_blocksize as f08
    from repro_torch.experiments import execute
    plan = dataclasses.replace(f08.experiment(quick=True, trace_backend="numpy"),
                               T=SHARD_T).plan()
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 1
    runs = [None] + ([cards] if cards > 1 else [])
    for D in runs:
        empty_runner_cache()
        reset_counts()
        res = execute(plan, devices=D, cross_check_shard=True, assert_compiles=True,
                      device=DEVICE)
        launched = counts()
        info, sc = res.info, res.info.shard_check
        S_exec, t_pad = info.groups[0]["S_exec"], info.groups[0]["T_pad"]
        primary = "vmap" if info.devices == 1 else str(("shard", info.devices))
        alt = str(("shard", 1)) if info.devices == 1 else "vmap"
        check(sc == {"group": 0, "primary": primary, "alt": alt, "systems": S_exec,
                     "bit_exact": True}, f"shard_check {sc}")
        check_captures(f"shard_executor D {info.devices}", info)
        shards = info.devices + 1 if info.devices > 1 else 2
        check(launched["fused_cache_step"] == shards * t_pad,
              f"fused_cache_step launched {launched['fused_cache_step']} times, expected "
              f"{shards} runners x t_pad {t_pad}")
        rate = info.events / info.run_s / info.devices
        alt_rate = info.events / info.shard_check_run_s       # one device either way
        print(f"shard_executor: the fig08 quick grid ({info.systems} systems, {S_exec} lanes, "
              f"T {t_pad}, numpy traces) through execute(devices={D}, cross_check_shard=True): "
              f"shard_check {json.dumps(sc)}; {primary} {rate:.1f} events/s/device "
              f"(replays {info.run_s:.3f} s, capture {info.compile_s:.3f} s), {alt} "
              f"{alt_rate:.1f} events/s/device (replays {info.shard_check_run_s:.3f} s); "
              f"fused_cache_step launches {launched['fused_cache_step']}", flush=True)
    if cards == 1:
        print("shard_executor: one card visible, so no run over several cards", flush=True)


# --------------------------------------------------------------------------
# phase 14: fig12's policy matrix
# --------------------------------------------------------------------------

COUNTERS = ("prefetches_issued", "demand_hit_fraction", "corepf_hit_fraction",
            "cache_occupancy")


def _policy_combos(specs):
    from repro_torch.benchmarks.run import policy_combos

    def error(msg):
        raise ValueError(msg)
    return policy_combos(specs, error)


def _matrix_run(f12, combos, T):
    """fig12's policy experiment over ``combos`` at ``T``, numpy traces,
    on the card: (rows, ExperimentResult)."""
    import dataclasses
    exp = f12.policy_experiment(combos, quick=True, trace_backend="numpy")
    res = dataclasses.replace(exp, T=T).run(assert_compiles=True, device=DEVICE)
    from repro_torch.benchmarks.common import workloads
    rows = f12.policy_rows(res.get, workloads(True), combos, res.info.us_per_call())
    rows.append({"name": "fig12_policies_engine",
                 "derived": f"groups={res.info.planned_groups}"})
    return rows, res


def _same_points(what, res, want_points, rtol):
    """Every point's metrics against JAX's golden: counters exact, floats
    (ipc, fam_latency, issue_rate) within ``rtol``."""
    for pt, gp in zip(res.points, want_points):
        check([list(c) for c in pt.coords] == gp["coords"], f"{what}: point order")
        m = res.metrics_for(pt)
        for k, v in m.items():
            want = np.asarray(gp[k], np.float32)
            ok = np.array_equal(v, want) if k in COUNTERS else \
                np.allclose(v, want, rtol=rtol, atol=0)
            check(ok, f"{what} {pt.coords}: {k} {v} vs JAX's {want}")


def _random_run(spec):
    """The golden's random-replacement combo on the card: the quick
    workloads on ``spec["nodes"]`` nodes, numpy traces, prefetching on, the
    cache cut to ``spec["dram_cache_bytes"]``, on ``spec["kernel_backend"]``."""
    import dataclasses
    from repro_torch import experiments as tx
    from repro_torch.configs.base import FamConfig
    from repro_torch.policies import PolicySet, SimFlags
    base = dataclasses.replace(FamConfig(), kernel_backend=spec["kernel_backend"],
                               dram_cache_bytes=spec["dram_cache_bytes"])
    exp = tx.Experiment(name="random_replacement", T=spec["T"], base=base, flags=SimFlags(),
                        nodes=spec["nodes"], trace_backend="numpy",
                        axes=(tx.workload_axis(QUICK_WORKLOADS),
                              tx.policy_axis({"random": PolicySet(replacement="random")})))
    return exp.run(assert_compiles=True, device=DEVICE)


def _events_line(info):
    return (f"executor wall {info.wall_s:.3f} s (captures {info.compile_s:.3f} s, replays "
            f"{info.run_s:.3f} s) = {info.events / info.wall_s:.1f} events/s/device")


def policy_matrix(torch):
    """Phase 14: fig12's policy matrix at its golden T on numpy traces
    against JAX's golden (rows exact, every point's metrics), its spp+wfq
    rows against a plain fig12 run's w2 rows at that T, the golden's
    random-replacement combo on the ``torch`` cache step (every point's
    metrics), and ``random`` refused by the CUDA cache step. The counts are
    read around the matrix and random runs: t_pad launches a group of the
    matrix (the ``cuda`` cache step), none in the random combo's. Returns
    the matrix's launches and the plain fig12 run (telemetry off), which
    phase 15 holds its telemetry run's shared metrics against."""
    import dataclasses
    from repro_torch.benchmarks import fig12_wfq as f12
    from repro_torch.benchmarks.common import workloads
    from repro_torch.policies import PolicySet
    golden = json.loads((ROOT / "src/repro_torch/testdata/figures_golden.json").read_text())
    m, spec = golden["matrix"], golden["random"]
    combos = _policy_combos(m["specs"])
    check({k: v.describe() for k, v in combos.items()} == m["combos"],
          f"combos {list(combos)} differ from the golden's")
    empty_runner_cache()
    reset_counts()
    rres = _random_run(spec)
    check(counts()["fused_cache_step"] == 0, "the random combo launched the CUDA cache step")
    empty_runner_cache()
    rows, res = _matrix_run(f12, combos, m["T"])
    launched = counts()
    launches = launched.pop("fused_cache_step")
    check(not any(launched.values()), f"unexpected launches on the matrix path: {launched}")
    info = res.info
    planned = sum(g["T_pad"] for g in info.groups)
    check(launches == planned, f"the matrix launched fused_cache_step {launches} times, "
          f"expected {planned}")
    check_captures("matrix", info)
    got = {r["name"]: r["derived"] for r in rows}
    check(got == m["derived"], f"matrix derived differ from JAX's: "
          f"{[(k, got.get(k), v) for k, v in m['derived'].items() if got.get(k) != v]}")
    _same_points("matrix", res, m["points"], golden["rtol"])
    print(f"policy matrix ({'+'.join(m['specs'])}, T {m['T']}): {len(got)} rows equal to "
          f"JAX's, every point's metrics within rtol {golden['rtol']} (counters exact); "
          f"{info.planned_groups} groups, {info.systems} systems; {_events_line(info)}; "
          f"fused_cache_step launches {launches}", flush=True)
    for r in rows:
        print(f"  {r['name']},\"{r['derived']}\"")
    info = rres.info
    check(info.planned_groups == spec["groups"], f"random: {info.planned_groups} groups")
    check_captures("random", info)
    _same_points("random", rres, spec["points"], golden["rtol"])
    occupancy = min(float(rres.metrics_for(p)["cache_occupancy"].min()) for p in rres.points)
    print(f"random replacement ({spec['kernel_backend']} cache step, {info.systems} systems x "
          f"{spec['nodes']} nodes x {spec['T']} events, a {spec['dram_cache_bytes']} B cache, "
          f"occupancy {occupancy:.3f} at least): every point's metrics equal to JAX's within "
          f"rtol {golden['rtol']} (counters exact); {_events_line(info)}", flush=True)
    # the matrix's spp+wfq rows and points are the plain run's w2 ones
    plain = dataclasses.replace(f12.experiment(quick=True, trace_backend="numpy"), T=m["T"])
    pres = plain.run(assert_compiles=True, device=DEVICE)
    prows = {r["name"]: r["derived"]
             for r in f12.figure_rows(pres.get, workloads(True), 0.0)}
    same = 0
    for r in rows:
        if r["name"].endswith("_spp+wfq"):
            w2 = r["name"].replace("_spp+wfq", "_w2")
            check(prows[w2] == r["derived"], f"{r['name']} {r['derived']} != {w2} {prows[w2]}")
            same += 1
    for n in f12.NODE_COUNTS:
        for w in workloads(True):
            a = res.get(nodes=n, workload=w, policy="spp+wfq")
            b = pres.get(nodes=n, workload=w, variant="w2")
            check(all(np.array_equal(a[k], b[k]) for k in a),
                  f"spp+wfq and w2 differ at nodes {n}, {w}")
    check(same == len(f12.NODE_COUNTS), f"{same} spp+wfq rows")
    print(f"policy matrix: spp+wfq rows equal the plain fig12 run's w2 rows at T {m['T']} "
          f"({same} rows, every point's metrics bit for bit)", flush=True)
    # random has no mode in the CUDA cache step: refused before any launch
    before = counts()["fused_cache_step"]
    try:
        _matrix_run(f12, {"random": PolicySet(replacement="random")}, 100)
    except ValueError as e:
        check("'random'" in str(e), f"cuda + random raised another error: {e}")
        print(f"cuda cache step with random replacement refused: {e}", flush=True)
    else:
        check(False, "kernel_backend='cuda' ran random replacement")
    check(counts()["fused_cache_step"] == before, "cuda + random launched the kernel")
    return launches, pres

# --------------------------------------------------------------------------
# phases 15-17: telemetry windows, the Pond fleets, the throughput benchmark
# --------------------------------------------------------------------------

TELE_GOLDEN = "src/repro_torch/testdata/obs_tenants_golden.json"
POND_TRACES = "src/repro_torch/testdata/pond_numpy_traces.npz"
#: telemetry columns holding counts (exact against JAX); the float gauges
#: (wfq_*_backlog, token_rate, lat_sum) are held at the golden's rtol
TELE_GAUGES = ("wfq_demand_backlog", "wfq_prefetch_backlog", "token_rate", "lat_sum")
#: the Pond run on device traces against JAX's golden: every fleet
#: percentile (and tenant record percentile) in the golden's histogram
#: bucket or the next one, every fleet slowdown geomean within |log| 0.01
#: (the port on the CPU measured 0 buckets and |log| 0:
#: ``python tests/test_torch_tenants.py --compare-device``)
POND_BUCKETS, POND_LOG_SLOWDOWN = 1, 0.01


def _tele_golden():
    return json.loads((ROOT / TELE_GOLDEN).read_text())


def _launch_check(what, info, launched):
    """One capture or cache hit a group, fused_cache_step launched t_pad times a group
    (and the counter saw exactly that), no other kernel."""
    launches = launched.pop("fused_cache_step")
    check_captures(what, info)
    for g in info.groups:
        check(g["launches"] == g["T_pad"], f"{what}: {g['launches']} launches in a group "
              f"of t_pad {g['T_pad']}")
    check(launches == sum(g["T_pad"] for g in info.groups),
          f"{what}: fused_cache_step launched {launches} times")
    check(not any(launched.values()), f"{what}: unexpected launches {launched}")
    return launches


def telemetry_path(torch, profiles, plain):
    """Phase 15: fig12's quick grid at the golden's T on numpy traces with
    telemetry windows, through the driver's experiment and row code: rows,
    ``derived`` and ``windowed_tail`` equal to JAX's, every point's
    windows equal to JAX's (counts exact, gauges within the golden's
    rtol), the shared metrics bit-identical to ``plain``, phase 14's run of
    the same grid with telemetry off, one capture or cache hit and t_pad launches a
    group; on the fig08
    grid at warmup 0 the windows sum to the run totals; phase 10's
    profiled 200-event windows of the fig08 grid with and without
    telemetry (``profiles``) side by side. Returns the telemetry run's
    launches."""
    import dataclasses
    from repro_torch.benchmarks import fig12_wfq as f12
    from repro_torch.benchmarks.common import workloads
    from repro_torch.configs.base import fam_replace
    from repro_torch.core import famsim
    from repro_torch.obs.telemetry import COUNTERS, HIST_OFFSET, counter_index
    gold = _tele_golden()["telemetry"]
    check(gold["n_windows"] == TELEMETRY_WINDOWS, f"golden windows {gold['n_windows']}")
    rtol = json.loads((ROOT / "src/repro_torch/testdata/figures_golden.json")
                      .read_text())["rtol"]
    exp = dataclasses.replace(f12.experiment(quick=True, trace_backend="numpy",
                                             telemetry=gold["n_windows"]), T=gold["T"])
    check(plain.points[0].T == gold["T"] and plain.points[0].cfg.telemetry == 0 and
          [p.coords for p in plain.points] == [p.coords for p in exp.points()],
          "phase 14's plain fig12 run is not this grid without telemetry")
    empty_runner_cache()
    reset_counts()
    t0 = time.perf_counter()
    res = exp.run(assert_compiles=True, device=DEVICE)
    step_s = {"fig12": time.perf_counter() - t0}
    launches = _launch_check("fig12 telemetry", res.info, counts())
    rows = f12.figure_rows(res.get, workloads(True), res.info.us_per_call())
    got = {r["name"]: {"derived": r["derived"], "windowed_tail": r["windowed_tail"]}
           for r in rows}
    check(got == gold["rows"], f"fig12 telemetry rows differ from JAX's: "
          f"{[(k, got.get(k), v) for k, v in gold['rows'].items() if got.get(k) != v]}")
    gauges = [counter_index(c) for c in TELE_GAUGES]
    counted = [i for i in range(len(COUNTERS)) if i not in gauges]
    worst, exact = 0.0, True
    for pt, gp, pt0 in zip(res.points, gold["points"], plain.points):
        check([list(c) for c in pt.coords] == gp["coords"], "telemetry: point order")
        m, want = res.metrics_for(pt), np.asarray(gp["telemetry"], np.float32)
        w = m["telemetry"]
        check(np.array_equal(w[:, counted], want[:, counted]),
              f"{pt.coords}: a counted telemetry column differs from JAX's")
        check(np.allclose(w[:, gauges], want[:, gauges], rtol=rtol, atol=0),
              f"{pt.coords}: a telemetry gauge differs from JAX's beyond rtol {rtol}")
        exact &= bool(np.array_equal(w, want))
        rel = np.abs(w[:, gauges] - want[:, gauges]) / np.maximum(np.abs(want[:, gauges]), 1e-30)
        worst = max(worst, float(rel.max()))
        m0 = plain.metrics_for(pt0)
        check("telemetry" not in m0 and set(m) == set(m0) | {"telemetry"}, "metric keys")
        for k, v in m0.items():
            check(np.array_equal(v, m[k]), f"{pt.coords}: {k} differs with telemetry on")
    info = res.info
    print(f"telemetry: fig12 quick at T {gold['T']} with {gold['n_windows']} windows, "
          f"{info.systems} systems in {info.planned_groups} groups ({info.compiles} "
          f"captures, fused_cache_step launches {launches} = t_pad a group): "
          f"{len(rows)} rows, derived and windowed_tail equal to JAX's; every point's "
          f"windows: counts exact, gauges {'bit for bit' if exact else 'within rtol'} "
          f"(largest relative gauge difference {worst:.3e}); shared metrics bit-identical "
          f"to telemetry 0 (phase 14's run); executor wall {info.wall_s:.3f} s (captures "
          f"{info.compile_s:.3f} s, replays {info.run_s:.3f} s) vs telemetry 0 "
          f"{plain.info.wall_s:.3f} s (captures {plain.info.compile_s:.3f} s, "
          f"replays {plain.info.run_s:.3f} s)", flush=True)
    # the fig08 grid at warmup 0: the windows partition the run
    t_step = time.perf_counter()
    donor, p, addrs, gaps, _ = fig08_grid(T_CHECK, "cuda")
    reset_counts()
    out = famsim.sweep(fam_replace(donor, telemetry=gold["n_windows"]), p, None, addrs,
                       gaps, warmup_frac=0.0, device=DEVICE)
    check(counts()["fused_cache_step"] == T_CHECK, "fig08 telemetry: launches")
    out = {k: v.cpu().numpy() for k, v in out.items()}
    tele = out["telemetry"].astype(np.float64)
    col = lambda name: tele[..., counter_index(name)].sum(-1)
    check((col("events") == T_CHECK).all(), "fig08 telemetry: events")
    check(np.array_equal(col("pf_issued"), out["prefetches_issued"][:, 0]),
          "fig08 telemetry: windows' pf_issued != prefetches_issued")
    check(np.array_equal(tele[..., HIST_OFFSET:].sum((-2, -1)), col("demand_fam")),
          "fig08 telemetry: histogram counts != FAM-bound demands")
    hit = (col("demand_hit") / np.maximum(col("demand_fam"), 1.0)).astype(np.float32)
    check(np.allclose(hit, out["demand_hit_fraction"][:, 0], rtol=1e-6, atol=0),
          "fig08 telemetry: windows' hit fraction != demand_hit_fraction")
    print(f"telemetry: fig08 grid ({addrs.shape[0]} systems x {T_CHECK} events, warmup 0): "
          f"the windows sum to the run totals (events, prefetches issued, one histogram "
          f"count per FAM-bound demand, the hit fraction)", flush=True)
    step_s["fig08 warmup 0"] = time.perf_counter() - t_step
    (off_kernels, off_ms), (on_kernels, on_ms) = profiles[0], profiles[TELEMETRY_WINDOWS]
    print(f"telemetry: graphed fig08 window (phase 10), device kernels an event "
          f"{on_kernels:.1f} with {TELEMETRY_WINDOWS} windows vs {off_kernels:.1f} without; "
          f"device time {on_ms:.4f} vs {off_ms:.4f} ms an event", flush=True)
    print("telemetry phase seconds: " + json.dumps({k: round(v, 3) for k, v in step_s.items()}),
          flush=True)
    return launches


def pond_traces():
    """The Pond's stored numpy traces, keyed as the executor's trace memo."""
    stored = np.load(ROOT / POND_TRACES)
    out = {}
    for key in sorted({k.rsplit(":", 1)[0] for k in stored.files}):
        w, T, seed = key.split(":")
        out[(w, int(T), int(seed))] = (stored[key + ":lines"].astype(np.int64) * 64,
                                       stored[key + ":gaps"])
    return out


def _bucket(x):
    from repro_torch.obs.telemetry import LAT_EDGES
    return int(sum(x > e for e in LAT_EDGES))


def pond_differences(summaries, records, want):
    """(largest histogram-bucket distance of a fleet or tenant percentile,
    largest |log| ratio of a fleet slowdown geomean) against ``want``, a
    golden entry of JAX's summaries and records."""
    buckets, logs = 0, 0.0
    for a, b in zip(summaries, want["summaries"]):
        check(a["fleet"] == b["fleet"], "pond: fleet order")
        logs = max(logs, abs(float(np.log(a["slowdown_geomean"] / b["slowdown_geomean"]))))
    for a, b in list(zip(summaries, want["summaries"])) + list(zip(records, want["records"])):
        for q in ("p50", "p95", "p99"):
            buckets = max(buckets, abs(_bucket(a[q]) - _bucket(b[q])))
    return buckets, logs


def pond_path(torch):
    """Phase 16: the quick Pond sweep through ``run.py pond --device`` on
    the stored numpy traces (every fleet summary and tenant record equal
    to JAX's golden) and on device traces (within POND_BUCKETS /
    POND_LOG_SLOWDOWN); each one planned group, one capture or cache hit and t_pad
    launches. Returns the two runs' launches."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.experiments import store_traces
    gold = _tele_golden()["pond"]
    store_traces(pond_traces())
    total = 0
    for backend in ("numpy", "device"):
        empty_runner_cache()
        reset_counts()
        t0 = time.perf_counter()
        rows = bench_run.main(["pond", "--device", DEVICE, "--trace-backend", backend])
        wall = time.perf_counter() - t0
        eng = rows[-1]
        e = eng["engine"]
        check(eng["name"] == "pond_engine" and e["planned_groups"] == 1,
              f"pond {backend}: {e['planned_groups']} groups")
        check_captures(f"pond {backend}", e)
        launched = counts()
        launches = launched.pop("fused_cache_step")
        g = e["groups"][0]
        check(g["launches"] == g["T_pad"] == launches == gold["T"],
              f"pond {backend}: {launches} launches, group {g['launches']} of t_pad {g['T_pad']}")
        check(not any(launched.values()), f"pond {backend}: unexpected launches {launched}")
        total += launches
        check((eng["fleets"], eng["tenant_lanes"], eng["isolated_lanes"]) ==
              (len(gold["fleets"]), gold["tenant_lanes"], gold["isolated_lanes"]),
              f"pond {backend}: lanes {eng}")
        summaries = [{k: v for k, v in r.items()
                      if k not in ("name", "us_per_call", "tenants_detail")} for r in rows[:-1]]
        records = [t for r in rows[:-1] for t in r["tenants_detail"]]
        want = gold[backend]
        same_s = sum(a == b for a, b in zip(summaries, want["summaries"]))
        same_r = sum(a == b for a, b in zip(records, want["records"]))
        check(len(summaries) == len(want["summaries"]) and len(records) == len(want["records"]),
              f"pond {backend}: {len(summaries)} fleets, {len(records)} records")
        if backend == "numpy":
            check(same_s == len(summaries) and same_r == len(records),
                  f"pond numpy: {len(summaries) - same_s} fleet summaries and "
                  f"{len(records) - same_r} tenant records differ from JAX's")
            detail = "every fleet summary and tenant record equal to JAX's"
        else:
            buckets, logs = pond_differences(summaries, records, want)
            check(buckets <= POND_BUCKETS and logs <= POND_LOG_SLOWDOWN,
                  f"pond device: percentiles {buckets} buckets, slowdown |log| {logs:.5f} "
                  f"from JAX's")
            detail = (f"{same_s} of {len(summaries)} fleet summaries and {same_r} of "
                      f"{len(records)} tenant records equal to JAX's, percentiles within "
                      f"{buckets} bucket(s), slowdown geomeans within |log| {logs:.5f}")
        events = e["events"]
        print(f"pond {backend}: {eng['fleets']} fleets, {eng['tenant_lanes']} tenant + "
              f"{eng['isolated_lanes']} isolated lanes (S_exec {g['S_exec']}, t_pad "
              f"{g['T_pad']}); {detail}; one group, {e['compiles']} capture, "
              f"fused_cache_step launches {launches}; executor wall {e['wall_s']:.3f} s = "
              f"{events / e['wall_s']:.1f} events/s/device (capture {e['compile_s']:.3f} s, "
              f"replays {e['run_s']:.3f} s = {e['run_s'] / g['T_pad'] * 1e3:.4f} ms an "
              f"event, card trace generation {e['trace_device_s']:.3f} s); command wall "
              f"{wall:.3f} s", flush=True)
    return total


def bench(torch):
    """Phase 17: ``bench --quick --repeats BENCH_REPEATS`` on both cache-step
    backends (digests equal, asserted by the benchmark), then the full grid
    (fig08 over all 19 workloads) on ``cuda`` once; the counts read around
    each: t_pad launches a ``cuda`` execution, none on ``torch``. Each run
    writes its roofline record (``roofline/famsim_step.json``) under a
    temporary ``--out``; they are returned under ``"roofline"``."""
    import tempfile
    from repro_torch.benchmarks import bench_famsim
    out = {"roofline": {}}
    for quick, argv in ((True, ["--quick", "--repeats", str(BENCH_REPEATS)]),
                        (False, ["--kernel-backend", "cuda", "--repeats", "1"])):
        empty_runner_cache()
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            rows = bench_famsim.main(argv + ["--device", DEVICE, "--out", tmp])
            out["roofline"]["quick" if quick else "full"] = json.loads(
                (Path(tmp) / bench_famsim.ROOFLINE).read_text())
        launched = counts()
        t_pad = bench_famsim._experiment("cuda", quick).plan().groups
        executions = BENCH_REPEATS if quick else 1
        want = executions * sum(g.t_pad for g in t_pad)
        check(launched.pop("fused_cache_step") == want,
              f"bench quick={quick}: launches differ from {want}")
        check(not any(launched.values()), f"unexpected launches in the bench: {launched}")
        for r in rows:
            check_captures(f"bench {'quick' if quick else 'full'} {r['backend']} (last "
                           "execution)", r["engine"])
            print(f"bench {'quick' if quick else 'full'} {r['backend']}: "
                  f"{r['events_per_sec_per_device']} events/s/device ({r['events']} events, "
                  f"{r['points']} points, best run_s {r['run_s_best']} of {r['run_s_all']}, "
                  f"captures {r['compile_s']} s, last execution's wall {r['wall_s_last']} s), "
                  f"digest {r['digest']}", flush=True)
        out["quick" if quick else "full"] = rows
    return out


# --------------------------------------------------------------------------
# phase roofline: counted work beside the times phases train, serving and
# bench measured (nothing is timed again)
# --------------------------------------------------------------------------

#: (d), one dry-run cell at 256 fake ranks, is left out: whisper-base
#: decode_32k (`python -m repro_torch.launch.dryrun --arch whisper-base
#: --shape decode_32k --device cuda`) took 27.93 s on the H100's host
#: (torch 2.11.0+cu128; the cell 14.55 s, the rest the process's start),
#: over the 20 s the phase may spend on it
ROOFLINE_DRYRUN_LEFT_OUT = ("whisper-base decode_32k at 256 fake ranks took 27.93 s with its "
                            "process's start (the cell 14.55 s), over 20 s")


def _terms_line(terms):
    return (f"compute_s {terms.compute_s:.6g}, memory_s {terms.memory_s:.6g} "
            f"({terms.bottleneck} bound), mfu_bound {terms.mfu_bound:.4%}")


def _roofline_train(torch, train):
    """(a): one adamw train step of TRAIN_ARCH at TRAIN_BATCH x TRAIN_SEQ
    (phase train's step) under the op counter on the card, beside phase
    train's measured step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.dryrun import model_flops_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.analysis import H100_SXM, analyze
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.steps import build_train_step, init_train_state
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=DEVICE)
    state = init_train_state(model, SERVE_SEED)
    step = build_train_step(model, AdamWConfig(**TRAIN_OPT))
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH)).batch(0, DEVICE)
    with OpCounter() as counter:
        state, metrics = step(state, batch)
    check(bool(np.isfinite(float(metrics["loss"]))), "the counted train step's loss")
    del state, metrics
    torch.cuda.empty_cache()
    model_flops = model_flops_for(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    terms = analyze(counter, chips=1, model_flops=model_flops)
    step_s = train["step_ms"] / 1e3
    share = terms.flops_per_device / step_s / H100_SXM.peak_flops
    hand = train["flops_all"] / step_s / H100_SXM.peak_flops
    print(f"roofline (a) train {cfg.name} B {TRAIN_BATCH} x S {TRAIN_SEQ}, one card: counted "
          f"{terms.flops_per_device:.6e} FLOPs (matmuls; FlopCounterMode's "
          f"{terms.xla_flops_once:.6e}), {terms.bytes_per_device:.6e} B; model flops "
          f"{model_flops:.6e} (6 x {cfg.active_param_count()} active x "
          f"{TRAIN_BATCH * TRAIN_SEQ}); {_terms_line(terms)}; measured step (phase train) "
          f"{step_s * 1e3:.1f} ms: measured MFU {model_flops / step_s / H100_SXM.peak_flops:.4%}, "
          f"counted FLOP/s {terms.flops_per_device / step_s / 1e12:.2f} T = {share:.4%} of the "
          f"bf16 peak against phase train's hand count {train['flops_all']:.6e} = {hand:.4%} "
          f"(counted / hand {terms.flops_per_device / train['flops_all']:.4f}); roofline share "
          f"(the bound over the measured step) {terms.step_time_s / step_s:.2%}", flush=True)


def _roofline_prefill(torch, prefill_s):
    """(b): SERVE_ARCH's prefill at SERVE_BATCH x SERVE_PROMPT counted on
    the card through the ``cuda`` backend (the kernel launches and its
    wrapper charges ``op_cost.attention_cost``) and through the ``torch``
    backend (the chunked attention's dots counted as they run), beside
    phase serving's measured prefill. The two counts must be equal."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import model_flops_for
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import H100_SXM, analyze
    from repro_torch.roofline.op_cost import OpCounter
    cfg = get_config(SERVE_ARCH)
    params = build_model(cfg, device=DEVICE).init(SERVE_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator(device=DEVICE).manual_seed(SERVE_SEED),
                           device=DEVICE)
    counted = {}
    for backend in ("cuda", "torch"):
        model = build_model(cfg, device=DEVICE, kernel_backend=backend)
        with OpCounter() as counter:
            logits, _ = model.prefill(params, {"tokens": tokens})
        check(bool(torch.isfinite(logits).all()), f"the counted {backend} prefill's logits")
        counted[backend] = counter
        del logits
    del params
    torch.cuda.empty_cache()
    kern, ref = counted["cuda"], counted["torch"]
    charge = kern.charges["flash_attention"]
    # the torch backend's attention dots: what it counts beyond the ops
    # both backends run (einsum lowers them to bmm or mm by shape)
    dots = ref.cost.flops - (kern.cost.flops - charge[0])
    check(charge[2] == cfg.num_layers, f"flash_attention charged {charge[2]} times, "
          f"expected {cfg.num_layers}")
    check(charge[0] == dots, f"the flash_attention charge {charge[0]:.6e} differs from the "
          f"torch backend's attention dots {dots:.6e}")
    model_flops = model_flops_for(cfg, ShapeSpec("prefill", SERVE_PROMPT, SERVE_BATCH,
                                                 "prefill"))
    terms = analyze(kern, chips=1, model_flops=model_flops)
    print(f"roofline (b) prefill {cfg.name} {SERVE_BATCH} x {SERVE_PROMPT} through the cuda "
          f"backend: counted {terms.flops_per_device:.6e} FLOPs, {terms.bytes_per_device:.6e} B; "
          f"flash_attention charged {charge[2]} times, {charge[0]:.6e} FLOPs and {charge[1]:.6e} "
          f"B, the torch backend's attention dots at the same shapes {dots:.6e} FLOPs (equal; its "
          f"whole prefill {ref.cost.flops:.6e} FLOPs, {ref.cost.bytes:.6e} B); model flops "
          f"{model_flops:.6e}; {_terms_line(terms)}; measured prefill (phase serving) "
          f"{prefill_s:.4f} s = {SERVE_BATCH * SERVE_PROMPT / prefill_s:.1f} tokens/s: measured "
          f"MFU {model_flops / prefill_s / H100_SXM.peak_flops:.4%}, counted FLOP/s "
          f"{terms.flops_per_device / prefill_s / 1e12:.2f} T, roofline share "
          f"{terms.step_time_s / prefill_s:.2%}", flush=True)


def _roofline_bench(records):
    """(c): the bench's roofline records (phase bench): bytes an event and
    the memory bound an event beside the measured time an event."""
    for grid, recs in records.items():
        for r in recs:
            per_event = sum(g["bytes_per_event"] * g["events"] for g in r["groups"]) / r["events"]
            steps = sum(g["events"] for g in r["groups"])
            check(per_event > 0, f"bench {grid} {r['backend']}: no bytes counted")
            print(f"roofline (c) bench {grid} {r['backend']}: {len(r['groups'])} group(s), "
                  f"{steps} steps for {r['events']} events: {per_event:.6g} counted B an event "
                  f"(a step {r['groups'][0]['bytes_per_event']:.6g} B for all its lanes), "
                  f"memory bound {r['memory_s'] / r['events'] * 1e6:.6g} us an event against "
                  f"{r['us_per_event']:.6g} us measured (best run_s {r['run_s_best']} s, "
                  f"{r['events_per_sec_per_device']} events/s/device): roofline share "
                  f"{r['memory_s'] / r['run_s_best']:.4%}", flush=True)


def roofline_path(torch, train, prefill_s, bench_records):
    """Phase roofline: (a) the train step's, (b) the prefill's and (c) the
    simulator's counted work and roofline terms against the H100's peaks
    (bounds, not measurements), each beside the time its own phase
    measured."""
    _roofline_train(torch, train)
    _roofline_prefill(torch, prefill_s)
    _roofline_bench(bench_records)
    print(f"roofline (d) left out: {ROOFLINE_DRYRUN_LEFT_OUT}", flush=True)


SEARCH_GOLDEN = "src/repro_torch/testdata/search_golden.json"
#: the search on device traces, cut for time from fig_search's 3
#: generations to 2 (the golden holds its generation 1; T stays 10,000:
#: generation 1 measured |log| 0.00886 of JAX's there against FIG_LOG_TOL,
#: and shorter traces average less)
SEARCH_DEVICE_GENERATIONS = 2
#: pond_tail over qos_space() on default_search_fleet() (16 tenants, zipf)
POND_SEARCH = dict(generations=2, population=4, T=1024, seed=0)
#: the one known difference in the search's files: the port's default
#: kernel backend is named "cuda" where JAX's default says "xla"
_KERNEL_NAMES = (('"kernel_backend":"cuda"', '"kernel_backend":"xla"'),
                 ('"kernel_backend": "cuda"', '"kernel_backend": "xla"'),
                 ("'cuda', ", "'xla', "))


def _as_jax(text):
    for port, ref in _KERNEL_NAMES:
        text = text.replace(port, ref)
    return text


#: the candidates of fig_search's quick run on numpy traces (T 10,000)
#: whose simulated results drift from JAX's golden: XLA's CPU code divides
#: by a reciprocal inside fused loops where the port divides exactly, and
#: these candidates' adaptation amplifies the ulp (the port's own CPU run
#: drifts the same: per-mix uplifts by |log| 2.016e-3, 1.5e-7 and 9.6e-5).
#: Their results, wherever they stand, are held to SEARCH_DRIFT_TOL;
#: every other line of the trajectory, and best.json, byte for byte.
SEARCH_DRIFT = ("g1c1", "g1c2", "g1c4")
SEARCH_DRIFT_TOL = 3e-3


def _drift_values(gold_lines):
    """The golden's result floats (fitness, objective, per-mix uplift) of
    the SEARCH_DRIFT candidates."""
    out = set()
    for line in gold_lines:
        rec = json.loads(line)
        if rec.get("label") in SEARCH_DRIFT:
            out |= {rec["fitness"], rec["objective"], *rec["per_mix"].values()}
    return out


def _json_diffs(got, want, drift, path=""):
    """The places where two parsed JSON values differ: a float of ``drift``
    beyond |log| SEARCH_DRIFT_TOL of the wanted one, anything else at all.
    Returns (paths, largest |log| ratio of a drift float)."""
    if isinstance(want, float) and want in drift and isinstance(got, float):
        ratio = abs(float(np.log(got / want))) if got > 0 and want > 0 else \
            (0.0 if got == want else float("inf"))
        return ([path] if ratio > SEARCH_DRIFT_TOL else []), ratio
    if isinstance(want, dict) and isinstance(got, dict) and got.keys() == want.keys():
        parts = [_json_diffs(got[k], want[k], drift, f"{path}.{k}") for k in want]
    elif isinstance(want, list) and isinstance(got, list) and len(got) == len(want):
        parts = [_json_diffs(g, w, drift, f"{path}[{i}]")
                 for i, (g, w) in enumerate(zip(got, want))]
    else:
        return ([] if got == want else [path]), 0.0
    return [p for ps, _ in parts for p in ps], max([r for _, r in parts], default=0.0)


def _floats(tree):
    if isinstance(tree, float):
        return {tree}
    nodes = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, list) else ()
    return set().union(*map(_floats, nodes))


def _golden_diffs(got, want, drift):
    """Lines (the trajectory's, then best.json) against the golden's: a
    line that holds no drift float byte for byte, one that does through
    :func:`_json_diffs`. Returns (paths, largest |log| of a drift float,
    indices of the lines that are not byte for byte)."""
    if len(got) != len(want):
        return [f"{len(got)} lines, {len(want)} wanted"], 0.0, []
    diffs, worst, loose = [], 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        loose.append(i)
        if not drift & _floats(json.loads(w)):
            diffs.append(f"[{i}] (not byte for byte)")
            continue
        d, r = _json_diffs(json.loads(g), json.loads(w), drift, f"[{i}]")
        diffs += d
        worst = max(worst, r)
    return diffs, worst, loose


def _golden_controls(want, drift):
    """The checker fails what it must: a drift float moved by 1.5 times
    SEARCH_DRIFT_TOL, and a result float of a line with no drift float
    moved by one ulp."""
    moved = {}
    for i, w in enumerate(want):
        rec = json.loads(w)
        if "fitness" not in rec:
            continue
        drifts = rec["fitness"] in drift
        if drifts and "drift" not in moved:
            rec["fitness"] *= float(np.exp(1.5 * SEARCH_DRIFT_TOL))
            moved["drift"] = (i, json.dumps(rec, sort_keys=True, separators=(",", ":")))
        elif not drifts and not drift & _floats(rec) and "exact" not in moved:
            rec["fitness"] = float(np.nextafter(rec["fitness"], np.inf))
            moved["exact"] = (i, json.dumps(rec, sort_keys=True, separators=(",", ":")))
    check(moved.keys() == {"drift", "exact"}, f"search controls: {sorted(moved)}")
    for what, (i, line) in moved.items():
        got = list(want)
        got[i] = line
        check(_golden_diffs(got, want, drift)[0],
              f"search control ({what} float of line {i} moved) passed the check")
    return {k: v[0] for k, v in moved.items()}


def _generation_lines(what, timings, t_pad):
    """Per generation: wall, captures, cache hits, replay ms an event and
    events/s/device; checks that every generation after the first
    captured nothing and hit the runner cache for every group."""
    for t in timings:
        if t["gen"] > 1:
            check(t["compiles"] == 0 and t["exec_cache_hits"] == t["planned_groups"],
                  f"{what} generation {t['gen']}: {t['compiles']} captures, "
                  f"{t['exec_cache_hits']} hits for {t['planned_groups']} groups")
        check_captures(f"{what} generation {t['gen']}", t)
        print(f"{what} generation {t['gen']}: wall {t['wall_s']:.3f} s, {t['compiles']} "
              f"capture(s) ({t['compile_s']:.3f} s), {t['exec_cache_hits']} cache hit(s) "
              f"for {t['planned_groups']} group(s), {t['systems']} systems, replays "
              f"{t['run_s']:.3f} s = {t['run_s'] / t_pad * 1e3:.4f} ms an event, "
              f"{t['events'] / t['wall_s']:.1f} events/s/device", flush=True)


def _search_run(backend, out, generations, T):
    """fig_search's quick run on ``backend`` traces through its driver, the
    counts read around it: (the ``run_search`` summary, launches, wall)."""
    from repro_torch.benchmarks import fig_search
    from repro_torch.search import best_experiment, load_best
    reset_counts()
    t0 = time.perf_counter()
    _, summary, replay = fig_search.run_result(trace_backend=backend, out=out,
                                               generations=generations, T_events=T,
                                               device=DEVICE)
    wall = time.perf_counter() - t0
    launched = counts()
    launches = launched.pop("fused_cache_step")
    check(not any(launched.values()), f"search {backend}: unexpected launches {launched}")
    check(replay["matches"], f"search {backend}: the replay differs: {replay}")
    check(summary["best"]["objective"] > 1.0, f"search {backend}: best {summary['best']}")
    replay_plan = best_experiment(load_best(summary["best_path"]),
                                  trace_backend=backend).plan()
    # a generation's groups run at its T (the evolutionary proposer's is the run's)
    t_pad = summary["best"]["T"]
    want = sum(t["planned_groups"] for t in summary["timings"]) * t_pad + \
        sum(g.t_pad for g in replay_plan.groups)
    check(launches == want, f"search {backend}: fused_cache_step launched {launches} "
          f"times, expected {want}")
    _generation_lines(f"search {backend}", summary["timings"], t_pad)
    return summary, launches, wall


def _cache_check(telemetry):
    """A plan of one runner key with other traced params than the plan that
    cached it: replayed from the cached graph, its rows equal a fresh
    capture's bit for bit."""
    from repro_torch.configs.base import FamConfig
    from repro_torch.experiments import (Experiment, execute, executor, grid_axis,
                                         group_cache_keys, mix_axis)
    from repro_torch.policies import PolicySet, SimFlags
    from repro_torch.benchmarks.fig14_mixes import _mixes

    def plan(values):
        return Experiment(name="cache_check", T=T_CHECK // 2,
                          base=FamConfig(telemetry=telemetry),
                          axes=(grid_axis("candidate", values),
                                mix_axis(_mixes(True)))).plan()
    wfq = PolicySet(scheduler="wfq")
    plan_a = plan({"a": {"policies": wfq.override("scheduler", weight=2.0)},
                   "b": {"flags": SimFlags(bw_adapt=True)}, "c": {}})
    plan_b = plan({"a": {"policies": wfq.override("scheduler", weight=0.7, backlog_cap=800.0)},
                   "b": {"policies": PolicySet().override("adaptation", mimd_increase=1.3,
                                                          min_issue_rate=0.3)},
                   "c": {"flags": SimFlags(bw_adapt=True),
                         "policies": wfq.override("adaptation", ema_alpha=0.5)}})
    check(group_cache_keys(plan_a) == group_cache_keys(plan_b), "cache check: keys differ")
    executor._clear_exec_cache()
    a = execute(plan_a, assert_compiles=True, device=DEVICE)
    cached = execute(plan_b, assert_compiles=True, device=DEVICE)
    executor._clear_exec_cache()
    fresh = execute(plan_b, assert_compiles=True, device=DEVICE)
    check((a.info.compiles, cached.info.compiles, cached.info.exec_cache_hits,
           fresh.info.compiles) == (1, 0, 1, 1),
          f"cache check: captures {a.info.compiles} / {cached.info.compiles} / "
          f"{fresh.info.compiles}, hits {cached.info.exec_cache_hits}")
    moved = False
    for pa, pc, pf in zip(a.points, cached.points, fresh.points):
        mc, mf = cached.metrics_for(pc), fresh.metrics_for(pf)
        check(mc.keys() == mf.keys(), "cache check: metric keys")
        for k in mc:
            check(np.array_equal(mc[k], mf[k]),
                  f"cache check (telemetry {telemetry}): {pc.coords} {k} replayed from "
                  "the cached graph differs from a fresh capture")
        moved |= not np.array_equal(a.metrics_for(pa)["ipc"], mc["ipc"])
    check(moved, "cache check: plan b's params moved no row")
    print(f"search cache check (telemetry {telemetry}): {len(cached.points)} points of "
          f"{len(_mixes(True))} mixes at T {T_CHECK // 2}, another plan's traced params "
          f"replayed from the cached graph (0 captures, 1 hit) equal a fresh capture bit "
          f"for bit in every metric", flush=True)


def _split(out):
    from repro_torch.search import read_trajectory, split_records
    return split_records(read_trajectory(out / "trajectory.jsonl"))


def search_path(torch):
    """Phase 18: ``fig_search``'s quick run through its driver on numpy
    traces (the golden's trajectory and best.json, but for SEARCH_DRIFT's
    results) and on device traces
    (generation 1 within FIG_LOG_TOL of JAX's), every generation after
    the first with no capture and a cache hit a group, the replays
    matching; ``pond_tail`` over ``qos_space()`` (POND_SEARCH), its warm
    generation capturing nothing; the captures the cache saved over the
    whole run and its bytes; then the cache check. Returns the launches."""
    import tempfile
    from repro_torch.experiments import executor
    from repro_torch.search import run_search
    from repro_torch.tenants.search import PondObjective, qos_space
    gold = json.loads((ROOT / SEARCH_GOLDEN).read_text())
    total = 0
    empty_runner_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        summary, launches, wall = _search_run("numpy", tmp / "numpy",
                                              gold["run"]["generations"], gold["run"]["T"])
        total += launches
        lines = [_as_jax(x) for x in
                 (tmp / "numpy" / "trajectory.jsonl").read_text().splitlines()]
        best = _as_jax((tmp / "numpy" / "best.json").read_text())
        want = gold["numpy"]["trajectory"] + [gold["numpy"]["best"]]
        drift = _drift_values(gold["numpy"]["trajectory"])
        diffs, worst, loose = _golden_diffs(lines + [best], want, drift)
        check(not diffs, f"search numpy: the trajectory or best.json differs from JAX's "
              f"(drifting results beyond |log| {SEARCH_DRIFT_TOL}, anything else at all) "
              f"at {diffs[:10]}")
        controls = _golden_controls(want, drift)
        check(json.loads(best)["derived"] == json.loads(gold["numpy"]["best"])["derived"],
              "search numpy: best.json's derived string differs from JAX's")
        check([t["new_group_keys"] for t in summary["timings"]] ==
              gold["numpy"]["new_group_keys"], "search numpy: new group keys")
        check(all(t["host_trace_events"] == 0 for t in summary["timings"]),
              "search numpy: traces generated on the host (node seeds off the golden's)")
        digest = hashlib.sha256(b"".join((tmp / "numpy" / f).read_bytes() for f in
                                         ("trajectory.jsonl", "best.json"))).hexdigest()
        print(f"search numpy: {len(lines)} trajectory lines and best.json equal to JAX's "
              f"but for the kernel backend's name: {len(want) - len(loose)} of {len(want)} "
              f"byte for byte, lines {loose} (candidates {', '.join(SEARCH_DRIFT)}) with "
              f"their results within |log| {worst:.3e} (bound {SEARCH_DRIFT_TOL}; controls: "
              f"a drift float moved by 1.5 x the bound in line {controls['drift']} and a "
              f"result moved by one ulp in line {controls['exact']} both fail); the derived "
              f"string {summary['best']['derived']} equal, the replay matches; sha256 of "
              f"trajectory.jsonl + best.json {digest}; fused_cache_step launches "
              f"{launches}; command wall {wall:.3f} s", flush=True)
        summary, launches, wall = _search_run("device", tmp / "device",
                                              SEARCH_DEVICE_GENERATIONS,
                                              gold["device_gen1"]["T"])
        total += launches
        _, cands, _ = _split(tmp / "device")
        gen1 = [c for c in cands if c["gen"] == 1]
        want = gold["device_gen1"]["candidates"]
        check([c["sample"] for c in gen1] == [c["sample"] for c in want],
              "search device: generation 1's samples differ from JAX's")
        logs = 0.0
        for c, w in zip(gen1, want):
            check(c["per_mix"].keys() == w["per_mix"].keys(), "search device: mixes")
            pairs = [(c["per_mix"][k], w["per_mix"][k]) for k in w["per_mix"]]
            pairs.append((c["objective"], w["objective"]))
            logs = max([logs] + [abs(float(np.log(a / b))) for a, b in pairs])
        check(logs <= FIG_LOG_TOL, f"search device: generation 1 within |log| {logs:.5f} of "
              f"JAX's, above {FIG_LOG_TOL}")
        print(f"search device: generation 1's {len(gen1)} candidates, every per-mix uplift "
              f"and objective within |log| {logs:.5f} of JAX's; best "
              f"{summary['best']['derived']}, the replay matches; fused_cache_step launches "
              f"{launches}; command wall {wall:.3f} s", flush=True)
        reset_counts()
        t0 = time.perf_counter()
        pond = run_search(qos_space(), objective=PondObjective(), out_dir=tmp / "pond",
                          device=DEVICE, **POND_SEARCH)
        wall = time.perf_counter() - t0
        launches = counts()["fused_cache_step"]
        total += launches
        check(launches == sum(t["planned_groups"] for t in pond["timings"]) *
              POND_SEARCH["T"], f"pond_tail: fused_cache_step launched {launches} times")
        _generation_lines("pond_tail", pond["timings"], POND_SEARCH["T"])
        print(f"pond_tail: {POND_SEARCH['generations']} generations of "
              f"{POND_SEARCH['population']} over 16 tenants at T {POND_SEARCH['T']}, best "
              f"{pond['best']['objective']:.6f}; fused_cache_step launches {launches}; "
              f"wall {wall:.3f} s", flush=True)
    runners = list(executor._EXEC_CACHE.values())
    print(f"runner cache after the search: {len(runners)} runners holding "
          f"{executor.exec_cache_bytes()} bytes (buffers and graph pools; "
          f"{sum(r.pool_bytes for r in runners)} in pools), at most "
          f"{cache_tally['bytes']} bytes before an emptying in the earlier phases; "
          f"captures saved over the run: {cache_tally['hits'] + sum(r.calls - 1 for r in runners)} "
          f"(calls of cached runners after their first; "
          f"{sum(r.calls - 1 for r in runners)} in the search)", flush=True)
    for telemetry in (0, TELEMETRY_WINDOWS):
        _cache_check(telemetry)
    return total


# --------------------------------------------------------------------------
# phase analysis: the static analyzer over the port, the sync guard, and
# the capture counts the CompileWatcher saw in the guarded runs above
# --------------------------------------------------------------------------

#: the runs whose watched capture counts phase analysis must find
GUARDED_RUNS = tuple(f"{f} {b}" for f in FIGURES for b in ("numpy", "device")) + \
    tuple(f"{f} numpy" for f in NEW_FIGURES) + ("pond numpy", "pond device", "bench quick")


def analysis_path(torch):
    """(a) ``repro_torch.analysis`` strict over the port's tree: no finding
    reported; (b) the sync guard is live on the card: ``.item()`` of a CUDA
    tensor inside ``no_implicit_transfers()`` raises, inside
    ``explicit_fetch()`` it does not, and the previous mode comes back;
    (c) ``xla_compiles``, ``compiles`` and ``planned_groups`` of every
    guarded run above (each ran under the guard and the CompileWatcher,
    ``assert_compiles=True``)."""
    import io
    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.runtime import explicit_fetch, no_implicit_transfers
    out = io.StringIO()
    code = run_analysis([str(ROOT / "src" / "repro_torch")], strict=True, out=out)
    print(out.getvalue().strip(), flush=True)
    check(code == 0 and ", 0 reported [strict]" in out.getvalue(),
          "repro_torch.analysis reported findings on the port's tree")
    x = torch.arange(4, dtype=torch.float32, device=DEVICE)
    before = torch.cuda.get_sync_debug_mode()
    raised = None
    with no_implicit_transfers():
        try:
            x.sum().item()
        except RuntimeError as e:
            raised = str(e).splitlines()[0]
        with explicit_fetch():
            fetched = x.sum().item()
    check(raised is not None, ".item() of a CUDA tensor inside no_implicit_transfers() "
          "did not raise")
    check(fetched == 6.0 and torch.cuda.get_sync_debug_mode() == before,
          "explicit_fetch() did not allow the fetch, or the guard left its mode set")
    print(f"analysis: the guard raised on .item() ({raised!r}); explicit_fetch() fetched "
          f"{fetched}; mode {before} restored", flush=True)
    for what, watched, captures, planned in compile_records:
        print(f"analysis: {what}: xla_compiles {watched}, compiles {captures}, "
              f"planned_groups {planned}", flush=True)
    seen = {r[0] for r in compile_records}
    missing = [w for w in GUARDED_RUNS if not any(s.startswith(w) for s in seen)]
    check(not missing, f"no watched capture count for {missing}")
    return compile_records


# --------------------------------------------------------------------------
# phase examples: the four examples/torch_*.py on the card, at cut sizes
# --------------------------------------------------------------------------

#: script -> its arguments (sizes cut by them for time)
EXAMPLES = {
    "torch_quickstart.py": ["--T", "1000"],
    "torch_multinode_fam.py": ["--T", "1000"],
    "torch_serve_tiered.py": ["--context", "256", "--new-tokens", "8"],
    "torch_train_lm.py": ["--steps", "30", "--dmodel", "128", "--layers", "2"],
}
EXAMPLE_TIMEOUT_S = 240


def examples_path(torch):
    """The four examples as subprocesses on the card, all started together,
    at the cut sizes of EXAMPLES: each exits 0 and prints its closing line
    (quickstart / serve_tiered / train_lm ``OK``, multinode's sharded
    re-run bit-exact); their walls."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(script, tmp):
        extra = ["--ckpt-dir", tmp] if script == "torch_train_lm.py" else []
        t0 = time.perf_counter()
        # run() kills the script if it outlasts the timeout
        done = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device",
                               DEVICE, *EXAMPLES[script], *extra], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=EXAMPLE_TIMEOUT_S)
        return done.returncode, done.stdout, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(EXAMPLES)) as pool:
        futures = {script: pool.submit(run, script, tmp) for script in EXAMPLES}
        results = {script: f.result() for script, f in futures.items()}
    for script, (rc, out, wall) in results.items():
        print(f"example {script} {' '.join(EXAMPLES[script])}: rc {rc}, {wall:.1f} s",
              flush=True)
        for line in out.strip().splitlines()[-8:]:
            print(f"  {line}", flush=True)
        check(rc == 0, f"example {script} exited {rc}:\n{out[-3000:]}")
        closing = "sharded-vs-vmap bit_exact=True" if script == "torch_multinode_fam.py" \
            else f"{script[len('torch_'):-3]} OK"
        check(closing in out, f"example {script}: no {closing!r} in its output")
    return {s: r[2] for s, r in results.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print the profiler's op table of the grid's window")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    phases = Phases()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # the card's top SM clock, for the access chain's cycles an id
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    built = phases.run("build", build_all)
    for lib, log in built:
        print(f"built {lib.name}\n{log.strip()}", flush=True)
    hgmma = tensor_core_sass()
    print("HGMMA instructions in the SASS of flash_attention_wgmma_kernel: " +
          ", ".join(f"D {d}: {c}" for d, c in sorted(hgmma.items(), key=lambda x: int(x[0]))),
          flush=True)
    regs = tensor_core_registers(built)
    print("registers of flash_attention_wgmma_kernel at launch (ptxas -v; setmaxnreg then "
          "moves them to the consumers), spill stores / loads in bytes: " +
          ", ".join(f"D {d}: {r} registers, spills {st} / {ld}"
                    for d, (r, st, ld) in sorted(regs.items())), flush=True)
    utmaldg = paged_tma_sass()
    print(f"UTMALDG instructions in the SASS of paged_attention_kernel: {sum(utmaldg.values())} "
          f"in {len(utmaldg)} instantiations", flush=True)
    gen = torch.Generator().manual_seed(0)
    max_err, timing = phases.run("kernel_vs_plain", kernel_vs_plain, torch, gen)
    tiering = phases.run("tiering_kernels_vs_plain", tiering_kernels_vs_plain, torch, gen)
    tiering["tier_access"] = phases.run("access_vs_plain", access_vs_plain, torch)
    tiering["tier_access"].update(phases.run("access_timing", access_timing, torch, mhz))
    flash = phases.run("flash_attention_vs_plain", flash_vs_plain, torch)
    kv_launched, kv_call_s = phases.run("tiered_kv", tiered_kv_path, torch)
    phases.run("tiered_kv_profile", tiered_kv_profile, torch, kv_call_s)
    moe_launched = phases.run("expert_tiering", expert_path, torch)
    serve_launched, serve_prefill_s = phases.run("serving", serving_path, torch)
    phases.run("moe_serving", moe_serving_path, torch)
    family_launched = {phase: phases.run(phase, family_serving_path, torch, phase)
                       for phase in FAMILY_SERVING}
    family_launched["arctic_serving"] = phases.run("arctic_serving", moe_serving_path, torch,
                                                   "arctic_serving")
    print("flash_attention launches of the family and arctic serving paths (counted apart): " +
          ", ".join(f"{p} {n['flash_attention']}" for p, n in family_launched.items()),
          flush=True)
    dense_train = phases.run("train", train_path, torch)
    parallel_launched, sharded = phases.run("parallel", parallel_path, torch, dense_train)
    print(f"flash_attention launches of phase parallel's prefill (counted apart): "
          f"{parallel_launched['flash_attention']}; of its sharded prefill (e): "
          f"{sharded['launched']['flash_attention']}", flush=True)
    gen_s = seed_golden_traces()
    launches, _, replay_ms, grid_out = phases.run("main_path", main_path, torch)
    phases.run("backends_and_golden", backends_and_golden, torch)
    profiles = phases.run("graph_profile", graph_profiles, torch, args.profile, replay_ms)
    phases.run("device_traces", device_traces, torch)
    phases.run("figures", figures_path, torch, grid_out, gen_s)
    phases.run("figures_10_12_15", figures_path, torch, grid_out, gen_s, NEW_FIGURES,
               NEW_FIG_BACKENDS)
    phases.run("shard_executor", shard_executor_path, torch)
    _, fig12_plain = phases.run("policy_matrix", policy_matrix, torch)
    phases.run("telemetry", telemetry_path, torch, profiles, fig12_plain)
    phases.run("pond", pond_path, torch)
    benched = phases.run("bench", bench, torch)
    phases.run("search", search_path, torch)
    phases.run("roofline", roofline_path, torch, dense_train, serve_prefill_s,
               benched["roofline"])
    phases.run("analysis", analysis_path, torch)
    phases.run("examples", examples_path, torch)
    print("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phases.seconds.items()}))
    print(f"total: {sum(phases.seconds.values()):.3f} s in phases, "
          f"{time.perf_counter() - t_start:.3f} s wall")
    print(f"profiler windows: {len(lead_in_lost)}, lead-in records lost at their start "
          f"{sum(lead_in_lost)} of {LEAD_IN * len(lead_in_lost)} (per window, in order: "
          f"{lead_in_lost})")
    print(smi)
    rows = {"fused_cache_step": dict(
        launches=launches, max_abs_err=max_err, ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"], bound_by="bytes",
        library_ms=None)}
    for name, r in tiering.items():
        rows[name] = dict(launches=kv_launched[name] + moe_launched[name],
                          **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")})
    rows["flash_attention"] = dict(launches=serve_launched["flash_attention"],
                                   **{k: flash[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **row} for name, row in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
