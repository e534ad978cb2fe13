"""The port's dry run (``repro_torch.launch.dryrun``, ``extension_cells``,
``perf_variants``) against the reference's.

* ``_needs_fsdp``, ``_wants_offload``, ``_pick_microbatches`` (data
  parallelism 16 and 32), ``model_flops_for``, ``make_context``'s rules,
  data axes and schedule (a two-axis and a three-axis mesh, both
  schedules), and the list of cells and skips for all ten configs and
  every ``--shape`` (``all`` and each name): equal to the reference's;
* one dense cell (granite-3-2b ``train_4k``) and one MoE cell
  (granite-moe-1b-a400m ``decode_32k``), each cut to 2 layers, on a 2 x 4
  mesh: the port's ``lower_cell`` on a fake process group of 8 ranks
  against the reference's ``lower_cell`` on 8 host devices.
  ``model_flops``, ``chips``, ``microbatches`` and the argument bytes are
  exactly equal; per-device flops within FLOPS_TOL (the port counts the
  ops it runs, XLA the ops it kept after fusion and simplification; the
  ratio is printed); the collective kinds present are listed;
* one xLSTM cell (xlstm-350m ``train_4k`` at 2 layers, its sequence cut
  to XLSTM_SEQ tokens) on a 1 x 8 mesh, whose model axis does not divide
  the config's 4 heads: the port's ``run_cell`` records ``ok``, and the
  record is held to the reference's ``lower_cell`` as the cells above,
  but for the per-device flops: the port splits the mLSTM recurrence
  along Dv, takes the up projection's weight gradient on each rank's
  columns and the unembedding's by vocab, where XLA's partitioning keeps
  more of the work whole, so its count is XLSTM_FLOPS_RATIO times the
  reference's (within FLOPS_TOL);
* the extension cell and each perf variant at the cut size (2 layers;
  the arctic variants at 1 layer on a 16 x 2 mesh, which keeps each
  rank's MoE token chunks few, as their microbatches run the layers up
  to 8 times; xlstm's chunked variant at a 128-token sequence, its sLSTM
  stepping once a token) write records with the reference's keys, and
  only under ``--out``.

The reference runs in one JAX subprocess with
``--xla_force_host_platform_device_count=8`` and ``make_production_mesh``
patched to the 2 x 4 mesh (its ``launch/dryrun.py`` sets ``XLA_FLAGS``
when imported, so no test process imports it); the port's cells run in
subprocesses of their own (the fake group becomes the process's
default group), split over four subprocesses, all started together.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun as DR
from test_torch_moe_ep import _env

REPO = Path(__file__).resolve().parents[1]
LAYERS = 2
MESH = (2, 4)
CELLS = {"dense": ("granite-3-2b", "train_4k"), "moe": ("granite-moe-1b-a400m", "decode_32k")}
#: the xLSTM cell: 4 heads on a model axis of 8, a sequence cut for the
#: sLSTM's step a token
XLSTM_CELL, XLSTM_MESH, XLSTM_SEQ = ("xlstm-350m", "train_4k"), (1, 8), 16
#: the xLSTM cell's per-device flops, port over reference: both count
#: the same work on one device (within 0.4 %); on the 8 model ranks the
#: port keeps 1.44 times an eighth of it (the sLSTM's gathered input
#: projection), XLA 1.94 times
XLSTM_FLOPS_RATIO = 0.743
FLOPS_TOL = 0.10          # |port / reference - 1| of the per-device flops
SHAPE_ARGS = ("all", "train_4k", "prefill_32k", "decode_32k", "long_500k")
# the reference record's keys the port replaces: XLA's lower / compile
# seconds by the port's build / counted-run seconds (``seconds`` where
# perf_variants records its own)
TIMES = {"lower_s": "build_s", "compile_s": "run_s"}
#: keys the port's records add: the fake mesh's seconds
ADDED = {"mesh_s"}

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax
    from repro.configs.base import ALL_SHAPES
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.launch import dryrun as DR
    from repro.parallel.compat import make_mesh
    layers, cells, shape_args = int(sys.argv[2]), json.loads(sys.argv[3]), json.loads(sys.argv[4])
    devs = jax.devices()
    DR.make_production_mesh = lambda multi_pod=False: make_mesh((2, 4), ("data", "model"),
                                                                devices=devs[:8])
    meshes = {"2": make_mesh((2, 4), ("data", "model"), devices=devs[:8]),
              "3": make_mesh((2, 2, 2), ("pod", "data", "model"), devices=devs[:8])}
    out = {"rules": {}, "cells": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            key = f"{arch}/{shape.name}"
            out["rules"][key] = {
                "fsdp": DR._needs_fsdp(cfg), "offload": DR._wants_offload(cfg),
                "mb": [DR._pick_microbatches(cfg, shape, dp) for dp in (16, 32)],
                "model_flops": DR.model_flops_for(cfg, shape),
                "ctx": {f"{m}/{s}": [ctx.rules, list(ctx.dp_axes), ctx.attn_schedule]
                        for m, mesh in meshes.items() for s in ("rect", "grouped")
                        for ctx in [DR.make_context(cfg, shape, mesh, schedule=s)]}}
        for arg in shape_args:
            names = [s.name for s in cfg.shapes()] if arg == "all" else arg.split(",")
            out["cells"][f"{arch}/{arg}"] = [[n, n in cfg.skipped_shapes()] for n in names]
    old = DR.get_config
    DR.get_config = lambda a: dataclasses.replace(old(a), num_layers=layers)
    out["lowered"] = {}
    for kind, (arch, shape) in cells.items():
        compiled, info = DR.lower_cell(arch, shape, False)
        out["lowered"][kind] = info
    (arch, shape), xmesh, xseq = json.loads(sys.argv[5])
    DR.make_production_mesh = lambda multi_pod=False: make_mesh(tuple(xmesh), ("data", "model"),
                                                                devices=devs[:8])
    DR.SHAPES_BY_NAME = {**DR.SHAPES_BY_NAME,
                         shape: dataclasses.replace(DR.SHAPES_BY_NAME[shape], seq_len=xseq)}
    out["lowered"]["xlstm"] = DR.lower_cell(arch, shape, False)[1]
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")

PORT_CELLS = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as DR
    layers, cells, mesh = int(sys.argv[2]), json.loads(sys.argv[3]), tuple(json.loads(sys.argv[4]))
    out = {}
    for kind, (arch, shape) in cells.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        counter, info = DR.lower_cell(arch, shape, cfg=cfg, mesh_shape=mesh, device="cpu")
        out[kind] = info
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")

PORT_VARIANTS = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import extension_cells as EC, perf_variants as PV
    part, layers, mesh, out_dir = (sys.argv[2], int(sys.argv[3]), tuple(json.loads(sys.argv[4])),
                                   sys.argv[5])
    cut = lambda arch, n=layers, **kw: dataclasses.replace(get_config(arch), num_layers=n, **kw)
    infos = {}
    if part == "qwen":
        infos["ext"] = EC.long_context_decode(out_dir, cfg=cut("yi-9b", run_long_context=True),
                                              mesh_shape=mesh, device="cpu")
        for which in ("qwen-buffered", "qwen-buffered-int8", "qwen-f32probe", "grouped-prefill"):
            infos[which] = PV.run(which, out=out_dir, cfg=cut("qwen2-vl-72b"), mesh_shape=mesh,
                                  device="cpu")
    elif part == "arctic":
        for which in PV.ARCTIC:
            infos[which] = PV.run(which, out=out_dir, cfg=cut("arctic-480b", 1),
                                  mesh_shape=(16, 2), device="cpu")
    else:
        infos["xlstm-chunked"] = PV.xlstm_chunked(out=out_dir, cfg=cut("xlstm-350m"),
                                                  mesh_shape=mesh, seq_len=128, device="cpu")
    with open(sys.argv[1], "w") as f:
        json.dump(infos, f)
""")
PORT_XLSTM = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as DR
    layers, ((arch, shape), mesh, seq) = int(sys.argv[2]), json.loads(sys.argv[3])
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    info = DR.run_cell(arch, shape, False, None, cfg=cfg, mesh_shape=tuple(mesh), seq_len=seq,
                       device="cpu")
    with open(sys.argv[1], "w") as f:
        json.dump({"xlstm": info}, f)
""")
#: the variants' runs, split over subprocesses that run together
PARTS = ("qwen", "arctic", "xlstm")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    files = {k: tmp / f"{k}.json" for k in ("reference", "cells", "xcell") + PARTS}
    xlstm = json.dumps([XLSTM_CELL, XLSTM_MESH, XLSTM_SEQ])
    procs = {
        "reference": [REFERENCE, files["reference"], LAYERS, json.dumps(CELLS),
                      json.dumps(SHAPE_ARGS), xlstm],
        "cells": [PORT_CELLS, files["cells"], LAYERS, json.dumps(CELLS), json.dumps(MESH)],
        "xcell": [PORT_XLSTM, files["xcell"], LAYERS, xlstm],
        **{part: [PORT_VARIANTS, files[part], part, LAYERS, json.dumps(MESH), tmp / "out"]
           for part in PARTS},
    }
    started = {k: subprocess.Popen([sys.executable, "-c"] + [str(a) for a in argv],
                                   env=_env(), cwd=tmp, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT)
               for k, argv in procs.items()}
    logs = {k: p.communicate(timeout=600)[0].decode() for k, p in started.items()}
    for k, p in started.items():
        assert p.returncode == 0, logs[k][-6000:]
    out = {k: json.loads(f.read_text()) for k, f in files.items()}
    out["variants"] = {k: v for part in PARTS for k, v in out.pop(part).items()}
    out["cells"].update(out.pop("xcell"))
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_reference(runs, arch):
    ref = runs["reference"]["rules"]
    from repro_torch.configs.base import ALL_SHAPES
    from repro_torch.parallel.compat import Mesh
    meshes = {"2": Mesh((2, 4), ("data", "model")),
              "3": Mesh((2, 2, 2), ("pod", "data", "model"))}
    assert sorted(ref) == sorted(f"{a}/{s.name}" for a in ARCH_IDS for s in ALL_SHAPES)
    cfg = get_config(arch)
    for shape in ALL_SHAPES:
        want = ref[f"{arch}/{shape.name}"]
        assert DR._needs_fsdp(cfg) == want["fsdp"]
        assert DR._wants_offload(cfg) == want["offload"]
        assert [DR._pick_microbatches(cfg, shape, dp) for dp in (16, 32)] == want["mb"]
        assert DR.model_flops_for(cfg, shape) == want["model_flops"]
        for m, mesh in meshes.items():
            for s in ("rect", "grouped"):
                ctx = DR.make_context(cfg, shape, mesh, schedule=s)
                rules = {k: list(v) if isinstance(v, tuple) else v
                         for k, v in ctx.rules.items()}
                assert [rules, list(ctx.dp_axes), ctx.attn_schedule] == \
                    want["ctx"][f"{m}/{s}"], (shape.name, m, s)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_skips_equal_reference(runs, arch):
    ref = runs["reference"]["cells"]
    for arg in SHAPE_ARGS:
        got = [[n, skipped] for a, n, skipped in DR.cells([arch], arg)]
        assert got == ref[f"{arch}/{arg}"], arg


def test_meshes():
    """Single and multi-pod run the same cells; the mesh sets the record's
    ``mesh`` and ``chips``."""
    assert DR.mesh_tag(False) == "16x16" and DR.mesh_tag(True) == "2x16x16"
    assert DR.chips_of(DR.POD1[0]) == 256 and DR.chips_of(DR.POD2[0]) == 512
    assert DR.mesh_axes((16, 16)) == ("data", "model")
    assert DR.mesh_axes((2, 16, 16)) == ("pod", "data", "model")


@pytest.mark.parametrize("kind", sorted(CELLS) + ["xlstm"])
def test_cell_against_reference(runs, kind):
    ref = runs["reference"]["lowered"][kind]
    got = dict(runs["cells"][kind])
    if kind == "xlstm":                 # run_cell's record: its status and seconds
        assert got.pop("status") == "ok", got.get("error")
        got.pop("seconds")
        assert get_config(XLSTM_CELL[0]).num_heads % XLSTM_MESH[1]
    assert got["chips"] == ref["chips"] == 8
    assert got["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert got.get("microbatches") == ref.get("microbatches")
    assert got["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    assert set(got["memory"]) == set(ref["memory"])
    assert set(got["roofline"]) == set(ref["roofline"])
    assert set(got) == {TIMES.get(k, k) for k in ref} | ADDED
    ratio = got["roofline"]["flops_per_device"] / ref["roofline"]["flops_per_device"]
    print(f"{kind} {CELLS.get(kind, XLSTM_CELL)}: per-device flops port / reference = {ratio:.4f}; "
          f"collective kinds port {sorted(got['roofline']['coll_bytes'])}, reference "
          f"{sorted(ref['roofline']['coll_bytes'])}; peak bytes port "
          f"{got['memory']['peak_device_bytes']}, reference "
          f"{ref['memory']['peak_device_bytes']}")
    want = XLSTM_FLOPS_RATIO if kind == "xlstm" else 1.0
    assert abs(ratio / want - 1) < FLOPS_TOL, ratio
    assert got["roofline"]["xla_flops_once"] == got["roofline"]["flops_per_device"]


# record file under --out -> (the run that wrote it, the reference's keys:
# "dense" / "moe" a lowered cell's, "buffered" perf_variants.record's)
RECORDS = {
    "extensions/yi-9b__long_500k.json": ("ext", "moe"),
    "qwen2-vl-72b__decode_32k__buffered_w64.json": ("qwen-buffered", "buffered"),
    "qwen2-vl-72b__decode_32k__buffered_w64_int8.json": ("qwen-buffered-int8", "buffered"),
    "qwen2-vl-72b__decode_32k__f32probe.json": ("qwen-f32probe", "moe"),
    "qwen2-vl-72b__prefill_32k__grouped.json": ("grouped-prefill", "moe"),
    "arctic-480b__train_4k__cf10.json": ("cf10", "dense"),
    "arctic-480b__train_4k__gradsync.json": ("gradsync", "dense"),
    "arctic-480b__train_4k__combined.json": ("combined", "dense"),
    "xlstm-350m__train_4k__chunked128.json": ("xlstm-chunked", "dense"),
}
# perf_variants.record's keys (the reference's ``perf_variants.py:45-52``
# and the buffered variant's extra, ``:120-124``), its compile seconds
# the port's ``seconds``
BUFFERED = {"cell", "variant", "roofline", "peak_device_bytes", "seconds",
            "flush_memory_s", "flush_amortized_memory_s"}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_record_has_reference_keys(runs, name):
    which, like = RECORDS[name]
    lowered = runs["reference"]["lowered"]
    rec = json.loads((runs["tmp"] / "out" / name).read_text())
    assert rec == runs["variants"][which]
    if like == "buffered":
        keys = BUFFERED
    else:
        keys = {TIMES.get(k, k) for k in lowered[like]} | ADDED
        if which == "ext":                      # run_cell's status and seconds
            keys |= {"status", "seconds"}
    assert set(rec) == keys
    assert set(rec["roofline"]) == set(lowered["dense"]["roofline"])
    assert rec.get("status", "ok") == "ok", rec.get("error")


def test_variants_write_only_under_out(runs):
    out = runs["tmp"] / "out"
    infos = runs["variants"]
    written = sorted(str(p.relative_to(out)) for p in out.rglob("*.json"))
    assert written == sorted(RECORDS)
    assert infos["gradsync"]["microbatches"] == 4 and infos["combined"]["microbatches"] == 8
    assert infos["qwen-buffered-int8"]["variant"] == "buffered_w64_int8"
    # nothing else in the runs' directory but the records and the outputs
    assert sorted(p.name for p in runs["tmp"].iterdir()) == \
        sorted(["out"] + [f"{k}.json" for k in ("reference", "cells", "xcell") + PARTS])
