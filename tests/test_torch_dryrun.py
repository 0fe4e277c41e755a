"""The port's dry run (`repro_torch.launch.dryrun`, the struct functions of
`launch.steps`) and `compress_bytes` against the JAX package on the CPU.

Everything of the reference comes from ONE subprocess for this module
(`_REFERENCE`, ``XLA_FLAGS`` of 512 host devices set there, as
`tests/test_dryrun.py` lowers in a subprocess): importing
`repro.launch.dryrun` sets ``XLA_FLAGS`` for its whole process, so this
worker never imports it.  Tolerance is zero throughout.

  * the HLO text parsers on the reference's HLO snippet plus scalar, tuple
    and ``-start`` lines;
  * the step arguments' struct trees of every cell of `cells()` on the 16x16
    mesh at full width, of four cells on the 2x16x16 mesh and of three
    ``optimized`` cells: leaf for leaf path, shape, dtype and sanitized
    spec; per-device argument (and donated) bytes against the sum of the
    reference's `shard_shape` bytes; ``param_bytes``, ``opt_bytes``,
    ``cache_bytes``;
  * the count itself: over ``meta`` equal to over real CPU tensors, exactly
    linear in ``repeats``, the recurrent archs' sequence extrapolation exact,
    and `run_cell` over ``meta`` for the ten archs at ``.reduced()`` (useful
    FLOPs never above the counted ones);
  * `moe.expert_counts` against `torch.bincount`;
  * the LZ4 cell over ``meta`` with the plain versions and the launchers
    made to raise;
  * `compress_bytes`: blocks equal to the reference's byte for byte, the
    deprecation warning, the round trip.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per test worker)
from repro_torch._tree import dtype_name, flatten_with_paths
from repro_torch.configs.base import SHAPES, ShapeConfig, all_arch_names, cells, get_config
from repro_torch.core import compressor
from repro_torch.core.corpus import adversarial_blocks
from repro_torch.core.decoder import decode_block
from repro_torch.core.lz4_types import MAX_BLOCK
from repro_torch.distributed.sharding import make_mesh, use_mesh
from repro_torch.kernels import _build
from repro_torch.kernels import fibhash as kfib
from repro_torch.kernels import match_extend as kext
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, moe
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parent.parent

# The reference's HLO snippet (tests/test_dryrun.py), plus scalar, tuple and
# async "-start" collectives and a convolution.
HLO = textwrap.dedent("""
    %x = f32[16,128]{1,0} parameter(0)
    %ag = f32[16,2048]{1,0} all-gather(f32[16,128]{1,0} %x), replica_groups={{0,1}}, dimensions={1}
    %ar = (bf16[256]{0}, bf16[256]{0}) all-reduce(bf16[256]{0} %a, bf16[256]{0} %b), to_apply=%sum
    %rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]{1,0} %y), dimensions={0}
    %cp = u8[1024]{0} collective-permute(u8[1024]{0} %z), source_target_pairs={{0,1}}
    %d = f32[64,32]{1,0} dot(f32[64,16]{1,0} %p, f32[16,32]{1,0} %q), lhs_contracting_dims={1}
    %notacoll = f32[4]{0} add(f32[4]{0} %m, f32[4]{0} %n)
""")
HLO_MORE = textwrap.dedent("""
    %s = f32[] all-reduce(f32[] %x), to_apply=%sum
    %t = (f32[4,4]{1,0}, s32[2]{0}) all-to-all(f32[4,4]{1,0} %a, s32[2]{0} %b), dimensions={0}
    %ags = (f32[8]{0}, f32[64]{0}) all-gather-start(f32[8]{0} %a), dimensions={0}
    %agd = f32[64]{0} all-gather-done((f32[8]{0}, f32[64]{0}) %ags)
    %ars = bf16[512]{0} all-reduce-start(bf16[512]{0} %g), to_apply=%sum
    %cps = (u32[16]{0}, u32[16]{0}) collective-permute-start(u32[16]{0} %c), source_target_pairs={{0,1}}
    %cv = bf16[8,30,30,16]{3,2,1,0} convolution(bf16[8,32,32,3]{3,2,1,0} %i, bf16[3,3,3,16]{3,2,1,0} %k), window={size=3x3}
    %dd = pred[] dot(pred[] %u, pred[] %v)
""")
TYPES = ["f32[16,128]{1,0}", "(bf16[256]{0}, s8[4]{0})", "pred[]", "pred[1,1,256]{1,0,2}",
         "f8e4m3fn[3,5]", "u64[]", "(f32[], s32[2,3]{1,0})", "f64[7]", "no shape here"]

# (arch, shape) on the 2x16x16 mesh: one train, prefill, decode, long_500k cell
MULTI_POD = [("internlm2-1.8b", "train_4k"), ("whisper-small", "prefill_32k"),
             ("mixtral-8x7b", "decode_32k"), ("recurrentgemma-9b", "long_500k")]
# (arch, shape) in the optimized posture on the 16x16 mesh
OPTIMIZED = [("qwen3-1.7b", "train_4k"), ("mixtral-8x7b", "prefill_32k"),
             ("gemma2-9b", "decode_32k")]


def _corpora() -> dict[str, bytes]:
    """`tests/test_lz4_jax.py`'s multi-block corpus and two adversarial ones."""
    adv = adversarial_blocks()
    return {
        "lz4_jax_multiblock": np.random.default_rng(7).integers(
            0, 8, 200_000, dtype=np.uint8).tobytes(),
        # the corpus's edge cases glued together, so every block boundary
        # cuts one of them somewhere else
        "adversarial_glued": b"".join(adv[k] for k in (
            "rle_to_boundary", "lit_ext_edge", "text", "short_13", "tile_straddle",
            "all_zero_short", "incompressible_short", "lit_nibble_edge3")),
        # a run across a block boundary, a block of exactly MAX_BLOCK, a short tail
        "runs_across_blocks": b"\x00" * (MAX_BLOCK + 3) + b"ab" * 40_000 + b"xyz",
    }


_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import functools, json, math, sys, warnings
    import jax
    from repro.configs.base import SHAPES, cells, get_config
    from repro.core.jax_compressor import compress_bytes
    from repro.distributed.sharding import use_mesh
    from repro.launch import steps
    from repro.launch.dryrun import (_shape_bytes, _tree_bytes, parse_collectives,
                                     parse_dot_bytes)
    from repro.launch.mesh import make_production_mesh
    from repro.models import lm

    req = json.load(open(sys.argv[1]))
    out = {"shape_bytes": [_shape_bytes(t) for t in req["types"]],
           "collectives": [parse_collectives(h) for h in req["hlo"]],
           "dot_bytes": [parse_dot_bytes(h) for h in req["hlo"]]}

    def spec(s):
        return [list(p) if isinstance(p, tuple) else p for p in s]

    def leaves(tree):
        rows = []
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "".join("/" + str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            rows.append([key, list(x.shape), str(x.dtype), spec(x.sharding.spec)])
        return rows

    def shard_bytes(tree):
        return sum(math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize
                   for x in jax.tree.leaves(tree))

    meshes = {False: make_production_mesh(), True: make_production_mesh(multi_pod=True)}

    def cell(arch, shape_name, multi_pod, optimized):
        mesh, cfg, shape = meshes[multi_pod], get_config(arch), SHAPES[shape_name]
        with use_mesh(mesh):
            if optimized:
                cfg = steps.optimized_config(cfg, shape, mesh)
            scfg = cfg if shape.mode == "train" else steps.serving_config(cfg, mesh)
            if shape.mode == "decode":
                args = steps.decode_state_structs(scfg, shape, mesh)
                donated = args[1]
            else:
                p, o, b = steps.train_state_structs(scfg, shape, mesh)
                args = (p, o, b) if shape.mode == "train" else (p, b)
                donated = (p, o) if shape.mode == "train" else ()
            params_s = jax.eval_shape(lambda: lm.init_params(jax.random.PRNGKey(0), scfg))
            rec = {"trees": [leaves(t) for t in args],
                   "param_bytes": _tree_bytes(params_s),
                   "argument_size_in_bytes": shard_bytes(args),
                   "alias_size_in_bytes": shard_bytes(donated)}
            if shape.mode == "train":
                rec["opt_bytes"] = 2 * rec["param_bytes"]
            if shape.mode == "decode":
                rec["cache_bytes"] = _tree_bytes(jax.eval_shape(functools.partial(
                    lm.init_cache, scfg, shape.global_batch, shape.seq_len)))
        return rec

    out["cells"] = {f"{a}|{s}|{int(m)}|{int(o)}": cell(a, s, m, o)
                    for a, s, m, o in req["cells"]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out["compress_bytes"] = {name: [b.hex() for b in compress_bytes(bytes.fromhex(h))]
                                 for name, h in req["corpora"].items()}
    print("RESULT:" + json.dumps(out))
""")


def _cell_key(arch, shape_name, multi_pod, optimized) -> str:
    return f"{arch}|{shape_name}|{int(multi_pod)}|{int(optimized)}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's parser outputs, struct trees and sizes of every cell
    here, and `compress_bytes` blocks, from one subprocess."""
    req = {"types": TYPES, "hlo": [HLO, HLO_MORE],
           "cells": ([(a, s, False, False) for a, s in cells()]
                     + [(a, s, True, False) for a, s in MULTI_POD]
                     + [(a, s, False, True) for a, s in OPTIMIZED]),
           "corpora": {k: v.hex() for k, v in _corpora().items()}}
    path = tmp_path_factory.mktemp("dryrun_ref") / "request.json"
    path.write_text(json.dumps(req))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                          capture_output=True, text=True, timeout=600, env=env,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")][0]
    return json.loads(line[len("RESULT:"):])


# -- the HLO text parsers ----------------------------------------------------------

def test_parsers_equal_reference(reference):
    assert [dryrun._shape_bytes(t) for t in TYPES] == reference["shape_bytes"]
    assert [dryrun.parse_collectives(h) for h in (HLO, HLO_MORE)] == reference["collectives"]
    assert [dryrun.parse_dot_bytes(h) for h in (HLO, HLO_MORE)] == reference["dot_bytes"]
    # the reference's own expectations (tests/test_dryrun.py) hold for the copy
    assert dryrun.parse_collectives(HLO)["all-gather"]["bytes"] == 16 * 2048 * 4
    assert dryrun.parse_dot_bytes(HLO) == (64 * 32 + 64 * 16 + 16 * 32) * 4


# -- the struct trees and the sizes of every cell -------------------------------------

def _spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s]


def _leaves(tree):
    return [[path, list(x.shape), dtype_name(x.dtype), _spec(x.sharding.spec)]
            for path, x in flatten_with_paths(tree)]


_MESHES = {}


def _meta_mesh(multi_pod: bool):
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod, device="meta")
    return _MESHES[multi_pod]


def _check_cell(reference, arch, shape_name, multi_pod, optimized):
    want = reference["cells"][_cell_key(arch, shape_name, multi_pod, optimized)]
    mesh, cfg, shape = _meta_mesh(multi_pod), get_config(arch), SHAPES[shape_name]
    with use_mesh(mesh):
        if optimized:
            cfg = steps.optimized_config(cfg, shape, mesh)
        scfg = cfg if shape.mode == "train" else steps.serving_config(cfg, mesh)
        if shape.mode == "decode":
            trees = steps.decode_state_structs(scfg, shape, mesh)
        else:
            p, o, b = steps.train_state_structs(scfg, shape, mesh)
            trees = (p, o, b) if shape.mode == "train" else (p, b)
    for got, exp in zip([_leaves(t) for t in trees], want["trees"], strict=True):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert g == e, (arch, shape_name, g, e)
        assert all(x.value.device.type == "meta" for _, x in flatten_with_paths(trees))
    # the record's byte entries, from the same structs
    _, sizes = dryrun.state_record(get_config(arch), shape, mesh, optimized)
    assert sizes["param_bytes"] == want["param_bytes"]
    assert sizes.get("opt_bytes") == want.get("opt_bytes")
    assert sizes.get("cache_bytes") == want.get("cache_bytes")
    assert sizes["memory"] == {"argument_size_in_bytes": want["argument_size_in_bytes"],
                               "alias_size_in_bytes": want["alias_size_in_bytes"]}


@pytest.mark.parametrize("arch,shape_name", cells())
def test_structs_equal_reference_single_pod(reference, arch, shape_name):
    _check_cell(reference, arch, shape_name, False, False)


@pytest.mark.parametrize("arch,shape_name", MULTI_POD)
def test_structs_equal_reference_multi_pod(reference, arch, shape_name):
    _check_cell(reference, arch, shape_name, True, False)


@pytest.mark.parametrize("arch,shape_name", OPTIMIZED)
def test_structs_equal_reference_optimized(reference, arch, shape_name):
    _check_cell(reference, arch, shape_name, False, True)


def test_shard_shape_divides_or_raises():
    mesh = make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)
    sh = steps.NamedSharding(mesh, steps.P(("data", "model"), None, "model"))
    assert sh.shard_shape((16, 3, 8)) == (2, 3, 2)
    assert steps.NamedSharding(mesh, steps.P()).shard_shape((5, 7)) == (5, 7)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((12, 3, 8))


# -- the count itself ------------------------------------------------------------

TINY_TRAIN = ShapeConfig("tiny_train", 32, 4, "train")


def _real_args(cfg, shape):
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(0, cfg, shape.global_batch, shape.seq_len, device="cpu")
    return params, adamw.init(params), batch


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b", "xlstm-125m"])
def test_meta_count_equals_cpu_count(arch):
    """The count over `meta` is the count over real CPU tensors (the step
    runs the same aten ops on both), on a (2, 2) mesh of each device."""
    cfg = get_config(arch).reduced()
    step = steps.make_train_step(cfg, adamw.AdamWConfig())
    counts = {}
    for dev in ("cpu", "meta"):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        with use_mesh(mesh):
            if dev == "cpu":
                args = _real_args(cfg, TINY_TRAIN)
                counts[dev] = dryrun.count(lambda: step(*args))[0]
            else:
                counts[dev] = dryrun.step_cost(cfg, TINY_TRAIN)[0]
    for key in ("flops", "dot_bytes"):
        assert counts["meta"][key] == counts["cpu"][key] > 0
    # Bytes too, but for `mask[:, -1] = 0.0` in `lm._assemble_inputs`: torch
    # turns that assignment into a `fill_` by a 0-d value on the CPU and into
    # a `copy_` of the value broadcast to B float32 (made by `scalar_tensor`)
    # on meta, which reads 4 * B bytes more.
    assert counts["meta"]["bytes"] - counts["cpu"]["bytes"] == 4 * TINY_TRAIN.global_batch


def test_count_exactly_linear_in_repeats():
    """Per-layer deltas of the count are equal (the reference's probe
    assumption, tests/test_dryrun.py::test_probe_linearity_subprocess)."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), fsdp=True)
    shape = ShapeConfig("t", seq_len=64, global_batch=8, mode="train")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    with use_mesh(mesh):
        c = [dryrun.step_cost(dryrun._with_repeats(cfg, [r]), shape)[0] for r in (2, 3, 4)]
    for key in ("flops", "bytes", "dot_bytes"):
        d1, d2 = c[1][key] - c[0][key], c[2][key] - c[1][key]
        assert d1 > 0 and d1 == d2, (key, c)


@pytest.mark.parametrize("mode,chunk", [("prefill", 256), ("train", 16)])
def test_sequence_extrapolation_exact(mode, chunk, monkeypatch):
    """The recurrent archs' extrapolation from three lengths equals a full
    trace at four chunks (xlstm at ``.reduced()``, B = 2).  Prefill steps by
    the real 256-token chunk; train, whose trace costs ~20x more, by 16
    tokens (its mLSTM then runs one chunk per sequence: the counts are
    still polynomials of degree 2 in the length, quadratic in bytes through
    the backward of the per-token slices)."""
    monkeypatch.setattr(dryrun, "SEQ_CHUNK", chunk)
    cfg = get_config("xlstm-125m").reduced()
    if mode == "prefill":
        cfg = steps.serving_config(cfg, make_mesh((1, 1), ("data", "model"), devices=["meta"]))
    shape = ShapeConfig("t", seq_len=4 * chunk, global_batch=2, mode=mode)
    got, lens = dryrun.step_cost(cfg, shape)
    assert lens == [chunk, 2 * chunk, 3 * chunk]
    assert got == dryrun.count_step(cfg, shape)


def test_traced_lengths():
    import inspect

    from repro_torch.models import recurrent
    # the chunk the extrapolation steps by is mlstm_block's
    assert inspect.signature(recurrent.mlstm_block).parameters["chunk"].default \
        == dryrun.SEQ_CHUNK == 256
    xlstm = get_config("xlstm-125m")
    assert dryrun.traced_lengths(xlstm, SHAPES["train_4k"]) == [256, 512, 768]
    assert dryrun.traced_lengths(xlstm, SHAPES["prefill_32k"]) == [256, 512, 768]
    assert dryrun.traced_lengths(xlstm, ShapeConfig("t", 768, 1, "train")) == [768]
    # attention archs and decode cells are traced at their own length
    assert dryrun.traced_lengths(get_config("qwen3-1.7b"), SHAPES["prefill_32k"]) == [32768]
    assert dryrun.traced_lengths(get_config("recurrentgemma-9b"),
                                 SHAPES["train_4k"]) == [4096]
    assert dryrun.traced_lengths(xlstm, SHAPES["long_500k"]) == [524288]


_ABSENT = ("compile_s", "collectives", "hlo_bytes", "probe_s")


def _zero_paths(x, path=""):
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in _zero_paths(v, f"{path}/{k}")]
    if isinstance(x, (int, float)) and not isinstance(x, bool) and x == 0:
        return [path]
    return []


@pytest.mark.parametrize("arch", all_arch_names())
def test_run_cell_over_meta_reduced(arch, monkeypatch):
    """`run_cell` over the 16x16 `meta` mesh for each arch at ``.reduced()``
    (train at B = 16, S = 16, whisper's reduced encoder length): a record with every count, none of the terms
    the port cannot count, and the useful FLOPs within the counted ones."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", {"train_4k": ShapeConfig("train_4k", 16, 16, "train")})
    rec = dryrun.run_cell(arch, "train_4k", False, verbose=False)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256 and rec["mode"] == "train"
    assert not [k for k in _ABSENT if k in rec]
    assert "temp_size_in_bytes" not in rec["memory"]
    assert "coll_bytes" not in rec["probe"]["total"]
    assert _zero_paths(rec) == []
    tot, glob = rec["probe"]["total"], rec["probe"]["global"]
    assert tot == {k: v / 256 for k, v in glob.items()}
    assert rec["cost"] == {"flops": tot["flops"], "bytes accessed": tot["bytes"]}
    assert rec["opt_bytes"] == 2 * rec["param_bytes"]
    cfg = get_config(arch).reduced()
    shape = dryrun.SHAPES["train_4k"]
    assert roofline.model_flops(cfg, shape, 1) <= glob["flops"]
    # json as the CLI writes it
    assert json.loads(json.dumps(rec)) == rec


def test_qwen3_train_4k_sizes_are_its_parameters():
    """qwen3-1.7b's train_4k cell at full width holds 1,720,574,976 float32
    parameters and their two moments (what `chip_smoke.py`'s `dryrun` phase
    holds against the card's allocation)."""
    mesh = _meta_mesh(False)
    _, sizes = dryrun.state_record(get_config("qwen3-1.7b"), SHAPES["train_4k"], mesh)
    n = 1_720_574_976
    assert sizes["param_bytes"] == 4 * n and sizes["opt_bytes"] == 8 * n


# -- MoE ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,n", [(8, 64), (4, 1), (16, 5000), (3, 0)])
def test_expert_counts_equal_bincount(E, n):
    flat_e = torch.from_numpy(np.random.default_rng(E * 1000 + n).integers(0, E, n))
    got = moe.expert_counts(flat_e, E)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.bincount(flat_e, minlength=E))
    assert moe.expert_counts(flat_e.to("meta"), E).shape == (E,)


# -- the LZ4 cell --------------------------------------------------------------------

def _refuse(*a, **k):
    raise AssertionError("the dry run called a plain version or a launcher")


def test_lz4_cell_over_meta_runs_no_plain_version_and_no_kernel(monkeypatch):
    for mod, name in ((kfib, "fibhash_plain"), (kfib, "_lib"), (kext, "match_extend_plain"),
                      (kext, "_lib"), (_build, "load"), (_build, "build_all")):
        monkeypatch.setattr(mod, name, _refuse)
    launches = (kfib.launches, kext.launches)
    rec = dryrun.run_lz4_cell(False, verbose=False)
    assert (kfib.launches, kext.launches) == launches
    assert rec["bytes_per_step"] == 8192 * 65536
    assert rec["shape"] == "blocks8192_associative" and rec["chips"] == 256
    P, B, M = MAX_BLOCK, MAX_BLOCK + compressor._PAD, 8192
    assert rec["kernels"] == {
        "fibhash": {"calls": 1, "bytes": M * (P + 3) + 2 * M * P * 4},
        "match_extend": {"calls": 1, "bytes": M * B + M * P * (4 + 1 + 4) + M * 4}}
    assert rec["probe"]["total"]["bytes"] * 256 == rec["probe"]["global"]["bytes"]
    assert "coll_bytes" not in rec["probe"]["total"]
    # the keys the roofline reads
    row = roofline.analyze_cell(json.loads(json.dumps(rec)))
    assert row["memory_s"] > 0 and row["collective_s"] is None and row["gbps_per_chip"] > 0


def test_wrappers_on_meta_report_bytes_and_cpu_still_runs_plain():
    class Counter:
        def __init__(self):
            self.calls = []

        def kernel(self, name, nbytes):
            self.calls.append((name, nbytes))

    c = Counter()
    _build.meta_counters.append(c)
    try:
        blocks = torch.empty((3, 100), dtype=torch.uint8, device="meta")
        words, hashes = kfib.fibhash(blocks, 90, 8)
        assert words.shape == hashes.shape == (3, 90) and words.dtype == torch.int32
        cand = torch.empty((3, 90), dtype=torch.int32, device="meta")
        valid = torch.empty((3, 90), dtype=torch.bool, device="meta")
        ns = torch.empty((3,), dtype=torch.int32, device="meta")
        out = kext.match_extend(blocks, cand, valid, ns, 36)
        assert out.shape == (3, 90) and out.device.type == "meta"
    finally:
        _build.meta_counters.remove(c)
    assert c.calls == [("fibhash", 3 * 93 + 2 * 3 * 90 * 4),
                       ("match_extend", 3 * 100 + 3 * 90 * 9 + 3 * 4)]
    rows = torch.from_numpy(np.random.default_rng(1).integers(0, 4, (2, 64), np.uint8))
    assert all(torch.equal(a, b) for a, b in zip(kfib.fibhash(rows, 60, 8),
                                                 kfib.fibhash_plain(rows, 60, 8)))


# -- compress_bytes ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_corpora()))
def test_compress_bytes_equals_reference(reference, name):
    data = _corpora()[name]
    with pytest.warns(DeprecationWarning, match="compress_bytes is deprecated; use "
                      "LZ4Engine.compress \\(framed\\) or LZ4Engine.compress_to_blocks"):
        blocks = compressor.compress_bytes(data, device="cpu")
    assert [b.hex() for b in blocks] == reference["compress_bytes"][name]
    assert len(blocks) == math.ceil(len(data) / MAX_BLOCK)
    assert b"".join(decode_block(b) for b in blocks) == data


def test_compress_bytes_round_trip_and_options():
    data = _corpora()["lz4_jax_multiblock"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        base = compressor.compress_bytes(data, device="cpu")
        # use_pallas is accepted and changes nothing; the associative select
        # writes the same blocks
        assert compressor.compress_bytes(data, use_pallas=True, scan_impl="associative",
                                         device="cpu") == base
        small = compressor.compress_bytes(data, hash_bits=6, max_match=12, device="cpu")
        assert compressor.compress_bytes(b"", device="cpu") == [b"\x00"]
    assert b"".join(decode_block(b) for b in small) == data
    assert sum(len(b) for b in base) < len(data)
