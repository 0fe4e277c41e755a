"""The dry run: every (arch x shape x mesh) cell traced over ``meta`` tensors.

The port of the JAX package's `launch/dryrun.py`.  For each cell this builds
the step's arguments as `steps.Struct`s — ``meta`` tensors (shapes and
dtypes, no storage) with the `NamedSharding` of each — on the production
mesh of repeated ``meta`` devices (`make_production_mesh(device="meta")`,
the counterpart of the reference's 512 forced host devices), so no array is
ever allocated, then runs the REAL step function over them (the train step
for train shapes, prefill or a decode step for serving shapes) and records
what it can count:

  * ``param_bytes``, ``opt_bytes`` (train) and ``cache_bytes`` (decode):
    global bytes of the parameters, of AdamW's m and v, of the cache, exact
    from their shapes;
  * ``memory.argument_size_in_bytes``: the bytes of ONE device's shards of
    every argument of the step (`NamedSharding.shard_shape`);
    ``memory.alias_size_in_bytes``: the same for the donated arguments
    (params and optimizer state for train, the cache for decode; prefill
    donates none);
  * ``cost.flops``: the FLOPs `torch.utils.flop_counter.FlopCounterMode`
    counts over the trace — matmul-class ops (mm, bmm, addmm, baddbmm,
    convolution, attention); elementwise ops count none;
  * ``cost["bytes accessed"]``: operand bytes plus result bytes of every
    aten op the trace runs, each op on its own (unfused, like XLA:CPU's
    figure that the reference records); view ops and allocations move no
    bytes and count none; a hand kernel's wrapper on ``meta`` adds the bytes
    its kernel would move (each input and output once);
  * ``probe.total``: ``flops``, ``bytes`` and ``dot_bytes`` (operand and
    result bytes of the matmul-class ops alone).  The trace runs the cell's
    GLOBAL batch once; every per-device figure (``cost``, ``probe.total``)
    is the global count divided by ``chips``, the share of one device under
    an even split.  ``probe.global`` keeps the global counts.

Where the reference asks a compiler, the port reports what it can count and
leaves the rest out: there are no temp or generated-code bytes (the port has
no compiler) and no collectives (the port runs none: `constrain` is the
identity), so ``compile_s``, ``collectives``, ``hlo_bytes``,
``memory.temp_size_in_bytes`` and ``probe.total.coll_bytes`` are absent
from every record — never 0, never estimated.

The port's layers run as a Python loop, so a trace at full depth is exact
and needs no repeats probe (`_with_repeats` is kept for the linearity
check).  Where the trace itself grows with the sequence — the mLSTM and
sLSTM loops of `models/recurrent.py` — train and prefill cells longer than
three mLSTM chunks are traced at 256, 512 and 768 tokens and extrapolated
(`step_cost`), which is exact there: every count is a polynomial of degree
at most 2 in the length over whole chunks.  ``probe.seq_lens`` lists the
lengths traced.

Results are one JSON per cell under experiments/torch_dryrun/.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._tree import flatten
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cells, get_config
from repro_torch.core.compressor import _PAD, compress_blocks_records
from repro_torch.core.lz4_types import MAX_BLOCK
from repro_torch.distributed.sharding import use_mesh
from repro_torch.kernels import _build
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "torch_dryrun")

# ---------------------------------------------------------------------------
# HLO text parsers: copies of the reference's (pure text functions).
# ---------------------------------------------------------------------------

_COLL_RE = re.compile(
    r"=\s*([a-z0-9\[\],{}() ]*?)\b"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", re.IGNORECASE,
)
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|f8e4m3fn|f8e5m2|s64|s32|s16|s8|u64|u32|u16|u8|pred)\[([0-9,]*)\]")

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "u8": 1, "pred": 1,
}


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Sum per-device result bytes of every collective op in the HLO."""
    stats: dict[str, dict] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        op = m.group(2).lower()
        # result type(s): everything on the line up to the opcode
        head = line.split("=", 1)
        res_bytes = _shape_bytes(head[1].split(m.group(2))[0]) if len(head) > 1 else 0
        s = stats.setdefault(op, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += res_bytes
    return stats


_DOT_RE = re.compile(r"=\s*[a-z0-9\[\],{} ]+?\s(dot|convolution)\(")


def parse_dot_bytes(hlo_text: str) -> int:
    """Operand+result bytes of every dot — the fused-TPU memory-term floor.

    XLA:CPU barely fuses elementwise chains, so raw `bytes accessed` reflects
    CPU lowering, not TPU HBM traffic; on TPU everything except matmul
    streams, collectives and layer-boundary tensors lives in fused kernels.
    """
    total = 0
    for line in hlo_text.splitlines():
        if not _DOT_RE.search(line):
            continue
        for m in _SHAPE_RE.finditer(line):
            n = 1
            if m.group(2):
                for d in m.group(2).split(","):
                    n *= int(d)
            total += n * _DTYPE_BYTES[m.group(1)]
    return total


# ---------------------------------------------------------------------------
# Counting a trace
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that allocate without moving a byte
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
                _aten.new_empty_strided}
# the matmul-class ops whose bytes make `dot_bytes`
_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.addbmm,
         _aten.convolution, _aten.convolution_backward}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _ByteCount(TorchDispatchMode):
    """Operand + result bytes of every aten op run under it (views and
    allocations excepted), of the matmul-class ones alone, and of the hand
    kernels that wrappers on ``meta`` report (`_build.count_meta_call`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.dot_bytes = 0
        self.kernels: dict[str, dict] = {}

    def __enter__(self):
        _build.meta_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.meta_counters.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if not func.is_view and packet not in _ALLOCATIONS:
            n = _nbytes((args, kwargs, out))
            self.bytes += n
            if packet in _DOTS:
                self.dot_bytes += n
        return out


def count(fn) -> tuple[dict, dict]:
    """Run ``fn()`` and count it: ``({"flops", "bytes", "dot_bytes"},
    {kernel: {"calls", "bytes"}})``."""
    flops = FlopCounterMode(display=False)
    with flops, _ByteCount() as nbytes:
        fn()
    return ({"flops": int(flops.get_total_flops()), "bytes": nbytes.bytes,
             "dot_bytes": nbytes.dot_bytes}, nbytes.kernels)


def _tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in flatten(tree)[0])


def _shard_bytes(tree) -> int:
    """Bytes of one device's shards of every `steps.Struct` in ``tree``."""
    return sum(math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize
               for s in flatten(tree)[0])


def _with_repeats(cfg: ModelConfig, reps: list[int]) -> ModelConfig:
    segs = tuple(
        dataclasses.replace(s, repeats=r) for s, r in zip(cfg.segments, reps)
    )
    return dataclasses.replace(
        cfg, segments=segs, unroll_layers=True,
        n_layers=sum(len(s.unit) * s.repeats for s in segs),
    )


# Layer kinds whose trace loops over the sequence (`models/recurrent.py`:
# sLSTM once per token, mLSTM once per chunk of `mlstm_block`'s 256).
_SEQ_LOOP_KINDS = ("mlstm", "slstm")
SEQ_CHUNK = 256


def traced_lengths(cfg: ModelConfig, shape: ShapeConfig) -> list[int]:
    """The sequence lengths a cell is traced at: its own, or three whole
    mLSTM chunks' worth to extrapolate from (see the module docstring)."""
    loops = any(spec.kind in _SEQ_LOOP_KINDS for seg in cfg.segments for spec in seg.unit)
    S = shape.seq_len
    if not loops or shape.mode == "decode" or S <= 3 * SEQ_CHUNK or S % SEQ_CHUNK:
        return [S]
    return [SEQ_CHUNK, 2 * SEQ_CHUNK, 3 * SEQ_CHUNK]


def _step_args(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    params = lm.init_params(cfg, device="meta")
    B = shape.global_batch
    if shape.mode == "decode":
        return (params, lm.init_cache(cfg, B, shape.seq_len, device="meta"),
                torch.empty((B,), dtype=torch.int32, device="meta"))
    batch = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in input_specs(cfg, shape).items()}
    return (params, adamw.init(params), batch) if shape.mode == "train" else (params, batch)


def _run_step(cfg: ModelConfig, shape: ShapeConfig, args: tuple) -> None:
    if shape.mode == "train":
        steps_mod.make_train_step(cfg, adamw.AdamWConfig())(*args)
    elif shape.mode == "prefill":
        steps_mod.make_prefill_step(cfg, cache_len=shape.seq_len + 128)(*args)
    else:
        # `decode_step` reads its position on the host, which a meta tensor
        # cannot give; the step scores every cache slot whatever it is
        params, cache, tokens = args
        lm.decode_step(params, cache, tokens, shape.seq_len - 1, cfg)


def count_step(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Global counts of one step of ``cfg`` at ``shape`` over ``meta``
    arguments (under the current mesh), the arguments' making not counted."""
    args = _step_args(cfg, shape)
    return count(lambda: _run_step(cfg, shape, args))[0]


def step_cost(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, list[int]]:
    """Global counts of one step of ``cfg`` at ``shape`` (under the current
    mesh), extrapolated where `traced_lengths` says, and the lengths traced.

    The extrapolation is the quadratic through the three traced lengths
    (Newton's forward differences, in integers): exact for every count that
    is a polynomial of degree at most 2 in the length over whole chunks —
    FLOPs and matmul bytes are linear there; the backward of the per-token
    slices writes a full-length gradient per token, so bytes are quadratic.
    """
    lens = traced_lengths(cfg, shape)
    counts = [count_step(cfg, dataclasses.replace(shape, seq_len=s)) for s in lens]
    if len(lens) == 1:
        return counts[0], lens
    t = (shape.seq_len - lens[0]) // (lens[1] - lens[0])
    c0, c1, c2 = counts
    return {key: c0[key] + t * (c1[key] - c0[key])
            + t * (t - 1) // 2 * (c2[key] - 2 * c1[key] + c0[key])
            for key in c0}, lens


def _per_device(tot: dict, chips: int) -> dict:
    return {k: v / chips for k, v in tot.items()}


def state_record(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 optimized: bool = False) -> tuple[ModelConfig, dict]:
    """(the config the cell's step runs, its byte entries: ``param_bytes``,
    ``opt_bytes`` or ``cache_bytes``, ``memory``), from the step's `Struct`s
    on ``mesh``."""
    with use_mesh(mesh):
        if optimized:
            cfg = steps_mod.optimized_config(cfg, shape, mesh)
        scfg = cfg if shape.mode == "train" else steps_mod.serving_config(cfg, mesh)
        if shape.mode == "decode":
            args = steps_mod.decode_state_structs(scfg, shape, mesh)
            donated = args[1]
        else:
            args = steps_mod.train_state_structs(scfg, shape, mesh)
            if shape.mode == "prefill":
                args = (args[0], args[2])
            donated = args[:2] if shape.mode == "train" else ()
    rec = {"param_bytes": _tree_bytes(args[0])}
    if shape.mode == "train":
        rec["opt_bytes"] = 2 * rec["param_bytes"]
    if shape.mode == "decode":
        rec["cache_bytes"] = _tree_bytes(args[1])
    rec["memory"] = {"argument_size_in_bytes": _shard_bytes(args),
                     "alias_size_in_bytes": _shard_bytes(donated)}
    return scfg, rec


def dry_run(cfg: ModelConfig, shape: ShapeConfig, mesh, optimized: bool = False) -> dict:
    """The record of one cell on ``mesh`` (see the module docstring), less
    the names `run_cell` adds."""
    chips = mesh.size
    rec: dict = {"optimized": optimized, "chips": chips, "mode": shape.mode,
                 "time": time.time()}
    t0 = time.time()
    scfg, sizes = state_record(cfg, shape, mesh, optimized)
    rec.update(sizes)
    with use_mesh(mesh):
        tot, lens = step_cost(scfg, shape)
    rec["lower_s"] = time.time() - t0
    per_dev = _per_device(tot, chips)
    rec["cost"] = {"flops": per_dev["flops"], "bytes accessed": per_dev["bytes"]}
    rec["probe"] = {"total": per_dev, "global": tot, "seq_lens": lens}
    return rec


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             optimized: bool = False) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
           **dry_run(get_config(arch), SHAPES[shape_name], mesh, optimized)}
    if verbose:
        print(
            f"[dryrun] {arch} {shape_name} {rec['mesh']}: "
            f"trace {rec['lower_s']:.1f}s flops/dev {rec['cost']['flops']:.3e} "
            f"bytes/dev {rec['cost']['bytes accessed']:.3e}",
            flush=True,
        )
    return rec


def run_lz4_cell(multi_pod: bool, scan_impl: str = "associative", blocks: int = 8192,
                 hash_bits: int = 8, candidate_impl: str = "sort",
                 verbose: bool = True) -> dict:
    """Dry-run the paper's own workload: `compress_blocks_records` over a
    batch of ``blocks`` padded 64 KB blocks, split evenly over every mesh
    axis (embarrassingly parallel), traced over ``meta`` tensors.  The
    staged path's hand kernels (`fibhash`, `match_extend`) launch nothing
    there and report their bytes; ``kernels`` counts their calls.  The
    path runs no matmul-class op, so its counted FLOPs are 0."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rec = {
        "arch": "lz4-engine", "shape": f"blocks{blocks}_{scan_impl}"
        + ("_scatter" if candidate_impl == "scatter" else ""),
        "mesh": _mesh_name(multi_pod), "chips": mesh.size,
        "mode": "compress", "time": time.time(),
        "bytes_per_step": blocks * MAX_BLOCK,
    }

    def step():
        out = compress_blocks_records(
            torch.empty((blocks, MAX_BLOCK + _PAD), dtype=torch.uint8, device="meta"),
            torch.empty((blocks,), dtype=torch.int32, device="meta"),
            hash_bits=hash_bits, scan_impl=scan_impl, candidate_impl=candidate_impl)
        return out.size.to(torch.int64).sum(), out.emit.sum()

    t0 = time.time()
    with use_mesh(mesh):
        tot, kernels = count(step)
    rec["lower_s"] = time.time() - t0
    per_dev = _per_device({"flops": tot["flops"], "bytes": tot["bytes"]}, mesh.size)
    rec["cost"] = dict(per_dev)
    rec["kernels"] = kernels
    rec["probe"] = {"total": per_dev,  # same schema as LM cells for the roofline reader
                    "global": {"flops": tot["flops"], "bytes": tot["bytes"]}}
    if verbose:
        print(
            f"[dryrun] lz4-engine {rec['shape']} {rec['mesh']}: "
            f"trace {rec['lower_s']:.1f}s flops/dev {per_dev['flops']:.3e} "
            f"bytes/dev {per_dev['bytes']:.3e}",
            flush=True,
        )
    return rec


def cell_path(arch: str, shape_name: str, multi_pod: bool, optimized: bool = False) -> str:
    mesh = ("multi" if multi_pod else "single") + ("_opt" if optimized else "")
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--lz4", action="store_true",
                    help="run the lz4-engine cells (paper's own workload)")
    ap.add_argument("--reprobe", action="store_true",
                    help="refresh only the counts of existing single-pod cell JSONs")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the beyond-paper optimized posture (see steps.optimized_config)")
    args = ap.parse_args(argv)

    if args.reprobe:
        for arch, shape_name in cells():
            path = cell_path(arch, shape_name, False)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                rec = json.load(f)
            fresh = run_cell(arch, shape_name, False, verbose=False,
                             optimized=rec.get("optimized", False))
            for key in ("cost", "probe", "lower_s"):
                rec[key] = fresh[key]
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[reprobe] {arch} {shape_name} {rec['lower_s']:.0f}s", flush=True)
        return

    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multi"]
    if args.lz4:
        for multi in meshes:
            rec = run_lz4_cell(multi, scan_impl="associative")
            path = cell_path("lz4-engine", rec["shape"], multi)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        return
    todo = cells() if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape_name in todo:
        for multi in meshes:
            path = cell_path(arch, shape_name, multi, args.optimized)
            if args.skip_existing and os.path.exists(path):
                continue
            try:
                rec = run_cell(arch, shape_name, multi, optimized=args.optimized)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception:
                failures.append((arch, shape_name, multi))
                print(f"[dryrun] FAILED {arch} {shape_name} multi={multi}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}", flush=True)
        sys.exit(1)
    print("[dryrun] all cells OK", flush=True)


if __name__ == "__main__":
    main()
