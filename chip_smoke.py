#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--stop-after build|kernels|small]

Builds the CUDA kernels from `src/repro_torch/csrc/*.cu` (into `build/`),
holds each against its plain PyTorch version on the card (exact equality —
every output is an integer or a byte), then drives the port's paths: the
write path, `repro_torch.LZ4Engine(device="cuda").compress`, through the
fused datapath (the default) and through the staged one
(``candidate_impl="sort"|"sortkey"|"scatter"``), and the read path,
`repro_torch.LZ4DecodeEngine(device="cuda")` (`decode`, `decode_blocks`,
`decode_to_device`, `FrameReader.read_range_device`), on 8 MiB and on
256 MiB of seeded data, and checks the frames and the bytes.  Then the
resilience layer and the engines' consumers on the card:
`resilience_small` (salvage and v6 parity of damaged 8 MiB frames under
both planners, every report equal to the CPU engine's), `checkpoint_full`
(save / restore of a ~0.8 GiB training state, `restore_with_fallback` past
a damaged step, a salvage restore and the crash seams on a small twin),
`consumers_small` (KV-cache offload and restore to the card, the token
pipeline, gradient frames) and `salvage_full` (three damaged blocks of a
256 MiB v6 frame rebuilt).  Then the sharded fabric: `fabric_small`
(8 MiB: frame v4 through the host-partition path and through meshes of
(2, 1), (2, 2) and (1, 8) shards — distinct cards where enough are visible,
else cuda:0 repeated — sharded decode under both planners, the int8
pod-sum, `restore(shardings=)` and the pipeline schedule) and `fabric_full`
(the 256 MiB data over a (2, 2) mesh, compressed and decoded).  Then the
serving path: `models_small` (the ten architectures at `.reduced()` on the
card against the CPU, within 1e-3), `serve_full` (qwen3-1.7b at full
width: `ServingEngine` answers 8 requests; prefill/decode consistency
within 2e-3; the float32 forward on the card against the CPU) and
`serve_offload` (a live session's ~470 MB bfloat16 KV cache offloaded
through `LZ4Engine(device="cuda")`, restored to the card bit-exact with
on-device planning, and decoding continued from it identically).  Then
training: `train_small` (before ``--stop-after small``: the ten
architectures at `.reduced()`, `train_loss` and every gradient leaf on the
card against the CPU within 1e-3, one `make_train_step` step's parameters,
m and v within 1e-5), `train_drill` (`launch/train.py` at qwen3-1.7b's
`--scale 100m`, 12 steps, a checkpoint every 4, once uninterrupted and once
failing at step 7: the loss falls, the recovered run ends at the same loss,
the saves launch the write kernels and the restore `decode_wave`) and
`train_full` (qwen3-1.7b at full width, B = 1 x 4096: ms per step,
tokens/s, MFU against 989 TFLOP/s, peak memory, idle share).  Then
`dryrun` (the port's dry run over `meta` tensors on the host: qwen3-1.7b's
train_4k cell and the LZ4 cell on the 16x16 meta mesh, and the state bytes
it counts at `train_full`'s shape held to what `train_full` allocated) and
`compress_bytes` (the deprecated wrapper on 8 MiB: blocks equal to the
engine's on the card and to the CPU's).  Then `restore_distinct` (a 256
MiB checkpoint restored with `shardings=` onto the distinct devices
``cuda:0`` and the CPU under three specs: every leaf a `ShardedTensor`
whose shards sit on their devices at their indices with the saved bytes,
`full()` bit for bit) and `examples` (the four `examples/torch_*.py` on
the card at their quick sizes, in parallel subprocesses: exit 0 and their
"OK" lines).
Checkpoints and shards are written under `build/smoke_scratch/` and
removed.
Imports `repro_torch` only — never the JAX reference.  One JSON line per
phase; any failed check raises, so the process exits non-zero at once.
Without a CUDA device it exits non-zero and prints no result.

The second to last line is ``{"kernels": [...]}`` (per kernel: launches on
the main path, error against the plain version, time, plain time, bound,
and the launches of the `compress_bytes` check);
the last line is ``{"ok": true, "device": {...}}``.  The 256 MiB write
phases print each frame's SHA-256, so that runs of two checkouts show
whether they write the same bytes.
"""
from __future__ import annotations

import binascii
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False — this "
             "script needs one CUDA device and has no CPU fallback")

import repro_torch  # noqa: E402
from repro_torch import (  # noqa: E402
    FrameReader,
    FrameFormatError,
    LZ4DecodeEngine,
    LZ4Engine,
    decode_frame_serial,
    encode_frame,
    frame_info,
)
from repro_torch.core import compressor  # noqa: E402
from repro_torch.core.compressor import _PAD, OUT_CAP  # noqa: E402
from repro_torch.core.corpus import adversarial_blocks, corpus_files  # noqa: E402
from repro_torch.core.decode_plan import (  # noqa: E402
    DevicePlanCaps,
    plan_block_fast,
    to_device_plan,
)
from repro_torch.core.decoder import decode_block  # noqa: E402
from repro_torch.core.emitter import emit_block  # noqa: E402
from repro_torch.core.frame import block_crc, check_block  # noqa: E402
from repro_torch.core.lz4_types import LAST_LITERALS, MAX_BLOCK, MIN_MATCH  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import crc32 as k_crc  # noqa: E402
from repro_torch.kernels import decode_wave as k_wave  # noqa: E402
from repro_torch.kernels import emit_scatter as k_emit  # noqa: E402
from repro_torch.kernels import fibhash as k_fib  # noqa: E402
from repro_torch.kernels import fused_compress as k_fused  # noqa: E402
from repro_torch.kernels import match_extend as k_ext  # noqa: E402
from repro_torch.kernels import plan_layout as k_layout  # noqa: E402
from repro_torch.kernels import plan_speculative as k_plan  # noqa: E402
from repro_torch.kernels import window_select as k_select  # noqa: E402
from repro_torch._tree import flatten, flatten_with_paths, tree_map  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core.engine import default_engine  # noqa: E402
from repro_torch.data.pipeline import ShardedTokenPipeline  # noqa: E402
from repro_torch.distributed import fabric  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    NamedSharding,
    P,
    ShardedTensor,
    make_mesh,
    single_device_mesh,
    use_mesh,
)
from repro_torch.optim import grad_compress  # noqa: E402
from repro_torch.resilience.inject import (  # noqa: E402
    FaultInjector,
    InjectedCrash,
    corrupt_frame_block,
    flip_bits,
    install,
)
from repro_torch.serving import engine as serving  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import SHAPES, all_arch_names, get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline, steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.inputs import make_batch  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SEED = 20260731
DEV = torch.device("cuda")
DEFAULTS = (8, 36, 8)                      # (hash_bits, max_match, pws)
SWEEP = [(6, 12, 8), (10, 68, 4), (8, 36, 16), (12, 36, 8)]
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and the
# fp32 rate outside the tensor cores, used here for 32-bit integer operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNEL_MODULES = (k_fused, k_emit, k_select)           # the write path's
READ_KERNEL_MODULES = (k_wave, k_plan, k_crc, k_layout)  # the read path's
STAGED_KERNEL_MODULES = (k_fib, k_ext)                 # the staged path's
ALL_KERNEL_MODULES = KERNEL_MODULES + STAGED_KERNEL_MODULES
EVERY_KERNEL_MODULE = ALL_KERNEL_MODULES + READ_KERNEL_MODULES
WRITE_KERNELS = ("fused_compress", "emit_scatter", "window_select")
READ_KERNELS = ("decode_wave", "plan_speculative", "crc32", "plan_layout")
# Checkpoints, shards and the like go here (inside the checkout, git-ignored).
SCRATCH = ROOT / "build" / "smoke_scratch"
SALVAGE_FULL_BYTES = 256 << 20
RESILIENCE_BYTES = 8 << 20         # resilience_small's data
STATE_LAYERS, STATE_WIDTH = 24, 2048   # checkpoint_full's float32 weights
STAGED_IMPLS = ("sort", "sortkey", "scatter")
CAPS = DevicePlanCaps()
ROUND_BUCKETS = (0, 1, 2, 4, 8, 16)
LONG_CRC_ROW = (64 << 20) + 5   # bytes of the long row the crc32 kernel checks
FABRIC_SHAPES = ((2, 1), (2, 2), (1, 8))   # ("data", "model") meshes of fabric_small
TIME_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn()` in ms, by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def read_want(wave, plan, crc) -> dict:
    """The read kernels' launches: `plan_decode` launches `plan_speculative`
    and `plan_layout` once a dispatch each, the host planner neither."""
    return dict(decode_wave=wave, plan_speculative=plan, crc32=crc, plan_layout=plan)


def reset_launches(modules=KERNEL_MODULES) -> None:
    for mod in modules:
        mod.reset_launches()


def launch_counts(modules) -> dict:
    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in modules}


def comparer(modules):
    """(results, note): ``note(name, *pairs)`` holds each (kernel, plain)
    output pair equal and tallies cases and the largest difference per
    kernel in ``results``."""
    res = {m.__name__.rsplit(".", 1)[1]: {"max_abs_diff": 0, "cases": 0}
           for m in modules}

    def note(name: str, *pairs) -> None:
        for a, b in pairs:
            d = max_abs_diff(a, b)
            res[name]["max_abs_diff"] = max(res[name]["max_abs_diff"], d)
            res[name]["cases"] += 1
            check(d == 0, f"{name}: kernel and plain version differ by {d}")

    return res, note


def kernel_device_ms(name: str, fn, iters: int = 20) -> float | str:
    """Mean device time of one launch of kernel `name` over `iters` calls of
    `fn`, from the profiler's device rows.  Unlike the CUDA-event time it
    leaves out the gaps in which the device waits for the host to launch
    (the wrapper's checks and allocations), which dominate a kernel of a few
    microseconds."""
    rep = profile_device(lambda: [fn() for _ in range(iters)])
    if isinstance(rep, str):
        return rep
    rows = [r for r in rep["top"] if f"{name}_kernel" in r["name"]]
    if not rows:
        return "not measured (no profiler row for the kernel)"
    return sum(r["seconds"] for r in rows) * 1e3 / sum(r["count"] for r in rows)


def timed(w: dict, name: str | None = None) -> dict:
    """CUDA-event times of a kernel and its plain version, the kernel's
    profiler device time when `name` is given, and the bound: bytes over
    the HBM rate against operations over the 32-bit rate."""
    byte_ms = w["bytes"] / PEAK_BYTES_PER_S * 1e3
    op_ms = w["ops"] / PEAK_OPS_PER_S * 1e3
    out = dict(ms=cuda_ms(w["run"], iters=w.get("iters", 50), warmup=5),
               plain_ms=cuda_ms(w["plain"], iters=w["plain_iters"], warmup=1),
               bound_ms=max(byte_ms, op_ms),
               bound_by="bytes" if byte_ms >= op_ms else "operations",
               bytes=w["bytes"], operations=w["ops"])
    if name is not None:
        out["device_ms"] = kernel_device_ms(name, w["run"])
    return out


# -- data -------------------------------------------------------------------

def kernel_blocks(m: int = 32, garbage: bool = False):
    """(m, MAX_BLOCK + _PAD) uint8 + (m,) int32 on the card: the adversarial
    blocks, filled up with corpus blocks; optionally seeded noise past n."""
    blocks = list(adversarial_blocks().values())
    base = b"".join(corpus_files().values())
    i = 0
    while len(blocks) < m:
        blocks.append(base[i: i + MAX_BLOCK])
        i += MAX_BLOCK
    blocks = blocks[:m]
    rng = np.random.default_rng(SEED)
    stack = (rng.integers(0, 256, (m, MAX_BLOCK + _PAD), np.uint8) if garbage
             else np.zeros((m, MAX_BLOCK + _PAD), np.uint8))
    ns = np.zeros((m,), np.int32)
    for j, b in enumerate(blocks):
        stack[j, : len(b)] = np.frombuffer(b, np.uint8)
        ns[j] = len(b)
    return torch.from_numpy(stack).to(DEV), torch.from_numpy(ns).to(DEV)


def seeded_data(nbytes: int, seed: int) -> bytes:
    """`nbytes` of seeded data: the 14-file corpus repeated, every repeat
    with its own 0.4 % of bytes replaced (so hash tables differ from repeat to
    repeat), and about one 64 KB block in eight overwritten with noise (so
    raw passthrough is exercised)."""
    rng = np.random.default_rng(seed)
    base = np.frombuffer(b"".join(corpus_files().values()), np.uint8)
    reps = -(-nbytes // len(base))
    out = np.tile(base, reps)[:nbytes].copy()
    hits = rng.integers(0, nbytes, nbytes // 256)
    out[hits] = rng.integers(0, 256, hits.size, np.uint8)
    nblocks = -(-nbytes // MAX_BLOCK)
    for b in np.nonzero(rng.random(nblocks) < 0.125)[0]:
        lo, hi = b * MAX_BLOCK, min((b + 1) * MAX_BLOCK, nbytes)
        out[lo:hi] = rng.integers(0, 256, hi - lo, np.uint8)
    return out.tobytes()


def boundary_layouts():
    """Hand-built emit layouts: one match after `lit` literals, both length
    fields at their token-nibble / extension-byte boundaries (where C++ `%`
    and a floor modulus differ).  Returns CUDA inputs + the host oracle."""
    vals = (14, 15, 16, 269, 270, 271)
    ext = lambda v: 0 if v < 15 else 1 + (v - 15) // 255  # noqa: E731
    K, rows, oracles = 1024, [], []
    rng = np.random.default_rng(SEED + 1)
    for lit in vals:
        for mlx in vals:
            head = rng.integers(0, 256, lit, np.uint8).tobytes()
            data = head + head[-1:] * (mlx + MIN_MATCH) + b"tail-bytes"
            size0 = 3 + ext(lit) + lit + ext(mlx)
            final_lit = len(data) - (lit + mlx + MIN_MATCH)
            total = size0 + 1 + ext(final_lit) + final_lit
            fields = np.zeros((ref.N_FIELDS, 2), np.int32)
            fields[:, 0] = [0, 0, lit, ext(lit), mlx, ext(mlx), 1, 1]
            fields[:, 1] = [size0, lit + mlx + MIN_MATCH, final_lit,
                            ext(final_lit), 0, 0, 0, 0]
            seg = np.zeros((K,), np.int32)
            seg[size0:] = 1
            blk = np.zeros((MAX_BLOCK + _PAD,), np.uint8)
            blk[: len(data)] = np.frombuffer(data, np.uint8)
            rows.append((blk, seg, fields, total))
            oracles.append(emit_block(data, [True], [lit], [mlx + MIN_MATCH],
                                      [1], len(data)))
    stack = lambda i, dt: torch.from_numpy(  # noqa: E731
        np.stack([np.asarray(r[i], dt) for r in rows])).to(DEV)
    return (stack(0, np.uint8), stack(1, np.int32), stack(2, np.int32),
            stack(3, np.int32)), oracles


def cu_const(name: str, key: str) -> int:
    """A constant of a kernel source (``constexpr int KEY = N;``)."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    return int(re.search(rf"constexpr int {key} = (\d+);", src).group(1))


def select_hard_rows(pws: int, P: int, seed: int):
    """(7, P) valid + lengths on the card for the window select at one pws:
    lengths in [-3, CAP], lengths that jump several windows (36 at pws 4),
    zeros and negatives at valid positions, all valid with every length at
    R (17) and at CAP, and two rows that take the kernel's sequential walk: a
    valid length of CAP + 45 = 300, and one of 2^31 - 3 (the free pointer
    wraps int32)."""
    cap = cu_const("window_select", "CAP")
    rng = np.random.default_rng(seed)
    ar = np.arange(P)
    rows = [
        (rng.random(P) < 0.5, rng.integers(-3, cap + 1, P)),
        (rng.random(P) < 0.3, np.full(P, 36 if pws <= 4 else min(cap, 9 * pws))),
        (rng.random(P) < 0.6, rng.integers(-3, 2, P)),
        (np.ones(P, bool), np.full(P, 17)),
        (np.ones(P, bool), np.full(P, cap)),
        ((rng.random(P) < 0.7) | (ar == P // 2),
         np.where(ar == P // 2, cap + 45, rng.integers(4, 37, P))),
        ((ar % 3 != 1) | (ar == P // 3),
         np.where(ar == P // 3, 2**31 - 3, rng.integers(4, 37, P))),
    ]
    v = torch.from_numpy(np.stack([r[0] for r in rows])).to(DEV)
    lengths = np.stack([r[1] for r in rows]).astype(np.int32)
    return v, torch.from_numpy(lengths).to(DEV)


# -- phases -----------------------------------------------------------------

def phase_env() -> str:
    probe = repro_torch.probe()
    nvcc = _build.find_nvcc()
    check(nvcc is not None, "nvcc not found")
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say("env", probe=probe, nvcc_version=nvcc_version.splitlines()[-2:],
        python=sys.version.split()[0], card=card)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    ptxas = {name: [ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "error" in ln]
             for name, log in _build.build_log.items()}
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=_build.build_seconds,
        libraries=[p.name for p in paths.values()], ptxas=ptxas,
        registers_and_spills={name: ptxas_summary(log)
                              for name, log in _build.build_log.items()})


def ptxas_summary(log: str) -> dict:
    """Registers per thread and spill bytes of each kernel function that
    `nvcc -Xptxas -v` reports in one build log (a template gives one entry
    per instantiation)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    stores = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    loads = [int(x) for x in re.findall(r"(\d+) bytes spill loads", log)]
    return dict(registers=regs, spill_store_bytes=stores, spill_load_bytes=loads)


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card; times at M = 32
    and the engine defaults.  Returns per-kernel measurements."""
    res, note = comparer(KERNEL_MODULES)
    rng = np.random.default_rng(SEED + 2)
    timing_inputs = {}
    for hb, mm, pws in [DEFAULTS] + SWEEP:
        for garbage in (False, True):
            blocks, ns = kernel_blocks(32, garbage=garbage)
            # (a) fused_compress
            cand, lengths = k_fused.fused_compress(blocks, ns, MAX_BLOCK, hb, pws, mm)
            torch.cuda.synchronize()
            cand_p, lengths_p = k_fused.fused_compress_plain(
                blocks, ns, MAX_BLOCK, hb, pws, mm)
            note("fused_compress", (cand, cand_p), (lengths, lengths_p))
            # (c) window_select, on the datapath's real output and on
            # synthetic dense / all-true / all-false rows
            valid = lengths >= MIN_MATCH
            syn_valid = torch.from_numpy(rng.random((32, MAX_BLOCK)) < 0.6).to(DEV)
            syn_valid[0] = True
            syn_valid[1] = False
            syn_len = torch.from_numpy(
                rng.integers(MIN_MATCH, mm + 1, (32, MAX_BLOCK)).astype(np.int32)
            ).to(DEV)
            for v, l in ((valid, lengths), (syn_valid, syn_len),
                         (syn_valid.to(torch.uint8), syn_len)):
                got = k_select.window_select(v, l, pws)
                torch.cuda.synchronize()
                note("window_select", *zip(got, k_select.window_select_plain(v, l, pws)))
            # (b) emit_scatter, on the layout the main path computes
            rec = compressor.compress_blocks_records(
                blocks, ns, hash_bits=hb, max_match=mm, pws=pws)
            seg, fields, total = ops._emit_layout(
                rec.emit, rec.pos, rec.length, rec.offset, ns, OUT_CAP)
            out = k_emit.emit_scatter(blocks, seg, fields, total)
            torch.cuda.synchronize()
            note("emit_scatter",
                 (out, k_emit.emit_scatter_plain(blocks, seg, fields, total)))
            check(bool((total == rec.size).all()), "layout total != plan size")
            if (hb, mm, pws) == DEFAULTS and not garbage:
                timing_inputs = dict(blocks=blocks, ns=ns, valid=valid,
                                     lengths=lengths, seg=seg, fields=fields,
                                     total=total)
    # emit_scatter at the extension-byte boundaries, against the host oracle too
    (b_blk, b_seg, b_fields, b_total), oracles = boundary_layouts()
    out = k_emit.emit_scatter(b_blk, b_seg, b_fields, b_total)
    torch.cuda.synchronize()
    note("emit_scatter", (out, k_emit.emit_scatter_plain(b_blk, b_seg, b_fields, b_total)))
    out_h = out.cpu().numpy()
    for j, oracle in enumerate(oracles):
        check(out_h[j, : len(oracle)].tobytes() == oracle,
              f"emit_scatter boundary case {j} differs from emit_block")
    # odd K takes the one-byte-per-thread kernel
    out = k_emit.emit_scatter(b_blk, b_seg[:, :1021].contiguous(), b_fields, b_total)
    note("emit_scatter", (out, k_emit.emit_scatter_plain(
        b_blk, b_seg[:, :1021].contiguous(), b_fields, b_total)))
    # table in device memory (hash_bits = 16) and a window wider than a warp
    blocks, ns = kernel_blocks(8)
    for hb, mm, pws in [(16, 36, 8), (8, 36, 64), (13, 20, 32)]:
        got = k_fused.fused_compress(blocks, ns, MAX_BLOCK, hb, pws, mm)
        torch.cuda.synchronize()
        note("fused_compress",
             *zip(got, k_fused.fused_compress_plain(blocks, ns, MAX_BLOCK, hb, pws, mm)))
        v = got[1] >= MIN_MATCH
        note("window_select", *zip(k_select.window_select(v, got[1], pws),
                                   k_select.window_select_plain(v, got[1], pws)))

    fused_edge_cases(note)

    # window_select: every pws of {1, ..., 2048} on rows that stress the
    # chunked form and take its sequential walk; P that leaves chunks ragged
    # or fewer chunks than CTAs
    for pws in (1, 4, 8, 16, 32, 64, 2048):
        v, l = select_hard_rows(pws, MAX_BLOCK, SEED + 20 + pws)
        note("window_select", *zip(k_select.window_select(v, l, pws),
                                   k_select.window_select_plain(v, l, pws)))
    for P, pws in ((1000, 8), (24, 8), (3 * 2048, 2048), (MAX_BLOCK - 256, 4)):
        v, l = select_hard_rows(pws, P, SEED + 30 + P)
        v = v.to(torch.uint8)
        note("window_select", *zip(k_select.window_select(v, l, pws),
                                   k_select.window_select_plain(v, l, pws)))

    # -- times at M = 32, defaults -------------------------------------------
    t = timing_inputs
    hb, mm, pws = DEFAULTS
    M, B, P, K = 32, MAX_BLOCK + _PAD, MAX_BLOCK, OUT_CAP
    S = t["fields"].shape[2]
    W = P // pws
    ext_ops = int((t["lengths"][t["lengths"] > 0] - MIN_MATCH + 1).sum())
    tot_sum = int(t["total"].clamp(max=K).sum())
    work = {
        # bytes: each input read once, each output written once; operations:
        # what this run's data needs (extension compares that really happen,
        # output bytes below `total`).
        "fused_compress": dict(
            bytes=M * B + M * 4 + 2 * M * P * 4,
            ops=M * P * 20 + 2 * ext_ops,
            run=lambda: k_fused.fused_compress(t["blocks"], t["ns"], P, hb, pws, mm),
            plain=lambda: k_fused.fused_compress_plain(t["blocks"], t["ns"], P, hb, pws, mm),
            plain_iters=3),
        "emit_scatter": dict(
            bytes=4 * tot_sum + M * ref.N_FIELDS * S * 4 + M * 4 + M * B + M * K,
            ops=12 * tot_sum + M * K,
            run=lambda: k_emit.emit_scatter(t["blocks"], t["seg"], t["fields"], t["total"]),
            plain=lambda: k_emit.emit_scatter_plain(t["blocks"], t["seg"], t["fields"], t["total"]),
            plain_iters=5),
        "window_select": dict(
            bytes=M * P * 5 + M * W * 9,
            ops=M * (P + 8 * W),
            run=lambda: k_select.window_select(t["valid"], t["lengths"], pws),
            plain=lambda: k_select.window_select_plain(t["valid"], t["lengths"], pws),
            plain_iters=1),
    }
    for name, w in work.items():
        res[name].update(timed(w, name))
    # fused_compress also on 32 blocks of the data the main path compresses
    mb, mn = main_path_blocks(32)
    main_len = k_fused.fused_compress(mb, mn, P, hb, pws, mm)[1]
    main_ext = int((main_len[main_len > 0] - MIN_MATCH + 1).sum())
    main = timed(dict(work["fused_compress"], ops=M * P * 20 + 2 * main_ext,
                      run=lambda: k_fused.fused_compress(mb, mn, P, hb, pws, mm),
                      plain=lambda: k_fused.fused_compress_plain(mb, mn, P, hb, pws, mm)),
                 "fused_compress")
    res["fused_compress"]["main_path_data"] = {f: main[f] for f in TIME_KEYS}
    say("kernels_check", shapes=dict(M=M, B=B, P=P, K=K, S=S, W=W),
        tolerance=0, results=res)
    return res


def main_path_blocks(m: int):
    """(m, MAX_BLOCK + _PAD) uint8 + (m,) int32 on the card: 64 KB blocks
    of the data the main path compresses (`seeded_data`)."""
    data = np.frombuffer(seeded_data(m * MAX_BLOCK, SEED + 9), np.uint8)
    stack = np.zeros((m, MAX_BLOCK + _PAD), np.uint8)
    stack[:, :MAX_BLOCK] = data.reshape(m, MAX_BLOCK)
    return (torch.from_numpy(stack).to(DEV),
            torch.full((m,), MAX_BLOCK, dtype=torch.int32, device=DEV))


def fused_edge_cases(note) -> None:
    """fused_compress at the edges of its cluster layout: one block and a
    last cluster alone (M = 1, 33); rows that start 1, 2, 3 and 5 bytes off
    16-byte alignment; n at, just past and inside every CTA's range; P =
    6144 (three units of 2048: windows of 2048 take one CTA, windows of 8 a
    non-power-of-two segment count); P = 131072 (uint32 candidates, kept
    in the cand output)."""
    hb, mm, pws = DEFAULTS
    args = (MAX_BLOCK, hb, pws, mm)

    def both(blocks, ns, *a):
        got = k_fused.fused_compress(blocks, ns, *a)
        torch.cuda.synchronize()
        note("fused_compress", *zip(got, k_fused.fused_compress_plain(blocks, ns, *a)))

    for m in (1, 33):
        both(*kernel_blocks(m, garbage=True), *args)
    blocks, ns = kernel_blocks(8, garbage=True)
    flat = torch.zeros(blocks.numel() + 16, dtype=torch.uint8, device=DEV)
    for off in (1, 2, 3, 5):
        view = flat[off: off + blocks.numel()].view(blocks.shape)
        view.copy_(blocks)
        both(view, ns, *args)
    span = MAX_BLOCK // k_fused._plan(blocks.shape[1], *args[:3]).cluster
    starts = [q * span + d for q in range(MAX_BLOCK // span) for d in (0, 4, 5, 37, 2000)]
    blocks, _ = kernel_blocks(len(starts), garbage=True)
    both(blocks, torch.tensor(starts, dtype=torch.int32, device=DEV), *args)
    small, sn = kernel_blocks(8, garbage=True)
    small = small[:, : 6144 + _PAD].contiguous()
    sn = sn.clamp(max=6144)
    for p_ws in (2048, 8):
        both(small, sn, 6144, hb, p_ws, mm)
    wide, _ = kernel_blocks(8, garbage=True)
    wide = wide[:, :MAX_BLOCK].reshape(4, 2 * MAX_BLOCK)
    wide = torch.cat([wide, torch.zeros((4, _PAD), dtype=torch.uint8, device=DEV)], 1)
    wn = torch.tensor([2 * MAX_BLOCK, 70001, MAX_BLOCK + 3, 9], dtype=torch.int32, device=DEV)
    both(wide, wn, 2 * MAX_BLOCK, 6, pws, mm)


# -- the staged compress path -------------------------------------------------

STAGED_NS = (0, 1, 2, 3, 4, 5, 12, 13, 2500, MAX_BLOCK)
MATCH_CAPS = (4, 5, 12, 20, 36, 68, 100)   # max_match values match_extend is held at


def odd_candidates(rng, shape, B: int) -> torch.Tensor:
    """Random (M, P) int32 candidates: in-range, -1, at or past the row's end,
    at or after the position itself, and the int32 extremes."""
    M, P = shape
    p = np.arange(P, dtype=np.int64)[None, :]
    pick = rng.integers(0, 6, shape)
    cand = np.select(
        [pick == 0, pick == 1, pick == 2, pick == 3, pick == 4],
        [rng.integers(0, P, shape), np.full(shape, -1),
         rng.integers(B - 4, B + 100, shape), p + rng.integers(0, 8, shape),
         rng.choice([-(1 << 31), (1 << 31) - 1, 1 << 30], shape)],
        rng.integers(-100, 0, shape))
    return torch.from_numpy(cand.astype(np.int32)).to(DEV)


def sector_bytes(mask: torch.Tensor) -> int:
    """Bytes in the 32-byte sectors (the card's smallest DRAM transfer) that
    hold a byte flagged in `mask`, one flag per byte of a buffer."""
    flat = mask.reshape(-1)
    pad = torch.zeros(((-flat.numel()) % 32,), dtype=torch.bool, device=flat.device)
    return int(torch.cat([flat, pad]).view(-1, 32).any(1).sum()) * 32


def match_extend_work(block, cand, valid, ns, lengths, max_match: int):
    """Bytes and operations `match_extend` needs on these inputs (the least
    any kernel must do, from this data): all of `valid` and `ns` read and
    every length written; `cand` only in the sectors that hold a valid
    position; of each row only the sectors its compares read.  A valid
    position compares `min(e + 1, cap)` byte pairs (its extension e, plus
    the mismatch that stops it below the cap), at p + 4 + j and at
    cand + 4 + j, each clamped to the row as the kernel clamps it.
    Returns (bytes, operations, byte compares)."""
    M, B = block.shape
    P = cand.shape[1]
    dev = block.device
    p = torch.arange(P, dtype=torch.int64, device=dev)[None, :].expand(M, P)
    cap = (ns.long()[:, None] - LAST_LITERALS - (p + MIN_MATCH)).clamp(
        0, max_match - MIN_MATCH)
    k = torch.minimum(lengths.long() - MIN_MATCH + 1, cap)
    live = valid & (k > 0)
    # the compared row bytes: a +1/-1 at each range's ends, summed along the row
    diff = torch.zeros((M, B + 1), dtype=torch.int32, device=dev)
    rows = torch.arange(M, device=dev)[:, None].expand(M, P)[live]
    for start in (p + MIN_MATCH, cand.long() + MIN_MATCH):
        s, n = start[live], k[live]
        lo, hi = s.clamp(0, B - 1), (s + n).clamp(1, B)
        ones = torch.ones_like(lo, dtype=torch.int32)
        diff.index_put_((rows, lo), ones, accumulate=True)
        diff.index_put_((rows, hi), -ones, accumulate=True)
    row_bytes = sector_bytes(diff[:, :B].cumsum(1) > 0)
    cand_bytes = sector_bytes(valid.reshape(-1, 1).expand(-1, 4))
    compares = int(k[live].sum())
    nbytes = M * P + M * 4 + cand_bytes + row_bytes + M * P * 4
    return nbytes, M * P * 4 + 4 * compares, compares


def phase_staged_kernels() -> dict:
    """`fibhash` and `match_extend` against their plain versions on the card,
    exact, on the adversarial + corpus blocks (zeros and noise past n),
    hash_bits over {1, 6, 8, 12, 13, 16} and max_match over `MATCH_CAPS`,
    `match_extend` also on rows of 240,000 bytes; times at M = 32 and the
    engine defaults."""
    res, note = comparer(STAGED_KERNEL_MODULES)
    rng = np.random.default_rng(SEED + 10)
    hb, mm, pws = DEFAULTS
    timing_inputs = {}
    for garbage in (False, True):
        blocks, ns = kernel_blocks(32, garbage=garbage)
        B = blocks.shape[1]
        # fibhash: the rows as they come and as the staged path masks them,
        # every position the row has and the engine's MAX_BLOCK
        block, cand, valid4 = compressor.staged_candidates(blocks, ns, "scatter", hb, pws)
        for bits in (1, 6, 8, 12, 13, 16):
            for rows in (blocks, block):
                for P in (MAX_BLOCK, B - 3):
                    got = k_fib.fibhash(rows, P, bits)
                    torch.cuda.synchronize()
                    note("fibhash", *zip(got, k_fib.fibhash_plain(rows, P, bits)))
        # match_extend: the staged path's own inputs; random candidates
        # (-1, past the row, >= p, int32 extremes) with a random mask; every
        # n of STAGED_NS; all-zero rows, where every extension runs to its cap
        odd = odd_candidates(rng, cand.shape, B)
        odd_valid = torch.from_numpy(rng.random(cand.shape) < 0.7).to(DEV)
        odd_ns = torch.tensor([STAGED_NS[j % len(STAGED_NS)]
                               for j in range(cand.shape[0])],
                              dtype=torch.int32, device=DEV)
        zeros = torch.zeros_like(blocks)
        zero_cand = torch.from_numpy(
            rng.integers(-2, MAX_BLOCK, cand.shape).astype(np.int32)).to(DEV)
        all_true = torch.ones_like(valid4)
        full_ns = torch.full_like(ns, MAX_BLOCK)
        # ... and P not a multiple of 8 (one position at a time)
        odd_p = MAX_BLOCK - 3
        for m in MATCH_CAPS:
            for args in ((block, cand, valid4, ns),
                         (blocks, odd, odd_valid, odd_ns),
                         (blocks, odd, odd_valid.to(torch.uint8), ns),
                         (zeros, zero_cand, all_true, full_ns),
                         (blocks, odd[:, :odd_p].contiguous(),
                          odd_valid[:, :odd_p].contiguous(), odd_ns)):
                got = k_ext.match_extend(*args, m)
                torch.cuda.synchronize()
                note("match_extend", (got, k_ext.match_extend_plain(
                    *args[:2], args[2].to(torch.bool), args[3], m)))
            got = k_ext.match_extend(zeros, zero_cand, all_true, full_ns, m)
            p = torch.arange(MAX_BLOCK, device=DEV)
            cap = MIN_MATCH + torch.clamp(MAX_BLOCK - 5 - (p + MIN_MATCH), 0, m - MIN_MATCH)
            check(bool((got == cap.to(torch.int32)[None]).all()),
                  "match_extend on all-zero rows did not run to the cap")
        if not garbage:
            timing_inputs = dict(blocks=blocks, block=block, cand=cand,
                                 valid4=valid4, ns=ns)
    # match_extend on rows of 240,000 bytes (wider than any block): repeats,
    # garbage candidates
    wide_b = 240_000
    wb = torch.from_numpy(np.tile(rng.integers(0, 4, (2, wide_b // 8), np.uint8), 8)).to(DEV)
    wc = odd_candidates(rng, (2, wide_b - 8), wide_b)
    wv = torch.from_numpy(rng.random((2, wide_b - 8)) < 0.7).to(DEV)
    wn = torch.tensor([wide_b, wide_b - 77], dtype=torch.int32, device=DEV)
    for m in (5, 36):
        got = k_ext.match_extend(wb, wc, wv, wn, m)
        torch.cuda.synchronize()
        note("match_extend", (got, k_ext.match_extend_plain(wb, wc, wv, wn, m)))

    t = timing_inputs
    (M, B), P = t["block"].shape, MAX_BLOCK
    lengths = k_ext.match_extend(t["block"], t["cand"], t["valid4"], t["ns"], mm)
    ext_bytes, ext_ops, compares = match_extend_work(
        t["block"], t["cand"], t["valid4"], t["ns"], lengths, mm)
    work = {
        # fibhash: each input read once (P + 3 bytes of each row), each
        # output written once.
        "fibhash": dict(
            bytes=M * (P + 3) + 2 * M * P * 4,
            ops=M * P * 9,
            run=lambda: k_fib.fibhash(t["block"], P, hb),
            plain=lambda: k_fib.fibhash_plain(t["block"], P, hb),
            plain_iters=5),
        # what this run's data needs (`match_extend_work`)
        "match_extend": dict(
            bytes=ext_bytes,
            ops=ext_ops,
            run=lambda: k_ext.match_extend(t["block"], t["cand"], t["valid4"], t["ns"], mm),
            plain=lambda: k_ext.match_extend_plain(t["block"], t["cand"], t["valid4"], t["ns"], mm),
            plain_iters=3),
    }
    for name, w in work.items():
        res[name].update(timed(w, name))
    say("staged_kernels_check", shapes=dict(M=M, B=B, P=P), tolerance=0,
        valid_positions=int(t["valid4"].sum()), compares=compares, results=res)
    return res


# -- the read path ------------------------------------------------------------

def card_payloads(m: int, adversarial: bool = True) -> tuple[list[bytes], list[bytes]]:
    """m LZ4 payloads compressed on the card (`compress_to_blocks`): every
    adversarial block (the all-zero one is an RLE chain of depth 65535) on
    its own, unless ``adversarial`` is off, then 64 KB blocks of the data the
    main path reads (`seeded_data`).  Returns (payloads, originals)."""
    eng = LZ4Engine(device=DEV)
    originals = list(adversarial_blocks().values()) if adversarial else []
    payloads = [eng.compress_to_blocks(b)[0] for b in originals]
    fill = seeded_data(2 * m * MAX_BLOCK, SEED + 9)
    originals += [fill[i: i + MAX_BLOCK] for i in range(0, len(fill), MAX_BLOCK)]
    payloads += eng.compress_to_blocks(fill)
    # Incompressible blocks come out longer than `blk_cap`: the engine
    # decodes those on the host (counted fallback), so they are left out.
    keep = [j for j, p in enumerate(payloads) if len(p) <= CAPS.blk_cap][:m]
    check(len(keep) == m, "too few payloads fit blk_cap")
    return [payloads[j] for j in keep], [originals[j] for j in keep]


def stack_rows(rows: list[bytes], width: int, garbage: bool = False, seed: int = 0):
    """(M, width) uint8 on the card (zeros or seeded noise past each row)
    and (M,) int32 lengths."""
    rng = np.random.default_rng(seed)
    buf = (rng.integers(0, 256, (len(rows), width), np.uint8) if garbage
           else np.zeros((len(rows), width), np.uint8))
    ns = np.zeros((len(rows),), np.int32)
    for j, r in enumerate(rows):
        buf[j, : len(r)] = np.frombuffer(r, np.uint8)
        ns[j] = len(r)
    return torch.from_numpy(buf).to(DEV), torch.from_numpy(ns).to(DEV)


def wave_inputs(payloads: list[bytes]):
    """The decode_wave kernel's inputs for host plans of `payloads`, laid out
    on the card by the engine's own stage (`ops._decode_layout`)."""
    plans = [to_device_plan(plan_block_fast(p), CAPS) for p in payloads]
    blk, _ = stack_rows(payloads, CAPS.blk_cap)
    col = lambda f: torch.from_numpy(np.stack([getattr(d, f) for d in plans])).to(DEV)  # noqa: E731
    sc = lambda f: torch.tensor([getattr(d, f) for d in plans], dtype=torch.int32, device=DEV)  # noqa: E731
    total = sc("out_size")
    lit_blk, ptr = ops._decode_layout(
        col("lit_src"), col("lit_dst"), col("lit_len"), col("match_dst"),
        col("match_off"), sc("n_lit"), sc("n_match"), total, CAPS.out_cap)
    return blk, lit_blk, ptr, total, max(d.n_waves for d in plans)


def spec_rows(payloads: list[bytes]) -> list[bytes]:
    """Rows for the header kernel: valid payloads, truncations, interior
    flips, a block of 0xFF bytes, and n in {0, 1, 2, blk_cap}."""
    rng = np.random.default_rng(SEED + 6)
    rows = list(payloads)
    for p in payloads[:6]:
        rows += [p[: len(p) // 3], p[: max(len(p) - 1, 0)]]
    for p in payloads[-4:]:
        for _ in range(3):
            m = bytearray(p)
            if m:
                m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
            rows.append(bytes(m))
    noise = rng.integers(0, 256, CAPS.blk_cap, np.uint8).tobytes()
    rows += [b"\xff" * CAPS.blk_cap, b"", noise[:1], noise[:2], noise]
    return rows


def chain_row(rng, n: int, through=()) -> bytes:
    """n bytes of sequences with no match extension, each hop 3..17 bytes
    (token, lit_nib literals, two offset bytes), passing through every offset
    in `through`."""
    out = bytearray()
    targets = sorted(t for t in through if 0 < t < n)
    while len(out) < n:
        cur = len(out)
        gap = next((t - cur for t in targets if t > cur), n - cur)
        hop = gap if 3 <= gap <= 17 else min(17, max(3, gap - 3))
        hop = min(hop, n - cur) if n - cur >= 3 else n - cur
        lit = max(hop - 3, 0)
        out.append((lit << 4) | int(rng.integers(0, 15)))
        out += rng.integers(0, 256, max(hop - 1, 0), np.uint8).tobytes()
    return bytes(out[:n])


def spec_hard_rows() -> list[bytes]:
    """Rows for the header kernel's chunked chain select: the longest chain
    (`00 xx xx`, 21,846 headers), literals that jump a whole chunk, hops
    landing on, just before and just after every chunk edge, on and just
    before every segment edge, n in {0, 1, 2, 3, blk_cap}, and a row that is
    70 % 0xFF bytes."""
    rng = np.random.default_rng(SEED + 21)
    cap = CAPS.blk_cap
    B = cap + ops.SPEC_PAD
    C = cu_const("plan_speculative", "CLUSTER")
    L = (-(-B // C) + 31) // 32 * 32   # offsets per CTA
    longest = b"".join(bytes([0]) + rng.integers(0, 256, 2, np.uint8).tobytes()
                       for _ in range(-(-cap // 3)))[:cap]
    k = 2 * L // 255 + 1
    head = bytes([0xF0]) + b"\xff" * k + bytes([7])
    lit = rng.integers(0, 256, 255 * k + 7 + 15, np.uint8).tobytes()
    jump = head + lit + b"\x01\x00"
    rows = [longest, jump + chain_row(rng, cap - len(jump))]
    rows += [chain_row(rng, cap, [q * L + d for q in range(1, C)]) for d in (0, -1, 1, -3)]
    seg = cu_const("plan_speculative", "SEG")
    rows += [chain_row(rng, cap, [q * L + g * seg + d for q in range(C)
                                  for g in range(1, -(-L // seg))]) for d in (0, -1)]
    noise = rng.integers(0, 256, cap, np.uint8).tobytes()
    rows += [noise[:n] for n in (0, 1, 2, 3, cap)]
    rows.append(np.where(rng.random(cap) < 0.7, 255,
                         rng.integers(0, 256, cap)).astype(np.uint8).tobytes())
    return rows


def wave_hard_rows(K: int, B: int, seed: int):
    """(M, B) blocks, (M, K) lit_blk and ptr, (M,) totals on the card for
    the decode_wave kernel's cluster layout: the all-zero block's RLE chain
    (depth K - 1), a chain through both sides of every slice boundary of
    clusters of 8, 4 and 2 CTAs in shuffled order (hops that cross slices
    both ways), a permutation (cycles only), forward pointers, random maps
    with lit_blk out of range and a ragged total."""
    rng = np.random.default_rng(seed)
    k = np.arange(K)
    lit = rng.integers(0, B, K)
    rows = [(lit, np.maximum(k - 1, 0), K)]
    for C in (8, 4, 2):
        S = max(cu_const("decode_wave", "MIN_SLICE"), 1 << (-(-K // C) - 1).bit_length())
        edges = [e for q in range(1, C) if q * S < K for e in (q * S - 1, q * S)]
        order = rng.permutation(np.array(edges + [0, K - 1]))
        for fill in (k, np.maximum(k - 3, 0)):
            p = fill.copy()
            p[order[0]] = order[0]
            p[order[1:]] = order[:-1]
            rows.append((lit, p, K))
    rows.append((lit, rng.permutation(K), K))
    rows.append((lit, np.minimum(k + rng.integers(1, 50, K), K - 1), K - 7))
    rows.append((rng.integers(-2 * B, 2 * B, K), rng.integers(0, K, K),
                 int(rng.integers(0, K + 1))))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(DEV)  # noqa: E731
    blocks = torch.from_numpy(rng.integers(0, 256, (len(rows), B), np.uint8)).to(DEV)
    return (blocks, t(np.stack([r[0] for r in rows])), t(np.stack([r[1] for r in rows])),
            t([r[2] for r in rows]))


def wave_edge_cases(note, blk, lit_blk, ptr, total, payloads, originals) -> None:
    """decode_wave at the edges of its cluster layout.  The kernel takes 8,
    4 or 2 CTAs per block, the most whose M x C CTAs fit the card's SMs, so
    M picks the cluster: the hard rows at K = 65536 and K = 1021 (a ragged
    last slice) at every rounds of 0-16 as they are (clusters of 8), and
    repeated to the most blocks that take clusters of 4 and the fewest that
    take clusters of 2; one block (M = 1) and 133 blocks (more than one wave
    of clusters of 2)."""
    def both(b, l, p, t, rounds):
        out = k_wave.decode_wave(b, l, p, t, rounds)
        torch.cuda.synchronize()
        note("decode_wave", (out, k_wave.decode_wave_plain(b, l, p, t, rounds)))
        return out

    def repeat_rows(tensors, m):
        reps = -(-m // tensors[0].shape[0])
        return [x.repeat(reps, *([1] * (x.dim() - 1)))[:m].contiguous() for x in tensors]

    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    for K in (CAPS.out_cap, 1021):
        hard = wave_hard_rows(K, 300, SEED + K)
        check(8 * hard[0].shape[0] <= sms, "decode_wave hard rows take clusters of 8")
        for rounds in range(17):
            both(*hard, rounds)
        for m in (sms // 4, sms // 4 + 1):   # clusters of 4, then of 2
            for rounds in (5, 16):
                both(*repeat_rows(hard, m), rounds)
    out = both(blk[:1], lit_blk[:1], ptr[:1], total[:1], 16)
    check(out[0, : len(originals[0])].cpu().numpy().tobytes() == originals[0],
          "decode_wave M = 1 row != input")
    out = both(*repeat_rows((blk, lit_blk, ptr, total), 133), 16)
    host = out.cpu().numpy()
    for j in range(0, 133, 11):
        o = originals[j % blk.shape[0]]
        check(host[j, : len(o)].tobytes() == o, f"decode_wave M = 133 row {j} != input")


WIDE_CAPS = (DevicePlanCaps(blk_cap=98304), DevicePlanCaps(out_cap=131072))
WIDE_PAYLOAD = 96_000   # a corrupt payload: past max_b() - SPEC_PAD, within blk_cap


def plan_wide_cases(note, rows: list[bytes]):
    """plan_speculative's wide kernel (rows wider than `max_b()`): the
    read-path rows at the width `blk_cap=98304` gives (98,432), with noise
    past n and a payload that fills the width; and a chain of 3-byte hops
    longer than 3 * 2^16 bytes, where the plain version's 16 doubling rounds
    mark only the first 2^16 headers.  Returns the timing inputs (8 rows)."""
    B = WIDE_CAPS[0].blk_cap + ops.SPEC_PAD
    check(B > k_plan.max_b(), "the wide caps must reach the wide kernel")
    rng = np.random.default_rng(SEED + 26)
    fill = rng.integers(0, 256, WIDE_PAYLOAD, np.uint8).tobytes()
    wrows = rows[:14] + [fill, b"\xff" * (B - 1), fill[:3]]
    for garbage in (False, True):
        wb, wn = stack_rows(wrows, B, garbage, SEED + 27)
        got = k_plan.plan_speculative(wb, wn)
        torch.cuda.synchronize()
        note("plan_speculative", *zip(got, k_plan.plan_speculative_plain(wb, wn)))
    hops = 3 * (1 << 16) + 3000
    chain = b"".join(bytes([0]) + rng.integers(0, 256, 2, np.uint8).tobytes()
                     for _ in range(hops // 3))
    cb, cn = stack_rows([chain, chain[:5000]], hops + 1)
    got = k_plan.plan_speculative(cb, cn)
    torch.cuda.synchronize()
    note("plan_speculative", *zip(got, k_plan.plan_speculative_plain(cb, cn)))
    check(int(got[0][0].sum()) == 1 << 16,
          "plan_speculative wide: 16 rounds mark the first 2^16 headers")
    return stack_rows(wrows[:8], B, False, SEED + 27)


def wave_wide_cases(note) -> None:
    """decode_wave's wide kernel (K > MAX_K): the hard rows at K = 131072
    (out_cap=131072) at rounds 0, 1, 5, 16 and 17, and at a ragged K."""
    for K in (WIDE_CAPS[1].out_cap, 2 * k_wave.MAX_K + 77):
        hard = wave_hard_rows(K, 300, SEED + 28)
        for rounds in (0, 1, 5, 16, 17):
            out = k_wave.decode_wave(*hard, rounds)
            torch.cuda.synchronize()
            note("decode_wave", (out, k_wave.decode_wave_plain(*hard, rounds)))


def crc_cases(note, rng) -> np.ndarray:
    """crc32 against its plain version and binascii: ragged n (0..3, 4, 5,
    15, 16, 17, 65535, 65536) at M = 1, 8, 64 and 133 (every row count a
    read-path batch makes, and more); the data
    pointer 1..15 bytes past 16-byte alignment (contiguous views with a
    storage offset, rows of an odd width); three rows of 600,999 bytes and
    one of 64 MiB + 5 bytes (many CTAs per row, n = K and K - 3).  Returns
    the long row."""
    def both(d, n):
        got = k_crc.crc32(d, n)
        torch.cuda.synchronize()
        note("crc32", (got, k_crc.crc32_plain(d, n)))
        host, nh = d.cpu().numpy(), n.cpu().numpy()
        check(got.tolist() == [binascii.crc32(host[j, : nh[j]].tobytes())
                               for j in range(len(nh))], "crc32 != binascii.crc32")

    ragged = [0, 1, 2, 3, 4, 5, 15, 16, 17, 4096, 8191, 65535, MAX_BLOCK]
    for m in (1, 8, 64, 133):
        data = torch.from_numpy(rng.integers(0, 256, (m, MAX_BLOCK), np.uint8)).to(DEV)
        n = torch.tensor([ragged[j % len(ragged)] if m > 1 else MAX_BLOCK
                          for j in range(m)], dtype=torch.int32, device=DEV)
        both(data, n)
    flat = torch.from_numpy(rng.integers(0, 256, 8 * (MAX_BLOCK + 7) + 16, np.uint8)).to(DEV)
    K = MAX_BLOCK + 7
    n = torch.tensor([K, K - 1, K - 9, 0, 3, 4, 17, 40000], dtype=torch.int32, device=DEV)
    for off in range(1, 16):
        view = flat[off: off + 8 * K].view(8, K)
        check(view.is_contiguous() and view.data_ptr() % 16 == off, "crc32 view offset")
        both(view, n)
    width = 600_999   # more than MAX_ITERS steps of a CTA: several CTAs per row
    multi = torch.from_numpy(rng.integers(0, 256, (3, width), np.uint8)).to(DEV)
    both(multi, torch.tensor([width, width - 5000, 3], dtype=torch.int32, device=DEV))
    long_row = rng.integers(0, 256, LONG_CRC_ROW, np.uint8)
    lr_dev = torch.from_numpy(long_row).to(DEV)[None]
    for n in (long_row.size, long_row.size - 3):
        both(lr_dev, torch.tensor([n], dtype=torch.int32, device=DEV))
    return long_row


def literal_block(data: bytes) -> bytes:
    """A valid block of one literals-only (final) sequence, of any length."""
    v = len(data)
    head = bytes([0xF0]) + b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255]) \
        if v >= 15 else bytes([v << 4])
    return head + data


def layout_cases(note, rows: list[bytes], hard: list[bytes]) -> None:
    """plan_layout against its plain version on the same header fields (the
    plan_speculative kernel's): the read-path rows and the chain-select rows
    at M = 8 and M = 64 under the default caps, with noise past n; at a
    width off 4 (is_start read one int32 at a time); caps that overflow
    (max_lit, max_match 40; out_cap 4099, off 4, so the writes go one int32
    at a time); small max_out; and the wide caps (B = 98,432, out_cap =
    131,072) with a 90,000-byte literal run."""
    def both(b, n, mo, caps: DevicePlanCaps):
        fields = k_plan.plan_speculative(b, n)
        kw = dict(max_lit=caps.max_lit, max_match=caps.max_match, out_cap=caps.out_cap)
        got = k_layout.plan_layout(*fields, n, mo, **kw)
        torch.cuda.synchronize()
        note("plan_layout", *zip(got, k_layout.plan_layout_plain(*fields, n, mo, **kw)))
        return got

    pool = rows + hard
    B = CAPS.blk_cap + ops.SPEC_PAD
    rng = np.random.default_rng(SEED + 30)
    for M in (8, 64):
        pick_rows = [pool[j % len(pool)] for j in range(M)] if M == 8 else \
            [pool[int(j) % len(pool)] for j in rng.permutation(max(M, len(pool)))[:M]]
        for garbage in (False, True):
            b, n = stack_rows(pick_rows, B, garbage, SEED + 31)
            mo = torch.full((M,), MAX_BLOCK, dtype=torch.int32, device=DEV)
            status = both(b, n, mo, CAPS)[0]
            check(int((status[:, ops.SPEC_ERR] == 0).sum()) > 0,
                  "plan_layout: no clean row among the checked rows")
        mo = torch.from_numpy(rng.integers(0, MAX_BLOCK + 1, M).astype(np.int32)).to(DEV)
        both(b, n, mo, CAPS)
        both(b, n, torch.full_like(mo, MAX_BLOCK),
             DevicePlanCaps(max_lit=40, max_match=40, out_cap=4099))
    ob, on = stack_rows(rows[:16], B + 3, True, SEED + 32)
    both(ob, on, torch.full((16,), MAX_BLOCK, dtype=torch.int32, device=DEV), CAPS)
    wide = [literal_block(rng.integers(0, 256, 90_000, np.uint8).tobytes())] + rows[:7]
    caps = DevicePlanCaps(blk_cap=WIDE_CAPS[0].blk_cap, out_cap=WIDE_CAPS[1].out_cap)
    wb, wn = stack_rows(wide, caps.blk_cap + ops.SPEC_PAD, True, SEED + 33)
    status, total = both(wb, wn, torch.full((8,), caps.out_cap, dtype=torch.int32,
                                            device=DEV), caps)[:2]
    check(int(total[0]) == 90_000, "plan_layout: the wide literal row's total")


def wide_times(spec_rows_wide, main_like: list[bytes]) -> dict:
    """Times of the two wide kernels at M = 8, with their bounds: not on any
    default path, so recorded, not tuned."""
    sb, sn = spec_rows_wide
    M, B = sb.shape
    K = WIDE_CAPS[1].out_cap
    plans = [to_device_plan(plan_block_fast(p), WIDE_CAPS[1]) for p in main_like[:M]]
    blk, _ = stack_rows(main_like[:M], CAPS.blk_cap)
    col = lambda f: torch.from_numpy(np.stack([getattr(d, f) for d in plans])).to(DEV)  # noqa: E731
    sc = lambda f: torch.tensor([getattr(d, f) for d in plans], dtype=torch.int32, device=DEV)  # noqa: E731
    total = sc("out_size")
    lit_blk, ptr = ops._decode_layout(
        col("lit_src"), col("lit_dst"), col("lit_len"), col("match_dst"),
        col("match_off"), sc("n_lit"), sc("n_match"), total, K)
    depth = max(d.n_waves for d in plans)
    Bw = blk.shape[1]
    out = {
        "plan_speculative_wide": timed(dict(
            bytes=M * B + 4 * M + 7 * 4 * M * B, ops=M * B * (40 + 16 * 4),
            run=lambda: k_plan.plan_speculative(sb, sn),
            plain=lambda: k_plan.plan_speculative_plain(sb, sn),
            plain_iters=2, iters=10), "plan_speculative_wide"),
        "decode_wave_wide": timed(dict(
            bytes=M * Bw + 2 * 4 * M * K + 4 * M + M * K, ops=M * K * (2 * depth + 4),
            run=lambda: k_wave.decode_wave(blk, lit_blk, ptr, total, 16),
            plain=lambda: k_wave.decode_wave_plain(blk, lit_blk, ptr, total, 16),
            plain_iters=2, iters=10), "decode_wave_wide"),
    }
    out["plan_speculative_wide"]["B"] = B
    out["decode_wave_wide"].update(K=K, depth_needed=depth)
    return {k: {f: v[f] for f in v if f != "operations"} for k, v in out.items()}


def phase_decode_kernels() -> dict:
    """The read path's kernels against their plain versions on the card,
    exact; times at M = 8 (the engine's micro-batch) and M = 64."""
    res, note = comparer(READ_KERNEL_MODULES)

    payloads, originals = card_payloads(64)
    # decode_wave: every round bucket, on the engine's layout of host plans
    blk, lit_blk, ptr, total, depth = wave_inputs(payloads[:32])
    for rounds in ROUND_BUCKETS:
        out = k_wave.decode_wave(blk, lit_blk, ptr, total, rounds)
        torch.cuda.synchronize()
        note("decode_wave", (out, k_wave.decode_wave_plain(blk, lit_blk, ptr, total, rounds)))
        if rounds >= depth:
            host = out.cpu().numpy()
            for j, o in enumerate(originals[:32]):
                check(host[j, : len(o)].tobytes() == o, f"decode_wave row {j} != input")
    # ... and on random maps with lit_blk out of range within total
    rng = np.random.default_rng(SEED + 7)
    K = CAPS.out_cap
    g_lit = torch.from_numpy(rng.integers(-2 * CAPS.blk_cap, 2 * CAPS.blk_cap,
                                          (8, K)).astype(np.int32)).to(DEV)
    g_ptr = torch.from_numpy(rng.integers(0, K, (8, K)).astype(np.int32)).to(DEV)
    g_tot = torch.from_numpy(rng.integers(0, K + 1, 8).astype(np.int32)).to(DEV)
    for rounds in (1, 16):
        out = k_wave.decode_wave(blk[:8], g_lit, g_ptr, g_tot, rounds)
        torch.cuda.synchronize()
        note("decode_wave", (out, k_wave.decode_wave_plain(blk[:8], g_lit, g_ptr, g_tot, rounds)))

    wave_edge_cases(note, blk, lit_blk, ptr, total, payloads, originals)

    # plan_speculative: valid, truncated, flipped, 0xFF runs, tiny n; zeros
    # and noise past n
    rows = spec_rows(payloads[:32])
    for garbage in (False, True):
        sb, sn = stack_rows(rows, CAPS.blk_cap + ops.SPEC_PAD, garbage, SEED + 8)
        got = k_plan.plan_speculative(sb, sn)
        torch.cuda.synchronize()
        note("plan_speculative", *zip(got, k_plan.plan_speculative_plain(sb, sn)))
    # ... and the rows that stress its chunked chain select
    hard = spec_hard_rows()
    for garbage in (False, True):
        hb, hn = stack_rows(hard, CAPS.blk_cap + ops.SPEC_PAD, garbage, SEED + 22)
        got = k_plan.plan_speculative(hb, hn)
        torch.cuda.synchronize()
        note("plan_speculative", *zip(got, k_plan.plan_speculative_plain(hb, hn)))
        check(int(got[0][0].sum()) == -(-CAPS.blk_cap // 3),
              "plan_speculative: the longest chain's header count")
    # ... at a width not a multiple of 16, so that rows past the first start
    # off 16-byte alignment and take the kernel's byte staging
    for garbage in (False, True):
        ob, on = stack_rows(rows[:16], CAPS.blk_cap + ops.SPEC_PAD + 3, garbage, SEED + 25)
        got = k_plan.plan_speculative(ob, on)
        torch.cuda.synchronize()
        note("plan_speculative", *zip(got, k_plan.plan_speculative_plain(ob, on)))
    # ... at the widest row the shared-memory kernel takes, and one byte
    # wider (the wide kernel, per-offset tables in device memory)
    lim = k_plan.max_b()
    check(90_000 < lim < k_plan.MAX_B, f"plan_speculative: max_b() = {lim}")
    r = np.random.default_rng(SEED + 23)
    wide = [chain_row(r, lim - 1), r.integers(0, 256, lim - 1, np.uint8).tobytes()]
    for width in (lim, lim + 1):
        wb, wn = stack_rows(wide, width, True, SEED + 24)
        got = k_plan.plan_speculative(wb, wn)
        torch.cuda.synchronize()
        note("plan_speculative", *zip(got, k_plan.plan_speculative_plain(wb, wn)))
    spec_wide = plan_wide_cases(note, rows)
    # plan_layout: on the header kernel's fields of the same rows
    layout_cases(note, rows, hard)
    # the fused plan + decode + CRC of the engine, card against CPU
    mo = torch.full((len(rows),), MAX_BLOCK, dtype=torch.int32, device=DEV)
    kw = dict(out_cap=CAPS.out_cap, max_lit=CAPS.max_lit,
              max_match=CAPS.max_match, rounds=16, compute_crc=True)
    on_card = ops.plan_decode(sb, sn, mo, **kw)
    on_cpu = ops.plan_decode(sb.cpu(), sn.cpu(), mo.cpu(), **kw)
    for a, b in zip(on_card, on_cpu):
        check(torch.equal(a.cpu(), b), "plan_decode on the card != on the CPU")

    # decode_wave: tables wider than the cluster kernel's (the wide kernel)
    wave_wide_cases(note)

    # crc32: ragged rows, every row count the read path makes and more, rows
    # off 16-byte alignment, rows of several clusters, one long row; also
    # against binascii
    long_row = crc_cases(note, rng)

    # -- times at M = 8 and M = 64, on blocks of the main path's data --------
    main_like, _ = card_payloads(64, adversarial=False)
    timing = {}
    for M in (8, 64):
        blk, lit_blk, ptr, total, depth = wave_inputs(main_like[:M])
        sb, sn = stack_rows(main_like[:M], CAPS.blk_cap + ops.SPEC_PAD)
        rows_u8 = k_wave.decode_wave(blk, lit_blk, ptr, total, 16)
        B, K, Bs = CAPS.blk_cap, CAPS.out_cap, CAPS.blk_cap + ops.SPEC_PAD
        used = int(total.sum())
        fields = k_plan.plan_speculative(sb, sn)
        mo = torch.full((M,), MAX_BLOCK, dtype=torch.int32, device=DEV)
        lkw = dict(max_lit=CAPS.max_lit, max_match=CAPS.max_match, out_cap=K)
        nodes = int(fields[0].sum())
        work = {
            # bytes: each input read once, each output written once;
            # operations: the doubling rounds these blocks need (`depth`).
            "decode_wave": dict(
                bytes=M * B + 2 * 4 * M * K + 4 * M + M * K,
                ops=M * K * (2 * depth + 4),
                run=lambda: k_wave.decode_wave(blk, lit_blk, ptr, total, 16),
                plain=lambda: k_wave.decode_wave_plain(blk, lit_blk, ptr, total, 16),
                plain_iters=3),
            "plan_speculative": dict(
                bytes=M * Bs + 4 * M + 7 * 4 * M * Bs,
                ops=M * Bs * (40 + 16 * 4),
                run=lambda: k_plan.plan_speculative(sb, sn),
                plain=lambda: k_plan.plan_speculative_plain(sb, sn),
                plain_iters=3),
            "crc32": dict(
                bytes=used + 4 * M + 8 * M,
                ops=2 * used,
                run=lambda: k_crc.crc32(rows_u8, total),
                plain=lambda: k_crc.crc32_plain(rows_u8, total),
                plain_iters=3),
            # bytes: is_start below n, six fields at each chain node, n and
            # max_out; out: the status, the total, lit_blk and ptr
            "plan_layout": dict(
                bytes=4 * int(sn.sum()) + 6 * 4 * nodes + 8 * M
                + 4 * (ops.SPEC_STATUS + 1) * M + 8 * M * K,
                ops=M * K * 4 + nodes * 16,
                run=lambda: k_layout.plan_layout(*fields, sn, mo, **lkw),
                plain=lambda: k_layout.plan_layout_plain(*fields, sn, mo, **lkw),
                plain_iters=3),
        }
        timing[M] = {name: timed(w, name) for name, w in work.items()}
        timing[M]["decode_wave"]["depth_needed"] = depth
        timing[M]["plan_layout"]["chain_nodes"] = nodes
        # the same launch without rounds (staging and output alone), and
        # random maps, where no round finds a fixed point and all 16 run
        g = torch.from_numpy(rng.integers(0, K, (M, K)).astype(np.int32)).to(DEV)
        timing[M]["decode_wave"]["device_ms_rounds0"] = kernel_device_ms(
            "decode_wave", lambda: k_wave.decode_wave(blk, lit_blk, ptr, total, 0))
        timing[M]["decode_wave"]["device_ms_random16"] = kernel_device_ms(
            "decode_wave", lambda: k_wave.decode_wave(blk, lit_blk, g, total, 16))
    lr_dev = torch.from_numpy(long_row).to(DEV)[None]
    lr = torch.tensor([long_row.size], dtype=torch.int32, device=DEV)
    crc_long = timed(dict(bytes=long_row.size + 12, ops=2 * long_row.size,
                          run=lambda: k_crc.crc32(lr_dev, lr),
                          plain=lambda: k_crc.crc32_plain(lr_dev, lr),
                          plain_iters=1, iters=10), "crc32")
    for name in res:
        res[name].update(timing[8][name])
    say("decode_kernels_check", tolerance=0, results=res,
        times_M64={k: {f: v[f] for f in v if f not in ("bytes", "operations")}
                   for k, v in timing[64].items()},
        crc32_long_row=dict(bytes=long_row.size, **{f: crc_long[f] for f in TIME_KEYS}),
        wide_paths=wide_times(spec_wide, main_like),
        shapes=dict(B=CAPS.blk_cap, B_spec=CAPS.blk_cap + ops.SPEC_PAD,
                    K=CAPS.out_cap, rows_spec=len(rows), rows_spec_hard=len(hard)))
    return res


def with_trailer(frame: bytes, data: bytes) -> bytes:
    """The same blocks as a frame with the whole-object CRC trailer (v5)."""
    blocks = frame_info(frame)["blocks"]
    return encode_frame(
        [frame[b["offset"]: b["offset"] + b["csize"]] for b in blocks],
        [b["usize"] for b in blocks], [b["raw"] for b in blocks],
        checksums=[b["crc"] for b in blocks], content_crc=block_crc(data))


def phase_read_small() -> None:
    """8 MiB through `LZ4DecodeEngine(device="cuda")`, host planning and
    on-device planning, every entry point: bytes == input, `DecodeStats`
    == the CPU plain-version engine's, and a flipped payload byte raises the
    CPU engine's message; also the frame rebuilt with the whole-object
    trailer (v5), whose CRC over the joined tensor runs on the device."""
    data = seeded_data(8 << 20, SEED + 5)
    frame = LZ4Engine(device=DEV).compress(data)
    info = frame_info(frame)
    blocks = info["blocks"]
    payloads = [frame[b["offset"]: b["offset"] + b["csize"]] for b in blocks]
    raws = [b["raw"] for b in blocks]
    usizes = [b["usize"] for b in blocks]
    lo, hi = MAX_BLOCK - 100, 3 * MAX_BLOCK
    victim = next(i for i, b in enumerate(blocks) if not b["raw"])
    mutant = bytearray(frame)
    mutant[blocks[victim]["offset"] + blocks[victim]["csize"] // 2] ^= 0x40
    v5 = with_trailer(frame, data)
    bad_trailer = bytearray(v5)
    bad_trailer[-1] ^= 0x01
    report = []
    for pod in (False, True):
        stats = {}
        for key, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
            eng = LZ4DecodeEngine(device=dev, plan_on_device=pod)
            st = stats[key] = {}
            check(eng.decode(frame) == data, f"decode ({dev}, {pod})")
            st["decode"] = eng.stats.as_dict()
            out = eng.decode_blocks(payloads, raws, usizes=usizes)
            check(b"".join(out) == data, f"decode_blocks ({dev}, {pod})")
            st["decode_blocks"] = eng.stats.as_dict()
            t = eng.decode_to_device(frame, verify=True)
            # torch.device("cuda") != torch.device("cuda:0"): compare types
            check(t.device.type == dev.type,
                  f"decode_to_device ({dev}, {pod}) returned a {t.device} tensor")
            check(t.cpu().numpy().tobytes() == data,
                  f"decode_to_device ({dev}, {pod}): bytes differ")
            check(eng.stats.host_bytes == 0, "decode_to_device fetched content")
            st["decode_to_device"] = eng.stats.as_dict()
            # with the whole-object trailer, checked on the device
            check(eng.decode_to_device(v5).cpu().numpy().tobytes() == data,
                  f"decode_to_device of the v5 frame ({dev}, {pod})")
            st["decode_to_device_v5"] = eng.stats.as_dict()
            r = FrameReader(frame, engine=eng).read_range_device(lo, hi - lo)
            check(r.cpu().numpy().tobytes() == data[lo:hi], "read_range_device")
            errors = []
            for call, bad in ((eng.decode, mutant), (eng.decode_to_device, mutant),
                              (eng.decode_to_device, bad_trailer)):
                try:
                    call(bytes(bad))
                    errors.append(None)
                except FrameFormatError as e:
                    errors.append(str(e))
            check(all(errors), f"a flipped payload or trailer byte decoded ({dev}, {pod})")
            st["errors"] = errors
        check(stats["card"] == stats["cpu"],
              f"card and CPU engines differ (plan_on_device={pod}): {stats}")
        report.append(dict(plan_on_device=pod, stats=stats["card"]))
    say("read_small", bytes=len(data), frame_bytes=len(frame),
        blocks=len(blocks), raw_blocks=sum(raws), equal_to_cpu=True,
        runs=report, wide_caps=read_wide_caps(frame, data))


def read_wide_caps(frame: bytes, data: bytes) -> list:
    """Caps wider than the kernels' defaults (ROADMAP C2): the 8 MiB frame
    with `blk_cap=98304` under on-device planning (plan_speculative's wide
    kernel) and `out_cap=131072` under both planners (decode_wave's), and a
    frame whose one block is a corrupt payload wider than `max_b() -
    SPEC_PAD` but within `blk_cap`.  Bytes == input, `DecodeStats` and error
    messages == the CPU engine's, and the launch counts show the kernels
    ran."""
    rng = np.random.default_rng(SEED + 29)
    check(WIDE_PAYLOAD > k_plan.max_b() - ops.SPEC_PAD, "the corrupt payload is not wide")
    bad = encode_frame([rng.integers(0, 256, WIDE_PAYLOAD, np.uint8).tobytes()],
                       [MAX_BLOCK], [False], checksums=[0])
    runs = []
    for caps, pod in ((WIDE_CAPS[0], True), (WIDE_CAPS[1], False), (WIDE_CAPS[1], True)):
        stats = {}
        for key, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
            eng = LZ4DecodeEngine(device=dev, plan_on_device=pod, caps=caps)
            st = stats[key] = {}
            reset_launches(READ_KERNEL_MODULES)
            check(eng.decode(frame) == data, f"wide caps decode ({dev}, {caps}, {pod})")
            launches = launch_counts(READ_KERNEL_MODULES)
            st["decode"] = eng.stats.as_dict()
            if key == "card":
                d = eng.stats.dispatches
                want = read_want(d, d if pod else 0, 0)
                check(d > 0 and launches == want,
                      f"wide caps ({caps}, {pod}): launches {launches}, want {want}")
                card_launches = launches
            t = eng.decode_to_device(frame, verify=True)
            check(t.cpu().numpy().tobytes() == data and eng.stats.host_bytes == 0,
                  f"wide caps decode_to_device ({dev}, {caps}, {pod})")
            st["decode_to_device"] = eng.stats.as_dict()
            errors = []
            for call in (eng.decode, eng.decode_to_device):
                try:
                    call(bad)
                    errors.append(None)
                except FrameFormatError as e:
                    errors.append(str(e))
            check(all(errors), f"the wide corrupt payload decoded ({dev}, {caps}, {pod})")
            st["errors"] = errors
            st["fallback_blocks_of_corrupt"] = eng.stats.fallback_blocks
        check(stats["card"] == stats["cpu"],
              f"wide caps: card and CPU engines differ ({caps}, {pod}): {stats}")
        runs.append(dict(caps=dict(blk_cap=caps.blk_cap, out_cap=caps.out_cap),
                         plan_on_device=pod, launches=card_launches, stats=stats["card"]))
    return runs


def phase_read_full(frame: bytes, data: bytes) -> dict:
    """The read path at full size: the 256 MiB frame of `path_full` through
    `LZ4DecodeEngine(device="cuda", plan_on_device=True)` at micro-batch 8
    (the default: THE read path, whose launch counts are returned) and 64,
    the same blocks as a v5 frame (whole-object trailer), then the
    host-planned device path at 32 MiB."""
    data_dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(DEV)
    info = frame_info(frame)
    coded = sum(b["usize"] for b in info["blocks"] if not b["raw"])
    LZ4DecodeEngine(device=DEV, plan_on_device=True).decode_to_device(frame)
    runs, main = [], None

    def one(eng, method, frame, want_dev, want_host, coded):
        reset_launches(READ_KERNEL_MODULES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(eng, method)(frame)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts(READ_KERNEL_MODULES)
        st = eng.stats
        if method == "decode_to_device":
            check(torch.equal(out, want_dev), "decode_to_device bytes differ")
            check(st.host_bytes == 0, "decode_to_device fetched content")
        else:
            check(out == want_host, "decode bytes differ")
            check(st.host_bytes == coded, "host_bytes != decoded coded blocks")
        check(st.fallback_blocks == 0, "a block fell back to the host")
        return dt, launches, st

    for mb in (8, 64):
        eng = LZ4DecodeEngine(device=DEV, plan_on_device=True, micro_batch=mb)
        for method in ("decode_to_device", "decode"):
            dt, launches, st = one(eng, method, frame, data_dev, data, coded)
            want = read_want(st.dispatches, st.dispatches,
                             st.dispatches if method == "decode_to_device" else 0)
            check(launches == want, f"{method} mb={mb}: launches {launches} "
                  f"for {st.dispatches} dispatches")
            if mb == 8 and method == "decode_to_device":
                main = launches
            runs.append(dict(plan_on_device=True, micro_batch=mb, method=method,
                             seconds=dt, output_GB_per_s=len(data) / dt / 1e9,
                             blocks_per_s=st.blocks / dt,
                             host_bytes=st.host_bytes,
                             host_bytes_per_output_byte=st.host_bytes / len(data),
                             fallback_blocks=st.fallback_blocks,
                             stats=st.as_dict(), launches=launches))
    # The same blocks with the whole-object trailer: one more crc32 launch,
    # over the joined 256 MiB tensor.
    eng = LZ4DecodeEngine(device=DEV, plan_on_device=True)
    dt, launches, st = one(eng, "decode_to_device", with_trailer(frame, data),
                           data_dev, data, coded)
    check(launches == read_want(st.dispatches, st.dispatches, st.dispatches + 1),
          f"v5 decode_to_device: launches {launches} for {st.dispatches} dispatches")
    runs.append(dict(plan_on_device=True, micro_batch=8, method="decode_to_device",
                     trailer=True, seconds=dt, output_GB_per_s=len(data) / dt / 1e9,
                     blocks_per_s=st.blocks / dt, host_bytes=st.host_bytes,
                     host_bytes_per_output_byte=st.host_bytes / len(data),
                     fallback_blocks=st.fallback_blocks, stats=st.as_dict(),
                     launches=launches))
    small = data[: 32 << 20]
    small_frame = LZ4Engine(device=DEV).compress(small)
    s_coded = sum(b["usize"] for b in frame_info(small_frame)["blocks"] if not b["raw"])
    eng = LZ4DecodeEngine(device=DEV)
    for method in ("decode_to_device", "decode"):
        dt, launches, st = one(eng, method, small_frame, data_dev[: len(small)],
                               small, s_coded)
        want = read_want(st.dispatches, 0,
                         st.dispatches if method == "decode_to_device" else 0)
        check(launches == want, f"host-planned {method}: launches {launches}")
        runs.append(dict(plan_on_device=False, micro_batch=8, method=method,
                         seconds=dt, output_GB_per_s=len(small) / dt / 1e9,
                         blocks_per_s=st.blocks / dt, host_bytes=st.host_bytes,
                         host_bytes_per_output_byte=st.host_bytes / len(small),
                         fallback_blocks=st.fallback_blocks,
                         stats=st.as_dict(), launches=launches))
    say("read_full", bytes=len(data), frame_bytes=len(frame),
        blocks=len(info["blocks"]), runs=runs,
        peak_device_MiB=torch.cuda.max_memory_allocated() / 2**20)
    return main


def profile_device(fn) -> dict | str:
    """Device busy time and idle share of one call of `fn` under
    torch.profiler (device-side rows only)."""
    try:  # the profiler is an extra: a card it cannot trace is reported, not fatal
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            # Device-side rows only: an operator's row repeats the time of
            # the kernels it launched.
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((ev.key, us / 1e6, ev.count))
        busy = sum(r[1] for r in rows)
        if busy <= 0:
            return "not measured (the profiler saw no device time)"
        rows.sort(key=lambda r: -r[1])
        return dict(wall_seconds_under_profiler=prof_wall, busy_seconds=busy,
                    idle_share=1 - busy / prof_wall,
                    device_ops=sum(r[2] for r in rows),
                    top=[dict(name=k[:60], seconds=t, count=c) for k, t, c in rows[:12]])
    except Exception as e:  # noqa: BLE001
        return f"not measured ({type(e).__name__}: {e})"


def span_table(fn) -> tuple[dict, float]:
    """The engine's own spans over one call of `fn` (telemetry on)."""
    from repro_torch import obs

    obs.reset()
    obs.configure(nvtx=True)   # every span also pushes/pops an NVTX range
    check(obs.tracer()._nvtx_module() is not None, "NVTX bridge did not arm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    obs.configure(nvtx=False)
    spans: dict[str, list[float]] = {}
    for r in obs.tracer().finished():
        spans.setdefault(r["name"], []).append(r["dur_ns"] / 1e9)
    obs.reset()
    return {k: dict(count=len(v), seconds=sum(v)) for k, v in sorted(spans.items())}, wall


def phase_read_breakdown(data: bytes) -> None:
    """Where the read path's wall time goes: spans of one
    `decode_to_device(verify=True)` (plan_on_device, micro-batch 8) over a
    64 MiB frame, and the device's idle share under the profiler."""
    frame = LZ4Engine(device=DEV).compress(data)
    eng = LZ4DecodeEngine(device=DEV, plan_on_device=True, telemetry=True)
    table, wall = span_table(lambda: eng.decode_to_device(frame))
    plain = LZ4DecodeEngine(device=DEV, plan_on_device=True)
    device = profile_device(lambda: plain.decode_to_device(frame))
    say("read_breakdown", bytes_out=len(data), frame_bytes=len(frame),
        micro_batch=8, wall_seconds=wall, spans=table, device=device)


def phase_path_small() -> tuple[bytes, bytes]:
    data = seeded_data(8 << 20, SEED + 3)
    t0 = time.perf_counter()
    cpu = LZ4Engine(device="cpu")
    ref_frame = cpu.compress(data)
    cpu_s = time.perf_counter() - t0
    combos = []
    for device_emit in (True, False):
        for drain in ("sliced", "full"):
            for scan_impl in ("sequential", "associative"):
                eng = LZ4Engine(device=DEV, device_emit=device_emit,
                                drain=drain, scan_impl=scan_impl)
                frame = eng.compress(data)
                check(frame == ref_frame,
                      f"frame differs from the CPU plain-version frame "
                      f"(device_emit={device_emit}, drain={drain}, {scan_impl})")
                combos.append(dict(device_emit=device_emit, drain=drain,
                                   scan_impl=scan_impl,
                                   host_bytes=eng.stats.host_bytes,
                                   dispatches=eng.stats.dispatches))
    check(decode_frame_serial(ref_frame) == data, "8 MiB frame does not round-trip")
    say("path_small", bytes_in=len(data), frame_bytes=len(ref_frame),
        cpu_plain_seconds=round(cpu_s, 3), cpu_stats=cpu.stats.as_dict(),
        frames_equal=len(combos), combos=combos, round_trip=True)
    return data, ref_frame


def verify_frame(frame: bytes, data: bytes, sample: int, seed: int) -> dict:
    info = frame_info(frame)
    nblocks = -(-len(data) // MAX_BLOCK)
    check(len(info["blocks"]) == nblocks, "frame block count is wrong")
    check(info["content_size"] == len(data), "frame content size is wrong")
    check(sum(b["usize"] for b in info["blocks"]) == len(data), "usize total")
    rng = np.random.default_rng(seed)
    picks = sorted(set(rng.choice(nblocks, size=min(sample, nblocks),
                                  replace=False).tolist()) | {0, nblocks - 1})
    raw = 0
    for i in picks:
        b = info["blocks"][i]
        payload = frame[b["offset"]: b["offset"] + b["csize"]]
        out = payload if b["raw"] else decode_block(payload, max_out=b["usize"])
        raw += bool(b["raw"])
        check_block(i, b["usize"], b["crc"], out)
        check(out == data[i * MAX_BLOCK: (i + 1) * MAX_BLOCK],
              f"block {i} does not decode to its input")
    return dict(blocks=nblocks, sampled=len(picks), sampled_raw=raw,
                version=info["version"])


def phase_path_full(data: bytes, micro_batch: int) -> tuple[dict, bytes, dict]:
    """The main path at full size.  Counts are zeroed just before and read
    just after; each dispatch must have launched each kernel once."""
    eng = LZ4Engine(device=DEV, micro_batch=micro_batch)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = eng.compress(data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(KERNEL_MODULES)
    st = eng.stats
    for name, n in launches.items():
        check(n == st.dispatches and n > 0,
              f"{name}: {n} launches for {st.dispatches} dispatches")
    verified = verify_frame(frame, data, sample=96, seed=SEED + micro_batch)
    check(st.raw_blocks > 0, "no raw passthrough block in the run")
    say("path_full", micro_batch=micro_batch, bytes_in=len(data),
        frame_bytes=len(frame), frame_sha256=hashlib.sha256(frame).hexdigest(),
        ratio=len(data) / len(frame), seconds=seconds, input_GB_per_s=len(data) / seconds / 1e9,
        blocks_per_s=st.blocks / seconds,
        host_bytes_per_input_byte=st.host_bytes / len(data),
        stats=st.as_dict(), launches=launches, verified=verified,
        peak_device_MiB=torch.cuda.max_memory_allocated() / 2**20)
    return launches, frame, dict(seconds=seconds, input_GB_per_s=len(data) / seconds / 1e9,
                                 dispatches=st.dispatches, launches=dict(launches))


def phase_breakdown(data: bytes) -> None:
    """Where the write path's wall time goes: the engine's own spans
    (telemetry on) over one call, and — where the profiler can trace the
    card — the share of the wall time the device was busy."""
    eng = LZ4Engine(device=DEV, telemetry=True)
    table, wall = span_table(lambda: eng.compress(data))
    plain = LZ4Engine(device=DEV)
    device = profile_device(lambda: plain.compress(data))
    say("breakdown", bytes_in=len(data), micro_batch=32, wall_seconds=wall,
        spans=table, device=device)


def staged_want(st, scan_impl: str = "sequential", device_emit: bool = True) -> dict:
    """Launches one staged-path call must show: the two staged kernels once
    per dispatch, the select and emit kernels where the call runs them, and
    never the fused kernel."""
    d = st.dispatches
    return dict(fused_compress=0, emit_scatter=d if device_emit else 0,
                window_select=d if scan_impl == "sequential" else 0,
                fibhash=d, match_extend=d)


def phase_path_staged_small(data: bytes, ref_frame: bytes) -> None:
    """8 MiB (the data of `path_small`) through the staged path, every
    candidate stage, both selects and once with host emission: each frame ==
    the CPU plain-version frame `path_small` computed."""
    combos = []
    for impl in STAGED_IMPLS:
        for scan_impl, device_emit in (("sequential", True), ("associative", True),
                                       ("sequential", False)):
            eng = LZ4Engine(device=DEV, candidate_impl=impl, scan_impl=scan_impl,
                            device_emit=device_emit)
            reset_launches(ALL_KERNEL_MODULES)
            frame = eng.compress(data)
            torch.cuda.synchronize()
            launches = launch_counts(ALL_KERNEL_MODULES)
            check(frame == ref_frame,
                  f"staged frame differs from the CPU plain-version frame "
                  f"({impl}, {scan_impl}, device_emit={device_emit})")
            check(eng.stats.candidate_impl == impl, "stats.candidate_impl")
            want = staged_want(eng.stats, scan_impl, device_emit)
            check(launches == want, f"{impl}/{scan_impl}/{device_emit}: "
                  f"launches {launches}, want {want}")
            combos.append(dict(candidate_impl=impl, scan_impl=scan_impl,
                               device_emit=device_emit,
                               dispatches=eng.stats.dispatches,
                               host_bytes=eng.stats.host_bytes))
    say("path_staged_small", bytes_in=len(data), frames_equal=len(combos),
        combos=combos)


def phase_path_staged_full(data: bytes, full_frame: bytes) -> dict:
    """The staged path at full size (256 MiB, micro-batch 32, engine
    defaults): ``candidate_impl="scatter"`` (the JAX package's choice on a
    GPU) and ``"sortkey"``; each frame == the frame `path_full` wrote.
    Counts are zeroed just before and read just after each call; returns
    the scatter run's."""
    runs, main = [], None
    for impl in ("scatter", "sortkey"):
        eng = LZ4Engine(device=DEV, candidate_impl=impl)
        eng.compress(data[: 32 << 20])          # unmeasured: allocator growth
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ALL_KERNEL_MODULES)
        t0 = time.perf_counter()
        frame = eng.compress(data)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts(ALL_KERNEL_MODULES)
        st = eng.stats
        check(frame == full_frame,
              f"{impl}: the 256 MiB frame differs from path_full's")
        check(launches == staged_want(st) and st.dispatches > 0,
              f"{impl}: launches {launches} for {st.dispatches} dispatches")
        if impl == "scatter":
            main = launches
        runs.append(dict(candidate_impl=impl, seconds=seconds,
                         input_GB_per_s=len(data) / seconds / 1e9,
                         blocks_per_s=st.blocks / seconds,
                         host_bytes_per_input_byte=st.host_bytes / len(data),
                         peak_device_MiB=torch.cuda.max_memory_allocated() / 2**20,
                         stats=st.as_dict(), launches=launches))
    say("path_staged_full", bytes_in=len(data), frame_bytes=len(full_frame),
        frame_sha256=hashlib.sha256(full_frame).hexdigest(), micro_batch=32,
        frames_equal_path_full=True, runs=runs)
    return main


def phase_staged_breakdown(data: bytes) -> None:
    """Where the staged path's (scatter) wall time goes: engine spans over
    one call and the device's idle share and largest rows under the
    profiler, as `breakdown` does for the fused path."""
    eng = LZ4Engine(device=DEV, candidate_impl="scatter", telemetry=True)
    table, wall = span_table(lambda: eng.compress(data))
    plain = LZ4Engine(device=DEV, candidate_impl="scatter")
    device = profile_device(lambda: plain.compress(data))
    say("staged_breakdown", candidate_impl="scatter", bytes_in=len(data),
        micro_batch=32, wall_seconds=wall, spans=table, device=device)


# -- the resilience layer and the engines' consumers ------------------------

def scratch_dir(name: str) -> Path:
    d = SCRATCH / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def counted(fn, *engines):
    """Run ``fn()`` with every kernel's launch count set to 0 just before
    and read just after.  Returns (result, seconds on the host clock ending
    in a synchronize, launches, dispatches each engine issued in between)."""
    d0 = [e.totals.dispatches for e in engines]
    reset_launches(EVERY_KERNEL_MODULE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (out, dt, launch_counts(EVERY_KERNEL_MODULE),
            [e.totals.dispatches - d for e, d in zip(engines, d0)])


def pick(launches: dict, names) -> dict:
    return {k: launches[k] for k in names}


def block_span(info: dict, i: int) -> tuple[int, int]:
    start = sum(b["usize"] for b in info["blocks"][:i])
    return start, start + info["blocks"][i]["usize"]


def tree_leaves(tree) -> list:
    return flatten(tree)[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and a.device.type == b.device.type
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.to(a.device).reshape(-1).view(torch.uint8)))


def trees_same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same_bits(x, y) for x, y in zip(la, lb))


def as_meta(tree):
    return tree_map(lambda x: torch.empty_like(x, device="meta"), tree)


def training_state(cache: bytes, layers: int, width: int, seed: int) -> dict:
    """A training state on the card: `layers` float32 (width, width) seeded
    normal weights, their bfloat16 copies, an int32 step and a uint8 data
    cache (the compressible leaf)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    params = {f"layer_{i:02d}": torch.randn((width, width), generator=g, device=DEV)
              for i in range(layers)}
    return {"params": params,
            "params_bf16": {k: v.to(torch.bfloat16) for k, v in params.items()},
            "step": torch.tensor(seed, dtype=torch.int32, device=DEV),
            "data_cache": torch.frombuffer(bytearray(cache), dtype=torch.uint8).to(DEV)}


def leaf_entry(ckpt_path: Path, leaf: str) -> dict:
    man = json.loads((ckpt_path / "manifest.json").read_text())
    return next(e for e in man["leaves"] if e["path"] == leaf)


def damage_block(ckpt_path: Path, block: dict) -> bytes:
    """Overwrite the first 16 bytes of one stored LZ4 block in data.bin with
    0xFF (its first token and length bytes: a literal run past the block's
    end, so the block cannot decode — seeded bit flips can leave a block
    that decodes to the right size, which only the leaf's CRC catches).
    Returns the block's original bytes."""
    with open(ckpt_path / "data.bin", "r+b") as f:
        f.seek(block["offset"])
        orig = f.read(block["size"])
        f.seek(block["offset"])
        f.write(b"\xff" * 16)
    return orig


def cpu_report(frame: bytes, plan_on_device: bool) -> dict:
    """The CPU engine's `SalvageReport` of ``frame`` as a dict (run in the
    worker processes of `phase_resilience_small`)."""
    torch.set_num_threads(1)
    eng = LZ4DecodeEngine(device="cpu", plan_on_device=plan_on_device)
    return dataclasses.asdict(eng.salvage(frame))


def phase_resilience_small() -> None:
    """Salvage and v6 parity reconstruction on the card, 8 MiB compressed
    there as v3 and as v6 (`parity_group=4`): for seeds 0, 1, 2 one block
    corrupted, salvaged under both planners (the v6 block rebuilt, the v3
    block lost with exactly its span as the hole); then a truncated frame,
    two damaged blocks in one group, a damaged parity payload, and
    `FrameReader` in salvage mode.  Every `SalvageReport` == the CPU
    engine's field by field on the same bytes (computed meanwhile in worker
    processes); every per-block dispatch launched `decode_wave` (and
    `plan_speculative` with on-device planning) once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t_phase = time.perf_counter()
    data = seeded_data(RESILIENCE_BYTES, SEED + 6)
    v3 = LZ4Engine(device=DEV).compress(data)
    v6 = LZ4Engine(device=DEV, parity_group=4).compress(data)
    info = frame_info(v3)
    n = len(info["blocks"])
    card = {pod: LZ4DecodeEngine(device=DEV, plan_on_device=pod) for pod in (False, True)}
    cases = []   # (name, frame, plan_on_device, check of the report)

    def whole(victim):
        return lambda r: (r.reconstructed == [victim] and r.lost == [] and r.data == data
                          and r.content_crc_ok is True)

    def hole(victim):
        lo, hi = block_span(info, victim)
        return lambda r: (r.lost == [victim] and r.holes == [(lo, hi)]
                          and r.data[:lo] == data[:lo] and r.data[hi:] == data[hi:]
                          and r.data[lo:hi] == bytes(hi - lo))

    rng = np.random.default_rng(SEED + 31)
    for seed in (0, 1, 2):
        victim = int(rng.integers(0, n))
        for pod in (False, True):
            cases.append((f"v6, seed {seed}, block {victim}",
                          corrupt_frame_block(v6, victim, seed, n=3), pod, whole(victim)))
            cases.append((f"v3, seed {seed}, block {victim}",
                          corrupt_frame_block(v3, victim, seed, n=3), pod, hole(victim)))
    lo5 = block_span(info, 5)[0]
    cut = info["blocks"][5]["offset"] + 10
    for pod in (False, True):
        cases.append(("v3 truncated inside block 5", v3[:cut], pod,
                      lambda r: (r.ok == list(range(5)) and r.holes == [(lo5, len(data))]
                                 and r.data[:lo5] == data[:lo5])))
    two = corrupt_frame_block(corrupt_frame_block(v6, 8, 0, n=3), 9, 1, n=3)
    cases.append(("v6, blocks 8 and 9 of group 2 damaged", two, False,
                  lambda r: (r.lost == [8, 9] and r.reconstructed == []
                             and "damaged" in r.errors[8])))
    p = frame_info(v6)["parity"][3]
    cases.append(("v6, block 12 and the parity payload of group 3 damaged",
                  flip_bits(corrupt_frame_block(v6, 12, 2, n=3), 2, 3, p["offset"],
                            p["offset"] + p["plen"]), True,
                  lambda r: r.lost == [12] and "failed its CRC" in r.errors[12]))
    bad = corrupt_frame_block(v6, 20, 4, n=3)
    runs = []
    totals = dict.fromkeys(READ_KERNELS, 0)
    with ProcessPoolExecutor(max_workers=6,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        want = [pool.submit(cpu_report, frame, pod) for _, frame, pod, _ in cases]
        want_reader = pool.submit(cpu_report, bad, True)
        for (name, frame, pod, ok), fut in zip(cases, want):
            eng = card[pod]
            rep, dt, launches, (d,) = counted(lambda: eng.salvage(frame), eng)
            check(ok(rep), f"{name} (plan_on_device={pod}): {rep.ok=} {rep.lost=} "
                  f"{rep.reconstructed=} {rep.holes=}")
            got = pick(launches, READ_KERNELS)
            check(d > 0 and got == read_want(d, d if pod else 0, 0),
                  f"{name} (plan_on_device={pod}): launches {got} for {d} dispatches")
            check(dataclasses.asdict(rep) == fut.result(),
                  f"{name} (plan_on_device={pod}): the card's SalvageReport differs "
                  "from the CPU engine's")
            for k in totals:
                totals[k] += got[k]
            runs.append(dict(case=name, plan_on_device=pod, seconds=dt, dispatches=d,
                             launches=got, ok=len(rep.ok), reconstructed=rep.reconstructed,
                             lost=rep.lost, holes=rep.holes,
                             content_crc_ok=rep.content_crc_ok))
        # FrameReader, and the refusals this slice removed (on_error="salvage",
        # salvage(), FrameReader(on_error="salvage"), FrameReader.salvage()).
        rep = FrameReader(bad, engine=card[True]).salvage()
        check(rep.reconstructed == [20] and rep.data == data
              and dataclasses.asdict(rep) == want_reader.result(), "FrameReader.salvage")
    tolerant = FrameReader(v3[:cut], engine=card[True], on_error="salvage")
    check(tolerant.block_count == n and tolerant.read_range(1000, 200_000) == data[1000:201_000]
          and tolerant.read_range_device(70_000, 9_000).cpu().numpy().tobytes()
          == data[70_000:79_000], "FrameReader(on_error='salvage') reads")
    try:
        tolerant.read_block(5)
        check(False, "a read of the cut block decoded")
    except FrameFormatError:
        pass
    eng = LZ4DecodeEngine(device=DEV, on_error="salvage")
    check(eng.decode(bad) == data and eng.last_salvage.reconstructed == [20]
          and eng.decode(v3) == data, "LZ4DecodeEngine(on_error='salvage').decode")
    say("resilience_small", bytes=len(data), blocks=n, frame_bytes=dict(v3=len(v3), v6=len(v6)),
        reports_equal_to_cpu=len(runs) + 1, launches_total=totals, runs=runs,
        seconds=time.perf_counter() - t_phase)


def phase_checkpoint_full(data: bytes) -> None:
    """`checkpoint.save` / `restore` of a ~0.8 GiB training state on the card
    (24 float32 2048 x 2048 leaves, their bfloat16 copies, a step, the 256
    MiB data as a uint8 cache), saved by the default engine and restored by
    `LZ4DecodeEngine(plan_on_device=True)` (the host planner would make the
    restore host-bound): every leaf equal, the write kernels once per
    compress dispatch, `plan_speculative` and `decode_wave` once per decode
    dispatch; a damaged block makes the strict restore raise and
    `restore_with_fallback` step back once, an undamaged directory none.
    On a 22 MiB twin: a salvage restore zero-fills exactly the damaged
    block, each crash seam leaves the last complete step, injected I/O
    faults are retried.  A 2 MiB tree writes the same bytes on the card and
    on the CPU."""
    from repro_torch import obs

    t_phase = time.perf_counter()
    root = scratch_dir("checkpoint_full")
    state = training_state(data, layers=STATE_LAYERS, width=STATE_WIDTH, seed=SEED + 40)
    like = as_meta(state)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    enc, dec = default_engine(), LZ4DecodeEngine(device=DEV, plan_on_device=True)
    saves = []

    def save(step: int, tree) -> None:
        _, dt, launches, (d,) = counted(lambda: ckpt.save(str(root), step, tree), enc)
        got = pick(launches, WRITE_KERNELS)
        check(d > 0 and all(v == d for v in got.values()),
              f"save {step}: launches {got} for {d} dispatches")
        saves.append(dict(step=step, seconds=dt, GB_per_s=nbytes / dt / 1e9,
                          dispatches=d, launches=got))

    save(1, state)
    sha = hashlib.sha256((root / "ckpt_1" / "data.bin").read_bytes()).hexdigest()
    data_bin = (root / "ckpt_1" / "data.bin").stat().st_size
    (tree, step), dt, launches, (d,) = counted(
        lambda: ckpt.restore(str(root), 1, like, decode_engine=dec), dec)
    got = pick(launches, READ_KERNELS)
    check(step == 1 and trees_same(tree, state), "restore 1: leaves differ")
    check(d > 0 and got == read_want(d, d, 0),
          f"restore 1: launches {got} for {d} dispatches")
    restored = dict(step=1, seconds=dt, GB_per_s=nbytes / dt / 1e9, dispatches=d,
                    launches=got)
    del tree
    state2 = dict(state, step=state["step"] + 1)
    save(2, state2)
    # One compressed block of the data cache damaged in step 2.
    entry = leaf_entry(root / "ckpt_2", "/data_cache")
    coded = [b for b in entry["blocks"] if b["lz4"]]
    block = coded[len(coded) // 3]
    orig = damage_block(root / "ckpt_2", block)
    try:
        ckpt.restore(str(root), 2, like, decode_engine=dec)
        check(False, "the strict restore of a damaged step succeeded")
    except ckpt.CheckpointError as e:
        strict_error = str(e)
    obs.configure(enabled=True)
    fallback = []
    try:
        for damaged in (True, False):
            obs.reset()
            (tree, step), dt, _, _ = counted(
                lambda: ckpt.restore_with_fallback(str(root), like, decode_engine=dec))
            steps = obs.snapshot()["metrics"]["counters"].get("checkpoint.fallback_steps", 0)
            want_step = 1 if damaged else 2
            check(step == want_step and steps == (1 if damaged else 0)
                  and trees_same(tree, state if damaged else state2),
                  f"restore_with_fallback (damaged={damaged}): step {step}, "
                  f"fallback_steps {steps}")
            fallback.append(dict(damaged=damaged, step=step, fallback_steps=steps,
                                 seconds=dt))
            del tree
            with open(root / "ckpt_2" / "data.bin", "r+b") as f:   # repair it
                f.seek(block["offset"])
                f.write(orig)
    finally:
        obs.reset()
        obs.configure(enabled=False)
    del state, state2, like
    shutil.rmtree(root)
    torch.cuda.empty_cache()

    # The twin: 4 x 512 x 512 weights, their bfloat16 copies, 16 MiB cache.
    twin = training_state(data[: 16 << 20], layers=4, width=512, seed=SEED + 41)
    twin2 = training_state(data[16 << 20: 32 << 20], layers=4, width=512, seed=SEED + 42)
    twin_like = as_meta(twin)
    troot = scratch_dir("checkpoint_twin")
    ckpt.save(str(troot), 1, twin)
    obs.configure(enabled=True)
    try:
        obs.reset()
        inj = FaultInjector(seed=0, fail={"checkpoint.open": 1, "checkpoint.read": 2})
        with install(inj):
            tree, _ = ckpt.restore(str(troot), 1, twin_like, decode_engine=dec)
        retries = obs.snapshot()["metrics"]["counters"].get("resilience.retries", 0)
    finally:
        obs.reset()
        obs.configure(enabled=False)
    check(trees_same(tree, twin) and retries == 3 and sorted(inj.io_faults)
          == ["checkpoint.open", "checkpoint.read", "checkpoint.read"],
          f"injected I/O faults: retries {retries}, faults {inj.io_faults}")
    entry = leaf_entry(troot / "ckpt_1", "/data_cache")
    k = [i for i, b in enumerate(entry["blocks"]) if b["lz4"]][-20]
    damage_block(troot / "ckpt_1", entry["blocks"][k])
    report = {}
    (tree, _), salvage_s, launches, (d,) = counted(
        lambda: ckpt.restore(str(troot), 1, twin_like, decode_engine=dec,
                             on_error="salvage", report=report), dec)
    lo, hi = k * MAX_BLOCK, (k + 1) * MAX_BLOCK
    dc, want = tree["data_cache"], twin["data_cache"]
    check(report == {"zero_filled": {"/data_cache": [k]}, "crc_mismatch": ["/data_cache"]}
          and not dc[lo:hi].any() and torch.equal(dc[:lo], want[:lo])
          and torch.equal(dc[hi:], want[hi:])
          and trees_same(dict(tree, data_cache=want), twin),
          f"salvage restore: report {report}")
    twin_salvage = dict(block=k, zero_filled=[lo, hi], report=report, seconds=salvage_s,
                        dispatches=d, launches=pick(launches, READ_KERNELS))
    seams = {}
    for seam in ("checkpoint.data", "checkpoint.manifest", "checkpoint.rename",
                 "checkpoint.cleanup"):
        d = scratch_dir("crash")
        ckpt.save(str(d), 1, twin)
        inj = FaultInjector(seed=3, crash_at=seam)
        try:
            with install(inj):
                ckpt.save(str(d), 2, twin2)
            crashed = False
        except InjectedCrash:
            crashed = True
        want_step = 2 if seam == "checkpoint.cleanup" else 1
        latest = ckpt.latest_step(str(d))
        tree, step = ckpt.restore_with_fallback(str(d), twin_like, decode_engine=dec)
        check(crashed and inj.crashes == [seam] and latest == want_step == step
              and trees_same(tree, twin2 if want_step == 2 else twin),
              f"crash at {seam}: latest_step {latest}, restored {step}")
        seams[seam] = dict(latest_step=latest, restored_step=step)
    shutil.rmtree(troot)
    # A tree of under 2 MiB: the card's and the CPU's checkpoints are the
    # same bytes.
    small = {"w": twin["params"]["layer_00"][:256], "h": twin["params_bf16"]["layer_01"][:256],
             "c": twin["data_cache"][: 1 << 20], "step": twin["step"]}
    a, b = scratch_dir("small_card"), scratch_dir("small_cpu")
    ckpt.save(str(a), 1, small)
    ckpt.save(str(b), 1, small, engine=LZ4Engine(device="cpu"))
    for name in ("data.bin", "manifest.json"):
        check((a / "ckpt_1" / name).read_bytes() == (b / "ckpt_1" / name).read_bytes(),
              f"{name}: the card's checkpoint differs from the CPU's")
    small_bytes = (a / "ckpt_1" / "data.bin").stat().st_size
    shutil.rmtree(SCRATCH)
    say("checkpoint_full", state_bytes=nbytes, leaves=2 * STATE_LAYERS + 2,
        data_bin_bytes=data_bin, data_bin_sha256=sha, saves=saves, restore=restored,
        strict_error=strict_error, fallback=fallback, io_retries=retries,
        twin_salvage=twin_salvage, crash_seams=seams,
        small_tree_data_bin_bytes=small_bytes, small_tree_equal_to_cpu=True,
        seconds=time.perf_counter() - t_phase)


def phase_consumers_small(data: bytes) -> None:
    """KV-cache offload and restore to the card (each leaf a view of the
    decoded tensor, no content to the host), a damaged leaf salvaged, the
    reader's random access; the token pipeline on the card == with a CPU
    decode engine; gradient frames round-tripped; the error-feedback
    quantizer on the card == on the CPU."""
    t_phase = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(SEED + 50)

    def kv():  # a paused session: 512 of 1024 positions filled
        x = torch.zeros((4, 8, 1024, 128), dtype=torch.bfloat16, device=DEV)
        x[:, :, :512] = torch.randn((4, 8, 512, 128), generator=g, device=DEV)
        return x
    cache = {"k": kv(), "v": kv(), "pos": torch.full((4,), 512, dtype=torch.int32, device=DEV),
             "prefix": torch.frombuffer(bytearray(data[: 4 << 20]), dtype=torch.uint8).to(DEV)}
    enc = default_engine()
    dec = LZ4DecodeEngine(device=DEV, plan_on_device=True)
    (blob, stats), off_s, launches, (d,) = counted(lambda: serving.offload_cache(cache), enc)
    off_launches = pick(launches, WRITE_KERNELS)
    check(d > 0 and all(v == d for v in off_launches.values()), f"offload launches {launches}")
    h0 = dec.totals.host_bytes
    restored, res_s, launches, (rd,) = counted(
        lambda: serving.restore_cache(blob, dec, to_device=True), dec)
    res_launches = pick(launches, READ_KERNELS)
    check(trees_same(restored, cache) and dec.totals.host_bytes == h0
          and all(x._is_view() for x in tree_leaves(restored)),
          "restore_cache(to_device=True): leaves differ, are copies, or content "
          "crossed to the host")
    check(rd > 0 and res_launches == read_want(rd, rd, rd),
          f"restore_cache launches {res_launches} for {rd} dispatches")
    # A damaged leaf ("k", leaf 0 in sorted order): salvaged, its block zeroed.
    frame = blob[1][0]["frame"]
    info = frame_info(frame)
    victim = 3
    lo, hi = block_span(info, victim)
    bad = [blob[0], [dict(b) for b in blob[1]]]
    bad[1][0]["frame"] = corrupt_frame_block(frame, victim, SEED, n=3)
    report = {}
    got = serving.restore_cache(bad, dec, to_device=True, on_error="salvage", report=report)
    want_rep = LZ4DecodeEngine(device="cpu", plan_on_device=True).salvage(bad[1][0]["frame"])
    k_bytes = got["k"].reshape(-1).view(torch.uint8)
    ref_bytes = cache["k"].reshape(-1).view(torch.uint8)
    check(set(report) == {0} and report[0].lost == [victim]
          and dataclasses.asdict(report[0]) == dataclasses.asdict(want_rep)
          and not k_bytes[lo:hi].any() and torch.equal(k_bytes[:lo], ref_bytes[:lo])
          and torch.equal(k_bytes[hi:], ref_bytes[hi:])
          and trees_same(dict(got, k=cache["k"]), cache), "restore_cache salvage")
    rdr = serving.OffloadedCacheReader(blob, dec, to_device=True)
    part = rdr.read_leaf(0, start=1000, count=70_000)
    host = serving.OffloadedCacheReader(blob, LZ4DecodeEngine(device="cpu")).read_leaf(
        0, start=1000, count=70_000)
    flat = cache["k"].reshape(-1)[1000:71_000]
    check(same_bits(part, flat) and same_bits(host, flat.cpu()), "OffloadedCacheReader")
    # The token pipeline: shards written on the card, read on the card and
    # through a CPU engine.
    pipe_dir = scratch_dir("pipeline")
    batches = {}
    for cache_shards in (True, False):
        kw = dict(n_shards=4, shard_tokens=1 << 18, seed=7, cache_shards=cache_shards)
        on_card = ShardedTokenPipeline(str(pipe_dir), 32000, **kw)
        on_cpu = ShardedTokenPipeline(str(pipe_dir), 32000,
                                      decode_engine=LZ4DecodeEngine(device="cpu"), **kw)
        for step in range(3):
            a, b = on_card.batch(step, 8, 1024), on_cpu.batch(step, 8, 1024)
            check(a.dtype == np.int32 and np.array_equal(a, b),
                  f"pipeline batch {step} (cache_shards={cache_shards}) differs")
        batches[str(cache_shards)] = hashlib.sha256(a.tobytes()).hexdigest()[:16]
    ratio = on_card.compression_ratio()
    shutil.rmtree(SCRATCH)
    # Gradient frames and the quantizer.
    grads = {"w": torch.randn((1024, 1024), generator=g, device=DEV) * 1e-3,
             "e": torch.randn((512, 512), generator=g, device=DEV).to(torch.bfloat16),
             "b": torch.randn((4096,), generator=g, device=DEV)}
    gframe = grad_compress.export_gradient_frame(grads)
    back = grad_compress.import_gradient_frame(gframe, as_meta(grads))
    check(trees_same(back, grads), "gradient frame round trip")
    ef = grad_compress.ef_init(grads)
    q, ef = grad_compress.quantize_with_error_feedback(grads, ef)
    cpu_grads = tree_map(lambda x: x.cpu(), grads)
    q_cpu, ef_cpu = grad_compress.quantize_with_error_feedback(
        cpu_grads, grad_compress.ef_init(cpu_grads))
    check(trees_same(tree_map(lambda x: x.cpu(), q), q_cpu)
          and trees_same(tree_map(lambda x: x.cpu(), ef), ef_cpu),
          "quantize_with_error_feedback: the card's differs from the CPU's")
    say("consumers_small", cache_bytes=stats["raw"], offload=dict(
            seconds=off_s, ratio=stats["ratio"], dispatches=d, launches=off_launches),
        restore_to_device=dict(seconds=res_s, dispatches=rd, launches=res_launches,
                               host_bytes=0, leaves_are_views=True),
        salvage_leaf=dict(block=victim, lost=report[0].lost, zero_filled=[lo, hi]),
        pipeline=dict(batches_equal_to_cpu=6, ratio=ratio, last_batch_sha256=batches),
        gradient_frame_bytes=len(gframe), quantizer_equal_to_cpu=True,
        seconds=time.perf_counter() - t_phase)


def phase_salvage_full(data: bytes) -> None:
    """Salvage at full size: the data as a v6 frame (`parity_group=8`),
    three blocks in three groups corrupted, salvaged by
    `LZ4DecodeEngine(device="cuda", plan_on_device=True)` one block per
    dispatch (about half the time of host planning per block): all three
    rebuilt, the content trailer verified."""
    data = data[:SALVAGE_FULL_BYTES]
    frame = LZ4Engine(device=DEV, parity_group=8).compress(data)
    n = len(frame_info(frame)["blocks"])
    rng = np.random.default_rng(SEED + 60)
    victims = sorted(int(grp) * 8 + int(rng.integers(0, 8))
                     for grp in rng.choice(n // 8, size=3, replace=False))
    bad = frame
    for j, v in enumerate(victims):
        bad = corrupt_frame_block(bad, v, SEED + j, n=3)
    eng = LZ4DecodeEngine(device=DEV, plan_on_device=True)
    rep, dt, launches, (d,) = counted(lambda: eng.salvage(bad), eng)
    got = pick(launches, READ_KERNELS)
    check(rep.reconstructed == victims and rep.lost == [] and rep.data == data
          and rep.content_crc_ok is True, f"salvage_full: {rep.reconstructed}, {rep.lost}")
    check(d > 0 and got == read_want(d, d, 0),
          f"salvage_full: launches {got} for {d} dispatches")
    say("salvage_full", bytes=len(data), blocks=n, parity_group=8, victims=victims,
        reconstructed=rep.reconstructed, seconds=dt, output_GB_per_s=len(data) / dt / 1e9,
        dispatches=d, launches=got, ok=len(rep.ok), content_crc_ok=rep.content_crc_ok)


# -- the sharded fabric --------------------------------------------------------

def fabric_mesh(shape, axes=("data", "model")):
    """A mesh of distinct cards where enough are visible, else of cuda:0
    repeated (each position still a shard of its own)."""
    n = int(np.prod(shape))
    distinct = torch.cuda.device_count() >= n
    devices = [torch.device("cuda", i if distinct else 0) for i in range(n)]
    return make_mesh(shape, axes, devices=devices), distinct


def launches_by_device(modules) -> dict:
    return {m.__name__.rsplit(".", 1)[1]: {f"cuda:{d}": n for d, n in
                                           sorted(m.launches_by_device.items())}
            for m in modules}


def shard_pieces(data: bytes, shards: int) -> list[bytes]:
    chunks = [data[i: i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    return [b"".join(chunks[sl.start: sl.stop])
            for sl in fabric.partition_blocks(len(chunks), shards)]


def payloads_of(frame: bytes) -> list[bytes]:
    return [frame[b["offset"]: b["offset"] + b["csize"]]
            for b in frame_info(frame)["blocks"]]


def check_subframes(frame: bytes, data: bytes, shards: int, single) -> int:
    """Each shard's subframe == the unsharded engine on its slice."""
    n = 0
    for s, piece in enumerate(shard_pieces(data, shards)):
        if piece:
            check(fabric.shard_subframe(frame, s) == single.compress(piece),
                  f"shard {s} of {shards}: subframe != the unsharded engine's")
            n += 1
    return n


def invert_bytes(frame: bytes, head: bool) -> bytes:
    """The last coded block with three middle payload bytes inverted (a
    checksum mismatch) or, with ``head``, its first four (a parse error)."""
    info = frame_info(frame)
    b = [b for b in info["blocks"] if not b["raw"]][-1]
    spots = (0, 1, 2, 3) if head else tuple(
        (b["csize"] // 2 + d) % b["csize"] for d in (0, 7, 19))
    bad = bytearray(frame)
    for d in spots:
        bad[b["offset"] + d] ^= 0xFF
    return bytes(bad)


def error_of(fn) -> str:
    try:
        fn()
    except FrameFormatError as e:
        return str(e)
    raise AssertionError("a damaged frame decoded without an error")


def phase_fabric_small() -> None:
    """The sharded fabric on 8 MiB: host-partition frames (shards 1, 2, 4;
    a 7-block input at 4 and 8 shards, fused and "sortkey"), mesh frames
    on (2, 1), (2, 2), (1, 8) meshes == the host path's, every subframe ==
    the unsharded engine on its slice; sharded decode under both planners,
    `read_range` across every shard boundary, a corrupt payload's error and
    the host fallback of oversized payloads == the unsharded engine's; the
    int8 pod-sum, `restore(shardings=)` and `pipeline_apply` on the card."""
    t_phase = time.perf_counter()
    data = seeded_data(8 << 20, SEED + 80)
    single = LZ4Engine(device=DEV)
    plain = payloads_of(single.compress(data))
    host, subframes = {}, 0
    for S in (1, 2, 4, 8):
        eng = LZ4Engine(device=DEV, shards=S)
        host[S] = eng.compress(data)
        info = frame_info(host[S])
        check(info["version"] == 4 and info["shard_count"] == S
              and payloads_of(host[S]) == plain and eng.stats.shards == S,
              f"host path, shards={S}: not the unsharded engine's blocks")
        subframes += check_subframes(host[S], data, S, single)
    seven = data[: 7 * MAX_BLOCK - 1000]
    for S in (4, 8):
        got = {impl: LZ4Engine(device=DEV, shards=S, candidate_impl=impl).compress(seven)
               for impl in ("fused", "sortkey")}
        check(got["fused"] == got["sortkey"], f"7 blocks over {S}: impls differ")
        subframes += check_subframes(got["fused"], seven, S, single)
    meshes = []
    for shape in FABRIC_SHAPES:
        mesh, distinct = fabric_mesh(shape)
        S = mesh.size
        eng = LZ4Engine(mesh=mesh)
        frame, dt, launches, (d,) = counted(lambda: eng.compress(data), eng)
        by_dev = launches_by_device(KERNEL_MODULES)
        check(frame == host[S], f"mesh {shape}: frame != the host path's")
        check(all(launches[k] == S * d for k in WRITE_KERNELS),
              f"mesh {shape}: launches {pick(launches, WRITE_KERNELS)} for "
              f"{S} shards x {d} dispatches")
        subframes += check_subframes(frame, data, S, single)
        run = dict(shape=list(shape), distinct_cards=distinct, shards=S,
                   compress=dict(seconds=dt, dispatches=d,
                                 launches=pick(launches, WRITE_KERNELS),
                                 launches_by_device=by_dev))
        bounds = sorted({sl.start * MAX_BLOCK for sl in
                         fabric.partition_blocks(-(-len(data) // MAX_BLOCK), S)} - {0})
        for on_device in (False, True):
            dec = LZ4DecodeEngine(mesh=mesh, plan_on_device=on_device)
            out, ddt, dl, (dd,) = counted(lambda: dec.decode(frame), dec)
            read_by_dev, dstats = launches_by_device(READ_KERNEL_MODULES), dec.stats.as_dict()
            want = read_want(S * dd, S * dd if on_device else 0, 0)
            check(out == data and dec.stats.fallback_blocks == 0,
                  f"mesh {shape}: sharded decode (plan_on_device={on_device})")
            check(pick(dl, READ_KERNELS) == want,
                  f"mesh {shape}: decode launches {pick(dl, READ_KERNELS)} != {want}")
            reader = FrameReader(frame, engine=dec, cache_blocks=0)
            for b in bounds:
                for lo, n in ((b - 50, 100), (b - 1, 2), (b - MAX_BLOCK // 2, MAX_BLOCK)):
                    n = min(n, len(data) - lo)
                    check(reader.read_range(lo, n) == data[lo: lo + n],
                          f"mesh {shape}: read_range({lo}, {n})")
            run["decode_plan_on_device" if on_device else "decode_host_planned"] = dict(
                seconds=ddt, dispatches=dd, launches=pick(dl, READ_KERNELS),
                launches_by_device=read_by_dev, stats=dstats,
                read_range_bounds=len(bounds))
        meshes.append(run)
    # Damage and fallback on the (2, 2) mesh against the unsharded engine.
    mesh, _ = fabric_mesh((2, 2))
    frame = host[4]
    coded = sorted(b["csize"] for b in frame_info(frame)["blocks"] if not b["raw"])
    caps = DevicePlanCaps(blk_cap=coded[len(coded) // 2])
    damage = {}
    for on_device in (False, True):
        sharded = LZ4DecodeEngine(mesh=mesh, plan_on_device=on_device)
        flat = LZ4DecodeEngine(device=DEV, plan_on_device=on_device)
        for head in (False, True):
            bad = invert_bytes(frame, head)
            got, want = error_of(lambda: sharded.decode(bad)), error_of(lambda: flat.decode(bad))
            check(got == want, f"corrupt payload: {got!r} != {want!r}")
            damage[f"{'head' if head else 'middle'}_plan_on_device={on_device}"] = got
        sharded = LZ4DecodeEngine(mesh=mesh, plan_on_device=on_device, caps=caps)
        flat = LZ4DecodeEngine(device=DEV, plan_on_device=on_device, caps=caps)
        check(sharded.decode(frame) == data == flat.decode(frame)
              and sharded.stats.fallback_blocks == flat.stats.fallback_blocks > 0,
              f"oversized payloads: fallback {sharded.stats.fallback_blocks} != "
              f"{flat.stats.fallback_blocks}")
        damage[f"fallback_blocks_plan_on_device={on_device}"] = sharded.stats.fallback_blocks
    consumers = fabric_consumers()
    say("fabric_small", bytes=len(data), host_shards=[1, 2, 4, 8],
        uneven=dict(blocks=7, shards=[4, 8], impls=["fused", "sortkey"]),
        subframes_equal=subframes, meshes=meshes, oversized_blk_cap=caps.blk_cap,
        damage=damage, consumers=consumers, seconds=time.perf_counter() - t_phase)


def fabric_consumers() -> dict:
    """The fabric's consumers on the card: the int8 pod-sum over a (2, 2)
    ("pod", "data") mesh == the CPU port's (exact), `restore(shardings=)`
    of a checkpoint onto the card's single-device mesh, and the GPipe
    schedule over four pods == the sequential composition (within 1e-5:
    cuBLAS may pick other kernels for the microbatches' shapes)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 81)
    x = torch.randn((64, 1024), generator=g, device=DEV)
    mesh, _ = fabric_mesh((2, 2), ("pod", "data"))
    with use_mesh(mesh):
        y = grad_compress.compressed_psum_pod(x)
    with use_mesh(make_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)):
        y_cpu = grad_compress.compressed_psum_pod(x.cpu())
    check(y.device == x.device and torch.equal(y.cpu(), y_cpu),
          "compressed_psum_pod: the card's differs from the CPU's")
    tree = {"w": torch.randn((256, 1024), generator=g, device=DEV),
            "i": torch.arange(50_000, dtype=torch.int32, device=DEV),
            "z": [torch.zeros(100_000, device=DEV), None]}
    d = scratch_dir("fabric")
    ckpt.save(str(d), 1, tree, engine=LZ4Engine(device=DEV))
    one = single_device_mesh()
    like = as_meta(tree)
    got, _ = ckpt.restore(str(d), 1, like,
                          shardings=tree_map(lambda _: NamedSharding(one, P()), like),
                          decode_engine=LZ4DecodeEngine(device=DEV))
    check(trees_same(got, tree) and all(t.device == one.device_at((0, 0))
                                        for t in tree_leaves(got)),
          "restore(shardings=) on the card")
    shutil.rmtree(SCRATCH)
    S, width = 4, 256
    params = {"w": torch.randn((S, width, width), generator=g, device=DEV) * 0.06,
              "b": torch.randn((S, width), generator=g, device=DEV) * 0.1}
    xs = torch.randn((64, width), generator=g, device=DEV)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    pods, _ = fabric_mesh((S,), ("pod",))
    with use_mesh(pods):
        yp = pipeline_apply(stage, params, xs, n_micro=8)
    seq = xs
    for s in range(S):
        seq = stage({"w": params["w"][s], "b": params["b"][s]}, seq)
    err = (yp - seq).abs().max().item()
    check(yp.device == xs.device and err < 1e-5, f"pipeline_apply: max error {err}")
    return dict(psum_pod=dict(shape=list(x.shape), equal_to_cpu=True,
                              max_abs_err=(y.cpu() - y_cpu).abs().max().item()),
                restore_shardings=dict(leaves=len(tree_leaves(tree)), equal=True),
                pipeline=dict(stages=S, width=width, rows=64, n_micro=8,
                              max_abs_err=err))


def phase_fabric_full(data: bytes, full_frame: bytes, path_full: dict) -> None:
    """The fabric at full size: `LZ4Engine(mesh=(2, 2))` at micro_batch 32
    per shard, frame == `LZ4Engine(shards=4)`'s, blocks == the unsharded
    frame's, each subframe == the unsharded engine on its slice; the v4
    frame decoded by the sharded read path with on-device planning.  Counts
    are zeroed just before each run and read just after."""
    t_phase = time.perf_counter()
    mesh, distinct = fabric_mesh((2, 2))
    eng = LZ4Engine(mesh=mesh, micro_batch=32)
    frame, dt, launches, (d,) = counted(lambda: eng.compress(data), eng)
    write_by_dev = launches_by_device(KERNEL_MODULES)
    check(all(launches[k] == 4 * d > 0 for k in WRITE_KERNELS),
          f"fabric_full: launches {pick(launches, WRITE_KERNELS)} for 4 x {d}")
    check(frame == LZ4Engine(device=DEV, shards=4).compress(data),
          "fabric_full: mesh frame != the host path's")
    check(payloads_of(frame) == payloads_of(full_frame),
          "fabric_full: blocks != the unsharded frame's")
    subframes = check_subframes(frame, data, 4, LZ4Engine(device=DEV))
    # The mesh against the unsharded engine in turns (mesh, flat, mesh,
    # flat; the counted run above is the first), on the host clock.
    flat = LZ4Engine(device=DEV, micro_batch=32)
    turns = [("mesh", dt)]
    for who, e in (("unsharded", flat), ("mesh", eng), ("unsharded", flat)):
        turns.append((who, counted(lambda: e.compress(data))[1]))
    dec = LZ4DecodeEngine(mesh=mesh, plan_on_device=True)
    out, ddt, dl, (dd,) = counted(lambda: dec.decode(frame), dec)
    read_by_dev = launches_by_device(READ_KERNEL_MODULES)
    want = read_want(4 * dd, 4 * dd, 0)
    check(out == data and dec.stats.fallback_blocks == 0, "fabric_full: decode")
    check(dd > 0 and pick(dl, READ_KERNELS) == want,
          f"fabric_full: decode launches {pick(dl, READ_KERNELS)} != {want}")
    st = eng.stats
    say("fabric_full", mesh=[2, 2], distinct_cards=distinct, bytes_in=len(data),
        frame_bytes=len(frame), frame_sha256=hashlib.sha256(frame).hexdigest(),
        compress=dict(seconds=dt, input_GB_per_s=len(data) / dt / 1e9,
                      blocks_per_s=st.blocks / dt, dispatches=d,
                      launches=pick(launches, WRITE_KERNELS),
                      launches_by_device=write_by_dev, stats=st.as_dict()),
        path_full=path_full, subframes_equal=subframes,
        turns=[dict(engine=w, seconds=t, input_GB_per_s=len(data) / t / 1e9)
               for w, t in turns],
        decode=dict(seconds=ddt, output_GB_per_s=len(data) / ddt / 1e9, dispatches=dd,
                    launches=pick(dl, READ_KERNELS), launches_by_device=read_by_dev,
                    stats=dec.stats.as_dict()),
        seconds=time.perf_counter() - t_phase)


def phase_fabric_breakdown(data: bytes) -> None:
    """Where the mesh path's wall time goes: the fabric's spans (telemetry
    on) over one (2, 2)-mesh compress, beside `breakdown`'s unsharded
    spans of the same data, and the device's idle share."""
    mesh, _ = fabric_mesh((2, 2))
    eng = LZ4Engine(mesh=mesh, telemetry=True)
    table, wall = span_table(lambda: eng.compress(data))
    device = profile_device(lambda: LZ4Engine(mesh=mesh).compress(data))
    say("fabric_breakdown", bytes_in=len(data), mesh=[2, 2], micro_batch=32,
        wall_seconds=wall, spans=table, device=device)


# -- the serving path: models, ServingEngine, a live KV cache offloaded --------

SERVE_ARCH = "qwen3-1.7b"
SERVE_OFFLOAD = dict(batch=4, prompt=512, cache_len=1024, new_tokens=8)
SMALL_TOL = 1e-3        # port on the card against the port on the CPU, float32
CONSISTENCY_TOL = 2e-3  # the reference's own (tests/test_models_smoke.py)


def serve_config():
    """The served model at full width (a CPU rehearsal swaps this out)."""
    return get_config(SERVE_ARCH)


def to_cpu(tree):
    return tree_map(lambda t: t.cpu(), tree)


def check_close(a: torch.Tensor, b: torch.Tensor, tol: float, what: str) -> float:
    """Hold ``a`` to ``b`` within ``tol`` (rtol = atol); the max |a - b|."""
    a, b = a.float().cpu(), b.float().cpu()
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}, or not finite")
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(torch.allclose(a, b, rtol=tol, atol=tol), f"{what}: max |difference| {err} over {tol}")
    return err


def served_requests(vocab: int, n: int = 8, new_tokens: int = 12, seed: int = 0):
    """The requests of the reference's `launch/serve.py`: prompt
    lengths 4-23 and tokens from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        plen = int(rng.integers(4, 24))
        out.append(serving.Request(uid=uid, prompt=rng.integers(0, vocab, plen).tolist(),
                                   max_new_tokens=new_tokens))
    return out


def run_engine(cfg, params, device, n: int = 4, new_tokens: int = 12, **kw):
    eng = serving.ServingEngine(cfg, params, device=device, **kw)
    for r in served_requests(cfg.vocab_size, n, new_tokens):
        eng.add_request(r)
    return eng.run()


def phase_models_small() -> None:
    """Each of the ten architectures at `.reduced()` (float32 compute, TF32
    off) on the card and on the CPU with the same weights: `forward_logits`,
    `prefill` (logits and every cache leaf) and one `decode_step` within
    1e-3; a 4-request `ServingEngine` run gives the same greedy tokens on
    both.  Mixtral's `moe_ffn` on a (2, 1) mesh of cuda:0 repeated == the
    CPU port's on a (2, 1) mesh of the CPU (capacity per shard)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for arch in all_arch_names():
        cfg = get_config(arch).reduced()
        params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED + 60),
                                device=DEV)
        cpu = to_cpu(params)
        batch = make_batch(1, cfg, 2, 32, device=DEV)
        cbatch = to_cpu(batch)
        e = {"forward": check_close(lm.forward_logits(params, batch, cfg),
                                    lm.forward_logits(cpu, cbatch, cfg), SMALL_TOL,
                                    f"{arch} forward_logits")}
        cache, logits = lm.prefill(params, batch, cfg, 40)
        ccache, clogits = lm.prefill(cpu, cbatch, cfg, 40)
        e["prefill"] = check_close(logits, clogits, SMALL_TOL, f"{arch} prefill")
        e["cache"] = max(check_close(a, b, SMALL_TOL, f"{arch} prefill cache")
                         for a, b in zip(tree_leaves(cache), tree_leaves(ccache)))
        tok = torch.full((2,), 7, dtype=torch.int32)
        logits, _ = lm.decode_step(params, cache, tok.to(DEV), cache["pos"], cfg)
        clogits, _ = lm.decode_step(cpu, ccache, tok, ccache["pos"], cfg)
        e["decode"] = check_close(logits, clogits, SMALL_TOL, f"{arch} decode_step")
        on_card = run_engine(cfg, params, DEV, new_tokens=6)
        on_cpu = run_engine(cfg, cpu, "cpu", new_tokens=6)
        check([r.output for r in on_card] == [r.output for r in on_cpu],
              f"{arch}: ServingEngine tokens differ between the card and the CPU")
        errs[arch] = e
    # mixtral's MoE on a data mesh: the capacity of each of 2 shards
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), capacity_factor=1.0)
    p = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED + 61), device=DEV)
    moe_p = tree_map(lambda t: t[0], p["segments"][0]["layers"]["0"]["moe"])
    x = torch.randn((4, 10, cfg.d_model), generator=torch.Generator(device=DEV)
                    .manual_seed(SEED + 62), device=DEV)
    with use_mesh(make_mesh((2, 1), ("data", "model"), devices=[DEV] * 2)):
        y, aux = moe.moe_ffn(moe_p, x, cfg)
    with use_mesh(make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)):
        cy, caux = moe.moe_ffn(to_cpu(moe_p), x.cpu(), cfg)
    one_shard, _ = moe.moe_ffn(to_cpu(moe_p), x.cpu(), cfg)
    errs["mixtral_moe_mesh_2x1"] = {"y": check_close(y, cy, SMALL_TOL, "moe_ffn on (2, 1)"),
                                    "aux": check_close(aux, caux, SMALL_TOL, "moe aux")}
    check(not torch.allclose(cy, one_shard, rtol=SMALL_TOL, atol=SMALL_TOL),
          "moe_ffn: 2 shards gave the one-shard result (capacity not per shard)")
    say("models_small", archs=len(errs) - 1, tol=SMALL_TOL, max_abs_err=errs,
        engine_tokens_equal=True, seconds=time.perf_counter() - t_phase)


def synced(fn):
    """(result, seconds on the host clock ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def decode_ms(params, cache, cfg, steps: int) -> float:
    """Mean ms of one greedy `decode_step` (host clock, synchronized)."""
    tok = torch.zeros((cache["layers"][0]["0"]["k"].shape[1],), dtype=torch.int32,
                      device=DEV)

    def run():
        c, t = cache, tok
        for _ in range(steps):
            logits, c = lm.decode_step(params, c, t, c["pos"], cfg)
            t = torch.argmax(logits, -1).to(torch.int32)
    run()   # warm-up
    return synced(run)[1] * 1e3 / steps


def host_ram_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def phase_serve_full() -> tuple:
    """qwen3-1.7b at full width (float32 parameters, bfloat16 compute) on
    the card: (a) a `ServingEngine(max_batch=4, cache_len=256)` answers the
    8 requests of the reference's `launch/serve.py` (12 new tokens each);
    (b) float32 consistency, B = 2, S = 32: prefill == forward_logits[:, -1] and one
    decode_step == teacher forcing, within the reference's own 2e-3; (c)
    the float32 forward, B = 1, S = 16, on the card == on the CPU within
    1e-3.  Returns (config, parameters) for `serve_offload`."""
    t_phase = time.perf_counter()
    cfg = serve_config()
    g = torch.Generator(device=DEV).manual_seed(SEED + 63)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced(lambda: lm.init_params(cfg, g, device=DEV))
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    # (a) the 8 requests of the reference's launch/serve.py
    run_engine(cfg, params, DEV, n=4, new_tokens=2)   # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    obs.configure(enabled=True)
    done, serve_s = synced(lambda: run_engine(cfg, params, DEV, n=8, new_tokens=12,
                                              max_batch=4, cache_len=256))
    spans = {}
    for r in obs.tracer().finished():
        spans.setdefault(r["name"], []).append(r["dur_ns"] / 1e9)
    obs.configure(enabled=False)
    obs.reset()
    peak = torch.cuda.max_memory_allocated()
    new_tokens = sum(len(r.output) for r in done)
    check(len(done) == 8 and all(len(r.output) == 12 for r in done)
          and all(0 <= t < cfg.vocab_size for r in done for t in r.output),
          "serve_full: requests not answered")
    # prefill and decode step on their own, synchronized
    batch = make_batch(SEED, cfg, 4, 24, device=DEV)
    lm.prefill(params, batch, cfg, 256)
    (cache, _), prefill_s = synced(lambda: lm.prefill(params, batch, cfg, 256))
    # The per-call casts of float32 weights to bfloat16 (the reference does
    # the same): steps with the weights cast once beforehand, in turns
    # (float32, bfloat16, float32, bfloat16) on the host clock.
    bf16 = tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params)
    turns = [decode_ms(w, cache, cfg, steps=12) for w in (params, bf16, params, bf16)]
    step_ms, step_ms_bf16 = np.mean(turns[0::2]), np.mean(turns[1::2])
    decode_device = profile_device(lambda: decode_ms(params, cache, cfg, steps=4))
    del bf16, cache
    # (b) consistency at full width, float32 compute
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    b32 = make_batch(1, cfg32, 2, 32, device=DEV)
    full = lm.forward_logits(params, b32, cfg32)
    cache, pre = lm.prefill(params, b32, cfg32, 40)
    err_pre = check_close(pre, full[:, -1], CONSISTENCY_TOL, "serve_full prefill vs forward")
    new = torch.full((2,), 7, dtype=torch.int32, device=DEV)
    dec, _ = lm.decode_step(params, cache, new, cache["pos"], cfg32)
    full2 = lm.forward_logits(params, {"tokens": torch.cat([b32["tokens"], new[:, None]], 1)},
                              cfg32)
    err_dec = check_close(dec, full2[:, -1], CONSISTENCY_TOL,
                          "serve_full decode vs teacher forcing")
    del full, full2, cache
    # (c) the same float32 forward on the CPU
    need = 2 * param_bytes
    avail = host_ram_available()
    if avail >= need:
        b16 = make_batch(2, cfg32, 1, 16, device=DEV)
        card = lm.forward_logits(params, b16, cfg32)
        cpu_params = to_cpu(params)
        (host, cpu_s) = synced(lambda: lm.forward_logits(cpu_params, to_cpu(b16), cfg32))
        cpu_check = dict(ran=True, max_abs_err=check_close(card, host, SMALL_TOL,
                                                           "serve_full card vs CPU"),
                         tol=SMALL_TOL, cpu_seconds=cpu_s)
        del cpu_params
    else:
        cpu_check = dict(ran=False, reason=f"host RAM available {avail} B < {need} B "
                                           "for a CPU copy of the weights")
    say("serve_full", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.hd, vocab=cfg.vocab_size,
        params=n_params, param_bytes=param_bytes, compute_dtype=cfg.compute_dtype,
        init_seconds=init_s,
        engine=dict(requests=len(done), new_tokens=new_tokens, seconds=serve_s,
                    tokens_per_s=new_tokens / serve_s,
                    spans={k: dict(count=len(v), seconds=sum(v))
                           for k, v in sorted(spans.items())},
                    max_memory_allocated=peak, outputs=[r.output for r in done[:2]]),
        prefill=dict(batch=4, prompt=24, ms=prefill_s * 1e3),
        decode=dict(batch=4, ms_per_step=step_ms, ms_per_step_bf16_weights=step_ms_bf16,
                    turns_ms=turns, cast_share=1 - step_ms_bf16 / step_ms,
                    device=decode_device),
        consistency=dict(tol=CONSISTENCY_TOL, prefill_vs_forward=err_pre,
                         decode_vs_teacher_forcing=err_dec),
        card_vs_cpu=cpu_check, seconds=time.perf_counter() - t_phase)
    return cfg, params


def phase_serve_offload(cfg, params) -> None:
    """A live full-width session (B = 4, 512-token prompts, cache_len 1024):
    its bfloat16 KV cache offloaded through `LZ4Engine(device="cuda")` and
    restored to the card (`to_device=True`, `plan_on_device=True`), every
    leaf bit-exact, no plaintext byte to the host; 8 more greedy tokens from
    the original cache and from the restored one are identical, logits and
    all.  Counts are zeroed just before the offload and the restore and
    read just after."""
    t_phase = time.perf_counter()
    o = SERVE_OFFLOAD
    batch = make_batch(SEED + 64, cfg, o["batch"], o["prompt"], device=DEV)
    (cache, logits), prefill_s = synced(lambda: lm.prefill(params, batch, cfg,
                                                            o["cache_len"]))
    kv = [t for t in tree_leaves(cache) if t.dtype == torch.bfloat16]
    kv_bytes = sum(t.numel() * t.element_size() for t in kv)
    enc = LZ4Engine(device=DEV)
    dec = LZ4DecodeEngine(device=DEV, plan_on_device=True)
    (blob, stats), off_s, off_launches, (d,) = counted(
        lambda: serving.offload_cache(cache, engine=enc), enc)
    h0 = dec.totals.host_bytes
    restored, res_s, res_launches, (rd,) = counted(
        lambda: serving.restore_cache(blob, dec, to_device=True), dec)
    host_bytes = dec.totals.host_bytes - h0
    launches = {k: off_launches[k] for k in WRITE_KERNELS}
    launches.update({k: res_launches[k] for k in READ_KERNELS})
    check(trees_same(restored, cache), "serve_offload: a restored leaf differs")
    check(all(x.device.type == DEV.type and x._is_view() for x in tree_leaves(restored)),
          "serve_offload: restored leaves are not views on the card")
    check(host_bytes == 0, f"serve_offload: {host_bytes} plaintext bytes to the host")
    check(all(v > 0 for v in launches.values()), f"serve_offload: launches {launches}")

    def generate(c):
        tok, toks, outs = torch.argmax(logits, -1).to(torch.int32), [], []
        for _ in range(o["new_tokens"]):
            lg, c = lm.decode_step(params, c, tok, c["pos"], cfg)
            tok = torch.argmax(lg, -1).to(torch.int32)
            toks.append(tok.tolist())
            outs.append(lg)
        return toks, outs
    toks, outs = generate(cache)
    toks_r, outs_r = generate(restored)
    check(toks == toks_r and all(torch.equal(a, b) for a, b in zip(outs, outs_r)),
          "serve_offload: decoding from the restored cache differs")
    say("serve_offload", arch=cfg.name, batch=o["batch"], prompt=o["prompt"],
        cache_len=o["cache_len"], prefill_ms=prefill_s * 1e3, leaves=len(tree_leaves(cache)),
        kv_bytes=kv_bytes, cache_bytes=stats["raw"], frame_bytes=stats["compressed"],
        ratio=stats["ratio"],
        offload=dict(seconds=off_s, GB_per_s=stats["raw"] / off_s / 1e9, dispatches=d),
        restore=dict(seconds=res_s, GB_per_s=stats["raw"] / res_s / 1e9, dispatches=rd,
                     host_bytes=host_bytes, leaves_are_views=True),
        launches=launches, continued_tokens=toks, continued_identical=True,
        seconds=time.perf_counter() - t_phase)


# -- training: train_loss and its gradient, AdamW, the loop's checkpoints ------

TRAIN_SMALL_TOL = 1e-3   # loss, and gradients x max(1, max|g_cpu|), card vs CPU
TRAIN_STEP_TOL = 1e-5    # one step's new parameters, m and v, card vs CPU
TRAIN_DRILL = dict(arch="qwen3-1.7b", scale="100m", batch=8, seq=256, steps=12,
                   ckpt_every=4, simulate_failure=7, lr="3e-4")
TRAIN_FULL = dict(batch=1, seq=4096, warmup_steps=1, timed_steps=3)


def train_config():
    """The trained model at full width (a CPU rehearsal swaps this out)."""
    return get_config(SERVE_ARCH)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"shape {tuple(a.shape)} vs {tuple(b.shape)}, or not finite")
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_train_small() -> None:
    """Each of the ten architectures at `.reduced()` (float32, TF32 off), B =
    2, S = 32, the same weights on the card and on the CPU (drawn on the CPU,
    carried by `params_from_numpy`): `train_loss` within 1e-3 and every
    gradient leaf within 1e-3 x max(1, max|g_cpu|) (`steps.loss_and_grads`,
    autograd through remat); one `make_train_step` step's new parameters,
    m and v within 1e-5 (`launch/train.py`'s optimizer settings)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for arch in all_arch_names():
        cfg = get_config(arch).reduced()
        # What `launch/train.py` builds at its default flags (--lr 3e-4, --steps
        # 20: 5 warm-up steps).  Adam's first update g / (|g| + eps) turns a
        # difference in a gradient near eps into one 1/eps times larger, so a
        # bound on the step is a bound for one learning rate: train.py's.
        opt_cfg = train_mod.opt_config(types.SimpleNamespace(lr=3e-4, steps=20, arch=arch))
        cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED + 70), device="cpu")
        params = params_from_numpy(tree_map(lambda t: t.numpy(), cpu), DEV)
        batch = make_batch(3, cfg, 2, 32, device=DEV)
        cbatch = to_cpu(batch)
        loss, grads = steps.loss_and_grads(params, batch, cfg)
        closs, cgrads = steps.loss_and_grads(cpu, cbatch, cfg)
        # "grad": the largest max |g - g_cpu| / max(1, max |g_cpu|) of a leaf
        e = {"loss": max_err(loss, closs), "grad": 0.0}
        check(e["loss"] <= TRAIN_SMALL_TOL, f"{arch} train_loss: {float(loss)} vs {float(closs)}")
        for (path, g), cg in zip(flatten_with_paths(grads), tree_leaves(cgrads)):
            err = max_err(g, cg) / max(1.0, float(cg.abs().max()))
            check(err <= TRAIN_SMALL_TOL, f"{arch} gradient {path}: {err} over {TRAIN_SMALL_TOL}")
            e["grad"] = max(e["grad"], err)
        step = steps.make_train_step(cfg, opt_cfg)
        p1, s1, m1 = step(params, adamw.init(params), batch)
        cp1, cs1, _ = step(cpu, adamw.init(cpu), cbatch)
        for what, a, b in (("params", p1, cp1), ("m", s1["m"], cs1["m"]),
                           ("v", s1["v"], cs1["v"])):
            e[what] = max(check_close(x, y, TRAIN_STEP_TOL, f"{arch} step {what}")
                          for x, y in zip(tree_leaves(a), tree_leaves(b)))
        check(int(s1["step"]) == 1 and float(m1["grad_norm"]) > 0, f"{arch}: step metrics")
        errs[arch] = e
    say("train_small", archs=len(errs), batch=2, seq=32, loss_and_grad_tol=TRAIN_SMALL_TOL,
        step_tol=TRAIN_STEP_TOL, max_abs_err=errs, seconds=time.perf_counter() - t_phase)


def drill_argv(ckpt_dir: Path, fail: int | None) -> list[str]:
    d = TRAIN_DRILL
    argv = ["--arch", d["arch"], "--scale", d["scale"], "--steps", str(d["steps"]),
            "--batch", str(d["batch"]), "--seq", str(d["seq"]), "--lr", d["lr"],
            "--ckpt-every", str(d["ckpt_every"]), "--log-every", str(d["steps"]),
            "--ckpt-dir", str(ckpt_dir), "--seed", "0", "--device", str(DEV)]
    return argv + (["--simulate-failure", str(fail)] if fail is not None else [])


def phase_train_drill() -> None:
    """`python -m repro_torch.launch.train` (its `main`) on the card at
    qwen3-1.7b's `--scale 100m` (d 512, 8 layers, vocab 32,000), B = 8 x
    256, 12 steps, a checkpoint every 4: once uninterrupted and once with
    `--simulate-failure 7` (restored from step 4).  The loss falls (last 5
    below 0.98 x the first 5); the recovered run ends at the uninterrupted
    run's loss within rtol 1e-4; every save launches each write kernel once
    per dispatch of its engine, every restore `decode_wave` (host planner,
    the default).  Counts are zeroed just before each save and restore and
    read just after (the checkpoint calls of `launch.train` are wrapped)."""
    t_phase = time.perf_counter()
    root = scratch_dir("train_drill")
    calls = {"save": [], "restore": []}

    def state_bytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    def save(ckpt_dir, step, tree, *, engine, **kw):
        path, dt, launches, (d,) = counted(
            lambda: ckpt.save(ckpt_dir, step, tree, engine=engine, **kw), engine)
        got = pick(launches, WRITE_KERNELS)
        check(d > 0 and all(v == d for v in got.values()),
              f"train_drill save {step}: launches {got} for {d} dispatches")
        n = state_bytes(tree)
        calls["save"].append(dict(step=step, bytes=n, seconds=dt, GB_per_s=n / dt / 1e9,
                                  dispatches=d, launches=got))
        return path

    def restore(ckpt_dir, step, like, *, decode_engine, **kw):
        out, dt, launches, (d,) = counted(
            lambda: ckpt.restore(ckpt_dir, step, like, decode_engine=decode_engine, **kw),
            decode_engine)
        got = pick(launches, READ_KERNELS)
        check(d > 0 and got == read_want(d, 0, 0),
              f"train_drill restore {step}: launches {got} for {d} dispatches")
        n = state_bytes(out[0])
        calls["restore"].append(dict(step=step, bytes=n, seconds=dt, GB_per_s=n / dt / 1e9,
                                     dispatches=d, launches=got))
        return out

    runs = {}
    train_mod.ckpt = types.SimpleNamespace(save=save, restore=restore,
                                           latest_step=ckpt.latest_step)
    try:
        for name, fail in (("uninterrupted", None), ("recovered", TRAIN_DRILL["simulate_failure"])):
            n_saves, n_restores = len(calls["save"]), len(calls["restore"])
            out, dt = synced(lambda: train_mod.main(drill_argv(root / name, fail)))
            runs[name] = dict(losses=out["losses"], final_loss=out["final_loss"], seconds=dt,
                              saves=len(calls["save"]) - n_saves,
                              restores=len(calls["restore"]) - n_restores)
    finally:
        train_mod.ckpt = ckpt
    first = runs["uninterrupted"]["losses"]
    check(len(first) == TRAIN_DRILL["steps"] and all(np.isfinite(first)),
          f"train_drill losses {first}")
    check(np.mean(first[-5:]) < 0.98 * np.mean(first[:5]),
          f"train_drill: loss did not fall ({np.mean(first[:5])} -> {np.mean(first[-5:])})")
    a, b = runs["uninterrupted"]["final_loss"], runs["recovered"]["final_loss"]
    check(abs(a - b) <= 1e-4 * abs(a), f"train_drill: recovered final loss {b} != {a}")
    check(runs["recovered"]["restores"] == 1 and calls["restore"][0]["step"] == 4,
          f"train_drill: restores {calls['restore']}")
    shutil.rmtree(root)
    saves, res = calls["save"], calls["restore"]
    cfg = train_mod.scale_config(get_config(TRAIN_DRILL["arch"]), TRAIN_DRILL["scale"])
    say("train_drill", **TRAIN_DRILL, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=sum(
            t.numel() for t in tree_leaves(lm.init_params(cfg, device="meta"))),
        state_bytes=saves[0]["bytes"], runs=runs,
        loss_first5=float(np.mean(first[:5])), loss_last5=float(np.mean(first[-5:])),
        recovered_equal=True, saves=saves, restores=res,
        save_GB_per_s=[c["GB_per_s"] for c in saves],
        restore_GB_per_s=[c["GB_per_s"] for c in res],
        launches_per_save={k: saves[0]["launches"][k] for k in WRITE_KERNELS},
        launches_per_restore=res[0]["launches"], seconds=time.perf_counter() - t_phase)


def phase_train_full(card: str) -> dict:
    """qwen3-1.7b at the published width and depth (1,720,574,976 float32
    parameters from a seeded generator, bfloat16 compute, remat on as the
    config has) trained by `steps.make_train_step` with the `AdamWConfig`
    that `launch/train.py` builds: one sequence of `train_4k`'s shape per
    step (B = 1, S = 4096; the global batch of 256 cut to the one sequence
    a card takes), tokens from `ShardedTokenPipeline`, the same batch every
    step; 1 warm-up step and 3 timed ones (host clock, synchronized), then
    a split one and one under torch.profiler.  MFU = `roofline.model_flops` / (step seconds
    x 989e12).  One more step is timed in halves (`loss_and_grads`, then
    `adamw.update`).  No checkpoint at this width."""
    t_phase = time.perf_counter()
    f = TRAIN_FULL
    cfg = train_config()
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=f["batch"])
    root = scratch_dir("train_full")
    pipe = ShardedTokenPipeline(str(root / "data"), cfg.vocab_size, seed=0,
                                shard_tokens=2 * f["seq"], engine=LZ4Engine(device=DEV),
                                decode_engine=LZ4DecodeEngine(device=DEV))
    batch = {"tokens": torch.from_numpy(pipe.batch(0, f["batch"], f["seq"])).to(DEV)}
    n_steps = f["warmup_steps"] + f["timed_steps"]
    # the run's steps: the timed ones, their warm-up, a split one, a profiled one
    opt_cfg = train_mod.opt_config(types.SimpleNamespace(lr=3e-4, steps=n_steps + 2,
                                                         arch=SERVE_ARCH))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=DEV).manual_seed(SEED + 80)
    params, init_s = synced(lambda: lm.init_params(cfg, g, device=DEV))
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt_state = adamw.init(params)
    # the bytes of the parameters, m and v that the card holds
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        (params, opt_state["m"], opt_state["v"])))
    step = steps.make_train_step(cfg, opt_cfg)
    state = [params, opt_state]
    del params, opt_state
    losses, norms, step_s = [], [], []

    def one_step():
        state[0], state[1], m = step(state[0], state[1], batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))

    for i in range(n_steps):
        _, dt = synced(one_step)
        if i >= f["warmup_steps"]:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    # one more step in its two halves: forward + backward, then the update
    (loss, grads), grad_s = synced(lambda: steps.loss_and_grads(state[0], batch, cfg))
    with torch.no_grad():
        (state[0], state[1], m), update_s = synced(
            lambda: adamw.update(grads, state[1], state[0], opt_cfg))
    del grads
    losses.append(float(loss))
    norms.append(float(m["grad_norm"]))
    device = profile_device(one_step)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train_full: losses {losses}, grad norms {norms}")
    check(losses[3] < losses[0], f"train_full: loss after 3 steps {losses[3]} !< {losses[0]}")
    del state
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    mean_s = float(np.mean(step_s))
    flops = roofline.model_flops(cfg, shape, 1)
    say("train_full", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.hd, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, params=n_params, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, remat=cfg.remat, remat_policy=cfg.remat_policy,
        batch=f["batch"], seq=f["seq"],
        reduced={"global_batch": f"{SHAPES['train_4k'].global_batch} -> {f['batch']} "
                                 "(the one sequence a single card takes per step)"},
        opt=dataclasses.asdict(opt_cfg), init_seconds=init_s, losses=losses, grad_norms=norms,
        ms_per_step=[s * 1e3 for s in step_s], mean_ms_per_step=mean_s * 1e3,
        split_step_ms=dict(loss_and_grads=grad_s * 1e3, adamw_update=update_s * 1e3),
        tokens_per_s=f["batch"] * f["seq"] / mean_s, model_flops=flops,
        mfu=flops / (mean_s * roofline.PEAK_FLOPS), mfu_peak_flops=roofline.PEAK_FLOPS,
        card=card, max_memory_allocated=peak, device=device, state_bytes=state_bytes,
        seconds=time.perf_counter() - t_phase)
    return dict(params=n_params, state_bytes=state_bytes, step_seconds=step_s,
                model_flops=flops)


def phase_dryrun(train_full: dict) -> None:
    """The port's dry run (`launch/dryrun.py`), on the host over `meta`
    tensors: `run_cell("qwen3-1.7b", "train_4k")` and `run_lz4_cell` on the
    16x16 meta mesh (records printed; the LZ4 cell must reach the `fibhash`
    and `match_extend` wrappers without a launch), then the dry run held to
    the card once: qwen3-1.7b at `train_full`'s shape (B = 1 x 4096) on a
    one-device meta mesh, whose ``param_bytes + opt_bytes`` must equal the
    bytes of the parameters, m and v that `train_full` allocated, byte for
    byte; its counted FLOPs are printed beside `train_full`'s measured
    step seconds (a count, not a device time)."""
    t_phase = time.perf_counter()
    reset_launches(EVERY_KERNEL_MODULE)
    cell = dryrun.run_cell(SERVE_ARCH, "train_4k", False, verbose=False)
    lz4 = dryrun.run_lz4_cell(False, verbose=False)
    say("dryrun_record", record=cell)
    say("dryrun_record", record=lz4)
    check(all(v == 0 for v in launch_counts(EVERY_KERNEL_MODULE).values()),
          f"the dry run launched kernels: {launch_counts(EVERY_KERNEL_MODULE)}")
    check(set(lz4["kernels"]) == {"fibhash", "match_extend"}
          and all(k["calls"] == 1 for k in lz4["kernels"].values()),
          f"the LZ4 cell's kernel calls: {lz4['kernels']}")
    for tot in (cell["probe"]["total"], lz4["probe"]["total"]):
        check(all(np.isfinite(v) and v >= 0 for v in tot.values()) and tot["bytes"] > 0,
              f"dry-run totals {tot}")
    check(cell["probe"]["total"]["flops"] > 0, "the train cell counted no FLOPs")
    one = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    shape = dataclasses.replace(SHAPES["train_4k"], name="train_full",
                                global_batch=TRAIN_FULL["batch"], seq_len=TRAIN_FULL["seq"])
    full = dryrun.dry_run(train_config(), shape, one)
    counted = full["param_bytes"] + full["opt_bytes"]
    check(counted == train_full["state_bytes"],
          f"dry run's params + m + v {counted} B != train_full's {train_full['state_bytes']} B")
    check(cell["param_bytes"] + cell["opt_bytes"] == counted,
          "the 16x16 cell's state bytes differ from the one-device cell's")
    flops = full["probe"]["global"]["flops"]
    check(flops >= train_full["model_flops"],
          f"counted FLOPs {flops} below the useful {train_full['model_flops']}")
    step_s = float(np.mean(train_full["step_seconds"]))
    say("dryrun", cell_lower_seconds=cell["lower_s"], lz4_lower_seconds=lz4["lower_s"],
        one_device=dict(shape=dataclasses.asdict(shape), param_bytes=full["param_bytes"],
                        opt_bytes=full["opt_bytes"], memory=full["memory"],
                        counted=full["probe"]["global"], lower_seconds=full["lower_s"]),
        train_full=dict(params=train_full["params"], state_bytes=train_full["state_bytes"],
                        mean_step_seconds=step_s, model_flops=train_full["model_flops"]),
        state_bytes_equal=True,
        counted_flops_per_measured_second=flops / step_s,
        useful_over_counted=train_full["model_flops"] / flops,
        seconds=time.perf_counter() - t_phase)


def phase_compress_bytes() -> dict:
    """The deprecated `compress_bytes` on the card: 8 MiB of the corpus (the
    data of `path_small`); its blocks must equal `LZ4Engine(device="cuda").
    compress_to_blocks` and `compress_bytes(device="cpu")` (the plain
    versions), byte for byte, and decode back.  Returns its launches."""
    t_phase = time.perf_counter()
    data = seeded_data(8 << 20, SEED + 3)
    reset_launches(EVERY_KERNEL_MODULE)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        blocks = compressor.compress_bytes(data)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = launch_counts(EVERY_KERNEL_MODULE)
        cpu_blocks = compressor.compress_bytes(data, device="cpu")
    check(any(issubclass(w.category, DeprecationWarning)
              and "compress_bytes is deprecated" in str(w.message) for w in caught),
          "compress_bytes did not warn")
    engine_blocks = LZ4Engine(device=DEV).compress_to_blocks(data)
    check(blocks == engine_blocks, "compress_bytes != LZ4Engine.compress_to_blocks on the card")
    check(blocks == cpu_blocks, "compress_bytes on the card != on the CPU")
    check(b"".join(decode_block(b) for b in blocks) == data, "compress_bytes does not round-trip")
    for name in WRITE_KERNELS:
        check(launches[name] > 0, f"compress_bytes launched no {name}")
    say("compress_bytes", bytes_in=len(data), blocks=len(blocks),
        bytes_out=sum(len(b) for b in blocks), card_seconds=card_s,
        blocks_equal=["engine", "cpu"], launches=launches,
        seconds=time.perf_counter() - t_phase)
    return launches


EXAMPLES_TIMEOUT = 240   # seconds for the four examples together
DISTINCT_DEVICES = ("cuda:0", "cpu")   # restore_distinct's mesh
DISTINCT_WIDTH = 2048    # restore_distinct's state: 64 x DISTINCT_WIDTH^2 bytes
DISTINCT_SPECS = {"rows": P("data", None), "cols": P(None, "data"), "replicated": P()}


def distinct_state(data: bytes, w: int) -> dict:
    """A state of 64 w^2 bytes (256 MiB at w = 2048) on the card for
    `restore_distinct`: six float32 and four bfloat16 (w, w) leaves of
    seeded normals (stored raw: noise to LZ4), a float32 (2w, 3w) and a
    bfloat16 (2w, 2w) leaf holding the first 32 w^2 bytes of the corpus
    data (coded blocks, so the restore launches the decode kernels), and a
    0-d step.  Every dimension divides by 2."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 90)
    state = {f"w{i}": torch.randn((w, w), generator=g, device=DEV) for i in range(6)}
    state.update({f"h{i}": torch.randn((w, w), generator=g, device=DEV).to(torch.bfloat16)
                  for i in range(4)})
    corpus = torch.frombuffer(bytearray(data[: 32 * w * w]), dtype=torch.uint8).to(DEV)
    state["c_f32"] = corpus[: 24 * w * w].view(torch.float32).reshape(2 * w, 3 * w)
    state["c_bf16"] = corpus[24 * w * w:].view(torch.bfloat16).reshape(2 * w, 2 * w)
    state["step"] = torch.tensor(SEED, dtype=torch.int32, device=DEV)
    return state


def halves(n: int, split: bool) -> list[slice]:
    return [slice(0, n // 2), slice(n // 2, n)] if split else [slice(None)] * 2


def phase_restore_distinct(data: bytes, card: str) -> None:
    """`checkpoint.restore(shardings=)` onto two distinct devices: a 256 MiB
    state saved by the card's engine, restored three times over the mesh
    ``make_mesh((2,), ("data",), devices=["cuda:0", "cpu"])`` with every
    leaf under P("data", None), P(None, "data") and P() (the 0-d step always
    under P()), by `LZ4DecodeEngine(plan_on_device=True)`.  Each leaf must
    come back as a `ShardedTensor` whose shard 0 is on the card and shard 1
    on the CPU, each at the index the spec gives (halves of the split
    dimension, the whole of every other), each holding exactly those bytes
    of the saved leaf; `full("cuda")` must equal the leaf bit for bit.
    Launches of the read kernels are counted per restore."""
    t_phase = time.perf_counter()
    root = scratch_dir("restore_distinct")
    state = distinct_state(data, DISTINCT_WIDTH)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    enc, dec = default_engine(), LZ4DecodeEngine(device=DEV, plan_on_device=True)
    _, save_s, launches, (d,) = counted(lambda: ckpt.save(str(root), 1, state, engine=enc),
                                        enc)
    save = dict(seconds=save_s, GB_per_s=nbytes / save_s / 1e9, dispatches=d,
                launches=pick(launches, WRITE_KERNELS))
    mesh = make_mesh((2,), ("data",), devices=list(DISTINCT_DEVICES))
    devices = list(mesh.devices)
    like = as_meta(state)
    restores = {}
    for name, spec in DISTINCT_SPECS.items():
        sh = {k: NamedSharding(mesh, spec if v.dim() else P()) for k, v in state.items()}
        (tree, step), dt, launches, (d,) = counted(
            lambda: ckpt.restore(str(root), 1, like, shardings=sh, decode_engine=dec), dec)
        got = pick(launches, READ_KERNELS)
        check(step == 1 and set(tree) == set(state), f"restore_distinct {name}: tree")
        check(d > 0 and got["plan_speculative"] == d and got["decode_wave"] > 0
              and got["crc32"] == 0,
              f"restore_distinct {name}: launches {got} for {d} dispatches")
        for k, leaf in state.items():
            t = tree[k]
            check(isinstance(t, ShardedTensor) and t.shape == tuple(leaf.shape)
                  and t.dtype == leaf.dtype, f"{name} {k}: not a ShardedTensor of the leaf")
            cuts = ([halves(n, spec[i] is not None if i < len(spec) else False)
                     for i, n in enumerate(leaf.shape)] if leaf.dim() else [])
            for pos, s in enumerate(t.shards):
                want = tuple(c[pos] for c in cuts)
                check(s.device == devices[pos] and s.data.device.type == devices[pos].type
                      and s.data.is_contiguous(), f"{name} {k}: shard {pos} on {s.device}")
                check(s.index == want, f"{name} {k}: shard {pos} index {s.index} != {want}")
                check(same_bits(s.data.to(DEV), leaf[want].contiguous()),
                      f"{name} {k}: shard {pos} bytes differ from the saved leaf")
            check(same_bits(t.full(DEV), leaf), f"{name} {k}: full() differs")
        restores[name] = dict(seconds=dt, GB_per_s=nbytes / dt / 1e9, dispatches=d,
                              launches=got)
        del tree
    shutil.rmtree(SCRATCH)
    say("restore_distinct", card=card, state_bytes=nbytes, leaves=len(state),
        mesh=[str(x) for x in devices], save=save, restores=restores,
        shards_equal=True, full_equal=True, seconds=time.perf_counter() - t_phase)


EXAMPLE_RUNS = {   # each example's arguments at its quick size, and its "OK" lines
    "torch_quickstart": ((), {"frame round-trip OK": 1, "parallel decode OK": 1,
                              "fetched 0 plaintext bytes to host": 1,
                              "decoder verified": 1}),
    "torch_compress_file": ((), {"round-trip OK": 14}),   # one per corpus file
    "torch_serve_lm": ((), {"bit-exact restore: True": 1}),
    "torch_train_lm": (("--quick",), {"[train] done; final loss": 1}),
}


def phase_examples(card: str) -> None:
    """`examples/torch_*.py` on the card at their quick sizes, all four at
    once in subprocesses with a time limit (the kernels in `build/` are
    reused, not rebuilt): each must exit 0 and print its "OK" lines."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    train_dir = scratch_dir("examples_train")
    procs = {}
    for name, (args, _) in EXAMPLE_RUNS.items():
        extra = ("--ckpt-dir", str(train_dir)) if name == "torch_train_lm" else ()
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    runs, ended = {}, {}
    try:
        # Output is a few KB per example, well inside a pipe's buffer.
        while len(ended) < len(procs) and time.perf_counter() - t_phase < EXAMPLES_TIMEOUT:
            for name, proc in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t_phase
            time.sleep(0.05)
        check(len(ended) == len(procs),
              f"examples still running after {EXAMPLES_TIMEOUT} s: {set(procs) - set(ended)}")
        for name, proc in procs.items():
            out, err = proc.communicate()
            lines = out.splitlines()
            check(proc.returncode == 0, f"{name} exited {proc.returncode}: {err[-2000:]}")
            found = {want: sum(want in ln for ln in lines) for want in EXAMPLE_RUNS[name][1]}
            check(found == EXAMPLE_RUNS[name][1], f"{name}: OK lines {found}: {out[-2000:]}")
            runs[name] = dict(seconds=ended[name], lines=len(lines), last_line=lines[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(SCRATCH)
    say("examples", card=card, runs=runs, seconds=time.perf_counter() - t_phase)


def main() -> None:
    # Bring-up aid: `--stop-after build|kernels|small` ends the run early
    # (exit 0, no result lines).  With no arguments the whole run.
    stop_after = sys.argv[2] if sys.argv[1:2] == ["--stop-after"] else None
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    if stop_after == "build":
        return
    measured = phase_kernels()
    measured.update(phase_decode_kernels())
    measured.update(phase_staged_kernels())
    if stop_after == "kernels":
        return
    phase_path_staged_small(*phase_path_small())
    phase_read_small()
    phase_resilience_small()
    phase_models_small()
    phase_train_small()
    if stop_after == "small":
        return
    t0 = time.perf_counter()
    data = seeded_data(256 << 20, SEED + 4)
    say("data", bytes=len(data), seconds=round(time.perf_counter() - t0, 3))
    # One unmeasured pass over the full data first: it pays the one-off costs
    # (first touch of the host heap, growth of the device allocator), which
    # would otherwise land on whichever measured pass runs first.
    LZ4Engine(device=DEV).compress(data)
    launches, frame, path_full = phase_path_full(data, micro_batch=32)   # THE write path
    phase_path_full(data, micro_batch=256)
    launches.update(phase_read_full(frame, data))             # THE read path
    phase_checkpoint_full(data)       # the consumers' path: save / restore
    phase_consumers_small(data)
    phase_salvage_full(data)
    phase_fabric_small()              # the sharded fabric: host and mesh paths
    phase_fabric_full(data, frame, path_full)
    phase_serve_offload(*phase_serve_full())   # the serving path at full width
    phase_train_drill()               # the training loop, its checkpoints and recovery
    train_full = phase_train_full(card)   # a training step at full width
    phase_dryrun(train_full)          # the dry run over meta tensors, held to train_full
    cb_launches = phase_compress_bytes()   # the deprecated list-of-blocks wrapper
    phase_restore_distinct(data, card)     # restore(shardings=) onto cuda:0 and the CPU
    phase_examples(card)              # examples/torch_*.py on the card
    staged = phase_path_staged_full(data, frame)              # the staged path
    launches.update({k: staged[k] for k in ("fibhash", "match_extend")})
    phase_breakdown(data[: 64 << 20])
    phase_read_breakdown(data[: 64 << 20])
    phase_staged_breakdown(data[: 64 << 20])
    phase_fabric_breakdown(data[: 64 << 20])
    say("done", seconds=round(time.perf_counter() - t_start, 3))

    replaces = {
        "fused_compress": "src/repro/kernels/fused_compress.py:160",
        "emit_scatter": "src/repro/kernels/emit_scatter.py:99",
        # no TPU kernel: the lax.scan graph stage _select_sequential
        "window_select": "src/repro/core/jax_compressor.py:196",
        "decode_wave": "src/repro/kernels/decode_wave.py:64",
        # no TPU kernel: the graph stages plan_speculative (checks, cumsum,
        # compaction; :294) and decode_gather's span maps and gathers (:216)
        "plan_layout": "src/repro/kernels/ops.py:294",
        "plan_speculative": "src/repro/kernels/plan_speculative.py:124",
        # no TPU kernel: the lax.scan graph stage crc32_bytes
        "crc32": "src/repro/kernels/ops.py:455",
        "fibhash": "src/repro/kernels/fibhash.py:44",
        "match_extend": "src/repro/kernels/match_extend.py:75",
    }
    kernels = []
    for name, m in measured.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": m["max_abs_diff"], "max_abs_diff": m["max_abs_diff"],
            "ms": m["ms"], "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "compress_bytes_launches": cb_launches[name],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
