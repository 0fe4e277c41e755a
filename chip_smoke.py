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
256 MiB of seeded data, and checks the frames and the bytes.
Imports `repro_torch` only — never the JAX reference.  One JSON line per
phase; any failed check raises, so the process exits non-zero at once.
Without a CUDA device it exits non-zero and prints no result.

The second to last line is ``{"kernels": [...]}`` (per kernel: launches on
the main path, error against the plain version, time, plain time, bound);
the last line is ``{"ok": true, "device": {...}}``.  The 256 MiB write
phases print each frame's SHA-256, so that runs of two checkouts show
whether they write the same bytes.
"""
from __future__ import annotations

import binascii
import hashlib
import json
import re
import subprocess
import sys
import time
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
from repro_torch.kernels import plan_speculative as k_plan  # noqa: E402
from repro_torch.kernels import window_select as k_select  # noqa: E402

SEED = 20260731
DEV = torch.device("cuda")
DEFAULTS = (8, 36, 8)                      # (hash_bits, max_match, pws)
SWEEP = [(6, 12, 8), (10, 68, 4), (8, 36, 16), (12, 36, 8)]
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and the
# fp32 rate outside the tensor cores, used here for 32-bit integer operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNEL_MODULES = (k_fused, k_emit, k_select)           # the write path's
READ_KERNEL_MODULES = (k_wave, k_plan, k_crc)          # the read path's
STAGED_KERNEL_MODULES = (k_fib, k_ext)                 # the staged path's
ALL_KERNEL_MODULES = KERNEL_MODULES + STAGED_KERNEL_MODULES
STAGED_IMPLS = ("sort", "sortkey", "scatter")
CAPS = DevicePlanCaps()
ROUND_BUCKETS = (0, 1, 2, 4, 8, 16)
LONG_CRC_ROW = (64 << 20) + 5   # bytes of the long row the crc32 kernel checks
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
        }
        timing[M] = {name: timed(w, name) for name, w in work.items()}
        timing[M]["decode_wave"]["depth_needed"] = depth
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
                want = dict(decode_wave=d, plan_speculative=d if pod else 0, crc32=0)
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
            want = dict(decode_wave=st.dispatches, plan_speculative=st.dispatches,
                        crc32=st.dispatches if method == "decode_to_device" else 0)
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
    check(launches == dict(decode_wave=st.dispatches, plan_speculative=st.dispatches,
                           crc32=st.dispatches + 1),
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
        want = dict(decode_wave=st.dispatches, plan_speculative=0,
                    crc32=st.dispatches if method == "decode_to_device" else 0)
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


def phase_path_full(data: bytes, micro_batch: int) -> dict:
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
    return launches, frame


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
    if stop_after == "small":
        return
    t0 = time.perf_counter()
    data = seeded_data(256 << 20, SEED + 4)
    say("data", bytes=len(data), seconds=round(time.perf_counter() - t0, 3))
    # One unmeasured pass over the full data first: it pays the one-off costs
    # (first touch of the host heap, growth of the device allocator), which
    # would otherwise land on whichever measured pass runs first.
    LZ4Engine(device=DEV).compress(data)
    launches, frame = phase_path_full(data, micro_batch=32)   # THE write path
    phase_path_full(data, micro_batch=256)
    launches.update(phase_read_full(frame, data))             # THE read path
    staged = phase_path_staged_full(data, frame)              # the staged path
    launches.update({k: staged[k] for k in ("fibhash", "match_extend")})
    phase_breakdown(data[: 64 << 20])
    phase_read_breakdown(data[: 64 << 20])
    phase_staged_breakdown(data[: 64 << 20])
    say("done", seconds=round(time.perf_counter() - t_start, 3))

    replaces = {
        "fused_compress": "src/repro/kernels/fused_compress.py:160",
        "emit_scatter": "src/repro/kernels/emit_scatter.py:99",
        # no TPU kernel: the lax.scan graph stage _select_sequential
        "window_select": "src/repro/core/jax_compressor.py:196",
        "decode_wave": "src/repro/kernels/decode_wave.py:64",
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
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
