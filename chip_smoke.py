#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--stop-after build|kernels|path_small]

Builds the CUDA kernels from `src/repro_torch/csrc/*.cu` (into `build/`),
holds each against its plain PyTorch version on the card (exact equality —
every output is an integer or a byte), then drives the port's main path,
`repro_torch.LZ4Engine(device="cuda").compress`, on 8 MiB and on 256 MiB of
seeded data, and checks the frames.  Imports `repro_torch` only — never the
JAX reference.  One JSON line per phase; any failed check raises, so the
process exits non-zero at once.  Without a CUDA device it exits non-zero
and prints no result.

The second to last line is ``{"kernels": [...]}`` (per kernel: launches on
the main path, error against the plain version, time, plain time, bound);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
from repro_torch import LZ4Engine, decode_frame_serial, frame_info  # noqa: E402
from repro_torch.core import compressor  # noqa: E402
from repro_torch.core.compressor import _PAD, OUT_CAP  # noqa: E402
from repro_torch.core.corpus import adversarial_blocks, corpus_files  # noqa: E402
from repro_torch.core.decoder import decode_block  # noqa: E402
from repro_torch.core.emitter import emit_block  # noqa: E402
from repro_torch.core.frame import check_block  # noqa: E402
from repro_torch.core.lz4_types import MAX_BLOCK, MIN_MATCH  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import emit_scatter as k_emit  # noqa: E402
from repro_torch.kernels import fused_compress as k_fused  # noqa: E402
from repro_torch.kernels import window_select as k_select  # noqa: E402

SEED = 20260731
DEV = torch.device("cuda")
DEFAULTS = (8, 36, 8)                      # (hash_bits, max_match, pws)
SWEEP = [(6, 12, 8), (10, 68, 4), (8, 36, 16), (12, 36, 8)]
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and the
# fp32 rate outside the tensor cores, used here for 32-bit integer operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNEL_MODULES = (k_fused, k_emit, k_select)


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


def reset_launches() -> None:
    for mod in KERNEL_MODULES:
        mod.reset_launches()


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
        libraries=[p.name for p in paths.values()], ptxas=ptxas)


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card; times at M = 32
    and the engine defaults.  Returns per-kernel measurements."""
    res = {m.__name__.rsplit(".", 1)[1]: {"max_abs_diff": 0, "cases": 0}
           for m in KERNEL_MODULES}

    def note(name: str, *pairs) -> None:
        for a, b in pairs:
            d = max_abs_diff(a, b)
            res[name]["max_abs_diff"] = max(res[name]["max_abs_diff"], d)
            res[name]["cases"] += 1
            check(d == 0, f"{name}: kernel and plain version differ by {d}")

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
        byte_ms = w["bytes"] / PEAK_BYTES_PER_S * 1e3
        op_ms = w["ops"] / PEAK_OPS_PER_S * 1e3
        res[name].update(
            ms=cuda_ms(w["run"], iters=50, warmup=5),
            plain_ms=cuda_ms(w["plain"], iters=w["plain_iters"], warmup=1),
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            bytes=w["bytes"], operations=w["ops"])
    say("kernels_check", shapes=dict(M=M, B=B, P=P, K=K, S=S, W=W),
        tolerance=0, results=res)
    return res


def phase_path_small() -> None:
    data = seeded_data(8 << 20, SEED + 3)
    t0 = time.perf_counter()
    cpu = LZ4Engine(device="cpu")
    ref_frame = cpu.compress(data)
    cpu_s = time.perf_counter() - t0
    combos = []
    for device_emit in (True, False):
        for drain in ("sliced", "full"):
            for scan_impl in ("sequential", "associative"):
                eng = LZ4Engine(device="cuda", device_emit=device_emit,
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
    eng = LZ4Engine(device="cuda", micro_batch=micro_batch)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = eng.compress(data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in KERNEL_MODULES}
    st = eng.stats
    for name, n in launches.items():
        check(n == st.dispatches and n > 0,
              f"{name}: {n} launches for {st.dispatches} dispatches")
    verified = verify_frame(frame, data, sample=96, seed=SEED + micro_batch)
    check(st.raw_blocks > 0, "no raw passthrough block in the run")
    say("path_full", micro_batch=micro_batch, bytes_in=len(data),
        frame_bytes=len(frame), ratio=len(data) / len(frame), seconds=seconds,
        input_GB_per_s=len(data) / seconds / 1e9,
        blocks_per_s=st.blocks / seconds,
        host_bytes_per_input_byte=st.host_bytes / len(data),
        stats=st.as_dict(), launches=launches, verified=verified,
        peak_device_MiB=torch.cuda.max_memory_allocated() / 2**20)
    return launches


def phase_breakdown(data: bytes) -> None:
    """Where the main path's wall time goes: the engine's own spans
    (telemetry on) over one call, and — where the profiler can trace the
    card — the share of the wall time the device was busy."""
    from repro_torch import obs

    obs.reset()
    obs.configure(nvtx=True)   # every span also pushes/pops an NVTX range
    check(obs.tracer()._nvtx_module() is not None, "NVTX bridge did not arm")
    eng = LZ4Engine(device="cuda", telemetry=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.compress(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    obs.configure(nvtx=False)
    spans: dict[str, list[float]] = {}
    for r in obs.tracer().finished():
        spans.setdefault(r["name"], []).append(r["dur_ns"] / 1e9)
    obs.reset()
    table = {k: dict(count=len(v), seconds=sum(v)) for k, v in sorted(spans.items())}

    device = "not measured"
    try:  # the profiler is an extra: a card it cannot trace is reported, not fatal
        from torch.profiler import ProfilerActivity, profile

        eng = LZ4Engine(device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.compress(data)
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
        if busy > 0:
            rows.sort(key=lambda r: -r[1])
            device = dict(
                wall_seconds_under_profiler=prof_wall, busy_seconds=busy,
                idle_share=1 - busy / prof_wall,
                top=[dict(name=k[:60], seconds=t, count=c) for k, t, c in rows[:12]])
    except Exception as e:  # noqa: BLE001
        device = f"not measured ({type(e).__name__}: {e})"
    say("breakdown", bytes_in=len(data), micro_batch=32, wall_seconds=wall,
        spans=table, device=device)


def main() -> None:
    # Bring-up aid: `--stop-after build|kernels|path_small` ends the run
    # early (exit 0, no result lines).  With no arguments the whole run.
    stop_after = sys.argv[2] if sys.argv[1:2] == ["--stop-after"] else None
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    if stop_after == "build":
        return
    measured = phase_kernels()
    if stop_after == "kernels":
        return
    phase_path_small()
    if stop_after == "path_small":
        return
    t0 = time.perf_counter()
    data = seeded_data(256 << 20, SEED + 4)
    say("data", bytes=len(data), seconds=round(time.perf_counter() - t0, 3))
    # One unmeasured pass over the full data first: it pays the one-off costs
    # (first touch of the host heap, growth of the device allocator), which
    # would otherwise land on whichever measured pass runs first.  Then the
    # two batch sizes in turns: 32, 256, 256, 32.
    LZ4Engine(device="cuda").compress(data)
    launches = phase_path_full(data, micro_batch=32)      # THE main path
    phase_path_full(data, micro_batch=256)
    phase_path_full(data, micro_batch=256)
    phase_path_full(data, micro_batch=32)
    phase_breakdown(data[: 64 << 20])
    say("done", seconds=round(time.perf_counter() - t_start, 3))

    replaces = {
        "fused_compress": "src/repro/kernels/fused_compress.py:160",
        "emit_scatter": "src/repro/kernels/emit_scatter.py:99",
        # no TPU kernel: the lax.scan graph stage _select_sequential
        "window_select": "src/repro/core/jax_compressor.py:196",
    }
    kernels = []
    for name, m in measured.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": m["max_abs_diff"], "max_abs_diff": m["max_abs_diff"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
