"""Parallel two-phase decompression: the `LZ4DecodeEngine` and `FrameReader`.

The read side of the port, held against the JAX package's
`core/decode_engine.py`.  A frame's blocks are independent, so each block is
decoded in two phases — a plan of literal spans and match copies, then the
copies — and the blocks fan out.  Four executors:

  "device"   — the default, on the card: ``LZ4DecodeEngine()`` means
               ``executor="device"`` on ``device="cuda"`` and raises when no
               CUDA device is available; ``device="cpu"`` runs the same
               executor through the kernels' plain PyTorch versions (what
               the tests use).  Host planning (`plan_block_fast` ->
               `to_device_plan`) stacks a micro-batch of fixed-shape
               `DevicePlan`s, and one dispatch per micro-batch resolves and
               materializes every block's bytes on the device
               (`kernels.ops.decode_gather`: stock-torch span maps, then the
               `decode_wave` kernel), double-buffered: micro-batch i+1 is
               dispatched before micro-batch i is drained.  With
               ``plan_on_device=True`` the parse moves to the device too
               (`kernels.ops.plan_decode`: the `plan_speculative` kernel,
               validation and compaction in torch, `decode_wave`, and the
               `crc32` kernel for verified device restores), so
               `decode_to_device` moves no content to the host, planning
               included.  Blocks whose plans overflow `DevicePlanCaps`, or
               whose payload exceeds ``blk_cap``, are decoded on the host and
               counted in `DecodeStats.fallback_blocks`, as in the reference.
  "serial"   — decode blocks inline on the host.
  "thread"   — a thread pool on the host.
  "process"  — a process pool on the host, started with the ``spawn``
               method (forking a parent with a live CUDA context is unsafe).

The host executors run only when the caller names them.  `FrameReader` adds
random access through the frame's block table (`read_block`, `read_range`,
`read_range_device`).

Not ported yet (refused with NotImplementedError): ``mesh=`` /
``shard_axes=`` (ROADMAP A8, the sharded fabric) and ``on_error="salvage"``
/ `salvage()` (ROADMAP A6, resilience).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops as kops

from .decode_plan import (
    _ERR_MESSAGES,
    MAX_RESOLVE_ROUNDS,
    DevicePlanCaps,
    DevicePlanOverflow,
    execute_plan,
    plan_block_fast,
    to_device_plan,
)
from .decoder import LZ4FormatError, decode_block
from .engine import _resolve_device
from .frame import (
    FrameFormatError,
    block_crc,
    check_block,
    check_content_crc,
    frame_info,
)
from .lz4_types import MAX_BLOCK, pad_pow2_count

__all__ = ["LZ4DecodeEngine", "DecodeStats", "FrameReader",
           "default_decode_engine"]

_EXECUTORS = ("serial", "thread", "process", "device")


def _spec_err_message(code: int) -> str:
    """Map a speculative-planner status code to the host planner's exact
    error message (codes 1..8 are `_ERR_MESSAGES`; 9 is the serial parser's
    missing-token error)."""
    if code == 9:
        return "truncated block: missing token"
    return _ERR_MESSAGES.get(code, f"invalid stream (status {code})")


def _round_bucket(rounds: int) -> int:
    """Round the needed pointer-doubling depth up to a power of two
    ({0, 1, 2, 4, 8, 16}), as the reference does to bound its compiled
    variants; kept so the two packages launch the same rounds."""
    if rounds <= 0:
        return 0
    b = 1
    while b < rounds:
        b <<= 1
    return b


@functools.lru_cache(maxsize=1)
def default_decode_engine() -> "LZ4DecodeEngine":
    """Process-wide default engine (used by `frame.decode_frame`): the
    device executor on the card."""
    return LZ4DecodeEngine()


def _decode_planned(payload: bytes, cap: int, sp=None) -> bytes:
    """Two-phase decode of one block (plan once, execute in bulk)."""
    if sp is None:
        plan = plan_block_fast(payload, max_out=cap)
        return execute_plan(payload, plan).tobytes()
    with sp("decode.plan", bytes_in=len(payload)):
        plan = plan_block_fast(payload, max_out=cap)
    with sp("decode.execute", bytes_out=plan.usize):
        return execute_plan(payload, plan).tobytes()


def _decode_one(payload: bytes, cap, two_phase: bool, ob: bool):
    """One block through the selected per-block host decoder, traced when
    on (spans of process-pool workers stay in the worker)."""
    if not ob:
        return (_decode_planned(payload, cap) if two_phase
                else decode_block(payload, cap))
    sp = obs.span_factory(True)
    if two_phase:
        return _decode_planned(payload, cap, sp)
    with sp("decode.execute", bytes_in=len(payload), fused=True):
        return decode_block(payload, cap)


def _frame_block_task(args) -> bytes:
    """Decode + verify one frame block (module-level so it pickles for the
    process pool)."""
    payload, usize, crc, index, two_phase, ob = args
    try:
        data = _decode_one(payload, usize, two_phase, ob)
    except FrameFormatError:
        raise
    except LZ4FormatError as e:
        raise FrameFormatError(f"block {index}: {e}") from e
    if ob:
        with obs.span_factory(True)("decode.verify", block=index):
            check_block(index, usize, crc, data)
    else:
        check_block(index, usize, crc, data)
    return data


def _plain_block_task(args) -> bytes:
    """Decode one raw LZ4 block (no framing, no checksum)."""
    payload, usize, index, two_phase, ob = args
    cap = usize if usize is not None else MAX_BLOCK
    data = _decode_one(payload, cap, two_phase, ob)
    if usize is not None and len(data) != usize:
        raise LZ4FormatError(
            f"block {index}: decoded {len(data)} bytes, expected {usize}"
        )
    return data


@dataclasses.dataclass
class DecodeStats:
    """Per-call counters (PLUS a lifetime accumulator on the engine).

    ``engine.stats`` is REPLACED at the start of every `decode` /
    `decode_blocks` / `decode_to_device` call and describes the most recent
    call only (`FrameReader` reads count into whatever call came last).
    ``engine.totals`` is the cumulative sum, merged in as each public call
    finishes (even on error).

    ``host_bytes`` counts every CONTENT byte fetched device -> host by the
    device executor: exactly the decoded payload of the blocks decoded on
    the device, or zero for `decode_to_device`, whose CRC checks run on the
    device (only checksums and, with ``plan_on_device``, the per-block
    status vectors cross back — metadata, not counted).
    """

    blocks: int = 0
    raw_blocks: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    parallel: bool = False
    dispatches: int = 0        # device executor: dispatches issued
    device_blocks: int = 0     # blocks decoded on the device
    fallback_blocks: int = 0   # device executor blocks decoded on host
    host_bytes: int = 0        # bytes fetched device -> host
    shards: int = 0            # always 0 here: the sharded fabric is not ported
    calls: int = 0             # 1 per finished call (totals.calls sums them)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def accumulate(self, other: "DecodeStats") -> None:
        """Fold ``other`` (one finished call) into this accumulator (not
        thread-safe by itself; the engine holds a lock around it)."""
        for f in ("blocks", "raw_blocks", "bytes_in", "bytes_out",
                  "dispatches", "device_blocks", "fallback_blocks",
                  "host_bytes"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.parallel = self.parallel or other.parallel
        self.shards = max(self.shards, other.shards)
        self.calls += max(other.calls, 1)


class LZ4DecodeEngine:
    """Two-phase (plan/execute) frame decoder with pluggable block fan-out.

    >>> eng = LZ4DecodeEngine()              # device executor, on the card
    >>> data = eng.decode(frame)
    >>> dev = eng.decode_to_device(frame)    # a CUDA uint8 tensor
    >>> LZ4DecodeEngine(device="cpu")        # the plain versions, on the CPU
    """

    def __init__(self, workers: int | None = None, executor: str | None = None,
                 min_parallel_blocks: int = 2, two_phase: bool | None = None,
                 micro_batch: int = 8,
                 caps: DevicePlanCaps | None = None,
                 adaptive_rounds: bool = True,
                 plan_on_device: bool = False,
                 on_error: str = "raise",
                 telemetry: bool | None = None,
                 mesh=None,
                 shard_axes: tuple[str, ...] | None = None,
                 device=None):
        if executor is not None and executor not in _EXECUTORS:
            raise ValueError(f"executor must be one of {_EXECUTORS}")
        if on_error not in ("raise", "salvage"):
            raise ValueError('on_error must be "raise" or "salvage"')
        if on_error == "salvage":
            raise NotImplementedError(
                'on_error="salvage" needs the salvage pass, which repro_torch '
                "does not have yet (ROADMAP queue A, item A6)")
        if mesh is not None or shard_axes is not None:
            raise NotImplementedError(
                "mesh= / shard_axes= select the sharded fabric, which "
                "repro_torch does not have yet (ROADMAP queue A, item A8)")
        if executor is None:
            executor = "device"
        if plan_on_device and executor != "device":
            raise ValueError("plan_on_device requires executor='device'")
        if workers is not None and workers < 1:
            raise ValueError("workers must be >= 1")
        if micro_batch < 1:
            raise ValueError("micro_batch must be >= 1")
        self.device = _resolve_device(device, "LZ4DecodeEngine")
        self.mesh, self.shard_axes, self.shards = None, (), 1
        if workers is None:
            workers = 1 if executor in ("serial", "device") \
                else min(4, os.cpu_count() or 1)
        self.workers = workers
        self.executor = executor if (workers > 1 or executor == "device") \
            else "serial"
        self.min_parallel_blocks = min_parallel_blocks
        # Device-executor knobs: blocks per dispatch, fixed plan-array caps,
        # and whether host planning computes exact wave depths so shallow
        # micro-batches run fewer pointer-doubling rounds.
        self.micro_batch = micro_batch
        self.caps = caps or DevicePlanCaps()
        self.adaptive_rounds = adaptive_rounds
        # Parse the token stream on the device and fuse plan + execute
        # (+ CRC) into one dispatch per micro-batch; `plan_block_fast` runs
        # only as the per-block fallback.  `adaptive_rounds` has no effect
        # here: with no host plan there is no `n_waves`, so the resolve
        # always runs MAX_RESOLVE_ROUNDS.
        self.plan_on_device = plan_on_device
        # Per-block host strategy: the fused chunked decoder inline, the
        # two-phase planner in workers.  Both are bit-identical.
        self.two_phase = (self.executor != "serial") if two_phase is None \
            else two_phase
        self.on_error = on_error
        # None follows the global `repro_torch.obs` gate at call time.
        self.telemetry = telemetry
        self.stats = DecodeStats()      # most recent call (see DecodeStats)
        self.totals = DecodeStats()     # lifetime accumulator
        self._totals_lock = threading.Lock()
        self._pool = None
        self._pool_lock = threading.Lock()

    def _obs_on(self) -> bool:
        return obs.enabled_for(self.telemetry)

    def _finish_call(self, st: DecodeStats) -> None:
        """Fold the finished call's stats into `totals` + the obs registry."""
        s = st
        s.calls = 1
        with self._totals_lock:
            self.totals.accumulate(s)
        if self._obs_on():
            r = obs.registry()
            r.counter("decode.calls", "decode calls").inc()
            r.counter("decode.blocks", "frame blocks decoded").inc(s.blocks)
            r.counter("decode.raw_blocks",
                      "raw-passthrough blocks").inc(s.raw_blocks)
            r.counter("decode.bytes_in", "compressed bytes in").inc(s.bytes_in)
            r.counter("decode.bytes_out", "decoded bytes out").inc(s.bytes_out)
            r.counter("decode.dispatches",
                      "device-executor dispatches").inc(s.dispatches)
            r.counter("decode.device_blocks",
                      "blocks decoded on the device").inc(s.device_blocks)
            r.counter("decode.fallback_blocks",
                      "device-executor blocks decoded on host "
                      "(plan overflowed DevicePlanCaps)").inc(s.fallback_blocks)
            r.counter("decode.host_bytes",
                      "content bytes fetched device -> host").inc(s.host_bytes)

    # -- worker pool --------------------------------------------------------

    def _get_pool(self):
        with self._pool_lock:
            if self._pool is None:
                if self.executor == "process":
                    import multiprocessing as mp
                    from concurrent.futures import ProcessPoolExecutor

                    self._pool = ProcessPoolExecutor(
                        self.workers, mp_context=mp.get_context("spawn"),
                    )
                else:
                    self._pool = ThreadPoolExecutor(
                        max_workers=self.workers,
                        thread_name_prefix="lz4-decode",
                    )
            return self._pool

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _map(self, fn, items: list, st: DecodeStats) -> list:
        """Run fn over items on the host executor (inline when the batch is
        too small for fan-out to pay)."""
        if (self.executor in ("thread", "process") and self.workers > 1
                and len(items) >= self.min_parallel_blocks):
            st.parallel = True
            chunk = max(1, len(items) // (self.workers * 4))
            return list(self._get_pool().map(fn, items, chunksize=chunk))
        return [fn(it) for it in items]

    # -- single blocks ------------------------------------------------------

    def decode_block(self, payload: bytes, max_out: int | None = None) -> bytes:
        """Planned decode of one raw LZ4 block (no framing), on the host."""
        return execute_plan(
            payload, plan_block_fast(payload, max_out=max_out)).tobytes()

    def decode_blocks(self, payloads: list[bytes], raws: list[bool],
                      usizes: list[int] | None = None) -> list[bytes]:
        """Decode a bag of independent blocks.

        ``raws[i]`` marks payloads stored uncompressed (returned as-is).
        ``usizes`` (optional) caps and checks each block's decoded size;
        without it blocks are capped at MAX_BLOCK.
        """
        if len(payloads) != len(raws):
            raise ValueError("payloads/raws length mismatch")
        if usizes is not None and len(usizes) != len(payloads):
            raise ValueError("usizes length mismatch")
        st = DecodeStats(
            blocks=len(payloads), raw_blocks=sum(map(bool, raws)),
            bytes_in=sum(len(p) for p in payloads),
        )
        self.stats = st
        try:
            with obs.span_factory(self._obs_on())(
                    "decode.total", blocks=len(payloads),
                    executor=self.executor):
                return self._decode_blocks_inner(payloads, raws, usizes, st)
        finally:
            self._finish_call(st)

    def _decode_blocks_inner(self, payloads, raws, usizes,
                             st: DecodeStats) -> list[bytes]:
        ob = self._obs_on()
        out: list[bytes | None] = [None] * len(payloads)
        if self.executor == "device" and self.plan_on_device:
            self._decode_blocks_specplan(payloads, raws, usizes, out, st)
        elif self.executor == "device":
            jobs = []
            for i, (payload, raw) in enumerate(zip(payloads, raws)):
                payload = bytes(payload)
                if raw:
                    out[i] = payload
                    continue
                usize = usizes[i] if usizes is not None else None
                plan, dplan = self._plan_for_device(
                    payload, usize if usize is not None else MAX_BLOCK)
                if usize is not None and plan.usize != usize:
                    raise LZ4FormatError(
                        f"block {i}: decoded {plan.usize} bytes, "
                        f"expected {usize}"
                    )
                if dplan is None:
                    st.fallback_blocks += 1
                    out[i] = execute_plan(payload, plan).tobytes()
                else:
                    jobs.append((i, payload, dplan))

            def finish(slot, payload, dp, row, _crc):
                out[slot] = self._fetch_row(row, dp.out_size, st)

            self._execute_device(jobs, finish, st, compute_crc=False)
        else:
            jobs = []
            for i, (payload, raw) in enumerate(zip(payloads, raws)):
                if raw:
                    out[i] = bytes(payload)
                else:
                    jobs.append((i, (bytes(payload),
                                     usizes[i] if usizes is not None else None,
                                     i, self.two_phase, ob)))
            for (i, _), data in zip(jobs, self._map(_plain_block_task,
                                                    [j for _, j in jobs], st)):
                out[i] = data
        st.bytes_out = sum(len(d) for d in out)
        return out

    # -- device executor ----------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """numpy -> device tensor.  On the card through pinned host memory
        with a non-blocking copy, so the host does not wait for the kernels
        already queued (PyTorch's caching host allocator keeps the pinned
        block alive until the copy is done)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _plan_for_device(self, payload: bytes, cap: int | None):
        """Host phase one for the device executor: plan, then convert to a
        fixed-shape DevicePlan.  Returns (plan, dplan-or-None); a None dplan
        means the block must execute on host (the counted fallback)."""
        with obs.span_factory(self._obs_on())(
                "decode.plan", bytes_in=len(payload), executor="device"):
            plan = plan_block_fast(payload, max_out=cap)
            if len(payload) > self.caps.blk_cap:
                return plan, None
            try:
                return plan, to_device_plan(
                    plan, self.caps, compute_waves=self.adaptive_rounds)
            except DevicePlanOverflow:
                return plan, None

    def _dispatch_device(self, batch: list, st: DecodeStats,
                         compute_crc: bool):
        """ONE dispatch for a micro-batch of (payload, dplan): upload the
        stacked plans, `ops.decode_gather` (and one `crc32` launch over the
        batch when ``compute_crc``).  The batch count is padded to a power
        of two and the doubling depth bucketed, as in the reference; padding
        rows decode to out_size = 0.  Returns (out (m, out_cap) uint8, crc
        (m,) int64 or None)."""
        sp = obs.span_factory(self._obs_on())
        caps = self.caps
        m = pad_pow2_count(len(batch), self.micro_batch)
        blk = np.zeros((m, caps.blk_cap), np.uint8)
        lit = [np.zeros((m, caps.max_lit), np.int32) for _ in range(3)]
        mat = [np.zeros((m, caps.max_match), np.int32) for _ in range(2)]
        scal = [np.zeros((m,), np.int32) for _ in range(3)]
        rounds = 0
        for j, (payload, dp) in enumerate(batch):
            blk[j, : len(payload)] = np.frombuffer(payload, np.uint8)
            lit[0][j], lit[1][j], lit[2][j] = dp.lit_src, dp.lit_dst, dp.lit_len
            mat[0][j], mat[1][j] = dp.match_dst, dp.match_off
            scal[0][j], scal[1][j], scal[2][j] = dp.n_lit, dp.n_match, dp.out_size
            rounds = max(rounds, dp.n_waves)
        st.dispatches += 1
        st.device_blocks += len(batch)
        with sp("decode.execute", rows=len(batch), executor="device",
                rounds=rounds):
            args = [self._upload(a) for a in (blk, *lit, *mat, *scal)]
            out = kops.decode_gather(*args, out_cap=caps.out_cap,
                                     rounds=_round_bucket(rounds))
            crc = kops.crc32_bytes(out, args[-1]) if compute_crc else None
            return out, crc

    def _execute_device(self, jobs: list, finish, st: DecodeStats,
                        compute_crc: bool) -> None:
        """Micro-batched, double-buffered device execution.

        ``jobs``: list of (slot, payload, dplan); ``finish(slot, payload,
        dplan, row, crc)`` consumes one block's output row (a view of the
        micro-batch's device buffer) and its device CRC (or None).
        Micro-batch i+1 is dispatched before micro-batch i is consumed, so
        host-side stacking overlaps device work (launches are asynchronous).
        """
        def drain(chunk, res):
            out, crc = res
            for row, (slot, payload, dp) in enumerate(chunk):
                finish(slot, payload, dp, out[row],
                       None if crc is None else crc[row])

        inflight = None
        for start in range(0, len(jobs), self.micro_batch):
            chunk = jobs[start: start + self.micro_batch]
            res = self._dispatch_device([(p, dp) for _, p, dp in chunk], st,
                                        compute_crc)
            if inflight is not None:
                drain(*inflight)
            inflight = (chunk, res)
        if inflight is not None:
            drain(*inflight)

    def _fetch_row(self, row, usize: int, st: DecodeStats) -> bytes:
        """Slice-fetch exactly `usize` decoded bytes of one output row (the
        transfer `host_bytes` counts).  The span doubles as the device-wait
        measurement: the copy synchronizes on the queued decode."""
        with obs.span_factory(self._obs_on())("decode.drain", bytes=usize):
            data = row[:usize].cpu().numpy().tobytes()
        st.host_bytes += usize
        return data

    # -- device executor: speculative on-device planning --------------------

    def _dispatch_specplan(self, batch: list, st: DecodeStats,
                           compute_crc: bool):
        """ONE fused plan + decode (+ CRC) dispatch for a micro-batch of raw
        (payload, max_out) pairs: payloads are stacked as they are and the
        device parses, validates, lays out, resolves and checksums them."""
        sp = obs.span_factory(self._obs_on())
        caps = self.caps
        m = pad_pow2_count(len(batch), self.micro_batch)
        blk = np.zeros((m, caps.blk_cap + kops.SPEC_PAD), np.uint8)
        ns = np.zeros((m,), np.int32)
        mo = np.zeros((m,), np.int32)
        for j, (payload, max_out) in enumerate(batch):
            blk[j, : len(payload)] = np.frombuffer(payload, np.uint8)
            ns[j] = len(payload)
            mo[j] = max_out
        st.dispatches += 1
        with sp("decode.plan_device", rows=len(batch), executor="device",
                crc=compute_crc):
            return kops.plan_decode(
                self._upload(blk), self._upload(ns), self._upload(mo),
                out_cap=caps.out_cap, max_lit=caps.max_lit,
                max_match=caps.max_match, rounds=MAX_RESOLVE_ROUNDS,
                compute_crc=compute_crc)

    def _execute_specplan(self, jobs: list, finish, st: DecodeStats,
                          compute_crc: bool) -> None:
        """Micro-batched, double-buffered speculative execution.

        ``jobs``: list of (slot, payload, max_out); ``finish(slot, payload,
        stat, row, crc)`` consumes one block's host status vector (fetching
        the batch's status synchronizes the dispatch; a few int32 per block,
        not counted by `host_bytes`), its device row and device CRC.
        """
        def drain(chunk, res):
            out, status, crc = res
            stat = status.cpu().numpy()
            for row, (slot, payload, _max_out) in enumerate(chunk):
                finish(slot, payload, stat[row], out[row], crc[row])

        inflight = None
        for start in range(0, len(jobs), self.micro_batch):
            chunk = jobs[start: start + self.micro_batch]
            res = self._dispatch_specplan(
                [(p, mo) for _, p, mo in chunk], st, compute_crc)
            if inflight is not None:
                drain(*inflight)
            inflight = (chunk, res)
        if inflight is not None:
            drain(*inflight)

    def _decode_blocks_specplan(self, payloads, raws, usizes, out,
                                st: DecodeStats) -> None:
        """`decode_blocks` body for the speculative planner (fills `out`),
        with the host planner's error messages and the counted fallback."""
        def host_fallback(i, payload):
            st.fallback_blocks += 1
            usize = usizes[i] if usizes is not None else None
            plan = plan_block_fast(
                payload, max_out=usize if usize is not None else MAX_BLOCK)
            if usize is not None and plan.usize != usize:
                raise LZ4FormatError(
                    f"block {i}: decoded {plan.usize} bytes, expected {usize}")
            out[i] = execute_plan(payload, plan).tobytes()

        jobs = []
        for i, (payload, raw) in enumerate(zip(payloads, raws)):
            payload = bytes(payload)
            if raw:
                out[i] = payload
            elif len(payload) > self.caps.blk_cap:
                host_fallback(i, payload)
            else:
                usize = usizes[i] if usizes is not None else None
                jobs.append((i, payload,
                             usize if usize is not None else MAX_BLOCK))

        def finish(slot, payload, stat, row, _crc):
            err = int(stat[kops.SPEC_ERR])
            if err:
                raise LZ4FormatError(_spec_err_message(err))
            if int(stat[kops.SPEC_OVERFLOW]):
                host_fallback(slot, payload)
                return
            usize = usizes[slot] if usizes is not None else None
            out_size = int(stat[kops.SPEC_OUT_SIZE])
            if usize is not None and out_size != usize:
                raise LZ4FormatError(
                    f"block {slot}: decoded {out_size} bytes, "
                    f"expected {usize}"
                )
            st.device_blocks += 1
            out[slot] = self._fetch_row(row, out_size, st)

        self._execute_specplan(jobs, finish, st, compute_crc=False)

    def _specplan_host_fallback(self, i: int, b: dict, payload: bytes,
                                to_device: bool, st: DecodeStats, sp):
        """Host plan + execute for one frame block the speculative path
        cannot keep on the device (payload over `blk_cap`, or a valid plan
        over the caps) — counted, with the size and CRC checks."""
        st.fallback_blocks += 1
        try:
            with sp("decode.plan", bytes_in=len(payload), executor="device",
                    fallback=True):
                plan = plan_block_fast(payload, max_out=b["usize"])
        except FrameFormatError:
            raise
        except LZ4FormatError as e:
            raise FrameFormatError(f"block {i}: {e}") from e
        if plan.usize != b["usize"]:
            raise FrameFormatError(
                f"block {i}: decoded {plan.usize} bytes, "
                f"table says {b['usize']}"
            )
        with sp("decode.execute", block=i, fallback=True):
            data = execute_plan(payload, plan).tobytes()
        with sp("decode.verify", block=i):
            check_block(i, b["usize"], b["crc"], data)
        return self._host_result(data, to_device)

    def _check_pending_crcs(self, pending: list, sp) -> None:
        """Compare the device CRCs of to-device blocks with the table, in
        block order, after the whole batch ran: one device -> host copy of
        the checksums (8 bytes per block, not counted by `host_bytes`)."""
        with sp("decode.verify", blocks=len(pending), in_graph=True):
            if not pending:
                return
            got = torch.stack([g for _, g, _ in pending]).cpu().tolist()
            for (i, _, want), g in zip(pending, got):
                if g != want:
                    raise FrameFormatError(f"block {i}: checksum mismatch")

    def _decode_entries_specplan(self, frame: bytes,
                                 entries: list[tuple[int, dict]],
                                 to_device: bool = False, verify: bool = True,
                                 st: DecodeStats | None = None):
        """`_decode_entries_device` with speculative on-device planning:
        the host touches only each block's status vector (and, with
        ``to_device`` and ``verify``, its CRC)."""
        if st is None:
            st = self.stats
        sp = obs.span_factory(self._obs_on())
        meta = {}
        out: list = [None] * len(entries)
        jobs = []
        pending_crc: list = []
        for j, (i, b) in enumerate(entries):
            payload = frame[b["offset"]: b["offset"] + b["csize"]]
            if b["raw"]:
                with sp("decode.verify", block=i, raw=True):
                    check_block(i, b["usize"], b["crc"], payload)
                out[j] = self._host_result(payload, to_device)
                continue
            if len(payload) > self.caps.blk_cap:
                out[j] = self._specplan_host_fallback(
                    i, b, payload, to_device, st, sp)
                continue
            meta[j] = (i, b)
            jobs.append((j, payload, b["usize"]))

        def finish(slot, payload, stat, row, crc):
            i, b = meta[slot]
            err = int(stat[kops.SPEC_ERR])
            if err:
                raise FrameFormatError(f"block {i}: {_spec_err_message(err)}")
            if int(stat[kops.SPEC_OVERFLOW]):
                out[slot] = self._specplan_host_fallback(
                    i, b, payload, to_device, st, sp)
                return
            out_size = int(stat[kops.SPEC_OUT_SIZE])
            if out_size != b["usize"]:
                raise FrameFormatError(
                    f"block {i}: decoded {out_size} bytes, "
                    f"table says {b['usize']}"
                )
            st.device_blocks += 1
            if to_device:
                if verify and b["crc"] is not None:
                    pending_crc.append((i, crc, b["crc"]))
                out[slot] = row[:out_size]
                return
            data = self._fetch_row(row, out_size, st)
            with sp("decode.verify", block=i):
                check_block(i, b["usize"], b["crc"], data)
            out[slot] = data

        self._execute_specplan(jobs, finish, st,
                               compute_crc=bool(to_device and verify))
        self._check_pending_crcs(pending_crc, sp)
        return out

    # -- frames -------------------------------------------------------------

    def _decode_entries(self, frame: bytes, entries: list[tuple[int, dict]],
                        st: DecodeStats | None = None) -> list[bytes]:
        """Decode the given (index, table-entry) frame blocks, in order.

        ``st`` is the owning call's stats object; `FrameReader` reads come
        through without one and count into whatever call came last.
        """
        if st is None:
            st = self.stats
        if self.executor == "device":
            return self._decode_entries_device(frame, entries, st=st)
        ob = self._obs_on()
        sp = obs.span_factory(ob)
        out: list[bytes | None] = [None] * len(entries)
        jobs = []
        for j, (i, b) in enumerate(entries):
            payload = frame[b["offset"]: b["offset"] + b["csize"]]
            if b["raw"]:
                with sp("decode.verify", block=i, raw=True):
                    check_block(i, b["usize"], b["crc"], payload)
                out[j] = payload
            else:
                jobs.append((j, (payload, b["usize"], b["crc"], i,
                                 self.two_phase, ob)))
        for (j, _), data in zip(jobs, self._map(_frame_block_task,
                                                [a for _, a in jobs], st)):
            out[j] = data
        return out

    def _decode_entries_device(self, frame: bytes,
                               entries: list[tuple[int, dict]],
                               to_device: bool = False, verify: bool = True,
                               st: DecodeStats | None = None):
        """Device-executor decode of (index, table-entry) frame blocks.

        ``to_device=True`` returns per-block DEVICE tensors (uint8) instead
        of host bytes, and the content never crosses device -> host: with
        ``verify=True`` each micro-batch's CRCs are computed on the device
        (one `crc32` launch per micro-batch) and only the checksums are
        fetched.  Raw and fallback blocks are uploaded host -> device.
        """
        if st is None:
            st = self.stats
        if self.plan_on_device:
            return self._decode_entries_specplan(
                frame, entries, to_device=to_device, verify=verify, st=st)
        sp = obs.span_factory(self._obs_on())
        meta = {}
        out: list = [None] * len(entries)
        jobs = []
        pending_crc: list = []
        for j, (i, b) in enumerate(entries):
            payload = frame[b["offset"]: b["offset"] + b["csize"]]
            if b["raw"]:
                with sp("decode.verify", block=i, raw=True):
                    check_block(i, b["usize"], b["crc"], payload)
                out[j] = self._host_result(payload, to_device)
                continue
            try:
                plan, dplan = self._plan_for_device(payload, b["usize"])
            except FrameFormatError:
                raise
            except LZ4FormatError as e:
                raise FrameFormatError(f"block {i}: {e}") from e
            # The plan knows the exact decoded size before dispatch, so a
            # lying table entry is rejected even with ``verify=False``.
            if plan.usize != b["usize"]:
                raise FrameFormatError(
                    f"block {i}: decoded {plan.usize} bytes, "
                    f"table says {b['usize']}"
                )
            if dplan is None:
                st.fallback_blocks += 1
                with sp("decode.execute", block=i, fallback=True):
                    data = execute_plan(payload, plan).tobytes()
                with sp("decode.verify", block=i):
                    check_block(i, b["usize"], b["crc"], data)
                out[j] = self._host_result(data, to_device)
                continue
            meta[j] = (i, b)
            jobs.append((j, payload, dplan))

        def finish(slot, payload, dp, row, crc):
            i, b = meta[slot]
            if to_device:
                if verify and b["crc"] is not None:
                    pending_crc.append((i, crc, b["crc"]))
                out[slot] = row[: dp.out_size]
                return
            data = self._fetch_row(row, dp.out_size, st)
            with sp("decode.verify", block=i):
                check_block(i, b["usize"], b["crc"], data)
            out[slot] = data

        self._execute_device(jobs, finish, st,
                             compute_crc=bool(to_device and verify))
        self._check_pending_crcs(pending_crc, sp)
        return out

    def _host_result(self, data: bytes, to_device: bool):
        if not to_device:
            return data
        return self._upload(np.frombuffer(data, np.uint8).copy())

    def _join_device(self, parts: list) -> torch.Tensor:
        if not parts:
            return torch.zeros((0,), dtype=torch.uint8, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def salvage(self, frame: bytes):
        """Not ported yet: the salvage pass is ROADMAP queue A, item A6."""
        raise NotImplementedError(
            "salvage() needs the salvage pass, which repro_torch does not "
            "have yet (ROADMAP queue A, item A6)")

    def decode(self, frame: bytes) -> bytes:
        """Frame -> original bytes; bit-identical to `decode_frame_serial`.

        Raises FrameFormatError on any malformation, including per-block
        and whole-object checksum mismatches.
        """
        info = frame_info(frame)
        blocks = info["blocks"]
        st = DecodeStats(
            blocks=len(blocks),
            raw_blocks=sum(b["raw"] for b in blocks),
            bytes_in=len(frame),
        )
        self.stats = st
        try:
            with obs.span_factory(self._obs_on())(
                    "decode.total", blocks=len(blocks),
                    executor=self.executor):
                parts = self._decode_entries(frame, list(enumerate(blocks)),
                                             st)
                out = b"".join(parts)
                # v5/v6 whole-object trailer: catches join-order/table-swap
                # corruption the per-block CRCs cannot.
                check_content_crc(info["content_crc"], block_crc(out))
            st.bytes_out = len(out)
            return out
        finally:
            self._finish_call(st)

    def decode_to_device(self, frame: bytes, verify: bool = True):
        """Frame -> decoded bytes as ONE uint8 tensor on the engine's device.

        The device-to-device restore path: compressed blocks are uploaded,
        decoded on the device and concatenated there; the plaintext never
        visits the host.  ``verify=True`` (default) checks each block's
        CRC-32 and the whole-object trailer on the device (`crc32` kernel)
        and fetches only the checksums, so `host_bytes` stays 0;
        ``verify=False`` skips those checks (the frame table's validation
        and the planners' format checks always run).  Works on any engine
        instance: it always takes the device execution path.
        """
        info = frame_info(frame)
        blocks = info["blocks"]
        st = DecodeStats(
            blocks=len(blocks),
            raw_blocks=sum(b["raw"] for b in blocks),
            bytes_in=len(frame),
        )
        self.stats = st
        try:
            sp = obs.span_factory(self._obs_on())
            with sp("decode.total", blocks=len(blocks), executor="device",
                    to_device=True, verify=verify):
                parts = self._decode_entries_device(
                    frame, list(enumerate(blocks)), to_device=True,
                    verify=verify, st=st)
                out = self._join_device(parts)
                if verify and info["content_crc"] is not None:
                    # Whole-object trailer, checked on the device over the
                    # joined tensor; only the checksum crosses to the host.
                    with sp("decode.verify", content=True, in_graph=True):
                        crc = int(kops.crc32_bytes(out, out.shape[0]))
                    check_content_crc(info["content_crc"], crc)
            st.bytes_out = sum(b["usize"] for b in blocks)
            return out
        finally:
            self._finish_call(st)


class FrameReader:
    """Seekable random-access reader over one frame.

    The frame's block table is the seek index: cumulative block usizes map
    decompressed offsets to blocks, so `read_range` touches only the blocks
    covering the requested range and `read_block` exactly one.  Decoded
    blocks pass through a small LRU (``cache_blocks``).

    >>> r = FrameReader(frame, engine=LZ4DecodeEngine(device="cpu"))
    >>> r.read_range(10, 20) == original[10:30]
    True
    """

    def __init__(self, frame: bytes, engine: LZ4DecodeEngine | None = None,
                 cache_blocks: int = 8, on_error: str = "raise"):
        if on_error not in ("raise", "salvage"):
            raise ValueError('on_error must be "raise" or "salvage"')
        if on_error == "salvage":
            raise NotImplementedError(
                'on_error="salvage" needs the salvage pass, which repro_torch '
                "does not have yet (ROADMAP queue A, item A6)")
        self._frame = bytes(frame)
        self._engine = engine or default_decode_engine()
        self._info = frame_info(self._frame)
        self.on_error = on_error
        self._blocks = self._info["blocks"]
        # starts[i] = decompressed offset of block i; starts[-1] = total size.
        self._starts = np.concatenate(
            ([0], np.cumsum([b["usize"] for b in self._blocks]))
        ).astype(np.int64)
        self._cache_blocks = cache_blocks
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._cache_lock = threading.Lock()

    # -- index --------------------------------------------------------------

    @property
    def block_count(self) -> int:
        return len(self._blocks)

    @property
    def usize(self) -> int:
        """Total decompressed size (from the table; no payload touched)."""
        return int(self._starts[-1])

    def __len__(self) -> int:
        return self.usize

    def block_range(self, i: int) -> tuple[int, int]:
        """Decompressed [start, end) interval of block i."""
        if not 0 <= i < self.block_count:
            raise IndexError(f"block {i} out of range [0, {self.block_count})")
        return int(self._starts[i]), int(self._starts[i + 1])

    def blocks_for_range(self, start: int, length: int) -> range:
        """Indices of the blocks covering decompressed [start, start+length)."""
        if start < 0 or length < 0 or start + length > self.usize:
            raise ValueError(
                f"range [{start}, {start + length}) outside [0, {self.usize})"
            )
        if length == 0:
            return range(0, 0)
        lo = int(np.searchsorted(self._starts, start, side="right")) - 1
        hi = int(np.searchsorted(self._starts, start + length, side="left"))
        return range(lo, hi)

    # -- reads --------------------------------------------------------------

    def _cache_put(self, i: int, data: bytes) -> None:
        if self._cache_blocks <= 0:
            return
        with self._cache_lock:
            self._cache[i] = data
            self._cache.move_to_end(i)
            while len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)

    def read_block(self, i: int) -> bytes:
        """Decode (or raw-slice) exactly block i, LRU-cached."""
        self.block_range(i)  # bounds check
        with self._cache_lock:
            if i in self._cache:
                self._cache.move_to_end(i)
                return self._cache[i]
        data = self._engine._decode_entries(
            self._frame, [(i, self._blocks[i])]
        )[0]
        self._cache_put(i, data)
        return data

    def read_range(self, start: int, length: int) -> bytes:
        """original[start : start+length], decoding only the covering blocks
        (those not in the LRU, in one engine call)."""
        cover = self.blocks_for_range(start, length)
        if len(cover) == 0:
            return b""
        have: dict[int, bytes] = {}
        with self._cache_lock:
            for i in cover:
                if i in self._cache:
                    self._cache.move_to_end(i)
                    have[i] = self._cache[i]
        missing = [i for i in cover if i not in have]
        if missing:
            for i, data in zip(missing, self._engine._decode_entries(
                    self._frame, [(i, self._blocks[i]) for i in missing])):
                have[i] = data
                self._cache_put(i, data)
        joined = have[cover[0]] if len(cover) == 1 else \
            b"".join(have[i] for i in cover)
        base = int(self._starts[cover[0]])
        return joined[start - base: start - base + length]

    def read_range_device(self, start: int, length: int, verify: bool = True):
        """`read_range`, but the result is a uint8 tensor on the engine's
        device: the covering blocks are decoded on the device (CRCs checked
        there with ``verify=True``) and joined and sliced there.  Bypasses
        the host-bytes LRU."""
        cover = self.blocks_for_range(start, length)
        if len(cover) == 0:
            return torch.zeros((0,), dtype=torch.uint8,
                               device=self._engine.device)
        parts = self._engine._decode_entries_device(
            self._frame, [(i, self._blocks[i]) for i in cover],
            to_device=True, verify=verify)
        joined = self._engine._join_device(parts)
        base = int(self._starts[cover[0]])
        return joined[start - base: start - base + length]

    def read(self) -> bytes:
        """Full decode."""
        return self._engine.decode(self._frame)
