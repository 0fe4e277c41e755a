"""Batched, device-resident compression pipeline: the `LZ4Engine`.

The engine is the primary write-path API.  It keeps the paper's
feedback-free token pipeline batch-parallel end to end:

  * arbitrary-length input is split into a ``(M, MAX_BLOCK + _PAD)`` uint8
    stack and compressed with ONE batched dispatch per micro-batch
    (configurable ``micro_batch``): the fused-datapath kernel (or, with
    ``candidate_impl="sort"|"sortkey"|"scatter"``, the staged path: the
    fibhash kernel, a candidate stage in stock torch ops, the word compare
    and the match_extend kernel), the window select, the layout prefix sums
    and the byte-emission kernel, all queued on the device's stream;
  * dispatch is double-buffered: kernel launches are asynchronous, so while
    the device crunches micro-batch i the host pads and dispatches
    micro-batch i+1, and — with ``device_emit`` — assembles the frame for
    micro-batch i-1.  On the card the upload goes through two alternating
    pinned staging buffers, so a buffer is never rewritten while its copy is
    in flight;
  * byte emission is device-resident by default (``device_emit=True``):
    token byte-lengths, exclusive prefix-sum offsets and the byte scatter
    run on the device (`compressor.compress_blocks_bytes` ->
    `kernels.ops.emit_bytes`), so only final frame bytes cross the host
    boundary.  ``device_emit=False`` fetches the per-window match records
    instead and emits on host with the vectorized prefix-sum emitter
    (emitter.py) — the bit-identity oracle path;
  * output is a self-describing frame (frame.py, spec in
    docs/frame-format.md) with per-block sizes, CRC32s, and a
    raw-passthrough flag for uncompressible blocks, decodable by
    `decode_frame` with no out-of-band metadata.

The engine runs on the card unless the caller asks for the CPU:
``LZ4Engine()`` means ``device="cuda"`` and raises when no CUDA device is
available; ``LZ4Engine(device="cpu")`` runs the kernels' plain versions.

``shards=`` / ``mesh=`` route `compress` through the sharded fabric
(`repro_torch.distributed.fabric`) and the output becomes a frame v4
container: ``shards=n`` alone partitions the block stack over n producers on
the engine's device (the host path), a ``mesh`` of more than one shard
launches each shard's rows on that shard's device (the mesh path).

`EngineStats.host_bytes` counts every byte fetched from the device, so the
host-transfer saving of ``device_emit`` is directly observable.

Partial trailing micro-batches are padded up to the next power of two (capped
at ``micro_batch``), as in the JAX package, so batch shapes — and the
`host_bytes` accounting that depends on them — agree between the packages.
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch import obs

from .compressor import (
    _PAD,
    compress_blocks_bytes,
    compress_blocks_records,
    resolve_candidate_impl,
)
from .emitter import emit_block
from .frame import block_crc, encode_frame
from .lz4_types import (
    DEFAULT_HASH_BITS,
    DEFAULT_MAX_MATCH,
    DEFAULT_PWS,
    MAX_BLOCK,
    pad_pow2_count,
)

__all__ = ["LZ4Engine", "EngineStats", "default_engine"]


@functools.lru_cache(maxsize=1)
def default_engine() -> "LZ4Engine":
    """Process-wide default engine (on the card)."""
    return LZ4Engine()


def _resolve_device(device, what: str = "LZ4Engine") -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" to "
                "run the plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or \"cpu\", got {device!r}")
    return dev


@dataclasses.dataclass
class EngineStats:
    """Per-call counters (PLUS a lifetime accumulator on the engine).

    ``engine.stats`` is replaced at the start of every `compress` /
    `compress_to_blocks` call — it describes the MOST RECENT call only.
    ``engine.totals`` is the cumulative sum over the engine's lifetime
    (merged in as each call finishes, even on error); use it — or the
    ``engine.*`` counters in `repro_torch.obs.registry()` when telemetry is
    on — for anything that must survive across calls.
    """

    blocks: int = 0
    dispatches: int = 0
    raw_blocks: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    host_bytes: int = 0  # bytes fetched device -> host (records or emit buffers)
    candidate_impl: str = ""  # the RESOLVED impl that ran ("auto" never runs)
    shards: int = 0  # sharded-fabric calls: shard count of the v4 container
    calls: int = 0  # 1 per finished call (so totals.calls counts calls)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def accumulate(self, other: "EngineStats") -> None:
        """Fold ``other`` (one finished call) into this accumulator.

        NOT thread-safe by itself — the engine serializes its `totals`
        accumulation behind a lock (`_finish_call`); external accumulators
        shared across threads need their own.
        """
        for f in ("blocks", "dispatches", "raw_blocks", "bytes_in",
                  "bytes_out", "host_bytes"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.calls += max(other.calls, 1)
        self.shards = max(self.shards, other.shards)
        if other.candidate_impl:
            self.candidate_impl = other.candidate_impl


def _slice_payload(out: np.ndarray, j: int, size: int) -> bytes:
    """Row j's first `size` bytes of a drained (M, out_cap) emit buffer."""
    return out[j, :size].tobytes()


def _pack_payloads(out: torch.Tensor, size: torch.Tensor,
                   ns: torch.Tensor) -> torch.Tensor:
    """A micro-batch's coded payloads back to back, on the device.

    Row j's first ``size[j]`` bytes for every row `compress` codes
    (``size < n``: raw-bound rows and padded rows, n = 0, drop out), in row
    order at the exclusive prefix sum of those sizes.  A coded size is below
    n <= MAX_BLOCK, so M * MAX_BLOCK bytes hold them all; the bytes no row
    keeps are scattered to one sink slot past the end.  Stock ops queued on
    the stream: no host sync.
    """
    M, cap = out.shape
    keep = torch.where(size < ns, size, torch.zeros_like(size)).to(torch.int64)
    start = torch.cumsum(keep, 0) - keep
    col = torch.arange(cap, dtype=torch.int64, device=out.device)
    sink = M * MAX_BLOCK
    dest = torch.where(col < keep[:, None], start[:, None] + col, sink)
    packed = torch.empty((sink + 1,), dtype=torch.uint8, device=out.device)
    return packed.scatter_(0, dest.view(-1), out.reshape(-1))


def _fetch_packed(packed: torch.Tensor, total: int) -> memoryview:
    """``packed[:total]`` in a host buffer of its own, in one synchronous
    copy.  No micro-batch's copy overwrites another's, so views of it stay
    valid for as long as they are held.  From the card the buffer is pinned,
    from PyTorch's caching host allocator: later calls get the same pages
    back, already mapped, where fresh host memory for the payloads would
    cost a page fault every 4 KiB."""
    host = torch.empty((total,), dtype=torch.uint8,
                       pin_memory=packed.device.type == "cuda")
    host.copy_(packed[:total])
    return memoryview(host.numpy())


def _packed_payload(st: EngineStats, payload: memoryview) -> memoryview:
    """A coded block's bytes: a view of its micro-batch's packed copy."""
    st.host_bytes += len(payload)
    return payload


class _Staging:
    """Host-side micro-batch buffers for one call.

    On the CPU every micro-batch gets fresh arrays.  For a CUDA device two
    pinned (micro_batch, MAX_BLOCK + _PAD) buffers alternate: micro-batch i
    is padded into buffer i % 2 and uploaded with a non-blocking copy; the
    buffer is next written for micro-batch i + 2, after micro-batch i was
    drained — and the drain's size fetch synchronizes past that copy.
    """

    def __init__(self, device: torch.device, micro_batch: int):
        self.device = device
        self.turn = 0
        self.bufs = None
        if device.type == "cuda":
            self.bufs = [
                (torch.zeros((micro_batch, MAX_BLOCK + _PAD), dtype=torch.uint8
                             ).pin_memory(),
                 torch.zeros((micro_batch,), dtype=torch.int32).pin_memory())
                for _ in range(2)]

    def take(self, m: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Zeroed (m, MAX_BLOCK + _PAD) uint8 and (m,) int32 host tensors."""
        if self.bufs is None:
            return (torch.zeros((m, MAX_BLOCK + _PAD), dtype=torch.uint8),
                    torch.zeros((m,), dtype=torch.int32))
        stack, ns = self.bufs[self.turn]
        self.turn ^= 1
        stack, ns = stack[:m], ns[:m]
        stack.zero_()
        ns.zero_()
        return stack, ns

    def upload(self, stack: torch.Tensor, ns: torch.Tensor):
        if self.bufs is None:
            return stack, ns
        return (stack.to(self.device, non_blocking=True),
                ns.to(self.device, non_blocking=True))


class LZ4Engine:
    """Batched LZ4 compression engine (the paper's combined scheme, S1+S2).

    >>> eng = LZ4Engine()                   # on the card; device="cpu" for tests
    >>> frame = eng.compress(data)          # one dispatch per micro-batch
    >>> assert eng.decompress(frame) == data
    """

    def __init__(self, hash_bits: int = DEFAULT_HASH_BITS,
                 max_match: int = DEFAULT_MAX_MATCH,
                 pws: int = DEFAULT_PWS,
                 micro_batch: int = 32,
                 scan_impl: str = "sequential",
                 candidate_impl: str = "auto",
                 device_emit: bool = True,
                 drain: str = "sliced",
                 content_crc: bool = False,
                 parity_group: int | None = None,
                 telemetry: bool | None = None,
                 mesh=None,
                 shard_axes: tuple[str, ...] | None = None,
                 shards: int | None = None,
                 device=None):
        if micro_batch < 1:
            raise ValueError("micro_batch must be >= 1")
        if drain not in ("sliced", "full"):
            raise ValueError('drain must be "sliced" or "full"')
        if scan_impl not in ("sequential", "associative"):
            raise ValueError('scan_impl must be "sequential" or "associative"')
        # Sharded fabric: ``mesh`` splits the block stack over
        # ``shard_axes`` (default: every mesh axis) and the output becomes
        # a frame v4; ``shards`` without a mesh selects the host-partition
        # path (the per-shard oracle) writing the same v4 shape.
        # ``shards=None`` with no mesh keeps the v3 writer.  A mesh engine
        # runs its own (host-path) work on shard 0's device unless
        # ``device`` says otherwise.
        if mesh is not None:
            from repro_torch.distributed import fabric

            axes, n = fabric.check_mesh(mesh, shard_axes)
            if shards is not None and shards != n:
                raise ValueError(f"shards={shards} != mesh shard count {n}")
            if not device_emit and n > 1:
                raise ValueError(
                    "the mesh fabric path requires device_emit=True "
                    "(host emission does not run per shard)")
            self.mesh, self.shard_axes, self.shards = mesh, axes, n
            if device is None:
                device = fabric.shard_devices(mesh, axes)[0]
        else:
            if shard_axes is not None:
                raise ValueError("shard_axes requires mesh")
            if shards is not None and shards < 1:
                raise ValueError("shards must be >= 1")
            self.mesh, self.shard_axes, self.shards = None, (), shards
        self.device = _resolve_device(device)
        self.hash_bits = hash_bits
        self.max_match = max_match
        self.pws = pws
        self.micro_batch = micro_batch
        self.scan_impl = scan_impl
        # "auto" resolves ONCE, here; EngineStats.candidate_impl records
        # what actually ran.
        self.candidate_impl = resolve_candidate_impl(candidate_impl)
        # device_emit=True: byte emission stays on the device; only the
        # final bytes cross the host boundary.  False: fetch match records
        # and emit on host via emit_block (the bit-identity oracle path).
        self.device_emit = device_emit
        # drain="sliced" (device_emit only): two-step fetch — size scalars
        # first, then the coded blocks' exact bytes, packed on the device
        # into ONE copy a micro-batch, and NOTHING for blocks bound for raw
        # passthrough — so host_bytes is the exact compressed payload.
        # "full" fetches the whole padded (M, out_cap) buffer per
        # micro-batch in one transfer.
        self.drain = drain
        # content_crc=True: stamp a whole-object CRC32 trailer on every
        # frame (version 5) on top of the per-block checksums.  Default
        # off: the v3 writer stays byte-identical.
        self.content_crc = content_crc
        # parity_group=N: append one XOR parity block per N data blocks so
        # any SINGLE damaged block per group can be reconstructed — the
        # frame becomes version 6, which always carries the whole-content
        # trailer too.  Default off: frame bytes are untouched.
        if parity_group is not None and parity_group < 1:
            raise ValueError("parity_group must be >= 1")
        self.parity_group = parity_group
        # Telemetry: None follows the global `repro_torch.obs` gate
        # (REPRO_OBS / obs.configure) at CALL time; True/False pins this
        # instance.  The flag never changes frame bytes.
        self.telemetry = telemetry
        self.stats = EngineStats()      # most recent call (see EngineStats)
        self.totals = EngineStats()     # lifetime accumulator
        # `totals` is shared mutable state: concurrent calls each fold their
        # own per-call stats object in under this lock, so lifetime counters
        # never lose updates.  `stats` stays a last-call-wins pointer.
        self._totals_lock = threading.Lock()
        self._sp = obs.span_factory(False)  # refreshed per call
        self._worker: "LZ4Engine | None" = None  # fabric host-path clone
        # `decompress` decodes where the engine compresses: a decode engine
        # (device executor) on the same device, owned by this engine.
        from .decode_engine import LZ4DecodeEngine  # local: engine <-> decoder

        self.decoder = LZ4DecodeEngine(device=self.device)

    def _obs_on(self) -> bool:
        return obs.enabled_for(self.telemetry)

    def _shard_worker(self) -> "LZ4Engine":
        """Single-device clone for the fabric's host-partition path (same
        datapath config, no mesh, this engine's device — the per-shard
        oracle)."""
        if self._worker is None:
            self._worker = LZ4Engine(
                hash_bits=self.hash_bits, max_match=self.max_match,
                pws=self.pws, micro_batch=self.micro_batch,
                scan_impl=self.scan_impl, candidate_impl=self.candidate_impl,
                device_emit=self.device_emit, drain=self.drain,
                telemetry=self.telemetry, device=self.device,
            )
        return self._worker

    def _finish_call(self, st: EngineStats) -> None:
        """Fold the finished call's stats into `totals` + the obs registry."""
        s = st
        s.calls = 1
        with self._totals_lock:
            self.totals.accumulate(s)
        if self._obs_on():
            r = obs.registry()
            r.counter("engine.calls", "compress calls").inc()
            r.counter("engine.blocks", "64 KB blocks compressed").inc(s.blocks)
            r.counter("engine.raw_blocks",
                      "blocks stored as raw passthrough").inc(s.raw_blocks)
            r.counter("engine.dispatches", "device dispatches").inc(s.dispatches)
            r.counter("engine.bytes_in", "input bytes").inc(s.bytes_in)
            r.counter("engine.bytes_out", "frame bytes out").inc(s.bytes_out)
            r.counter("engine.host_bytes",
                      "bytes fetched device -> host").inc(s.host_bytes)

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, stack: torch.Tensor, ns: torch.Tensor,
                  staging: _Staging, st: EngineStats):
        """ONE batched dispatch for a (M, MAX_BLOCK+_PAD) micro-batch."""
        fn = compress_blocks_bytes if self.device_emit else compress_blocks_records
        st.dispatches += 1
        with self._sp("compress.dispatch", rows=len(ns),
                      impl=self.candidate_impl):
            stack_dev, ns_dev = staging.upload(stack, ns)
            res = fn(stack_dev, ns_dev, hash_bits=self.hash_bits,
                     max_match=self.max_match, pws=self.pws,
                     scan_impl=self.scan_impl,
                     candidate_impl=self.candidate_impl, sp=self._sp)
            if self.device_emit and self.drain == "sliced":
                # Packed after `compress_blocks_bytes` returns, so the drain
                # copies exactly the bytes it returned.
                res = (*res, _pack_payloads(*res, ns_dev))
            return res

    def _pad_batch(self, chunks: list[bytes], staging: _Staging):
        """Stack chunks into a fixed-shape micro-batch (padded rows get n=0)."""
        with self._sp("compress.pad", blocks=len(chunks)):
            m = pad_pow2_count(len(chunks), self.micro_batch)
            stack_t, ns_t = staging.take(m)
            stack, ns = stack_t.numpy(), ns_t.numpy()
            for j, c in enumerate(chunks):
                stack[j, : len(c)] = np.frombuffer(c, np.uint8)
                ns[j] = len(c)
            return stack_t, ns_t

    def _payload_iter(self, data: bytes, st: EngineStats):
        """Yield (chunk, n, size, payload_fn) per block, counting into `st`.

        `payload_fn()` materializes the compressed block bytes: with the
        sliced drain a memoryview of its micro-batch's packed copy (bytes
        for a raw-bound block, fetched alone), a buffer slice with the full
        drain, a host `emit_block` call without ``device_emit``.
        Double-buffered: micro-batch i+1 is padded and dispatched before the
        host blocks on micro-batch i's results, so host-side padding (and
        frame assembly) overlaps device compute.  ``st`` is the CALL-LOCAL
        stats object (incremented, never replaced) — concurrent calls each
        carry their own, which is what keeps `totals` exact under threaded
        use; the staging buffers are call-local for the same reason.
        """
        self._sp = obs.span_factory(self._obs_on())
        with self._sp("compress.split"):
            chunks = [data[i: i + MAX_BLOCK]
                      for i in range(0, len(data), MAX_BLOCK)]
        st.blocks += len(chunks)
        st.bytes_in += len(data)
        staging = _Staging(self.device, min(
            self.micro_batch, pad_pow2_count(len(chunks), self.micro_batch)))
        inflight = None
        for start in range(0, len(chunks), self.micro_batch):
            batch = chunks[start: start + self.micro_batch]
            stack, ns = self._pad_batch(batch, staging)
            res = self._dispatch(stack, ns, staging, st)
            if inflight is not None:
                yield from self._drain(*inflight, st)
            inflight = (batch, res)
        if inflight is not None:
            yield from self._drain(*inflight, st)

    def _fetch_sliced(self, out_dev, j: int, size: int, st: EngineStats) -> bytes:
        """Slice-fetch exactly `size` bytes of row j alone: the payload of a
        block bound for raw passthrough, which the packed copy leaves out,
        when a caller asks for it (`compress_to_blocks`)."""
        with self._sp("compress.drain", bytes=size):
            data = out_dev[j, :size].cpu().numpy().tobytes()
        st.host_bytes += size
        if self._obs_on():
            r = obs.registry()
            r.counter("engine.drain_copies",
                      "payload copies from the device").inc()
            r.counter("engine.drain_fallback_blocks",
                      "payloads fetched alone, outside the packed copy").inc()
        return data

    def _drain(self, batch: list[bytes], res, st: EngineStats):
        if self.device_emit:
            if self.drain == "sliced":
                # Two-step drain: sync on the tiny size vector, then ONE copy
                # of the coded payloads `_dispatch` packed on the device; each
                # coded block's payload is a view of it.  Blocks the caller
                # stores as raw passthrough (size >= n) are not in it.
                out_dev, size_dev, packed_dev = res
                # The copy to host is the sync point: its span measures how
                # long the host WAITS on device compute (the rest of the
                # drain is host-side transfer/assembly).
                with self._sp("compress.wait", rows=len(batch)):
                    size = size_dev.cpu().numpy()
                st.host_bytes += size.nbytes
                sizes = size[: len(batch)].tolist()
                coded = [s < len(c) for s, c in zip(sizes, batch)]
                total = sum(s for s, k in zip(sizes, coded) if k)
                views = [None] * len(batch)
                if total:
                    with self._sp("compress.drain", bytes=total):
                        host = _fetch_packed(packed_dev, total)
                        off = 0
                        for j, s in enumerate(sizes):
                            if coded[j]:
                                views[j] = host[off: off + s]
                                off += s
                    if self._obs_on():
                        obs.registry().counter(
                            "engine.drain_copies",
                            "payload copies from the device").inc()
                for j, chunk in enumerate(batch):
                    s = sizes[j]
                    yield chunk, len(chunk), s, (
                        functools.partial(_packed_payload, st, views[j])
                        if coded[j] else
                        functools.partial(self._fetch_sliced, out_dev, j, s, st))
                return
            with self._sp("compress.wait", rows=len(batch)):
                out, size = (t.cpu().numpy() for t in res)
            st.host_bytes += out.nbytes + size.nbytes
            for j, chunk in enumerate(batch):
                s = int(size[j])
                yield chunk, len(chunk), s, functools.partial(_slice_payload, out, j, s)
        else:
            with self._sp("compress.wait", rows=len(batch)):
                emit, pos, length, offset, size = (
                    t.cpu().numpy() for t in
                    (res.emit, res.pos, res.length, res.offset, res.size))
            st.host_bytes += (emit.nbytes + pos.nbytes + length.nbytes
                              + offset.nbytes + size.nbytes)
            for j, chunk in enumerate(batch):
                yield chunk, len(chunk), int(size[j]), functools.partial(
                    emit_block, chunk, emit[j], pos[j], length[j], offset[j],
                    len(chunk),
                )

    # -- public API ---------------------------------------------------------

    def compress(self, data: bytes) -> bytes:
        """bytes -> self-describing frame (see frame.py / docs/frame-format.md).

        Blocks whose exact compressed size (computed on the device) does not
        beat the raw size are stored as raw passthrough, so worst-case
        expansion is the frame header, not LZ4's literal-run overhead.  With
        a mesh or ``shards=`` the call routes through the sharded fabric and
        the output is a frame v4 container.
        """
        st = EngineStats(candidate_impl=self.candidate_impl)
        self.stats = st
        ob = self._obs_on()
        sp = obs.span_factory(ob)
        if self.shards is not None:
            from repro_torch.distributed import fabric

            try:
                with sp("compress.total", bytes_in=len(data),
                        shards=self.shards):
                    return fabric.compress_sharded(self, data, st)
            finally:
                self._finish_call(st)
        ratio_hist = obs.registry().histogram(
            "engine.block_ratio", obs.DEFAULT_RATIO_BUCKETS,
            "per-block compression ratio usize/csize (raw blocks -> 1.0)",
        ) if ob else None
        try:
            with sp("compress.total", bytes_in=len(data)):
                payloads, usizes, raws, crcs = [], [], [], []
                for chunk, n, size, payload_fn in self._payload_iter(data, st):
                    if size >= n:
                        payloads.append(chunk)
                        raws.append(True)
                        st.raw_blocks += 1
                        if ratio_hist is not None and n:
                            ratio_hist.observe(1.0)
                    else:
                        payloads.append(payload_fn())
                        raws.append(False)
                        if ratio_hist is not None and size:
                            ratio_hist.observe(n / size)
                    usizes.append(n)
                    # Content checksum over the ORIGINAL chunk (only the
                    # compressor ever sees it): decode verifies per block.
                    with sp("compress.crc"):
                        crcs.append(block_crc(chunk))
                with sp("compress.frame", blocks=len(payloads)):
                    frame = encode_frame(
                        payloads, usizes, raws, checksums=crcs,
                        content_crc=block_crc(data)
                        if (self.content_crc or self.parity_group is not None)
                        else None,
                        parity_group=self.parity_group)
                st.bytes_out = len(frame)
                return frame
        finally:
            self._finish_call(st)

    def compress_to_blocks(self, data: bytes) -> list[bytes]:
        """bytes -> list of raw LZ4 blocks (one per 64 KB, no framing).

        Every block is valid LZ4 (no passthrough); lengths must travel
        out-of-band.  Sharded engines partition the block stack across
        shards (the split `compress` makes) and return the same flat,
        globally ordered list.
        """
        st = EngineStats(candidate_impl=self.candidate_impl)
        self.stats = st
        if not data:
            # Host-emitted empty block: no dispatch, no candidate stage ran.
            st.blocks = 1
            self._finish_call(st)
            return [emit_block(b"", [], [], [], [], 0)]
        if self.shards is not None:
            from repro_torch.distributed import fabric

            try:
                with obs.span_factory(self._obs_on())(
                        "compress.total", bytes_in=len(data), framing=False,
                        shards=self.shards):
                    blocks = fabric.shard_blocks_sharded(self, data, st)
                st.bytes_out = sum(len(b) for b in blocks)
                return blocks
            finally:
                self._finish_call(st)
        try:
            with obs.span_factory(self._obs_on())(
                    "compress.total", bytes_in=len(data), framing=False):
                blocks = [bytes(payload_fn()) for _, _, _, payload_fn
                          in self._payload_iter(data, st)]
            st.bytes_out = sum(len(b) for b in blocks)
            return blocks
        finally:
            self._finish_call(st)

    def decompress(self, frame: bytes) -> bytes:
        """Inverse of `compress`; validates the frame (sizes + checksums)
        throughout.  Decodes on the engine's device (`self.decoder`)."""
        return self.decoder.decode(frame)
