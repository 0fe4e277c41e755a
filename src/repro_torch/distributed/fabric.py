"""Sharded compression fabric: the block stack split across a mesh.

The port of the JAX package's `distributed/fabric.py`.  The 64 KB block
stack is partitioned into contiguous per-shard slices (`partition_blocks`),
every shard runs the single-device datapath on its slice
(`core.compressor.compress_blocks_bytes` on the write side,
`kernels.ops.decode_gather` / `plan_decode` on the read side), and the
per-shard outputs merge into a frame v4 container whose block table keeps
each block's shard and stays seekable across shard boundaries.

Two execution paths, byte-identical by construction:

  * mesh path (an engine ``mesh`` of more than one shard): one global
    ``(S*r, MAX_BLOCK+_PAD)`` stack per step, in pinned memory when a shard
    lives on a card; shard i's rows ``[i*r, (i+1)*r)`` are uploaded to its
    device without blocking and compressed there.  The reference splits the
    stack with `shard_map`; here ONE process launches shard after shard from
    the calling thread (never from Python threads: two kernels keep launch
    facts per device), once per mesh position, so a mesh that names one
    device several times runs the same code as one of distinct cards.  Rows
    are independent, so the bytes equal one global dispatch.
  * host path (no mesh, or a mesh of one shard): each shard's slice runs
    through a single-device worker engine (`LZ4Engine._shard_worker`) one
    after another — the oracle the mesh path is held against.

Spans (`repro_torch.obs`): the engine's ``compress.pad`` /
``compress.dispatch`` / ``compress.wait`` / ``compress.drain`` stage names
with ``shards=`` attributes, plus ``compress.shard`` (one per shard on the
host path) and ``compress.merge``.  Counters: ``fabric.dispatches``,
``fabric.merged_blocks``, ``fabric.fallback_blocks``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compressor import _PAD, compress_blocks_bytes
from repro_torch.core.decode_plan import MAX_RESOLVE_ROUNDS, execute_plan, plan_block_fast
from repro_torch.core.decoder import LZ4FormatError
from repro_torch.core.frame import (
    FrameFormatError,
    block_crc,
    check_block,
    encode_frame,
    frame_info,
)
from repro_torch.core.lz4_types import MAX_BLOCK, pad_pow2_count
from repro_torch.kernels import ops as kops

from .sharding import Mesh

__all__ = [
    "ShardSlice",
    "partition_blocks",
    "mesh_shard_count",
    "shard_devices",
    "check_mesh",
    "compress_sharded",
    "shard_blocks_sharded",
    "decode_items_sharded",
    "shard_subframe",
]


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """Contiguous run of global block indices owned by one shard."""

    shard: int
    start: int
    stop: int

    @property
    def count(self) -> int:
        return self.stop - self.start


def partition_blocks(n_blocks: int, shards: int) -> list[ShardSlice]:
    """Balanced contiguous partition of ``n_blocks`` across ``shards``.

    The first ``n_blocks % shards`` shards take one extra block, so shards
    differ by at most one block and trailing shards may own none when
    blocks < shards.  Contiguity keeps the merged v4 frame in global
    content order.
    """
    if shards < 1:
        raise ValueError("shards must be >= 1")
    base, rem = divmod(n_blocks, shards)
    out, pos = [], 0
    for s in range(shards):
        c = base + (1 if s < rem else 0)
        out.append(ShardSlice(s, pos, pos + c))
        pos += c
    return out


def mesh_shard_count(mesh: Mesh, shard_axes) -> int:
    """Total shard count = product of the mesh sizes of ``shard_axes``."""
    return int(np.prod([mesh.shape[a] for a in shard_axes], dtype=np.int64)) or 1


def shard_devices(mesh: Mesh, shard_axes) -> list[torch.device]:
    """Device of every shard, in shard order: shard i is the mesh position
    whose coordinates along ``shard_axes``, read row-major in the order
    given, make i — index 0 on every other axis (what `shard_map` does with
    ``PartitionSpec(shard_axes)`` on the leading dimension)."""
    sizes = [mesh.shape[a] for a in shard_axes]
    out = []
    for i in range(int(np.prod(sizes, dtype=np.int64))):
        coords = dict(zip(shard_axes, np.unravel_index(i, sizes)))
        out.append(mesh.device_at(int(coords.get(a, 0))
                                  for a in mesh.axis_names))
    return out


def check_mesh(mesh, shard_axes) -> tuple[tuple[str, ...], int]:
    """Validate an engine's ``mesh`` / ``shard_axes`` (default: every mesh
    axis); returns (axes, shard count)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch mesh (build one with "
            f"repro_torch.distributed.sharding.make_mesh), got "
            f"{type(mesh).__module__}.{type(mesh).__name__}")
    axes = tuple(shard_axes) if shard_axes is not None \
        else tuple(mesh.axis_names)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"shard axis {a!r} not in mesh "
                             f"{tuple(mesh.axis_names)}")
    return axes, mesh_shard_count(mesh, axes)


def _upload(a: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Host rows -> ``dev``: a non-blocking copy to a card (``a`` is pinned;
    PyTorch's caching host allocator keeps its block until the copy ran), a
    view on the CPU."""
    return a if dev.type == "cpu" else a.to(dev, non_blocking=True)


# ---------------------------------------------------------------------------
# Compress.
# ---------------------------------------------------------------------------

def _fetch_payload(st, sp, out_dev, row: int, size: int) -> bytes:
    """Slice-fetch exactly ``size`` compressed bytes of one shard's row."""
    with sp("compress.drain", bytes=size):
        data = out_dev[row, :size].cpu().numpy().tobytes()
    st.host_bytes += size
    return data


def _mesh_collect(engine, chunks, slices, st, sp):
    """Mesh path: per-shard lists of (chunk, n, size, payload_fn).

    One step takes up to ``micro_batch`` blocks PER SHARD: the global stack
    is ``(S*r, MAX_BLOCK+_PAD)`` with shard i owning rows ``[i*r, (i+1)*r)``
    (``r`` padded to a power of two, as in the reference; rows past a
    shard's slice carry n = 0 and are never drained, but their kernels run
    on the same input the reference gives them).  Each step gets its own
    host stack, so no buffer is rewritten while a copy from it is in
    flight.  Double-buffered: step k+1 is dispatched on every shard before
    the host syncs on step k's sizes.
    """
    per = [chunks[sl.start: sl.stop] for sl in slices]
    S = len(per)
    devs = shard_devices(engine.mesh, engine.shard_axes)
    pinned = any(d.type == "cuda" for d in devs)
    steps = max((len(p) for p in per), default=0)
    mb = engine.micro_batch
    out_lists: list[list] = [[] for _ in range(S)]

    def drain(meta, res):
        start, counts, r = meta
        with sp("compress.wait", rows=sum(counts), shards=S):
            sizes = [size_dev.cpu().numpy() for _, size_dev in res]
        st.host_bytes += sum(s.nbytes for s in sizes)
        for i, cnt in enumerate(counts):
            out_dev = res[i][0]
            for j in range(cnt):
                chunk = per[i][start + j]
                size = int(sizes[i][j])
                out_lists[i].append((chunk, len(chunk), size,
                                     functools.partial(_fetch_payload, st, sp,
                                                       out_dev, j, size)))

    inflight = None
    for start in range(0, steps, mb):
        counts = [max(0, min(mb, len(p) - start)) for p in per]
        r = pad_pow2_count(max(counts), mb)
        with sp("compress.pad", blocks=sum(counts), shards=S):
            stack_t = torch.zeros((S * r, MAX_BLOCK + _PAD), dtype=torch.uint8,
                                  pin_memory=pinned)
            ns_t = torch.zeros((S * r,), dtype=torch.int32, pin_memory=pinned)
            stack, ns = stack_t.numpy(), ns_t.numpy()
            for i, p in enumerate(per):
                for j in range(counts[i]):
                    c = p[start + j]
                    row = i * r + j
                    stack[row, : len(c)] = np.frombuffer(c, np.uint8)
                    ns[row] = len(c)
        st.dispatches += 1
        with sp("compress.dispatch", rows=sum(counts), shards=S,
                impl=engine.candidate_impl):
            res = [compress_blocks_bytes(
                       _upload(stack_t[i * r: (i + 1) * r], dev),
                       _upload(ns_t[i * r: (i + 1) * r], dev),
                       hash_bits=engine.hash_bits, max_match=engine.max_match,
                       pws=engine.pws, scan_impl=engine.scan_impl,
                       candidate_impl=engine.candidate_impl)
                   for i, dev in enumerate(devs)]
        if inflight is not None:
            drain(*inflight)
        inflight = ((start, counts, r), res)
    if inflight is not None:
        drain(*inflight)
    return out_lists


def _host_collect(engine, chunks, slices, st, sp):
    """Host path: each shard's slice through the single-device worker — the
    per-shard oracle: shard i's payloads come from exactly the dispatches a
    standalone `LZ4Engine` runs on the slice."""
    worker = engine._shard_worker()
    out_lists: list[list] = [[] for _ in slices]
    for sl in slices:
        if sl.count == 0:
            continue
        piece = b"".join(chunks[sl.start: sl.stop])
        with sp("compress.shard", shard=sl.shard, blocks=sl.count):
            out_lists[sl.shard] = list(worker._payload_iter(piece, st))
    return out_lists


def _collect(engine, data: bytes, st, sp):
    chunks = [data[i: i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    st.shards = engine.shards
    slices = partition_blocks(len(chunks), engine.shards)
    if engine.mesh is not None and engine.shards > 1:
        # The host path counts blocks / bytes_in inside the worker's
        # `_payload_iter`; the mesh path counts them here.
        st.blocks += len(chunks)
        st.bytes_in += len(data)
        return chunks, slices, _mesh_collect(engine, chunks, slices, st, sp)
    return chunks, slices, _host_collect(engine, chunks, slices, st, sp)


def compress_sharded(engine, data: bytes, st) -> bytes:
    """bytes -> frame v4, sharded across ``engine.shards`` producers.

    ``st`` is the engine call's `EngineStats`.  Blocks are partitioned
    contiguously, compressed on the mesh path when ``engine.mesh`` spans
    more than one shard (the host path otherwise), and merged — raw
    passthrough, CRCs and the v4 shard column — under one
    ``compress.merge`` span.
    """
    ob = engine._obs_on()
    sp = obs.span_factory(ob)
    chunks, slices, per_shard = _collect(engine, data, st, sp)
    S = engine.shards
    ratio_hist = obs.registry().histogram(
        "engine.block_ratio", obs.DEFAULT_RATIO_BUCKETS,
        "per-block compression ratio usize/csize (raw blocks -> 1.0)",
    ) if ob else None
    payloads, usizes, raws, crcs, shard_ids = [], [], [], [], []
    with sp("compress.merge", blocks=len(chunks), shards=S):
        for sl, items in zip(slices, per_shard):
            for chunk, n, size, payload_fn in items:
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
                crcs.append(block_crc(chunk))
                shard_ids.append(sl.shard)
        pg = engine.parity_group
        frame = encode_frame(payloads, usizes, raws, checksums=crcs,
                             shards=shard_ids, shard_count=S,
                             content_crc=block_crc(data)
                             if (engine.content_crc or pg is not None)
                             else None,
                             parity_group=pg)
    if ob:
        r = obs.registry()
        r.counter("fabric.dispatches",
                  "sharded compress/decode dispatches").inc(st.dispatches)
        r.counter("fabric.merged_blocks",
                  "blocks merged into v4 frames").inc(len(chunks))
    st.bytes_out = len(frame)
    return frame


def shard_blocks_sharded(engine, data: bytes, st) -> list[bytes]:
    """Sharded twin of `LZ4Engine.compress_to_blocks` (raw LZ4 blocks, no
    framing, no raw passthrough): every block's bytes through its shard's
    datapath, in global order."""
    sp = obs.span_factory(engine._obs_on())
    chunks, _slices, per_shard = _collect(engine, data, st, sp)
    out = []
    with sp("compress.merge", blocks=len(chunks), shards=engine.shards,
            framing=False):
        for items in per_shard:
            out.extend(bytes(payload_fn()) for _, _, _, payload_fn in items)
    return out


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

def _round_bucket(rounds: int) -> int:
    """Pointer-doubling depth rounded up to a power of two, as the
    reference buckets its compiled variants."""
    if rounds <= 0:
        return 0
    b = 1
    while b < rounds:
        b <<= 1
    return b


def _count_fabric(engine, st) -> None:
    if engine._obs_on():
        r = obs.registry()
        r.counter("fabric.dispatches",
                  "sharded compress/decode dispatches").inc(st.dispatches)
        r.counter("fabric.fallback_blocks",
                  "sharded-decode blocks executed on host "
                  "(plan overflowed DevicePlanCaps)").inc(st.fallback_blocks)


def _steps(engine, jobs):
    """Partition ``jobs`` over the shards and yield, per step,
    ``(per, start, counts, r)``: per-shard job lists, the step's first
    index within each, rows taken per shard and rows padded to."""
    slices = partition_blocks(len(jobs), engine.shards)
    per = [jobs[sl.start: sl.stop] for sl in slices]
    mb = engine.micro_batch
    for start in range(0, max(len(p) for p in per), mb):
        counts = [max(0, min(mb, len(p) - start)) for p in per]
        yield per, start, counts, pad_pow2_count(max(counts), mb)


def decode_items_sharded(engine, items, st) -> list:
    """Sharded device decode of independent blocks.

    ``items``: list of ``(index, payload, usize, crc, raw)`` in output
    order (``crc`` None skips the checksum, ``usize`` None caps at
    MAX_BLOCK).  Raw blocks short-circuit; blocks whose plans overflow
    `DevicePlanCaps` run on the host (counted in ``st.fallback_blocks``);
    the rest are planned on the host, partitioned contiguously across the
    mesh shards and decoded by `ops.decode_gather` on each shard's device.
    Returns the decoded bytes per item.  Engines with
    ``plan_on_device=True`` take the speculative path instead
    (`_decode_items_sharded_spec`).
    """
    if engine.plan_on_device:
        return _decode_items_sharded_spec(engine, items, st)
    sp = obs.span_factory(engine._obs_on())
    out: list = [None] * len(items)
    jobs = []  # (slot, index, usize, crc, payload, dplan)
    for slot, (i, payload, usize, crc, raw) in enumerate(items):
        if raw:
            with sp("decode.verify", block=i, raw=True):
                check_block(i, usize if usize is not None else len(payload),
                            crc, payload)
            out[slot] = payload
            continue
        try:
            plan, dplan = engine._plan_for_device(
                payload, usize if usize is not None else MAX_BLOCK)
        except FrameFormatError:
            raise
        except LZ4FormatError as e:
            raise FrameFormatError(f"block {i}: {e}") from e
        if usize is not None and plan.usize != usize:
            raise FrameFormatError(
                f"block {i}: decoded {plan.usize} bytes, table says {usize}"
            )
        if dplan is None:
            st.fallback_blocks += 1
            with sp("decode.execute", block=i, fallback=True):
                data = execute_plan(payload, plan).tobytes()
            with sp("decode.verify", block=i):
                check_block(i, plan.usize, crc, data)
            out[slot] = data
            continue
        jobs.append((slot, i, plan.usize, crc, payload, dplan))

    if not jobs:
        return out

    caps = engine.caps
    S = engine.shards
    devs = shard_devices(engine.mesh, engine.shard_axes)
    pinned = any(d.type == "cuda" for d in devs)

    def drain(meta, res):
        per, start, counts = meta
        for si, cnt in enumerate(counts):
            for j in range(cnt):
                slot, idx, usize, crc, _payload, _dp = per[si][start + j]
                with sp("decode.drain", bytes=usize):
                    data = res[si][j, :usize].cpu().numpy().tobytes()
                st.host_bytes += usize
                with sp("decode.verify", block=idx):
                    check_block(idx, usize, crc, data)
                out[slot] = data

    inflight = None
    for per, start, counts, r in _steps(engine, jobs):
        blk = np.zeros((S * r, caps.blk_cap), np.uint8)
        lit = [np.zeros((S * r, caps.max_lit), np.int32) for _ in range(3)]
        mat = [np.zeros((S * r, caps.max_match), np.int32) for _ in range(2)]
        scal = [np.zeros((S * r,), np.int32) for _ in range(3)]
        rounds = 0
        for si in range(S):
            for j in range(counts[si]):
                _slot, _idx, _usize, _crc, payload, dp = per[si][start + j]
                row = si * r + j
                blk[row, : len(payload)] = np.frombuffer(payload, np.uint8)
                lit[0][row], lit[1][row], lit[2][row] = (dp.lit_src, dp.lit_dst,
                                                         dp.lit_len)
                mat[0][row], mat[1][row] = dp.match_dst, dp.match_off
                scal[0][row], scal[1][row], scal[2][row] = (dp.n_lit,
                                                            dp.n_match,
                                                            dp.out_size)
                rounds = max(rounds, dp.n_waves)
        st.dispatches += 1
        st.device_blocks += sum(counts)
        with sp("decode.execute", rows=sum(counts), shards=S,
                executor="sharded", rounds=rounds):
            arrays = [torch.from_numpy(a) for a in (blk, *lit, *mat, *scal)]
            if pinned:
                arrays = [a.pin_memory() for a in arrays]
            res = [kops.decode_gather(
                       *(_upload(a[si * r: (si + 1) * r], dev) for a in arrays),
                       out_cap=caps.out_cap, rounds=_round_bucket(rounds))
                   for si, dev in enumerate(devs)]
        if inflight is not None:
            drain(*inflight)
        inflight = ((per, start, counts), res)
    if inflight is not None:
        drain(*inflight)
    _count_fabric(engine, st)
    return out


def _spec_host_fallback_item(engine, i, payload, usize, crc, st, sp):
    """Host plan + execute for one sharded item the speculative path
    cannot keep on a device (payload over `blk_cap`, or a plan over the
    caps) — counted, size-checked against the table and CRC-verified."""
    st.fallback_blocks += 1
    try:
        with sp("decode.plan", bytes_in=len(payload), executor="device",
                fallback=True):
            plan = plan_block_fast(
                payload, max_out=usize if usize is not None else MAX_BLOCK)
    except FrameFormatError:
        raise
    except LZ4FormatError as e:
        raise FrameFormatError(f"block {i}: {e}") from e
    if usize is not None and plan.usize != usize:
        raise FrameFormatError(
            f"block {i}: decoded {plan.usize} bytes, table says {usize}")
    with sp("decode.execute", block=i, fallback=True):
        data = execute_plan(payload, plan).tobytes()
    with sp("decode.verify", block=i):
        check_block(i, plan.usize, crc, data)
    return data


def _decode_items_sharded_spec(engine, items, st) -> list:
    """`decode_items_sharded` with speculative on-device planning.

    Raw payloads are stacked as they are into the ``(S*r, blk_cap +
    SPEC_PAD)`` global buffer with their lengths and size caps, and
    `ops.plan_decode` parses, validates, lays out and decodes each shard's
    rows on its device.  CRCs are checked on the host (``compute_crc``
    off), so `host_bytes` counts each block's ``out_size``.  The host reads
    each row's status vector at drain: parse errors raise the host
    planner's exact per-block message, size mismatches the ``table says``
    message, caps overflows take the counted host fallback.
    """
    from repro_torch.core.decode_engine import _spec_err_message

    sp = obs.span_factory(engine._obs_on())
    out: list = [None] * len(items)
    jobs = []  # (slot, index, usize, crc, payload, max_out)
    for slot, (i, payload, usize, crc, raw) in enumerate(items):
        if raw:
            with sp("decode.verify", block=i, raw=True):
                check_block(i, usize if usize is not None else len(payload),
                            crc, payload)
            out[slot] = payload
            continue
        if len(payload) > engine.caps.blk_cap:
            out[slot] = _spec_host_fallback_item(
                engine, i, payload, usize, crc, st, sp)
            continue
        jobs.append((slot, i, usize, crc, payload,
                     usize if usize is not None else MAX_BLOCK))

    if not jobs:
        return out

    caps = engine.caps
    S = engine.shards
    devs = shard_devices(engine.mesh, engine.shard_axes)
    pinned = any(d.type == "cuda" for d in devs)

    def drain(meta, res):
        per, start, counts = meta
        for si in range(S):
            rows, status, _crc = res[si]
            stat = status.cpu().numpy()
            for j in range(counts[si]):
                slot, idx, usize, crc, payload, _mo = per[si][start + j]
                err = int(stat[j, kops.SPEC_ERR])
                if err:
                    raise FrameFormatError(
                        f"block {idx}: {_spec_err_message(err)}")
                if int(stat[j, kops.SPEC_OVERFLOW]):
                    out[slot] = _spec_host_fallback_item(
                        engine, idx, payload, usize, crc, st, sp)
                    continue
                out_size = int(stat[j, kops.SPEC_OUT_SIZE])
                if usize is not None and out_size != usize:
                    raise FrameFormatError(
                        f"block {idx}: decoded {out_size} bytes, "
                        f"table says {usize}")
                st.device_blocks += 1
                with sp("decode.drain", bytes=out_size):
                    data = rows[j, :out_size].cpu().numpy().tobytes()
                st.host_bytes += out_size
                with sp("decode.verify", block=idx):
                    check_block(idx, out_size, crc, data)
                out[slot] = data

    inflight = None
    for per, start, counts, r in _steps(engine, jobs):
        blk_t = torch.zeros((S * r, caps.blk_cap + kops.SPEC_PAD),
                            dtype=torch.uint8, pin_memory=pinned)
        ns_t, mo_t = (torch.zeros((S * r,), dtype=torch.int32, pin_memory=pinned)
                      for _ in range(2))
        blk, ns, mo = blk_t.numpy(), ns_t.numpy(), mo_t.numpy()
        for si in range(S):
            for j in range(counts[si]):
                _slot, _idx, _usize, _crc, payload, max_out = per[si][start + j]
                row = si * r + j
                blk[row, : len(payload)] = np.frombuffer(payload, np.uint8)
                ns[row] = len(payload)
                mo[row] = max_out
        st.dispatches += 1
        with sp("decode.plan_device", rows=sum(counts), shards=S,
                executor="sharded"):
            res = [kops.plan_decode(
                       *(_upload(a[si * r: (si + 1) * r], dev)
                         for a in (blk_t, ns_t, mo_t)),
                       out_cap=caps.out_cap, max_lit=caps.max_lit,
                       max_match=caps.max_match, rounds=MAX_RESOLVE_ROUNDS,
                       compute_crc=False)
                   for si, dev in enumerate(devs)]
        if inflight is not None:
            drain(*inflight)
        inflight = ((per, start, counts), res)
    if inflight is not None:
        drain(*inflight)
    _count_fabric(engine, st)
    return out


# ---------------------------------------------------------------------------
# Provenance.
# ---------------------------------------------------------------------------

def shard_subframe(frame: bytes, shard: int) -> bytes:
    """One shard's blocks of a v4 frame as a standalone v3 frame.

    The fabric's invariant made testable: ``shard_subframe(v4_frame, s)``
    must equal ``LZ4Engine(<same config>).compress(slice_bytes)`` on shard
    s's slice of the input — no payload is re-encoded, the bytes are lifted
    out of the container.
    """
    info = frame_info(frame)
    if info["shard_count"] is None:
        raise FrameFormatError("not a version-4 (sharded) frame")
    payloads, usizes, raws, crcs = [], [], [], []
    for b in info["blocks"]:
        if b["shard"] != shard:
            continue
        payloads.append(frame[b["offset"]: b["offset"] + b["csize"]])
        usizes.append(b["usize"])
        raws.append(b["raw"])
        crcs.append(b["crc"])
    return encode_frame(payloads, usizes, raws, checksums=crcs)
