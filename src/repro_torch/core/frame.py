"""Self-describing multi-block container (LZ4-frame-style) with a seek index.

The normative byte-level specification of this format — complete enough for
a third party to implement an independent reader — lives in
docs/frame-format.md; this docstring is the working summary.

The raw block format needs out-of-band lengths: a list of compressed blocks
is not decodable without knowing where each block ends and how large it was
uncompressed.  This container makes `LZ4Engine.compress` output a single
self-describing byte string:

    frame  := magic(4) | version(1) | block_count(u32 LE)
              [content_size(u64 LE)]                          (version 3)
              | table | payloads
    table  := block_count x entry
    entry  := usize(u32 LE) | csize_flag(u32 LE)              (version 1)
            | usize(u32 LE) | csize_flag(u32 LE) | crc32(u32) (versions 2, 3)

`csize_flag` holds the payload size in the low 31 bits; the high bit marks an
uncompressible block stored raw (payload == original bytes, csize == usize).
Payloads are concatenated in block order immediately after the table.
Version 2 adds a CRC32 of each block's *uncompressed* content, so any stored
corruption — including a flipped literal byte that still parses — is detected
at decode time instead of surfacing as silent wrong output.  Version 3
additionally records the TOTAL content size in the header; `frame_info`
cross-checks it against the block table's usize sum, so a corrupted table
(or header) is rejected before any payload is decoded and readers can size
output buffers from the header alone.

Version 4 (the sharded-fabric container, written by a sharded `LZ4Engine`)
adds a `shard_count` header field and a per-entry `shard` id recording which
mesh shard produced each block:

    frame  := magic(4) | version=4 | block_count(u32 LE)
              | content_size(u64 LE) | shard_count(u32 LE)
              | table | payloads
    entry  := usize(u32) | csize_flag(u32) | crc32(u32) | shard(u32)

Blocks stay in GLOBAL content order (shards compress contiguous slices of
the block stack, so concatenating per-shard outputs in shard order preserves
it); the shard column is provenance plus a validation surface.  A reader
MUST reject a shard id >= shard_count and a shard column that ever
decreases — per-shard runs are contiguous by construction, so an
out-of-order entry means the table was corrupted or the merge was wrong.
Seekability is unchanged: the cumulative usize sum still maps any
decompressed range to covering blocks regardless of shard boundaries.

Version 5 appends a whole-object integrity trailer to the version-4 layout:

    frame  := magic(4) | version=5 | block_count(u32 LE)
              | content_size(u64 LE) | shard_count(u32 LE)
              | table | payloads | content_crc(u32 LE)
    entry  := usize(u32) | csize_flag(u32) | crc32(u32) | shard(u32)

`content_crc` is the CRC32 of the CONCATENATED uncompressed content — a
second, independent integrity surface over the whole object on top of the
per-block CRCs (per-block checks cannot catch a table that swaps two
equal-sized blocks' entries, or a reader bug that joins blocks in the
wrong order).  Full-frame decoders (`decode_frame_serial`, the decode
engine's `decode`/`decode_to_device`) verify it after the join; PARTIAL
reads (`FrameReader.read_range`) deliberately skip it — they never
materialise the whole object, which is the point of the seek index.
Unsharded version-5 writers record `shard_count = 1` with every block on
shard 0.

Version 6 (opt-in via ``LZ4Engine(parity_group=N)``) adds an erasure-coding
surface on top of the version-5 layout so salvage (`repro_torch.resilience`)
can *reconstruct* damage instead of merely mapping it:

    frame  := magic(4) | version=6 | block_count(u32 LE)
              | content_size(u64 LE) | shard_count(u32 LE)
              | parity_group(u32 LE)
              | table | payloads | ptable | parity_payloads
              | content_crc(u32 LE)
    entry  := usize(u32) | csize_flag(u32) | crc32(u32) | shard(u32)
    ptable := n_groups x pentry        n_groups = ceil(block_count / G)
    pentry := plen(u32) | pcrc(u32)

where ``G = parity_group >= 1``.  Data blocks are split into consecutive
groups of G; parity payload g is the byte-wise XOR of the group's STORED
payloads (compressed or raw, each zero-padded to ``plen``, the group's
maximum csize), and ``pcrc`` is the CRC32 of the parity payload itself.
Any SINGLE damaged payload in a group is reconstructed byte-identically by
XOR-ing the parity payload with the group's surviving payloads and
truncating to the damaged entry's table csize — then re-validated through
the normal decode + per-block CRC path, so a wrong reconstruction (two
overlapping faults, damaged parity) can never be returned silently.
Readers that never salvage can ignore parity entirely: the block table and
payload region are laid out exactly as in version 5, so partial reads
(`FrameReader.read_range`) skip the parity section for free, and full
decodes only add the (always-present in v6) whole-content trailer check.
Worked example + failure-mode table: docs/frame-format.md,
docs/resilience.md.

The block table is a public seek index (Rapidgzip-style, arXiv 2308.08955):
blocks are compressed independently, `frame_info` exposes each block's
`usize`/`csize`/payload `offset` without touching payload bytes, and the
cumulative sum of `usize` maps any decompressed byte range to the covering
blocks.  `FrameReader.read_range` (decode_engine.py) uses exactly this to
decode only the blocks a partial read needs; consumers may likewise seek by
indexing the table directly.

Kept deliberately minimal otherwise (no dictionaries, no entropy stage): the
point is self-description, seekability, and the raw-passthrough escape hatch
the paper's hardware also needs for incompressible inputs.

Decoding entry points:

  decode_frame         — delegates to the parallel two-phase
                         `LZ4DecodeEngine` (decode_engine.py).
  decode_frame_serial  — the original serial block walk, kept as the oracle
                         (`bytewise=True` drops to the byte-at-a-time block
                         decoder for a fully independent reference).
"""
from __future__ import annotations

import binascii
import struct

from .decoder import LZ4FormatError, decode_block, decode_block_bytewise
from .lz4_types import MAX_BLOCK

MAGIC = b"LZ4R"
VERSION_V1 = 1
VERSION_V2 = 2
VERSION_V3 = 3
VERSION_V4 = 4
VERSION_V5 = 5
VERSION_V6 = 6
VERSION = VERSION_V3  # unsharded writer version (checksums + content size)
RAW_FLAG = 0x80000000
_HEADER = struct.Struct("<4sBI")
_CONTENT_SIZE = struct.Struct("<Q")  # v3+: total uncompressed size
_SHARD_COUNT = struct.Struct("<I")   # v4+: shard count
_PARITY_GROUP = struct.Struct("<I")  # v6: data blocks per parity group
_ENTRY_V1 = struct.Struct("<II")
_ENTRY_V2 = struct.Struct("<III")   # also the v3 entry
_ENTRY_V4 = struct.Struct("<IIII")  # v2 entry + producing shard id (v4/v5/v6)
_PARITY_ENTRY = struct.Struct("<II")  # v6: padded length + parity-payload CRC
_CONTENT_CRC = struct.Struct("<I")  # v5/v6 trailer: whole-content CRC32
_ALL_VERSIONS = (VERSION_V1, VERSION_V2, VERSION_V3, VERSION_V4, VERSION_V5,
                 VERSION_V6)


class FrameFormatError(LZ4FormatError):
    """Malformed frame: bad magic/version, truncation, lying size fields,
    or (version >= 2) a block checksum mismatch."""


def block_crc(data: bytes) -> int:
    """The frame's per-block checksum: CRC32 of the uncompressed content."""
    return binascii.crc32(data) & 0xFFFFFFFF


def xor_bytes(parts: list[bytes], length: int | None = None) -> bytes:
    """Byte-wise XOR of ``parts``, each zero-padded to ``length`` (defaults
    to the longest part).  The v6 parity primitive — and, because XOR is its
    own inverse, also the reconstruction primitive: XOR of a group's parity
    payload with its surviving payloads yields the missing payload
    (zero-padded; truncate to its table csize)."""
    if length is None:
        length = max((len(p) for p in parts), default=0)
    acc = 0
    for p in parts:
        if len(p) > length:
            raise ValueError(f"part of {len(p)} bytes > parity length {length}")
        acc ^= int.from_bytes(p, "little")
    return acc.to_bytes(length, "little")


def parity_group_blocks(payloads: list[bytes],
                        group: int) -> list[tuple[int, int, bytes]]:
    """Compute the v6 parity section for ``payloads`` (STORED block bytes,
    in table order): one ``(plen, pcrc, parity_payload)`` per consecutive
    group of ``group`` blocks (the last group may be short)."""
    if group < 1:
        raise ValueError("parity_group must be >= 1")
    out = []
    for g0 in range(0, len(payloads), group):
        grp = [bytes(p) for p in payloads[g0: g0 + group]]
        parity = xor_bytes(grp)
        out.append((len(parity), block_crc(parity), parity))
    return out


def encode_frame(payloads: list[bytes], usizes: list[int],
                 raw_flags: list[bool],
                 checksums: list[int] | None = None,
                 content_size: bool = True,
                 shards: list[int] | None = None,
                 shard_count: int | None = None,
                 content_crc: int | None = None,
                 parity_group: int | None = None) -> bytes:
    """Assemble a frame from per-block payloads.

    payloads  : compressed block bytes (or raw input bytes where flagged);
                any bytes-like object, joined into the frame without a
                copy of its own (the engine's drain hands memoryviews)
    usizes    : uncompressed size of each block
    raw_flags : True where the payload is stored raw (uncompressible block)
    checksums : optional per-block `block_crc` of the UNCOMPRESSED content;
                when given the frame is written as version 3 (verified on
                decode), otherwise as version 1 (no integrity check).
    content_size : write the total uncompressed size into the header
                (version 3; requires checksums).  ``False`` produces a
                version-2 frame, byte-identical to the pre-v3 writer.
    shards    : per-block producing-shard ids (the sharded fabric's merge
                stage).  When given the frame is written as version 4:
                ids must be non-decreasing (shards own contiguous block
                runs) and < ``shard_count``.  Requires checksums +
                content_size.
    shard_count : total shard count recorded in the v4 header; defaults to
                ``max(shards) + 1`` (``1`` for an empty frame).  May exceed
                the largest id present — trailing shards can own zero
                blocks when the stack does not divide.
    content_crc : CRC32 of the CONCATENATED uncompressed content.  When
                given the frame is written as version 5 — the version-4
                layout plus a 4-byte trailer — and full-frame decoders
                verify the joined output against it.  Requires checksums +
                content_size; an unsharded version-5 frame records
                ``shard_count = 1`` with every block on shard 0.
    parity_group : data blocks per XOR parity group.  When given the frame
                is written as version 6 — the version-5 layout plus a
                ``parity_group`` header field and one parity block per
                group of that many data blocks (`parity_group_blocks`) —
                so salvage can reconstruct any single damaged block per
                group byte-identically.  Requires ``content_crc``.
    """
    if not (len(payloads) == len(usizes) == len(raw_flags)):
        raise ValueError("payloads/usizes/raw_flags length mismatch")
    if checksums is not None and len(checksums) != len(payloads):
        raise ValueError("checksums length mismatch")
    if parity_group is not None:
        if parity_group < 1:
            raise ValueError("parity_group must be >= 1")
        if content_crc is None:
            raise ValueError("version-6 frames require content_crc")
    if content_crc is not None:
        if checksums is None or not content_size:
            raise ValueError("version-5 frames require checksums + content_size")
        if shards is None:
            shards = [0] * len(payloads)
    if shards is not None:
        if checksums is None or not content_size:
            raise ValueError("version-4 frames require checksums + content_size")
        if len(shards) != len(payloads):
            raise ValueError("shards length mismatch")
        if shard_count is None:
            shard_count = (max(shards) + 1) if shards else 1
        if shard_count < 1:
            raise ValueError("shard_count must be >= 1")
        if any(s1 < s0 for s0, s1 in zip(shards, shards[1:])):
            raise ValueError("shard ids must be non-decreasing")
        if shards and (shards[0] < 0 or shards[-1] >= shard_count):
            raise ValueError("shard id out of range")
        if parity_group is not None:
            version = VERSION_V6
        elif content_crc is not None:
            version = VERSION_V5
        else:
            version = VERSION_V4
    elif checksums is None:
        version = VERSION_V1
    else:
        version = VERSION_V3 if content_size else VERSION_V2
    wide = version in (VERSION_V4, VERSION_V5, VERSION_V6)
    parts = [_HEADER.pack(MAGIC, version, len(payloads))]
    if version >= VERSION_V3:
        parts.append(_CONTENT_SIZE.pack(sum(usizes)))
    if wide:
        parts.append(_SHARD_COUNT.pack(shard_count))
    if version == VERSION_V6:
        parts.append(_PARITY_GROUP.pack(parity_group))
    for i, (payload, usize, raw) in enumerate(zip(payloads, usizes, raw_flags)):
        if not 0 <= usize <= MAX_BLOCK:
            raise ValueError(f"block uncompressed size {usize} out of range")
        if raw and len(payload) != usize:
            raise ValueError("raw block payload must equal its usize")
        if len(payload) >= RAW_FLAG:
            raise ValueError("block payload too large")
        cf = len(payload) | (RAW_FLAG if raw else 0)
        if wide:
            parts.append(_ENTRY_V4.pack(usize, cf, checksums[i] & 0xFFFFFFFF,
                                        shards[i]))
        elif checksums is None:
            parts.append(_ENTRY_V1.pack(usize, cf))
        else:
            parts.append(_ENTRY_V2.pack(usize, cf, checksums[i] & 0xFFFFFFFF))
    parts.extend(payloads)
    if version == VERSION_V6:
        groups = parity_group_blocks([bytes(p) for p in payloads],
                                     parity_group)
        for plen, pcrc, _ in groups:
            parts.append(_PARITY_ENTRY.pack(plen, pcrc))
        for _, _, parity in groups:
            parts.append(parity)
    if version in (VERSION_V5, VERSION_V6):
        parts.append(_CONTENT_CRC.pack(content_crc & 0xFFFFFFFF))
    return b"".join(parts)


def frame_info(frame: bytes, max_version: int | None = None) -> dict:
    """Parse and validate the header/table; returns block metadata.

    Raises FrameFormatError without touching any payload bytes.  Each block
    dict carries the seek-index fields: `usize`, `csize`, `raw`, payload
    `offset` into the frame, `crc` (None for version-1 frames), and `shard`
    (the producing shard for version-4 frames, None before).  The result's
    `content_size` is the version-3/4 header total (None for older
    versions), already validated against the table's usize sum — so a
    corrupted table or header field is caught BEFORE any payload decode;
    `shard_count` is the version-4/5 shard total (None before), with every
    table shard id validated in-range and non-decreasing; `content_crc` is
    the version-5 whole-content CRC32 trailer (None before v5) — exposed
    for full-frame decoders to verify after the join, never checked here
    (the header/table pass touches no payload bytes).

    ``max_version`` pins the reader's format horizon: a deployment still
    running the version-3 reader rejects version-4 frames outright instead
    of misparsing the wider table (tests assert this guard), exactly as the
    pre-v4 code did via its version allowlist.
    """
    if len(frame) < _HEADER.size:
        raise FrameFormatError("truncated frame header", cause="truncated")
    magic, version, count = _HEADER.unpack_from(frame, 0)
    if magic != MAGIC:
        raise FrameFormatError(f"bad magic {magic!r}", cause="structure")
    if version not in _ALL_VERSIONS:
        raise FrameFormatError(f"unsupported frame version {version}",
                               cause="structure")
    if max_version is not None and version > max_version:
        raise FrameFormatError(
            f"frame version {version} > reader max_version {max_version}",
            cause="structure",
        )
    table_start = _HEADER.size
    content_size = None
    shard_count = None
    parity_group = None
    wide = version in (VERSION_V4, VERSION_V5, VERSION_V6)
    if version >= VERSION_V3:
        if len(frame) < table_start + _CONTENT_SIZE.size:
            raise FrameFormatError("truncated content-size header",
                                   cause="truncated")
        (content_size,) = _CONTENT_SIZE.unpack_from(frame, table_start)
        table_start += _CONTENT_SIZE.size
    if wide:
        if len(frame) < table_start + _SHARD_COUNT.size:
            raise FrameFormatError("truncated shard-count header",
                                   cause="truncated")
        (shard_count,) = _SHARD_COUNT.unpack_from(frame, table_start)
        table_start += _SHARD_COUNT.size
        if shard_count < 1:
            raise FrameFormatError("shard_count must be >= 1",
                                   cause="structure")
    if version == VERSION_V6:
        if len(frame) < table_start + _PARITY_GROUP.size:
            raise FrameFormatError("truncated parity-group header",
                                   cause="truncated")
        (parity_group,) = _PARITY_GROUP.unpack_from(frame, table_start)
        table_start += _PARITY_GROUP.size
        if parity_group < 1:
            raise FrameFormatError("parity_group must be >= 1",
                                   cause="structure")
    entry = _ENTRY_V4 if wide else (
        _ENTRY_V1 if version == VERSION_V1 else _ENTRY_V2)
    table_end = table_start + count * entry.size
    if len(frame) < table_end:
        raise FrameFormatError("truncated block table", cause="truncated")
    blocks = []
    off = table_end
    prev_shard = 0
    for i in range(count):
        fields = entry.unpack_from(frame, table_start + i * entry.size)
        usize, cf = fields[0], fields[1]
        crc = fields[2] if version != VERSION_V1 else None
        shard = fields[3] if wide else None
        raw = bool(cf & RAW_FLAG)
        csize = cf & ~RAW_FLAG
        if usize > MAX_BLOCK:
            raise FrameFormatError(f"block {i}: usize {usize} > {MAX_BLOCK}",
                                   block_index=i, cause="structure")
        if raw and csize != usize:
            raise FrameFormatError(
                f"block {i}: raw csize {csize} != usize {usize}",
                block_index=i, cause="structure")
        if shard is not None:
            if shard >= shard_count:
                raise FrameFormatError(
                    f"block {i}: shard {shard} >= shard_count {shard_count}",
                    block_index=i, cause="structure",
                )
            if shard < prev_shard:
                raise FrameFormatError(
                    f"block {i}: shard {shard} after shard {prev_shard} — "
                    "shard runs must be contiguous and in order",
                    block_index=i, cause="structure",
                )
            prev_shard = shard
        blocks.append({"usize": usize, "csize": csize, "raw": raw,
                       "offset": off, "crc": crc, "shard": shard})
        off += csize
    parity = None
    if version == VERSION_V6:
        n_groups = (count + parity_group - 1) // parity_group
        ptable_end = off + n_groups * _PARITY_ENTRY.size
        if len(frame) < ptable_end:
            raise FrameFormatError("truncated parity table",
                                   cause="truncated")
        parity = []
        poff = ptable_end
        for g in range(n_groups):
            plen, pcrc = _PARITY_ENTRY.unpack_from(
                frame, off + g * _PARITY_ENTRY.size)
            grp = blocks[g * parity_group: (g + 1) * parity_group]
            want = max(b["csize"] for b in grp)
            if plen != want:
                raise FrameFormatError(
                    f"parity group {g}: plen {plen} != group max csize {want}",
                    cause="structure",
                )
            parity.append({"plen": plen, "crc": pcrc, "offset": poff})
            poff += plen
        off = poff
    content_crc = None
    if version in (VERSION_V5, VERSION_V6):
        if off + _CONTENT_CRC.size != len(frame):
            raise FrameFormatError(
                f"frame length {len(frame)} != header-implied "
                f"{off + _CONTENT_CRC.size}",
                cause="truncated" if len(frame) < off + _CONTENT_CRC.size
                else "structure",
            )
        (content_crc,) = _CONTENT_CRC.unpack_from(frame, off)
    elif off != len(frame):
        raise FrameFormatError(
            f"frame length {len(frame)} != header-implied {off}",
            cause="truncated" if len(frame) < off else "structure",
        )
    if content_size is not None:
        total = sum(b["usize"] for b in blocks)
        if total != content_size:
            raise FrameFormatError(
                f"content size {content_size} != block-table total {total}",
                cause="structure",
            )
    return {"version": version, "block_count": count, "blocks": blocks,
            "content_size": content_size, "shard_count": shard_count,
            "content_crc": content_crc, "parity_group": parity_group,
            "parity": parity}


def scan_frame(frame: bytes) -> dict:
    """Tolerant header/table parse for salvage (`repro_torch.resilience.salvage`).

    Where `frame_info` is all-or-nothing — one lying table field rejects the
    whole frame — `scan_frame` recovers as much structural metadata as the
    bytes support.  An intact frame takes the strict path and returns the
    `frame_info` dict plus ``complete=True`` / ``notes=[]``; a damaged one
    falls back to a tolerant walk that keeps every table row it can read:

      blocks : one dict per readable table row (same keys as `frame_info`
               plus ``ok`` — False when the entry is structurally invalid
               or its payload region runs past the end of the frame — and
               ``note`` describing why).  Offsets are computed cumulatively
               exactly as the writer laid payloads out, so rows AFTER a
               garbage csize may also go ``ok=False``; that is honest —
               their true position is unrecoverable without parity.
      parity : v6 parity-group dicts (``plen``/``crc``/``offset``/``ok``),
               or None when the parity section is unreadable.
      complete : False on the tolerant path.
      notes  : human-readable anomaly list (every reason the strict parse
               would have rejected the frame).

    Still raises `FrameFormatError` when there is nothing to salvage *with*:
    a frame too short for the fixed header, wrong magic, or an unknown
    version — no block table can be located then.  Never touches payload
    bytes; payload damage (the common case) is only discoverable by
    decoding, which is salvage's job.
    """
    try:
        info = frame_info(frame)
    except FrameFormatError:
        pass
    else:
        info["complete"] = True
        info["notes"] = []
        for b in info["blocks"]:
            b["ok"] = True
            b["note"] = None
        if info["parity"] is not None:
            for p in info["parity"]:
                p["ok"] = True
        return info
    if len(frame) < _HEADER.size:
        raise FrameFormatError("truncated frame header", cause="truncated")
    magic, version, count = _HEADER.unpack_from(frame, 0)
    if magic != MAGIC:
        raise FrameFormatError(f"bad magic {magic!r}", cause="structure")
    if version not in _ALL_VERSIONS:
        raise FrameFormatError(f"unsupported frame version {version}",
                               cause="structure")
    notes: list[str] = []
    table_start = _HEADER.size
    content_size = None
    shard_count = None
    parity_group = None
    wide = version in (VERSION_V4, VERSION_V5, VERSION_V6)
    if version >= VERSION_V3:
        if len(frame) >= table_start + _CONTENT_SIZE.size:
            (content_size,) = _CONTENT_SIZE.unpack_from(frame, table_start)
        else:
            notes.append("truncated content-size header")
        table_start += _CONTENT_SIZE.size
    if wide:
        if len(frame) >= table_start + _SHARD_COUNT.size:
            (shard_count,) = _SHARD_COUNT.unpack_from(frame, table_start)
            if shard_count < 1:
                notes.append("shard_count must be >= 1")
                shard_count = None
        else:
            notes.append("truncated shard-count header")
        table_start += _SHARD_COUNT.size
    if version == VERSION_V6:
        if len(frame) >= table_start + _PARITY_GROUP.size:
            (parity_group,) = _PARITY_GROUP.unpack_from(frame, table_start)
            if parity_group < 1:
                notes.append("parity_group must be >= 1")
                parity_group = None
        else:
            notes.append("truncated parity-group header")
        table_start += _PARITY_GROUP.size
    entry = _ENTRY_V4 if wide else (
        _ENTRY_V1 if version == VERSION_V1 else _ENTRY_V2)
    table_end = table_start + count * entry.size
    readable = min(count, max(0, (len(frame) - table_start)) // entry.size)
    if readable < count:
        notes.append(f"truncated block table: {readable}/{count} entries")
    blocks = []
    off = table_end
    for i in range(readable):
        fields = entry.unpack_from(frame, table_start + i * entry.size)
        usize, cf = fields[0], fields[1]
        crc = fields[2] if version != VERSION_V1 else None
        shard = fields[3] if wide else None
        raw = bool(cf & RAW_FLAG)
        csize = cf & ~RAW_FLAG
        note = None
        if usize > MAX_BLOCK:
            note = f"usize {usize} > {MAX_BLOCK}"
        elif raw and csize != usize:
            note = f"raw csize {csize} != usize {usize}"
        elif shard is not None and shard_count is not None \
                and shard >= shard_count:
            note = f"shard {shard} >= shard_count {shard_count}"
        elif off + csize > len(frame):
            note = "payload runs past end of frame"
        if note is not None:
            notes.append(f"block {i}: {note}")
        blocks.append({"usize": usize, "csize": csize, "raw": raw,
                       "offset": off, "crc": crc, "shard": shard,
                       "ok": note is None, "note": note})
        off += csize
    parity = None
    if version == VERSION_V6 and parity_group is not None \
            and readable == count:
        n_groups = (count + parity_group - 1) // parity_group
        ptable_end = off + n_groups * _PARITY_ENTRY.size
        if ptable_end <= len(frame):
            parity = []
            poff = ptable_end
            for g in range(n_groups):
                plen, pcrc = _PARITY_ENTRY.unpack_from(
                    frame, off + g * _PARITY_ENTRY.size)
                grp = blocks[g * parity_group: (g + 1) * parity_group]
                want = max(b["csize"] for b in grp)
                pnote = None
                if plen != want:
                    pnote = f"plen {plen} != group max csize {want}"
                elif poff + plen > len(frame):
                    pnote = "parity payload runs past end of frame"
                if pnote is not None:
                    notes.append(f"parity group {g}: {pnote}")
                parity.append({"plen": plen, "crc": pcrc, "offset": poff,
                               "ok": pnote is None})
                poff += plen
        else:
            notes.append("truncated parity table")
    elif version == VERSION_V6:
        notes.append("parity section unreadable (damaged header or table)")
    content_crc = None
    if version in (VERSION_V5, VERSION_V6):
        tail = (off if parity is None
                else parity[-1]["offset"] + parity[-1]["plen"] if parity
                else off)
        if all(b["ok"] for b in blocks) and readable == count \
                and tail + _CONTENT_CRC.size <= len(frame):
            (content_crc,) = _CONTENT_CRC.unpack_from(frame, tail)
        else:
            notes.append("content-crc trailer unreadable")
    if content_size is not None and readable == count:
        total = sum(b["usize"] for b in blocks)
        if total != content_size:
            notes.append(
                f"content size {content_size} != block-table total {total}")
    return {"version": version, "block_count": count, "blocks": blocks,
            "content_size": content_size, "shard_count": shard_count,
            "content_crc": content_crc, "parity_group": parity_group,
            "parity": parity, "complete": False, "notes": notes}


def check_block(i: int, usize: int, crc: int | None, data: bytes) -> None:
    """Validate one decoded block against its table entry (size + crc).

    The single source of truth for post-decode block validation — shared by
    `decode_frame_serial` and the decode engine's worker tasks so the oracle
    and the engine can never drift on which frames they reject.
    """
    if len(data) != usize:
        raise FrameFormatError(
            f"block {i}: decoded {len(data)} bytes, table says {usize}",
            block_index=i, cause="size",
        )
    if crc is not None and block_crc(data) != crc:
        raise FrameFormatError(f"block {i}: checksum mismatch",
                               block_index=i, cause="crc")


def check_content_crc(expected: int | None, crc: int) -> None:
    """Validate the joined output's CRC32 against the v5 trailer.

    `expected` is `frame_info(...)["content_crc"]` (None before version 5 —
    a no-op then); `crc` is `block_crc` over the full decoded object, or an
    equivalent in-graph CRC32.  Shared by every full-frame decode path so
    they reject identically; partial reads never call it.
    """
    if expected is not None and crc != expected:
        raise FrameFormatError("content checksum mismatch",
                               cause="content_crc")


def decode_frame(frame: bytes) -> bytes:
    """Frame -> original bytes; raises FrameFormatError on any malformation.

    Delegates to the process-wide `LZ4DecodeEngine` (the device executor,
    on the card; it raises where no CUDA device is available — pass frames
    to ``LZ4DecodeEngine(device="cpu").decode`` there).  The serial block
    walk survives as `decode_frame_serial`, the oracle the engine is tested
    against.
    """
    from .decode_engine import default_decode_engine  # local: frame <-> engine

    return default_decode_engine().decode(frame)


def decode_frame_serial(frame: bytes, bytewise: bool = False) -> bytes:
    """Serial oracle: walk blocks in order with the scalar block decoder.

    ``bytewise=True`` uses the byte-at-a-time reference decoder for a fully
    independent second opinion (slowest, most obviously correct).
    """
    info = frame_info(frame)
    decode = decode_block_bytewise if bytewise else decode_block
    out = bytearray()
    for i, b in enumerate(info["blocks"]):
        payload = frame[b["offset"]: b["offset"] + b["csize"]]
        if b["raw"]:
            data = payload
        else:
            try:
                data = decode(payload, max_out=b["usize"])
            except FrameFormatError:
                raise
            except LZ4FormatError as e:
                raise FrameFormatError(f"block {i}: {e}") from e
        check_block(i, b["usize"], b["crc"], data)
        out += data
    check_content_crc(info["content_crc"], block_crc(bytes(out)))
    return bytes(out)
