"""Plain NumPy reference of the paper's LZ4 compressor, and a reader of the
frames the benchmark judges.

The compressor follows the paper's scheme as the configuration states it:

* the block is cut into parallelization windows of ``pws`` bytes;
* every position of a window is hashed (Fibonacci hash of the 4-byte
  little-endian word, ``hash_bits`` bits) and written to a last-value table
  once the window is done, so the candidate of position p is the latest q
  with the same hash in an EARLIER window;
* a window emits at most one match: the earliest position at or past the
  end of the previous match whose word equals its candidate's (scheme S1),
  extended to at most ``max_match`` bytes (scheme S2);
* the LZ4 end-of-block rules hold: no match starts in the last 12 bytes,
  the last 5 bytes are literals;
* a block whose LZ4 bytes are not shorter than the block is stored raw.

The frame reader parses the container's header and block table (``LZ4R``,
versions 2 and 3: u32 usize, u32 csize with the raw flag in bit 31, u32
CRC-32 of the uncompressed block).

Imports numpy, zlib and the standard library only: nothing of the program
under test, and neither JAX nor the JAX package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MIN_MATCH = 4
MF_LIMIT = 12
LAST_LITERALS = 5
BLOCK = 65536
HASH_PRIME = 2654435761
RAW_FLAG = 0x80000000
MAGIC = b"LZ4R"


# -- the compressor ----------------------------------------------------------

def _candidates(hashes: np.ndarray, pws: int) -> np.ndarray:
    """cand[p] = max{q : hashes[q] == hashes[p], q // pws < p // pws}, or -1."""
    n = len(hashes)
    order = np.argsort(hashes, kind="stable")     # by hash, then by position
    h = hashes[order]
    w = order // pws
    # A run of equal (hash, window) shares one candidate: the element just
    # before the run, when it has the same hash (its window is then earlier).
    first = np.ones(n, dtype=bool)
    first[1:] = (h[1:] != h[:-1]) | (w[1:] != w[:-1])
    run = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    before = starts - 1
    ok = (before >= 0) & (h[np.maximum(before, 0)] == h[starts])
    run_cand = np.where(ok, order[np.maximum(before, 0)], -1)
    cand = np.empty(n, dtype=np.int64)
    cand[order] = run_cand[run]
    return cand


def sequences(block: bytes, hash_bits: int, pws: int, max_match: int) -> list:
    """The block's sequences as (literal_start, literal_len, match_len,
    offset); the last one is literals only (match_len 0)."""
    buf = np.frombuffer(block, dtype=np.uint8)
    n = len(buf)
    if n < MIN_MATCH:
        return [(0, n, 0, 0)]
    d = buf.astype(np.uint32)
    words = d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)
    hashes = ((words * np.uint32(HASH_PRIME)) >> np.uint32(32 - hash_bits)
              ).astype(np.int64)
    cand = _candidates(hashes, pws)
    pos = np.flatnonzero(cand >= 0)
    pos = pos[words[pos] == words[cand[pos]]]
    pos = pos[pos <= n - MF_LIMIT]
    # Every valid start's match length, capped by max_match and by the last
    # literals: it depends on p and its candidate alone.
    src = cand[pos]
    cap = np.minimum(n - LAST_LITERALS - pos, max_match)
    ext = np.zeros(len(pos), dtype=np.int64)
    alive = cap >= MIN_MATCH
    for k in range(max(0, max_match - MIN_MATCH)):
        alive &= k < cap - MIN_MATCH
        if not alive.any():
            break
        a = np.minimum(pos + MIN_MATCH + k, n - 1)
        b = np.minimum(src + MIN_MATCH + k, n - 1)
        alive &= buf[a] == buf[b]
        ext += alive
    # first[x]: index in `pos` of the first valid start at or past x.
    first = np.searchsorted(pos, np.arange(n + 1), side="left").tolist()
    pos, src, cap, ext = pos.tolist(), src.tolist(), cap.tolist(), ext.tolist()
    out = []
    anchor = 0
    start = 0
    while start <= n:
        i = first[start]
        if i >= len(pos):
            break
        p = pos[i]
        window_end = (p // pws + 1) * pws
        if cap[i] < MIN_MATCH:
            start = window_end
            continue
        length = MIN_MATCH + ext[i]
        out.append((anchor, p - anchor, length, p - src[i]))
        anchor = p + length
        start = max(anchor, window_end)
    out.append((anchor, n - anchor, 0, 0))
    return out


def _length_bytes(value: int) -> bytes:
    """The LZ4 extension bytes of a length whose nibble saturated at 15."""
    value -= 15
    return b"\xff" * (value // 255) + bytes((value % 255,))


def encode(block: bytes, seqs: list) -> bytes:
    """LZ4 block bytes of ``seqs`` over ``block``."""
    out = bytearray()
    for lit_start, lit_len, match_len, offset in seqs:
        ml = match_len - MIN_MATCH if match_len else 0
        out.append((min(lit_len, 15) << 4) | min(ml, 15))
        if lit_len >= 15:
            out += _length_bytes(lit_len)
        out += block[lit_start: lit_start + lit_len]
        if match_len:
            out += struct.pack("<H", offset)
            if ml >= 15:
                out += _length_bytes(ml)
    return bytes(out)


def compress_block(block: bytes, hash_bits: int, pws: int,
                   max_match: int) -> tuple[bool, bytes]:
    """(raw, payload) as the paper's compressor stores ``block`` in a frame."""
    payload = encode(block, sequences(block, hash_bits, pws, max_match))
    if len(payload) >= len(block):
        return True, bytes(block)
    return False, payload


# -- the block decoder -------------------------------------------------------

def parse_block(payload: bytes) -> list:
    """The sequences of an LZ4 block as (literal_offset_in_payload,
    literal_len, match_len, offset).  Raises ValueError on a malformed
    block."""
    out = []
    i, n = 0, len(payload)
    while i < n:
        token = payload[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("truncated literal length")
                b = payload[i]
                i += 1
                lit += b
                if b != 255:
                    break
        lit_at = i
        i += lit
        if i > n:
            raise ValueError("literals run past the block")
        if i == n:
            out.append((lit_at, lit, 0, 0))
            return out
        if i + 2 > n:
            raise ValueError("truncated offset")
        offset = payload[i] | (payload[i + 1] << 8)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                if i >= n:
                    raise ValueError("truncated match length")
                b = payload[i]
                i += 1
                ml += b
                if b != 255:
                    break
        out.append((lit_at, lit, ml + MIN_MATCH, offset))
    raise ValueError("block ends without a last literal run")


def decode_block(payload: bytes) -> bytes:
    """Decode one LZ4 block."""
    out = bytearray()
    for lit_at, lit, match_len, offset in parse_block(payload):
        out += payload[lit_at: lit_at + lit]
        if match_len:
            if not 0 < offset <= len(out):
                raise ValueError("match offset out of range")
            start = len(out) - offset
            if offset >= match_len:
                out += out[start: start + match_len]
            else:                           # an overlapping copy repeats bytes
                for k in range(match_len):
                    out.append(out[start + k])
    return bytes(out)


def _ragged(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The positions starts[j] + k for k < lens[j], segment after segment."""
    return np.repeat(starts - (np.cumsum(lens) - lens), lens) + np.arange(lens.sum())


def _lengths(buf: np.ndarray, n: np.ndarray, i: np.ndarray, end: np.ndarray,
             bad: np.ndarray) -> None:
    """Add the extension bytes of each length whose nibble is 15, in place:
    ``n`` the lengths, ``i`` the read positions, ``bad`` set where a length
    runs past ``end``."""
    more = np.flatnonzero((n == 15) & ~bad)
    while more.size:
        past = i[more] >= end[more]
        bad[more[past]] = True
        more = more[~past]
        b = buf[i[more]].astype(np.int64)
        i[more] += 1
        n[more] += b
        more = more[b == 255]


def decode_blocks(buf: np.ndarray, starts, ends, usize) -> tuple[np.ndarray, np.ndarray]:
    """Decode many LZ4 blocks of ``buf`` (uint8) at once: the payloads
    ``buf[starts[b]:ends[b]]``, one sequence of every block per step.

    Returns the blocks' bytes one after another, ``usize[b]`` each, and a
    flag per block: True where the payload parsed as ``parse_block`` parses
    it and filled exactly ``usize[b]`` bytes; a block that does not is left
    part zero.  Every match reads bytes of its own block written earlier,
    so one step's copies are all resolved.
    """
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    usize = np.asarray(usize, np.int64)
    obase = np.cumsum(usize) - usize
    oend = obase + usize
    out = np.zeros(int(usize.sum()), np.uint8)
    ok = np.zeros(len(starts), bool)
    i, o = starts.copy(), obase.copy()
    live = np.flatnonzero(starts < ends)
    while live.size:
        ii, oo, e = i[live], o[live], ends[live]
        tok = buf[ii].astype(np.int64)
        ii += 1
        bad = np.zeros(live.size, bool)
        lit = tok >> 4
        _lengths(buf, lit, ii, e, bad)
        bad |= (ii + lit > e) | (oo + lit > oend[live])
        lit[bad] = 0
        out[_ragged(oo, lit)] = buf[_ragged(ii, lit)]
        ii += lit
        oo += lit
        last = ~bad & (ii == e)
        ok[live[last]] = oo[last] == oend[live[last]]
        bad |= ~last & (ii + 2 > e)
        go = ~bad & ~last
        at = np.where(go, ii, 0)
        off = buf[at].astype(np.int64) | (buf[at + go].astype(np.int64) << 8)
        ii += 2
        ml = np.where(go, tok & 15, 0)
        _lengths(buf, ml, ii, e, bad)
        ml += MIN_MATCH
        bad |= go & ((off < 1) | (off > oo - obase[live]) | (oo + ml > oend[live]))
        bad |= go & (ii >= e)                      # no last literal run follows
        go &= ~bad
        ml[~go] = 0
        dst = _ragged(oo, ml)
        k = dst - np.repeat(oo, ml)
        off_r = np.repeat(np.where(go, off, 1), ml)
        out[dst] = out[dst - k - off_r + k % off_r]
        i[live], o[live] = ii, oo + ml
        live = live[go]
    return out, ok


# -- the frame -----------------------------------------------------------------

def read_frame(frame: bytes) -> dict:
    """Header and block table of a version 2 or 3 frame.  Raises ValueError
    where the container does not parse."""
    if frame[:4] != MAGIC:
        raise ValueError("bad magic")
    version = frame[4]
    if version not in (2, 3):
        raise ValueError(f"version {version} is not a v2/v3 frame")
    count = struct.unpack_from("<I", frame, 5)[0]
    at = 9
    content_size = None
    if version == 3:
        content_size = struct.unpack_from("<Q", frame, at)[0]
        at += 8
    if at + 12 * count > len(frame):
        raise ValueError("table runs past the frame")
    table = np.frombuffer(frame, dtype="<u4", count=3 * count,
                          offset=at).reshape(count, 3)
    csize = (table[:, 1] & ~np.uint32(RAW_FLAG)).astype(np.int64)
    offsets = at + 12 * count + np.concatenate(([0], np.cumsum(csize)[:-1])) \
        if count else np.zeros(0, np.int64)
    return dict(version=version, count=count, content_size=content_size,
                usize=table[:, 0].astype(np.int64), csize=csize,
                raw=(table[:, 1] & np.uint32(RAW_FLAG)) != 0,
                crc=table[:, 2].astype(np.int64), offsets=offsets,
                end=at + 12 * count + int(csize.sum()))


def block_crcs(obj: bytes) -> np.ndarray:
    """CRC-32 of each 64 KiB block of ``obj``."""
    view = memoryview(obj)
    return np.array([zlib.crc32(view[i: i + BLOCK])
                     for i in range(0, len(obj), BLOCK)], dtype=np.int64)


def check_frame(frame: bytes, obj: bytes, crcs: np.ndarray, sample,
                hash_bits: int, pws: int, max_match: int,
                decode: bool = True) -> dict:
    """Judge one frame of ``obj``.

    ``table_errors``: header fields and block-table entries (usize, CRC-32,
    raw payloads) that disagree with the object, plus 1 if the frame's
    length disagrees with its table.  ``payload_errors``: blocks of
    ``sample`` whose raw flag or payload differs from the reference
    compressor's.  ``decode_errors``: coded blocks, every one of the frame,
    that do not decode to their block of the object (None where ``decode``
    is False).
    """
    nblocks = -(-len(obj) // BLOCK)
    try:
        info = read_frame(frame)
    except (ValueError, struct.error):
        return dict(table_errors=nblocks + 1, payload_errors=len(sample),
                    decode_errors=nblocks)
    errors = int(info["count"] != nblocks)
    errors += int(info["content_size"] not in (None, len(obj)))
    errors += int(info["end"] != len(frame))
    if info["count"] != nblocks:
        return dict(table_errors=errors + nblocks, payload_errors=len(sample),
                    decode_errors=nblocks)
    want_usize = np.full(nblocks, BLOCK, np.int64)
    want_usize[-1] = len(obj) - BLOCK * (nblocks - 1)
    errors += int(np.count_nonzero(info["usize"] != want_usize))
    errors += int(np.count_nonzero(info["crc"] != crcs))
    view = memoryview(frame)
    objview = memoryview(obj)
    for i in np.flatnonzero(info["raw"]):
        at, size = int(info["offsets"][i]), int(info["csize"][i])
        errors += int(size != want_usize[i]
                      or view[at: at + size] != objview[i * BLOCK: i * BLOCK + size])
    wrong = 0
    for i in sample:
        block = obj[i * BLOCK: (i + 1) * BLOCK]
        raw, payload = compress_block(block, hash_bits, pws, max_match)
        at, size = int(info["offsets"][i]), int(info["csize"][i])
        wrong += int(bool(info["raw"][i]) != raw
                     or view[at: at + size] != payload)
    return dict(table_errors=errors, payload_errors=wrong,
                decode_errors=decode_errors(frame, info, obj) if decode else None)


def decode_errors(frame: bytes, info: dict, obj: bytes) -> int:
    """Coded blocks of ``frame`` (whose table is ``info``) that do not
    decode to their 64 KiB block of ``obj``."""
    coded = np.flatnonzero(~info["raw"])
    if not coded.size:
        return 0
    lo = np.minimum(info["offsets"][coded], len(frame))
    hi = np.minimum(lo + info["csize"][coded], len(frame))
    usize = np.clip(len(obj) - coded * BLOCK, 0, BLOCK)
    out, ok = decode_blocks(np.frombuffer(frame, np.uint8), lo, hi, usize)
    want = np.frombuffer(obj, np.uint8)
    wrong = ~ok
    obase = np.cumsum(usize) - usize
    for j in range(0, coded.size, 256):         # 16 MiB of blocks at a time
        sel = slice(j, j + 256)
        a, b = int(obase[j]), int(obase[sel][-1] + usize[sel][-1])
        src = np.concatenate([want[c * BLOCK: c * BLOCK + BLOCK] for c in coded[sel]])
        diff = np.flatnonzero(out[a:b] != src)
        if diff.size:
            blk = np.searchsorted(obase[sel] - a, diff, side="right") - 1
            wrong[j + np.unique(blk)] = True
    return int(np.count_nonzero(wrong))
