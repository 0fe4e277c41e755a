"""Plain PyTorch versions of the kernels (the correctness references).

Every function here is batched: the leading axis ``M`` is the micro-batch of
blocks, and nothing is vmapped.  They run on whatever device their inputs
live on; on CPU tensors the kernel wrappers (`fused_compress.py`,
`emit_scatter.py`, `window_select.py`, `decode_wave.py`,
`plan_speculative.py`, `crc32.py`, `fibhash.py`, `match_extend.py`)
dispatch to them, and on the card they
are what each hand-written kernel is held against.

All arithmetic is integer, so every comparison against these functions is
exact (tolerance zero).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.lz4_types import HASH_PRIME, LAST_LITERALS, MF_LIMIT, MIN_MATCH

# Row layout of the per-sequence `fields` array consumed by the emit kernel
# (`emit_bytes_ref` here, `csrc/emit_scatter.cu` on the card).  One column
# per sequence: the W per-window sequences plus the final literals-only one.
F_START = 0       # output byte offset of the sequence's token
F_ANCHOR = 1      # input offset of the sequence's first literal
F_LIT = 2         # literal count
F_LIT_EXT = 3     # literal-length extension byte count
F_MLX = 4         # match length - MIN_MATCH (0 for the final sequence)
F_MATCH_EXT = 5   # match-length extension byte count
F_OFF = 6         # 16-bit match back-offset (0 for the final sequence)
F_HAS_MATCH = 7   # 1 where the sequence carries a match, 0 for the final one
N_FIELDS = 8

# Element budget of the (rows, W * E + 1) int32 hash-table-over-time grid that
# `scatter_candidates_ref` materializes; larger batches are processed in row
# chunks so the plain version's footprint stays bounded (the grid is 8 MB per
# block at hash_bits = 8 and 128 MB at 12).
_GRID_ELEMS = 1 << 25


def fibhash_ref(b0, b1, b2, b3, hash_bits: int):
    """Fibonacci hash of the little-endian 4-byte word at each position.

    b0..b3 are the byte streams shifted by 0..3 positions (any integer dtype,
    values in [0, 255]).  Returns ``(words, hashes)``: the word as the int32
    bit pattern of its uint32 value, and the hash in [0, 2^hash_bits).

    torch has no complete uint32, so the word lives in int64 and the 32-bit
    product ``(w * HASH_PRIME) mod 2^32`` is assembled from 16-bit halves —
    no intermediate leaves the int64 range.
    """
    w = (b0.to(torch.int64) | (b1.to(torch.int64) << 8)
         | (b2.to(torch.int64) << 16) | (b3.to(torch.int64) << 24))
    lo = (w & 0xFFFF) * HASH_PRIME
    hi = (((w >> 16) * HASH_PRIME) & 0xFFFF) << 16
    prod = (lo + hi) & 0xFFFFFFFF
    h = prod >> (32 - hash_bits)
    words = torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)
    return words, h.to(torch.int32)


def match_extend_ref(block, cand, valid, n, max_match: int):
    """Bounded extended-match length (the paper's feedforward S2 datapath).

    block : (M, B) byte values (any integer dtype)
    cand  : (M, P) int32 candidate position per position (garbage if ~valid)
    valid : (M, P) bool   4-byte match already confirmed at p
    n     : (M,) int32    true block lengths
    max_match : the match-length cap (paper: 36)

    Returns (M, P) int32 full match length (>= 4 where valid, 0 elsewhere),
    capped at max_match and at the end-of-block rule (match end <= n-5).
    """
    M, P = cand.shape
    B = block.shape[1]
    p = torch.arange(P, dtype=torch.int64, device=cand.device)[None, :]
    n = n.to(torch.int64)[:, None]
    cand = cand.to(torch.int64)
    max_extra = torch.clamp(n - LAST_LITERALS - (p + MIN_MATCH), 0,
                            max_match - MIN_MATCH)
    prefix = torch.ones((M, P), dtype=torch.bool, device=cand.device)
    length = torch.zeros((M, P), dtype=torch.int32, device=cand.device)
    for j in range(max_match - MIN_MATCH):
        cur = block[:, torch.clamp(p[0] + MIN_MATCH + j, 0, B - 1)]
        cnd = torch.gather(block, 1, torch.clamp(cand + MIN_MATCH + j, 0, B - 1))
        prefix = prefix & (cur == cnd) & (j < max_extra)
        length = length + prefix.to(torch.int32)
    return torch.where(valid, MIN_MATCH + length, torch.zeros_like(length))


def _scatter_candidates_chunk(hashes, n, hash_bits: int, pws: int):
    M, P = hashes.shape
    dev = hashes.device
    E = 1 << hash_bits
    W = P // pws
    p = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    valid_pos = p <= n.to(torch.int64)[:, None] - MIN_MATCH
    win = p // pws
    h = hashes.to(torch.int64)
    # Invalid positions go to one sentinel slot past the grid, sliced off
    # below (scatter_reduce_ does not drop out-of-range indices).
    key = torch.where(valid_pos, win * E + h, torch.full_like(h, W * E))
    table = torch.zeros((M, W * E + 1), dtype=torch.int32, device=dev)
    table.scatter_reduce_(1, key, (p + 1).to(torch.int32).expand(M, P),
                          reduce="amax", include_self=True)
    tm = table[:, : W * E].reshape(M, W, E)
    run_max = torch.cummax(tm, dim=1).values
    excl = torch.cat(
        [torch.zeros((M, 1, E), dtype=torch.int32, device=dev), run_max[:, :-1]],
        dim=1)
    idx = win * E + torch.clamp(h, 0, E - 1)
    cand = torch.gather(excl.reshape(M, W * E), 1, idx) - 1
    return torch.where(valid_pos, cand, torch.full_like(cand, -1))


def scatter_candidates_ref(hashes, n, hash_bits: int, pws: int):
    """Scatter-max last-value-table candidate resolution (no sort).

    cand(p) = max{q : hash(q)=hash(p), win(q)<win(p)}: scatter positions
    into a (windows x entries) grid — the hash table materialized over
    time — exclusive cummax along the window axis, gather at
    (win(p), hash(p)).  hashes: (M, P) int32, n: (M,) int32.
    Returns (M, P) int32, -1 where no candidate / invalid position.
    """
    M, P = hashes.shape
    per_row = (P // pws) * (1 << hash_bits) + 1
    rows = max(1, _GRID_ELEMS // per_row)
    if M <= rows:
        return _scatter_candidates_chunk(hashes, n, hash_bits, pws)
    return torch.cat([
        _scatter_candidates_chunk(hashes[i: i + rows], n[i: i + rows],
                                  hash_bits, pws)
        for i in range(0, M, rows)
    ])


def fused_ref(block, n, positions: int, hash_bits: int, pws: int,
              max_match: int):
    """Plain version of the fused compression datapath (fused_compress.cu).

    One expression of hash -> last-value-table candidate -> word compare ->
    bounded extension.

    block     : (M, B) byte values (uint8 or any integer dtype); content at
                index >= n is ignored (treated as zero); B >= positions +
                max_match (the padded compressor block)
    n         : (M,) int32 true block lengths
    positions : position count P (P % pws == 0)

    Returns ``(cand, lengths)``: (M, P) int32 candidate position (-1 where
    none/invalid) and full match length (0 where no valid match, else in
    [MIN_MATCH, max_match]).
    """
    P = positions
    M, B = block.shape
    dev = block.device
    idx = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    block = torch.where(idx < n.to(torch.int64)[:, None], block,
                        torch.zeros_like(block))
    words, hashes = fibhash_ref(block[:, :P], block[:, 1: P + 1],
                                block[:, 2: P + 2], block[:, 3: P + 3],
                                hash_bits)
    p = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    cand = scatter_candidates_ref(hashes, n, hash_bits, pws)
    wc = torch.gather(words, 1, torch.clamp(cand.to(torch.int64), 0, P - 1))
    valid4 = (cand >= 0) & (wc == words) \
        & (p <= n.to(torch.int64)[:, None] - MF_LIMIT)
    lengths = match_extend_ref(block, cand, valid4, n, max_match)
    return cand, lengths


def emit_bytes_ref(block, seg, fields, total):
    """LZ4 byte materialization: (output position -> byte) via gathers.

    The inverse-scatter formulation of block emission: instead of scattering
    each sequence's ragged pieces into the output (variable-length writes),
    every output position k looks up its covering sequence `seg[k]` and
    derives its byte from the relative offset r = k - start alone:

        r == 0                         -> token
        1 <= r <= lit_ext              -> literal-length extension byte
        lit_ext < r <= lit_ext + lit   -> literal (one gather from the input)
        r == 1 + lit_ext + lit         -> offset low byte
        r == 2 + lit_ext + lit         -> offset high byte
        r beyond                       -> match-length extension byte

    block  : (M, B) input byte values (uint8 or any integer dtype)
    seg    : (M, K) int32 covering-sequence index per output position
    fields : (M, N_FIELDS, S) int32 per-sequence layout (see F_* rows above)
    total  : (M,) int32 exact compressed size; positions >= total emit 0

    Returns (M, K) uint8, bit-identical to `core.emitter.emit_block` on
    ``out[:total]``.
    """
    M, K = seg.shape
    B = block.shape[1]
    S = fields.shape[2]
    k = torch.arange(K, dtype=torch.int64, device=seg.device)[None, :]
    sg = torch.clamp(seg.to(torch.int64), 0, S - 1)
    f = fields.to(torch.int64)
    st, anc, lit, le, mlx, me, off, hm = (
        torch.gather(f[:, row], 1, sg) for row in range(N_FIELDS))

    r = k - st
    zero = torch.zeros_like(r)
    token = (torch.clamp(lit, max=15) << 4) \
        | torch.where(hm > 0, torch.clamp(mlx, max=15), zero)
    # Extension runs are (count-1) bytes of 255 followed by (value-15) % 255
    # (torch's % floors, like the reference's).
    ff = torch.full_like(r, 255)
    lit_ext_byte = torch.where(r < le, ff, (lit - 15) % 255)
    src = torch.clamp(anc + r - 1 - le, 0, B - 1)
    lit_byte = torch.gather(block, 1, src).to(torch.int64)
    lit_end = 1 + le + lit
    mext_byte = torch.where(r - (lit_end + 2) < me - 1, ff, (mlx - 15) % 255)
    b = torch.where(r == 0, token,
        torch.where(r <= le, lit_ext_byte,
        torch.where(r <= le + lit, lit_byte,
        torch.where(r == lit_end, off & 0xFF,
        torch.where(r == lit_end + 1, (off >> 8) & 0xFF, mext_byte)))))
    b = torch.where(k < total.to(torch.int64)[:, None], b, zero)
    return (b & 0xFF).to(torch.uint8)


def window_select_ref(valid, lengths, pws: int):
    """Paper-faithful window scan: one step per window, free-pointer carry.

    The plain version of `csrc/window_select.cu`: a Python loop over the
    W = P // pws windows, vectorized over the batch.  Per window the
    earliest eligible position (valid and >= the free pointer) is selected
    and the free pointer jumps past its match; a window with no eligible
    position reports its base position and the raw length there.

    valid   : (M, P) bool   position carries a usable match
    lengths : (M, P) int32  match length per position
    Returns ``(emit (M, W) bool, pos (M, W) int32, length (M, W) int32)``.
    """
    M, P = valid.shape
    W = P // pws
    dev = valid.device
    validw = valid.to(torch.bool).reshape(M, W, pws)
    lenw = lengths.to(torch.int32).reshape(M, W, pws)
    rel = torch.arange(pws, dtype=torch.int32, device=dev)[None, :]
    emit = torch.zeros((M, W), dtype=torch.bool, device=dev)
    pos = torch.zeros((M, W), dtype=torch.int32, device=dev)
    length = torch.zeros((M, W), dtype=torch.int32, device=dev)
    fp = torch.zeros((M,), dtype=torch.int32, device=dev)
    for w in range(W):
        base = w * pws
        elig = validw[:, w] & (rel + base >= fp[:, None])
        any_e = elig.any(dim=1)
        idx = torch.argmax(elig.to(torch.uint8), dim=1)
        sel_pos = (idx + base).to(torch.int32)
        sel_len = torch.gather(lenw[:, w], 1, idx[:, None])[:, 0]
        fp = torch.where(any_e, sel_pos + sel_len, fp)
        emit[:, w] = any_e
        pos[:, w] = sel_pos
        length[:, w] = sel_len
    return emit, pos, length


# -- read path ----------------------------------------------------------------

def _take_fill(src, idx):
    """``jnp.take(src, idx)`` row by row, with its out-of-range rule.

    A negative index in [-W, -1] wraps as numpy does; any other index outside
    [0, W) reads the fill value, INT32_MIN for int32, whose low byte is 0.
    Returns (M, K) int64 byte values: every result is a byte of ``src`` or 0.
    """
    W = src.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + W, idx)
    ok = (idx >= 0) & (idx < W)
    val = torch.gather(src.to(torch.int64), 1, idx.clamp(0, W - 1))
    return torch.where(ok, val, torch.zeros_like(val))


def decode_gather_ref(block, lit_blk, ptr, total, rounds: int):
    """Device-side block decode: transitive-source resolve + ONE byte gather.

    The plain version of `csrc/decode_wave.cu`.  Every output byte k carries
    its IMMEDIATE source — itself for literal bytes (a fixed point of the
    source map), ``k - offset`` for match bytes — and after `rounds` rounds
    of pointer doubling (``ptr = ptr[ptr]``) every chain of depth <= 2^rounds
    ends on a literal byte, whose value is ``block[lit_blk[ptr[k]]]``.

    block   : (M, B) compressed-payload bytes (uint8 or any integer dtype)
    lit_blk : (M, K) int32 literal source index into the block row; read
              as `jnp.take` reads it (see `_take_fill`), so a value out of
              range gives byte 0 and never reads outside the row
    ptr     : (M, K) int32 immediate source position, in [0, K) (the caller
              clips it, as `ops.decode_gather` does; it is clipped again here)
    total   : (M,) int32 decoded sizes; positions >= total emit 0
    rounds  : pointer-doubling rounds

    Returns (M, K) uint8, equal to `core.decode_plan.execute_device_plan`.
    """
    M, K = ptr.shape
    k = torch.arange(K, dtype=torch.int64, device=ptr.device)[None, :]
    p = ptr.to(torch.int64).clamp(0, K - 1)
    for _ in range(rounds):
        p = torch.gather(p, 1, p)
    src = torch.gather(lit_blk.to(torch.int64), 1, p)
    b = _take_fill(block, src)
    b = torch.where(k < total.to(torch.int64)[:, None], b, torch.zeros_like(b))
    return (b & 0xFF).to(torch.uint8)


def plan_fields_ref(block, n, chain_rounds: int = 16):
    """Candidate LZ4 header at every byte offset + the chain from offset 0.

    The plain version of `csrc/plan_speculative.cu`.  Every field of a
    sequence header is a pure function of its byte offset once the 0xFF-run
    table exists, so all offsets are decoded at once; the one chain actually
    reachable from offset 0 is then marked by pointer doubling over the
    next-header map.  The field math reproduces the host planner
    (`core.decode_plan.plan_block_fast`) byte for byte, including its
    clamped reads at ``min(pos, n - 1)`` and the run-table read at index
    ``n``, so the validator in `ops.plan_speculative` rejects malformed
    streams with the host planner's error codes.

    block        : (M, B) payload bytes (uint8 or any integer dtype); B must
                   be strictly greater than every n
    n            : (M,) int32 payload lengths
    chain_rounds : doubling rounds; 16 covers every chain of a 64 KB block
                   (each hop advances >= 3 bytes or ends at n)

    Returns seven (M, B) int32 tensors: is_start (1 where a header starts),
    lit_start, lit_len, ls_end (offset past the literals), off (16-bit back
    offset), mlen (match length), flags (bit 0: truncated literal-length
    extension, bit 1: truncated match-length extension).
    """
    M, B = block.shape
    dev = block.device
    blk = block.to(torch.int32)
    idx = torch.arange(B, dtype=torch.int32, device=dev)[None, :].expand(M, B)
    n = n.to(torch.int32)[:, None]
    inb = idx < n
    nm1 = torch.clamp(n - 1, min=0)

    def take(src, at):
        return torch.gather(src, 1, at.to(torch.int64))

    # ffrun[i] = length of the 0xFF run starting at i (0 at or past n): the
    # first non-0xFF position at or after i, by a reversed cummin, minus i.
    v = torch.where((blk == 255) & inb, torch.full_like(idx, B), idx)
    next_notff = torch.cummin(v.flip(1), dim=1).values.flip(1)
    ffrun = next_notff - idx

    lit_nib = blk >> 4
    has_lx = lit_nib == 15
    r1 = take(ffrun, torch.clamp(idx + 1, max=B - 1))
    term1 = idx + 1 + r1
    t1b = take(blk, torch.minimum(term1, nm1))
    lit_len = torch.where(has_lx, r1 * 255 + t1b + 15, lit_nib)
    lit_start = idx + 1 + torch.where(has_lx, 1 + r1, torch.zeros_like(r1))
    ls_end = lit_start + lit_len

    m_nib = blk & 15
    has_mx = m_nib == 15
    o0 = torch.minimum(ls_end, nm1)
    off = take(blk, o0) | (take(blk, torch.minimum(o0 + 1, nm1)) << 8)
    r2 = take(ffrun, torch.minimum(ls_end + 2, n))
    term2 = ls_end + 2 + r2
    t2b = take(blk, torch.minimum(term2, nm1))
    mlen = torch.where(has_mx, r2 * 255 + t2b + 19, m_nib + 4)
    nxt = ls_end + 2 + torch.where(has_mx, r2 + 1, torch.zeros_like(r2))

    flags = (has_lx & (term1 >= n)).to(torch.int32) \
        | ((has_mx & (term2 >= n)).to(torch.int32) << 1)

    # Chain select: mark holds the offsets reachable from 0 in < 2^r hops;
    # each round unions in the 2^r-hop successors (a scatter-max of the OLD
    # marks) and squares the pointer map.  jump stays in [0, B).
    jump = torch.where(inb, torch.minimum(nxt, n), idx).to(torch.int64)
    mark = (idx == 0).to(torch.int32)
    for _ in range(chain_rounds):
        mark = mark.scatter_reduce(1, jump, mark, reduce="amax",
                                   include_self=True)
        jump = torch.gather(jump, 1, jump)
    is_start = torch.where(inb, mark, torch.zeros_like(mark))
    return is_start, lit_start, lit_len, ls_end, off, mlen, flags


# CRC-32 (IEEE 802.3, reflected; zlib's and binascii's) ------------------------

CRC_POLY = 0xEDB88320
CRC_CHUNK = 64   # bytes per chunk of the plain version's first pass


def _multmodp(a: int, b: np.ndarray) -> np.ndarray:
    """a(x) * b(x) modulo the CRC polynomial, reflected bit order (zlib's
    `multmodp`); ``a`` is one value, ``b`` an array of uint32 values."""
    b = b.astype(np.uint64)
    p = np.zeros_like(b)
    for i in range(32):
        if a & (1 << (31 - i)):
            p ^= b
        b = np.where(b & 1, (b >> 1) ^ CRC_POLY, b >> 1)
    return p


@functools.lru_cache(maxsize=1)
def crc_byte_table() -> np.ndarray:
    """The 256-entry byte table of the reflected CRC-32."""
    t = np.arange(256, dtype=np.uint64)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ CRC_POLY, t >> 1)
    return t.astype(np.int64)


@functools.lru_cache(maxsize=1)
def crc_x2n_table() -> tuple[int, ...]:
    """x^(2^k) modulo the polynomial for k = 0..31 (zlib's `x2n_table`):
    multiplying a CRC register by x2n[k + 3] appends 2^k zero bytes."""
    t = [1 << 30]
    for _ in range(31):
        t.append(int(_multmodp(t[-1], np.array([t[-1]], np.uint64))[0]))
    return tuple(t)


@functools.lru_cache(maxsize=None)
def _shift_tables(log2_bytes: int) -> np.ndarray:
    """(4, 256) tables of the linear map "append 2^log2_bytes zero bytes" on
    a CRC register, one per register byte: the map of r is the XOR of
    table[j][(r >> 8j) & 0xFF]."""
    a = crc_x2n_table()[(log2_bytes + 3) & 31]
    b = np.arange(256, dtype=np.uint64)
    return np.stack([_multmodp(a, b << (8 * j)) for j in range(4)]).astype(np.int64)


def crc32_ref(data, n):
    """CRC-32 of ``data[m, :n[m]]`` for every row; == ``binascii.crc32``.

    The plain version of `csrc/crc32.cu`, vectorized over rows and chunks
    (never a byte loop over the row): each row is right-aligned in a buffer
    of whole chunks — leading zero bytes leave a zero-initialized CRC
    register at zero — with its first four bytes complemented, which is what
    the initial register 0xFFFFFFFF does to a stream of four or more bytes.
    Every chunk's register is computed independently (CRC_CHUNK serial
    table steps over all chunks at once), and neighbours are combined level
    by level: ``A^len(right) left ^ right``, where appending ``len`` zero
    bytes is a linear map applied through four byte tables.  All chunks
    have one length, so each level needs one map.  Rows with n < 4 take
    the plain byte-serial update (at most three steps).

    data : (M, K) uint8;  n : (M,) int32 with 0 <= n <= K.
    Returns (M,) int64 holding the unsigned CRC.
    """
    M, K = data.shape
    dev = data.device
    n64 = n.to(torch.int64)
    T = torch.as_tensor(crc_byte_table(), device=dev)
    out = torch.zeros((M,), dtype=torch.int64, device=dev)
    if M == 0 or K == 0:
        return out
    nch = 1 << max(0, (-(-K // CRC_CHUNK) - 1).bit_length())
    L = nch * CRC_CHUNK
    q = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    src = q - (L - n64)[:, None]
    vals = torch.gather(data, 1, src.clamp(0, K - 1)).to(torch.int64)
    vals = torch.where(src >= 0, vals, torch.zeros_like(vals))
    head = (src >= 0) & (src < 4) & (n64 >= 4)[:, None]
    vals = vals ^ torch.where(head, 0xFF, 0)
    v = vals.view(M, nch, CRC_CHUNK)
    c = torch.zeros((M, nch), dtype=torch.int64, device=dev)
    for j in range(CRC_CHUNK):
        c = T[(c ^ v[:, :, j]) & 0xFF] ^ (c >> 8)
    level = CRC_CHUNK.bit_length() - 1
    while c.shape[1] > 1:
        S = torch.as_tensor(_shift_tables(level), device=dev)
        left, right = c[:, 0::2], c[:, 1::2]
        c = (S[0][left & 0xFF] ^ S[1][(left >> 8) & 0xFF]
             ^ S[2][(left >> 16) & 0xFF] ^ S[3][(left >> 24) & 0xFF]) ^ right
        level += 1
    long_crc = c[:, 0] ^ 0xFFFFFFFF
    # n < 4: the byte-serial update from the initial register.
    s = torch.full((M,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    for j in range(min(3, K)):
        upd = T[(s ^ data[:, j].to(torch.int64)) & 0xFF] ^ (s >> 8)
        s = torch.where(j < n64, upd, s)
    return torch.where(n64 >= 4, long_crc, s ^ 0xFFFFFFFF)
