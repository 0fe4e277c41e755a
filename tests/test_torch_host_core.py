"""Host-side modules of the port against the reference's: frame v1-v6,
block emitter and decoder, error hierarchy.  Bytes in, bytes out: equality.
"""
import numpy as np
import pytest

from repro.core import decoder as jdec
from repro.core import emitter as jemit
from repro.core import frame as jframe
from repro.core import lz4_types as jtypes
from repro_torch.core import decoder as tdec
from repro_torch.core import emitter as temit
from repro_torch.core import frame as tframe
from repro_torch.core import lz4_types as ttypes
from repro_torch.core.corpus import corpus_blocks, corpus_files
from repro_torch.core.decode_engine import LZ4DecodeEngine
from repro_torch.resilience.errors import FrameError

from test_torch_util import MAX_BLOCK, rng


def _blocks():
    """Six (payload, usize, raw, crc) blocks: raw noise + LZ4 payloads."""
    r = rng(11)
    chunks = [b"abcabcabc" * 500, r.integers(0, 256, 700, np.uint8).tobytes(),
              b"\x00" * 4096, b"", b"z" * 17,
              r.integers(0, 3, 5000, np.uint8).tobytes()]
    payloads, usizes, raws, crcs = [], [], [], []
    for i, c in enumerate(chunks):
        raw = i % 2 == 1
        # A literals-only LZ4 block is valid for any content.
        payloads.append(c if raw else temit.emit_block(c, [], [], [], [], len(c)))
        usizes.append(len(c))
        raws.append(raw)
        crcs.append(tframe.block_crc(c))
    return chunks, payloads, usizes, raws, crcs


FRAME_KW = {
    "v1": lambda crcs, data: dict(),
    "v2": lambda crcs, data: dict(checksums=crcs, content_size=False),
    "v3": lambda crcs, data: dict(checksums=crcs),
    "v4": lambda crcs, data: dict(checksums=crcs, shards=[0, 0, 1, 1, 3, 3],
                                  shard_count=5),
    "v5": lambda crcs, data: dict(checksums=crcs,
                                  content_crc=tframe.block_crc(data)),
    "v6": lambda crcs, data: dict(checksums=crcs,
                                  content_crc=tframe.block_crc(data),
                                  parity_group=4),
}


@pytest.mark.parametrize("version", list(FRAME_KW))
def test_encode_frame_bytes_equal_and_cross_decode(version):
    chunks, payloads, usizes, raws, crcs = _blocks()
    data = b"".join(chunks)
    kw = FRAME_KW[version](crcs, data)
    f_t = tframe.encode_frame(payloads, usizes, raws, **kw)
    f_j = jframe.encode_frame(payloads, usizes, raws, **kw)
    assert f_t == f_j
    assert tframe.frame_info(f_j) == jframe.frame_info(f_t)
    assert tframe.scan_frame(f_j) == jframe.scan_frame(f_t)
    # Each package's serial decoder reads the other's frame.
    assert tframe.decode_frame_serial(f_j) == data
    assert jframe.decode_frame_serial(f_t) == data
    assert tframe.decode_frame_serial(f_j, bytewise=True) == data
    # The port's decode engine (device executor, plain versions on the CPU).
    assert LZ4DecodeEngine(device="cpu").decode(f_j) == data


def test_constants_and_size_helpers_equal():
    for name in ("MIN_MATCH", "MF_LIMIT", "LAST_LITERALS", "MAX_OFFSET",
                 "HASH_PRIME", "MAX_BLOCK", "DEFAULT_PWS", "DEFAULT_MAX_MATCH",
                 "DEFAULT_HASH_BITS"):
        assert getattr(ttypes, name) == getattr(jtypes, name), name
    for count in range(0, 70):
        for cap in (1, 2, 8, 32):
            assert ttypes.pad_pow2_count(count, cap) == jtypes.pad_pow2_count(count, cap)
    for v in (0, 14, 15, 16, 269, 270, 271, 600):
        assert ttypes.lit_ext_bytes(v) == jtypes.lit_ext_bytes(v)
        assert ttypes.match_ext_bytes(v + 4) == jtypes.match_ext_bytes(v + 4)
    s = ttypes.Sequence(0, 3, 9, 2)
    assert ttypes.sequence_size(s) == jtypes.sequence_size(jtypes.Sequence(0, 3, 9, 2))
    assert ttypes.MAX_BLOCK == MAX_BLOCK


@pytest.mark.parametrize("lit", [0, 14, 15, 16, 269, 270, 271])
@pytest.mark.parametrize("mlen", [4, 18, 19, 20, 273, 274, 275])
def test_emit_block_and_decode_block_equal(lit, mlen):
    """One match after `lit` literals, at the token-nibble and extension-byte
    boundaries of both length fields."""
    r = rng(lit * 1000 + mlen)
    head = r.integers(0, 256, max(lit, 1), np.uint8).tobytes()
    data = head + bytes([head[-1]]) * (mlen + 8)
    pos = max(lit, 1)
    args = (data, [True], [pos], [mlen], [1], len(data))
    if lit == 0:
        # A match cannot start at 0: shift by one literal, keep the length.
        args = (data, [True], [1], [mlen], [1], len(data))
    b_t, b_j = temit.emit_block(*args), jemit.emit_block(*args)
    assert b_t == b_j
    assert tdec.decode_block(b_j, max_out=len(data)) == data
    assert jdec.decode_block(b_t, max_out=len(data)) == data
    assert tdec.decode_block_bytewise(b_t, max_out=len(data)) == data


def test_corpus_equal():
    from repro.core import corpus as jcorpus

    assert corpus_files() == jcorpus.corpus_files()
    assert corpus_blocks()[:4] == jcorpus.corpus_blocks()[:4]


def _mutants(frame: bytes, nblocks: int):
    yield "bad magic", b"XXXX" + frame[4:]
    yield "bad version", frame[:4] + b"\x63" + frame[5:]
    yield "truncated header", frame[:6]
    yield "truncated table", frame[:20]
    yield "truncated payload", frame[:-3]
    yield "trailing bytes", frame + b"\x00"
    flipped = bytearray(frame)
    flipped[-1] ^= 0xFF
    yield "flipped last payload byte", bytes(flipped)
    table = 9 + 8  # v3 header: 9-byte base + 8-byte content size
    lied = bytearray(frame)
    lied[table] ^= 0x01   # block 0 usize
    yield "usize lie", bytes(lied)
    crc = bytearray(frame)
    crc[table + 8] ^= 0x40  # block 0 crc
    yield "crc flip", bytes(crc)
    size = bytearray(frame)
    size[9] ^= 0x02  # header content size
    yield "content size lie", bytes(size)


def test_corrupt_frames_rejected_identically():
    chunks, payloads, usizes, raws, crcs = _blocks()
    frame = tframe.encode_frame(payloads, usizes, raws, checksums=crcs)
    for label, mutant in _mutants(frame, len(payloads)):
        with pytest.raises(jframe.FrameFormatError) as ej:
            jframe.decode_frame_serial(mutant)
        with pytest.raises(tframe.FrameFormatError) as et:
            tframe.decode_frame_serial(mutant)
        assert str(et.value) == str(ej.value), label
        assert type(et.value).__name__ == type(ej.value).__name__, label
        assert et.value.cause == ej.value.cause, label
        assert et.value.block_index == ej.value.block_index, label
        assert isinstance(et.value, (tdec.LZ4FormatError, FrameError)), label


def test_corrupt_blocks_rejected_identically():
    good = temit.emit_block(b"abcdabcdabcdabcdabcdabcd", [True], [4], [12], [4], 24)
    for label, bad in [("truncated", good[:-2]), ("empty", b""),
                       ("zero offset", good[:5] + b"\x00\x00" + good[7:]),
                       ("offset before start", good[:5] + b"\xff\x7f" + good[7:])]:
        with pytest.raises(jdec.LZ4FormatError) as ej:
            jdec.decode_block(bad, max_out=24)
        with pytest.raises(tdec.LZ4FormatError) as et:
            tdec.decode_block(bad, max_out=24)
        assert str(et.value) == str(ej.value), label


def test_parity_and_xor_equal():
    _, payloads, *_ = _blocks()
    assert tframe.parity_group_blocks(payloads, 2) == jframe.parity_group_blocks(payloads, 2)
    assert tframe.xor_bytes(payloads[:3]) == jframe.xor_bytes(payloads[:3])
    with pytest.raises(tframe.FrameFormatError):
        tframe.check_block(0, 5, tframe.block_crc(b"hello"), b"hellx")
