"""The plain reference (`reference/lz4_paper.py`) held to the program on the
CPU, and the frame comparison on frames made wrong on purpose."""
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import corpus, harness  # noqa: E402
from portbench.reference import lz4_paper as ref  # noqa: E402

CORPUS = corpus.corpus(harness.CACHE / "cache")


def edge_blocks() -> list:
    """Corpus blocks (text, records, samples, the bitmap's long runs) and
    short or degenerate ones."""
    blocks = [CORPUS[i * 65536: (i + 1) * 65536] for i in (0, 3, 6, 9, 12, 15)]
    blocks += [b"", b"\x07", b"abcd" * 3, b"ab" * 6 + b"a", b"\x00" * 65536,
               b"\xaa" * 13 + b"\xbb" * 300 + b"\xaa" * 5000,
               bytes(range(256)) * 4 + b"Z" * 64, CORPUS[:65536 - 7] + b"tail567"]
    return blocks


@pytest.mark.parametrize("hash_bits,max_match,pws", [(8, 36, 8), (12, 36, 8),
                                                     (10, 68, 4), (8, 36, 16)])
def test_reference_compressor_equals_the_program(hash_bits, max_match, pws):
    from repro_torch import LZ4Engine

    eng = LZ4Engine(device="cpu", hash_bits=hash_bits, max_match=max_match,
                    pws=pws, candidate_impl="sortkey", scan_impl="associative",
                    micro_batch=16)
    blocks = edge_blocks()
    for block in blocks:
        got = eng.compress_to_blocks(block)
        assert len(got) == 1
        want = ref.encode(block, ref.sequences(block, hash_bits, pws, max_match))
        assert got[0] == want
        assert ref.decode_block(want) == block
        for _, _, length, _ in ref.sequences(block, hash_bits, pws, max_match)[:-1]:
            assert 4 <= length <= max_match


def test_sequences_keep_the_scheme():
    block = CORPUS[14 * 65536: 15 * 65536]          # the bitmap: long runs
    seqs = ref.sequences(block, 8, 8, 36)
    starts = [s + n for s, n, m, _ in seqs if m]
    assert len({p // 8 for p in starts}) == len(starts)    # one match a window
    assert max(m for _, _, m, _ in seqs) <= 36
    assert all(p <= len(block) - ref.MF_LIMIT for p in starts)
    assert seqs[-1][2] == 0 and seqs[-1][1] >= ref.LAST_LITERALS
    longer = ref.sequences(block, 8, 8, 68)
    assert max(m for _, _, m, _ in longer) > 36


@pytest.mark.parametrize("payload", [b"\xf0", b"\x10", b"\x14a\x00", b"\x00a"])
def test_decoder_refuses_malformed_blocks(payload):
    with pytest.raises(ValueError):
        ref.decode_block(payload)


def program_frame(obj: bytes) -> bytes:
    from repro_torch import LZ4Engine

    return LZ4Engine(device="cpu", candidate_impl="sortkey",
                     scan_impl="associative").compress(obj)


@pytest.fixture(scope="module")
def case():
    noise = np.random.default_rng(0).integers(0, 256, 65536, dtype=np.uint8)
    obj = CORPUS[: 3 * 65536] + noise.tobytes() + CORPUS[:1000]
    return obj, program_frame(obj), ref.block_crcs(obj)


def judge(frame, obj, crcs):
    return ref.check_frame(frame, obj, crcs, range(len(crcs)), 8, 8, 36)


def test_check_frame_passes_the_programs_frame(case):
    obj, frame, crcs = case
    info = ref.read_frame(frame)
    assert info["count"] == 5 and info["raw"].tolist() == [False] * 3 + [True, False]
    assert judge(frame, obj, crcs) == dict(table_errors=0, payload_errors=0,
                                           decode_errors=0)


def test_check_frame_catches_a_payload_byte(case):
    obj, frame, crcs = case
    info = ref.read_frame(frame)
    bad = bytearray(frame)
    bad[int(info["offsets"][1]) + 3] ^= 1
    assert judge(bytes(bad), obj, crcs) == dict(table_errors=0, payload_errors=1,
                                                decode_errors=1)
    bad = bytearray(frame)
    bad[int(info["offsets"][3]) + 3] ^= 1                  # a raw block
    assert judge(bytes(bad), obj, crcs)["table_errors"] == 1


def test_check_frame_catches_the_table(case):
    obj, frame, crcs = case
    at = 17 + 12 * 2 + 8                                   # block 2's CRC
    bad = frame[:at] + struct.pack("<I", 12345) + frame[at + 4:]
    assert judge(bad, obj, crcs)["table_errors"] == 1
    assert judge(frame[:-1], obj, crcs)["table_errors"] >= 1
    assert judge(b"LZ4X" + frame[4:], obj, crcs)["table_errors"] == 6


def test_check_frame_decodes_the_blocks_the_sample_leaves_out(case):
    obj, frame, crcs = case
    info = ref.read_frame(frame)
    bad = bytearray(frame)
    bad[int(info["offsets"][2]) + 9] ^= 0x5A
    got = ref.check_frame(bytes(bad), obj, crcs, [0, 4], 8, 8, 36)
    assert got == dict(table_errors=0, payload_errors=0, decode_errors=1)
    assert ref.check_frame(bytes(bad), obj, crcs, [0, 4], 8, 8, 36,
                           decode=False)["decode_errors"] is None


def test_block_decoder_equals_decode_block():
    blocks = edge_blocks()[:8] + [b"\x00" * 65536, b"ab" * 6 + b"a"]
    pays = [ref.encode(b, ref.sequences(b, hb, pws, mm))
            for b in blocks for hb, pws, mm in ((8, 8, 36), (10, 4, 68))]
    want = [b for b in blocks for _ in range(2)]
    malformed = [b"\xf0", b"\x10", b"\x14a\x00", b"\x00a", b"", b"\x1fa\x01\x00",
                 b"\x10a\x05\x00\x00"]               # the last: offset past the output
    pays += malformed
    usize = [len(b) for b in want] + [1, 1, 5, 1, 0, 100, 6]
    lens = np.array([len(p) for p in pays])
    starts = np.cumsum(lens) - lens
    out, ok = ref.decode_blocks(np.frombuffer(b"".join(pays), np.uint8),
                                starts, starts + lens, usize)
    assert ok.tolist() == [True] * len(want) + [False] * len(malformed)
    at = 0
    for b in want:
        assert out[at: at + len(b)].tobytes() == b
        at += len(b)
