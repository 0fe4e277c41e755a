"""The write path's sliced drain on the CPU: a micro-batch's coded payloads
packed on the device and brought to the host in ONE copy, each coded block's
payload a view of it.

Held against the JAX package's `LZ4Engine` (frames and `EngineStats`, host
bytes included, tolerance zero) and against the port's own ``drain="full"``
path, which fetches whole emit buffers: corpora with no, some and only raw
blocks and pow2 tails (one padded row included); `compress_to_blocks`, whose
raw-bound blocks are fetched alone; the fabric's host path, which asks for
payloads after later micro-batches were drained; the
``engine.drain_*`` counters and spans; and the benchmark's planted write
fault, which must still reach the frame.  Both packages compress with
``candidate_impl="sortkey"`` (the port with ``scan_impl="associative"``, the
same frames), so `EngineStats` agree field by field.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import LZ4Engine as JaxEngine
from repro_torch import LZ4Engine, decode_frame_serial, frame_info, obs

from test_torch_util import MAX_BLOCK, fabric_corpus, rng

ROOT = Path(__file__).resolve().parent.parent
PORT = dict(device="cpu", candidate_impl="sortkey", scan_impl="associative")
REF = dict(candidate_impl="sortkey")
MICRO_BATCH = 4
TAIL = 3000
# Raw flag of each block (the last one TAIL bytes).  Seven blocks: a batch of
# four, then a tail of three padded to four (one row with n = 0); five: a
# tail of one.
CORPORA = {
    "none_raw": [False] * 7,
    "some_raw": [False, True, False, False, False, True, False],
    "all_raw": [True] * 7,
    "some_raw_tail1": [False, False, True, False, False],
}


def corpus(raw: list[bool], seed: int = 28) -> bytes:
    """Noise where ``raw`` says (stored raw), elsewhere text or a small
    alphabet (coded, at payload sizes that differ block to block)."""
    r = rng(seed)
    parts = []
    for i, noise in enumerate(raw):
        n = TAIL if i == len(raw) - 1 else MAX_BLOCK
        if noise:
            parts.append(r.integers(0, 256, n, np.uint8).tobytes())
        elif i % 2:
            parts.append(r.integers(0, 4 + i, n, np.uint8).tobytes())
        else:
            parts.append(((b"drain block %d, " % i) * (n // 14 + 1))[:n])
    return b"".join(parts)


def port(**kw) -> LZ4Engine:
    return LZ4Engine(**{**PORT, "micro_batch": MICRO_BATCH, **kw})


def counter(name: str):
    return obs.registry().counter(name).value


def coded_dispatches(raw: list[bool], micro_batch: int = MICRO_BATCH) -> int:
    return sum(not all(raw[i: i + micro_batch])
               for i in range(0, len(raw), micro_batch))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_frames_and_stats_equal_reference(name):
    raw = CORPORA[name]
    data = corpus(raw)
    eng = port()
    frame = eng.compress(data)
    ref = JaxEngine(micro_batch=MICRO_BATCH, **REF)
    assert frame == ref.compress(data)
    assert eng.stats.as_dict() == ref.stats.as_dict()
    assert eng.stats.raw_blocks == sum(raw)
    assert [b["raw"] for b in frame_info(frame)["blocks"]] == raw
    assert port(drain="full").compress(data) == frame
    assert decode_frame_serial(frame) == data


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_one_payload_copy_a_dispatch_with_telemetry(name):
    raw = CORPORA[name]
    data = corpus(raw)
    want = port().compress(data)
    obs.reset()
    try:
        eng = port(telemetry=True)
        assert eng.compress(data) == want
        copies = coded_dispatches(raw)
        assert copies == (0 if all(raw) else eng.stats.dispatches)
        assert counter("engine.drain_copies") == copies
        assert counter("engine.drain_fallback_blocks") == 0
        drains = [r for r in obs.tracer().finished()
                  if r["name"] == "compress.drain"]
        assert len(drains) == copies
        assert {r["parent"] for r in drains} <= {"compress.total"}
        # The copies carry the coded payloads, nothing else.
        coded = sum(b["csize"] for b in frame_info(want)["blocks"]
                    if not b["raw"])
        assert sum(r["args"]["bytes"] for r in drains) == coded
    finally:
        obs.reset()


@pytest.mark.parametrize("name", ["some_raw", "all_raw"])
def test_compress_to_blocks_fetches_raw_bound_blocks_alone(name):
    """`compress_to_blocks` asks for every payload: the blocks `compress`
    would store raw are not in the packed copy and are fetched one by one."""
    raw = CORPORA[name]
    data = corpus(raw)
    ref = JaxEngine(micro_batch=MICRO_BATCH, **REF)
    want = ref.compress_to_blocks(data)
    assert port(drain="full").compress_to_blocks(data) == want
    obs.reset()
    try:
        eng = port(telemetry=True)
        assert eng.compress_to_blocks(data) == want
        assert eng.stats.as_dict() == ref.stats.as_dict()
        assert counter("engine.drain_fallback_blocks") == sum(raw)
        assert counter("engine.drain_copies") == (coded_dispatches(raw)
                                                  + sum(raw))
    finally:
        obs.reset()


@pytest.mark.parametrize("shards", [2, 4])
def test_fabric_host_path_asks_for_payloads_after_later_micro_batches(shards):
    """The host path lists every shard's micro-batches before it asks for
    one payload: each payload still holds its own bytes after the copies of
    the micro-batches drained after it."""
    data = fabric_corpus(12, seed=280 + shards)
    eng = LZ4Engine(shards=shards, micro_batch=2, **PORT)
    frame = eng.compress(data)
    ref = JaxEngine(shards=shards, micro_batch=2, **REF)
    assert frame == ref.compress(data)
    assert eng.stats.as_dict() == ref.stats.as_dict()
    assert eng.stats.dispatches > shards
    assert frame == LZ4Engine(shards=shards, micro_batch=2, drain="full",
                              **PORT).compress(data)
    assert decode_frame_serial(frame) == data
    blocks = eng.compress_to_blocks(data)
    assert blocks == LZ4Engine(micro_batch=2, **PORT).compress_to_blocks(data)


def test_planted_write_fault_reaches_the_frame():
    """The benchmark's write fault (one byte of one row of every dispatch,
    altered where `compress_blocks_bytes` returns it) is packed and shows in
    exactly that block's payload."""
    sys.path.insert(0, str(ROOT))
    from portbench.drivers.compress import FAULT_BYTE, FAULT_ROW, plant_fault

    raw = [False] * 8
    data = corpus(raw)
    eng = port(micro_batch=8)
    clean = eng.compress(data)
    with plant_fault():
        broken = eng.compress(data)

    def payloads(frame):
        return [frame[b["offset"]: b["offset"] + b["csize"]]
                for b in frame_info(frame)["blocks"]]

    got, want = payloads(broken), payloads(clean)
    assert [j for j in range(len(raw)) if got[j] != want[j]] == [FAULT_ROW]
    diff = [i for i, (a, b) in enumerate(zip(got[FAULT_ROW], want[FAULT_ROW]))
            if a != b]
    assert diff == [FAULT_BYTE]
    assert got[FAULT_ROW][FAULT_BYTE] == want[FAULT_ROW][FAULT_BYTE] ^ 0x5A
