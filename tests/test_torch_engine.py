"""The write-path slice as a whole: the port's `LZ4Engine(device="cpu")`
against the reference's `LZ4Engine(use_pallas=True, candidate_impl="fused")`
(Pallas kernels in interpret mode).  Frames are bytes and stats are counts:
tolerance zero.
"""
import functools
import threading

import numpy as np
import pytest
import torch

from repro.core import LZ4Engine as JaxEngine
from repro.core import decode_frame_serial as jax_decode_serial
from repro.core.jax_compressor import compress_block_records as jax_records
from repro_torch import LZ4Engine, compat, decode_frame_serial, frame_info
from repro_torch.core.compressor import (
    BlockRecords,
    compress_block_bytes,
    compress_block_records,
    compress_blocks_records,
    records_to_plan,
    resolve_candidate_impl,
)
from repro_torch.core.emitter import emit_block_from_records

from test_torch_util import MAX_BLOCK, adversarial_corpus, multiblock_corpus, pad_stack

STAT_FIELDS = ("blocks", "dispatches", "raw_blocks", "bytes_in", "bytes_out",
               "host_bytes", "candidate_impl", "calls")
MICRO_BATCH = 4   # 5 blocks -> one full batch of 4 and a pow2 tail of 1


@functools.lru_cache(maxsize=None)
def _reference(device_emit=True, drain="sliced", scan_impl="sequential", **kw):
    eng = JaxEngine(**compat.engine_config(
        micro_batch=MICRO_BATCH, device_emit=device_emit, drain=drain,
        scan_impl=scan_impl, **kw), use_pallas=True, candidate_impl="fused")
    frame = eng.compress(multiblock_corpus())
    return frame, eng.stats.as_dict()


def _port(**kw):
    kw = compat.engine_config(micro_batch=MICRO_BATCH, use_pallas=True,
                              donate=None, mesh=None, shards=None, **kw)
    return LZ4Engine(device="cpu", **kw)


@pytest.mark.parametrize("scan_impl", ["sequential", "associative"])
@pytest.mark.parametrize("drain", ["sliced", "full"])
@pytest.mark.parametrize("device_emit", [True, False])
def test_frames_and_stats_equal_reference(device_emit, drain, scan_impl):
    data = multiblock_corpus()
    ref_frame, ref_stats = _reference(device_emit, drain, scan_impl)
    eng = _port(device_emit=device_emit, drain=drain, scan_impl=scan_impl)
    frame = eng.compress(data)
    assert frame == ref_frame
    got = eng.stats.as_dict()
    for f in STAT_FIELDS:
        assert got[f] == ref_stats[f], f
    assert got["raw_blocks"] >= 1 and got["dispatches"] == 2
    # Cross-decode both ways, and the engine's own decompress.
    assert jax_decode_serial(frame) == data
    assert decode_frame_serial(ref_frame) == data
    assert eng.decompress(ref_frame) == data


@pytest.mark.parametrize("kw", [dict(content_crc=True), dict(parity_group=2)],
                         ids=["content_crc", "parity_group"])
def test_trailer_and_parity_frames_equal_reference(kw):
    data = multiblock_corpus()
    ref_frame, ref_stats = _reference(**kw)
    eng = _port(**kw)
    frame = eng.compress(data)
    assert frame == ref_frame
    assert frame_info(frame)["version"] == (6 if "parity_group" in kw else 5)
    for f in STAT_FIELDS:
        assert eng.stats.as_dict()[f] == ref_stats[f], f
    assert decode_frame_serial(frame) == data


@pytest.mark.parametrize("device_emit", [True, False])
def test_compress_to_blocks_equal_reference(device_emit):
    data = multiblock_corpus()[: 2 * MAX_BLOCK + 100]
    ref = JaxEngine(micro_batch=MICRO_BATCH, device_emit=device_emit,
                    use_pallas=True, candidate_impl="fused")
    eng = _port(device_emit=device_emit)
    blocks = eng.compress_to_blocks(data)
    assert blocks == ref.compress_to_blocks(data)
    for f in STAT_FIELDS:
        assert eng.stats.as_dict()[f] == ref.stats.as_dict()[f], f
    assert eng.compress_to_blocks(b"") == ref.compress_to_blocks(b"")
    assert eng.stats.blocks == 1 and eng.stats.dispatches == 0


def test_empty_and_tiny_inputs():
    eng = _port()
    ref = JaxEngine(micro_batch=MICRO_BATCH, use_pallas=True,
                    candidate_impl="fused")
    for data in (b"", b"x", b"hello world, hello world, hello world!"):
        assert eng.compress(data) == ref.compress(data)
        assert eng.decompress(eng.compress(data)) == data


@pytest.mark.parametrize("name", ["text", "rle_runs", "tile_straddle",
                                  "top_bit_words", "short_13", "empty"])
def test_records_equal_reference_and_compat_round_trip(name):
    import jax.numpy as jnp

    data = adversarial_corpus()[name]
    stack, ns = pad_stack([data])
    ref = jax_records(jnp.asarray(stack[0]), jnp.int32(int(ns[0])),
                      candidate_impl="fused")
    ref_np = {k: np.asarray(getattr(ref, k))
              for k in ("emit", "pos", "length", "offset", "size")}
    rec = compress_block_records(torch.from_numpy(stack[0]), int(ns[0]))
    batched = BlockRecords(*(getattr(rec, k)[None] for k in ref_np))
    got = compat.records_to_numpy(batched)
    for k, v in ref_np.items():
        np.testing.assert_array_equal(got[k][0], v, (name, k))
    # numpy -> BlockRecords -> numpy is the identity ...
    back = compat.records_to_numpy(compat.records_from_numpy(**ref_np))
    for k, v in ref_np.items():
        np.testing.assert_array_equal(back[k][0], v)
        assert back[k].dtype == got[k].dtype
    # ... and the reference's records drive this package's host emitter to
    # the bytes this package's device path emits.
    out, size = compress_block_bytes(torch.from_numpy(stack[0]), int(ns[0]))
    ref_rec = compat.records_from_numpy(**ref_np)
    one = BlockRecords(ref_rec.emit[0], ref_rec.pos[0], ref_rec.length[0],
                       ref_rec.offset[0], ref_rec.size[0])
    assert out[: int(size)].numpy().tobytes() == \
        emit_block_from_records(data, one, len(data))
    plan = records_to_plan(one, len(data))
    assert sum(s.lit_len + s.match_len for s in plan) == len(data)


def test_engine_config_mapping_and_refusals():
    assert compat.engine_config(use_pallas=True, donate=False, micro_batch=8,
                                mesh=None, shards=None, drain="full") == \
        dict(micro_batch=8, drain="full", mesh=None, shards=None)
    # The fabric keywords pass through and run (the fabric against the
    # reference: tests/test_torch_fabric.py); a JAX mesh is refused.
    from repro.distributed.sharding import single_device_mesh as jax_mesh
    from repro_torch.distributed.sharding import make_mesh

    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    kw = compat.engine_config(mesh=mesh, shard_axes=("data",), use_pallas=True)
    assert kw == dict(mesh=mesh, shard_axes=("data",))
    data = multiblock_corpus()
    frame = LZ4Engine(device="cpu", scan_impl="associative", **kw).compress(data)
    assert frame == LZ4Engine(device="cpu", scan_impl="associative",
                              **compat.engine_config(shards=2)).compress(data)
    assert frame_info(frame)["shard_count"] == 2
    assert decode_frame_serial(frame) == data
    with pytest.raises(TypeError, match="make_mesh"):
        compat.engine_config(mesh=jax_mesh())
    assert resolve_candidate_impl("auto") == resolve_candidate_impl("fused") == "fused"
    data = b"staged path " * 400
    for impl in ("sort", "sortkey", "scatter"):
        # The staged names resolve to themselves and run.
        assert resolve_candidate_impl(impl) == impl
        eng = LZ4Engine(device="cpu", candidate_impl=impl)
        assert eng.decompress(eng.compress(data)) == data
        assert eng.stats.candidate_impl == impl
    with pytest.raises(ValueError):
        LZ4Engine(device="cpu", candidate_impl="bogus")
    with pytest.raises(ValueError):
        LZ4Engine(device="cpu", drain="lazy")
    with pytest.raises(ValueError):
        LZ4Engine(device="cpu", scan_impl="bogus")
    with pytest.raises(ValueError):
        LZ4Engine(device="cpu", micro_batch=0)
    with pytest.raises(ValueError):
        compress_blocks_records(torch.zeros((1, 100), dtype=torch.uint8),
                                torch.zeros((1,), dtype=torch.int32))


def test_totals_accumulate_across_threads_and_telemetry_keeps_bytes():
    from repro_torch import obs

    data = multiblock_corpus()[: MAX_BLOCK + 500]
    eng = _port(scan_impl="associative")
    plain = eng.compress(data)
    threads = [threading.Thread(target=eng.compress, args=(data,))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert eng.totals.calls == 4 and eng.totals.blocks == 8
    assert eng.totals.bytes_in == 4 * len(data)
    obs.reset()
    traced = _port(scan_impl="associative", telemetry=True)
    assert traced.compress(data) == plain
    names = {r["name"] for r in obs.tracer().finished()}
    assert {"compress.total", "compress.pad", "compress.dispatch",
            "compress.wait", "compress.frame"} <= names
    snap = obs.snapshot()["metrics"]
    assert "engine.blocks" in str(snap)
    obs.reset()
