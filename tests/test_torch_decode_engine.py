"""The read-path slice as a whole: the port's `LZ4DecodeEngine(device="cpu")`
(the device executor through the kernels' plain versions, and the host
executors) against the reference's `LZ4DecodeEngine` built from the same
keywords (`compat.decode_engine_config`).  Decoded bytes, `DecodeStats`
field by field, error messages on the corruption sweeps, spans: equality.
"""
import functools
import multiprocessing

import numpy as np
import pytest
import torch

from repro.core import DevicePlanCaps as JaxCaps
from repro.core import FrameFormatError as JaxFrameError
from repro.core import FrameReader as JaxReader
from repro.core import LZ4DecodeEngine as JaxDecodeEngine
from repro.core import compress_windowed, encode_block
from repro.core import decode_frame_serial as jax_decode_serial
from repro.core import frame as jframe
from repro.core.decoder import LZ4FormatError as JaxFormatError
from repro_torch import (
    DecodeStats,
    FrameReader,
    LZ4DecodeEngine,
    LZ4Engine,
    compat,
    decode_frame_serial,
)
from repro_torch.core import frame as tframe
from repro_torch.core.decode_plan import DevicePlanCaps
from repro_torch.core.decoder import LZ4FormatError

from test_torch_util import MAX_BLOCK, multiblock_corpus

MICRO_BATCH = 2


@functools.lru_cache(maxsize=1)
def frames() -> dict[str, tuple[bytes, bytes]]:
    """name -> (frame, data): the engine corpus as v3 (a raw block, RLE and
    ragged tail), rebuilt as v5 and v6, an empty and a tiny frame, and a
    one-block text frame for the corruption sweeps."""
    data = multiblock_corpus()
    eng = LZ4Engine(device="cpu", micro_batch=4)
    v3 = eng.compress(data)
    info = tframe.frame_info(v3)
    payloads = [v3[b["offset"]: b["offset"] + b["csize"]] for b in info["blocks"]]
    usizes = [b["usize"] for b in info["blocks"]]
    raws = [b["raw"] for b in info["blocks"]]
    crcs = [b["crc"] for b in info["blocks"]]
    out = {"v3": (v3, data)}
    out["v5"] = (tframe.encode_frame(payloads, usizes, raws, checksums=crcs,
                                     content_crc=tframe.block_crc(data)), data)
    out["v6"] = (tframe.encode_frame(payloads, usizes, raws, checksums=crcs,
                                     content_crc=tframe.block_crc(data),
                                     parity_group=2), data)
    for name, d in (("empty", b""), ("tiny", b"xyz"),
                    ("text", b"fuzz me gently, " * 900)):
        out[name] = (eng.compress(d), d)
    return out


def engines(**cfg):
    """(port engine on the CPU, reference engine) from one keyword set."""
    cfg = dict(micro_batch=MICRO_BATCH, use_pallas=False, **cfg)
    port = LZ4DecodeEngine(device="cpu", **compat.decode_engine_config(**cfg))
    return port, JaxDecodeEngine(**cfg)


CONFIGS = {
    "serial": dict(executor="serial"),
    "thread": dict(executor="thread", workers=2),
    "process": dict(executor="process", workers=2),
    "device": dict(executor="device"),
    "device_static_rounds": dict(executor="device", adaptive_rounds=False),
    "device_plan_on_device": dict(executor="device", plan_on_device=True),
}
DEVICE_CONFIGS = ["device", "device_static_rounds", "device_plan_on_device"]


def assert_stats_equal(port, ref, label):
    got, want = port.stats.as_dict(), ref.stats.as_dict()
    assert got == want, (label, got, want)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_decode_bytes_and_stats_equal_reference(config):
    port, ref = engines(**CONFIGS[config])
    try:
        for name, (frame, data) in frames().items():
            assert port.decode(frame) == data, name
            assert ref.decode(frame) == data, name
            assert_stats_equal(port, ref, (config, name))
        assert port.totals.as_dict() == ref.totals.as_dict()
        if config in ("thread", "process"):
            assert port.totals.parallel
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("config", ["serial", "device", "device_plan_on_device"])
def test_decode_blocks_equal_reference(config):
    port, ref = engines(**CONFIGS[config])
    data = multiblock_corpus()[: 3 * MAX_BLOCK]
    payloads = LZ4Engine(device="cpu").compress_to_blocks(data)
    usizes = [min(MAX_BLOCK, len(data) - i * MAX_BLOCK)
              for i in range(len(payloads))]
    raws = [False] * len(payloads)
    assert b"".join(port.decode_blocks(payloads, raws, usizes=usizes)) == data
    assert port.decode_blocks(payloads, raws) == ref.decode_blocks(payloads, raws)
    assert_stats_equal(port, ref, config)
    with pytest.raises(LZ4FormatError) as et:
        port.decode_blocks(payloads[:1], [False], usizes=[usizes[0] - 1])
    with pytest.raises(JaxFormatError) as ej:
        ref.decode_blocks(payloads[:1], [False], usizes=[usizes[0] - 1])
    assert str(et.value) == str(ej.value)
    with pytest.raises(LZ4FormatError) as et:
        port.decode_blocks([b"\x10A\x00\x00\x10B"], [False])
    with pytest.raises(JaxFormatError) as ej:
        ref.decode_blocks([b"\x10A\x00\x00\x10B"], [False])
    assert str(et.value) == str(ej.value) == "zero offset"


@pytest.mark.parametrize("plan_on_device", [False, True])
def test_caps_overflow_falls_back_counted(plan_on_device):
    tiny = dict(max_lit=2, max_match=2)
    port = LZ4DecodeEngine(device="cpu", plan_on_device=plan_on_device,
                           caps=DevicePlanCaps(**tiny), micro_batch=MICRO_BATCH)
    ref = JaxDecodeEngine(executor="device", plan_on_device=plan_on_device,
                          caps=JaxCaps(**tiny), micro_batch=MICRO_BATCH)
    frame, data = frames()["v3"]
    assert port.decode(frame) == ref.decode(frame) == data
    assert_stats_equal(port, ref, "caps")
    st = port.stats
    assert st.fallback_blocks == st.blocks - st.raw_blocks and st.device_blocks == 0
    dev = port.decode_to_device(frame)
    assert dev.numpy().tobytes() == data
    ref.decode_to_device(frame)
    assert_stats_equal(port, ref, "caps to_device")


@pytest.mark.parametrize("plan_on_device", [False, True])
def test_decode_to_device_transfers_no_content(plan_on_device):
    port, ref = engines(executor="device", plan_on_device=plan_on_device)
    for name in ("v3", "v5", "v6", "empty", "tiny"):
        frame, data = frames()[name]
        for verify in (True, False):
            dev = port.decode_to_device(frame, verify=verify)
            assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
            assert dev.device == port.device
            assert dev.numpy().tobytes() == data, (name, verify)
            assert port.stats.host_bytes == 0
            assert np.asarray(ref.decode_to_device(frame, verify=verify)
                              ).tobytes() == data
            assert_stats_equal(port, ref, (name, verify))
    # A payload flip deep in a literal run parses, and only a CRC sees it.
    frame, _ = frames()["text"]
    mutant = bytearray(frame)
    mutant[-7] ^= 0x40
    with pytest.raises(tframe.FrameFormatError) as et:
        port.decode_to_device(bytes(mutant))
    with pytest.raises(JaxFrameError) as ej:
        ref.decode_to_device(bytes(mutant))
    assert str(et.value) == str(ej.value)
    # A table entry that lies about the size is caught with verify=False too.
    payload = LZ4Engine(device="cpu").compress_to_blocks(b"short block " * 50)[0]
    lying = tframe.encode_frame([payload], [620], [False],
                                checksums=[tframe.block_crc(b"short block " * 50)])
    with pytest.raises(tframe.FrameFormatError, match="table says") as et:
        port.decode_to_device(lying, verify=False)
    with pytest.raises(JaxFrameError) as ej:
        ref.decode_to_device(lying, verify=False)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("config", ["serial", "device", "device_plan_on_device"])
def test_reader_ranges_equal_reference(config):
    port, ref = engines(**CONFIGS[config])
    frame, data = frames()["v3"]
    rp, rr = FrameReader(frame, engine=port), JaxReader(frame, engine=ref)
    assert rp.block_count == rr.block_count and rp.usize == rr.usize == len(data)
    cases = [(0, 0), (0, 1), (len(data), 0), (len(data) - 1, 1),
             (MAX_BLOCK - 3, 7), (MAX_BLOCK, MAX_BLOCK), (70000, 90000)]
    for start, length in cases:
        want = data[start: start + length]
        assert rp.read_range(start, length) == rr.read_range(start, length) == want
        dev = rp.read_range_device(start, length)
        assert dev.numpy().tobytes() == want, (start, length)
        rr.read_range_device(start, length)
        # Reader reads count into the engine's last call, in both packages.
        assert_stats_equal(port, ref, (start, length))
    for i in range(rp.block_count):
        assert rp.read_block(i) == rr.read_block(i)
        assert rp.block_range(i) == rr.block_range(i)
    assert rp.read() == data
    with pytest.raises(ValueError):
        rp.read_range(len(data), 1)
    with pytest.raises(IndexError):
        rp.read_block(rp.block_count)


def _outcome(fn, frame):
    try:
        out = fn(frame)
        return "ok", out if isinstance(out, bytes) else np.asarray(out).tobytes()
    except (tframe.FrameFormatError, JaxFrameError) as e:
        return type(e).__name__, str(e)


def _mutants(frame: bytes):
    n = len(frame)
    for pos in list(range(min(48, n))) + list(range(48, n, max(1, n // 40))) + [n - 1]:
        m = bytearray(frame)
        m[pos] ^= 0x40
        yield bytes(m)
    for cut in range(0, n, max(1, n // 15)):
        yield frame[:cut]


@pytest.mark.parametrize("config", ["device", "device_plan_on_device"])
def test_corruption_sweeps_raise_the_reference_messages(config):
    """Byte flips and truncations (the reference's device-decode sweep):
    every mutant decodes to the same bytes or raises the same message as
    the reference engine, through `decode` and `decode_to_device`."""
    port, ref = engines(**CONFIGS[config])
    frame, data = frames()["text"]
    for mutant in _mutants(frame):
        for method in ("decode", "decode_to_device"):
            got = _outcome(getattr(port, method), mutant)
            want = _outcome(getattr(ref, method), mutant)
            assert got == want, (method, got, want)
        try:
            serial = decode_frame_serial(mutant)
        except tframe.FrameFormatError:
            serial = None
        got = _outcome(port.decode, mutant)
        assert (got[0] == "ok") == (serial is not None)
        if serial is not None:
            assert got[1] == serial == data


def test_frames_of_either_package_decode_in_the_other():
    chunks = [b"the quick brown fox jumps over the lazy dog. " * 300,
              b"\x00" * 5000 + b"tail"]
    payloads = [encode_block(c, compress_windowed(c, hash_bits=8,
                                                  max_match=36).sequences)
                for c in chunks]
    data = b"".join(chunks)
    jax_frame = jframe.encode_frame(payloads, [len(c) for c in chunks],
                                    [False, False],
                                    checksums=[jframe.block_crc(c) for c in chunks],
                                    content_crc=jframe.block_crc(data))
    for kw in (dict(), dict(plan_on_device=True), dict(executor="serial")):
        assert LZ4DecodeEngine(device="cpu", **kw).decode(jax_frame) == data
    port_frame, port_data = frames()["v5"]
    assert JaxDecodeEngine(executor="device").decode(port_frame) == port_data
    assert jax_decode_serial(port_frame) == port_data


def test_defaults_to_the_card_and_says_so(monkeypatch):
    from repro_torch.core import decode_engine as dem
    from repro_torch.core import frame as fmod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dem.default_decode_engine.cache_clear()
    with pytest.raises(RuntimeError, match='LZ4DecodeEngine runs on a CUDA device'):
        LZ4DecodeEngine()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fmod.decode_frame(frames()["tiny"][0])
    with pytest.raises(RuntimeError, match="is_available"):
        LZ4DecodeEngine(device="cuda", executor="serial")
    eng = LZ4DecodeEngine(device="cpu")
    assert eng.executor == "device" and eng.device == torch.device("cpu")
    writer = LZ4Engine(device="cpu")
    assert writer.decoder.device == writer.device
    assert writer.decoder.executor == "device"
    frame, data = frames()["tiny"]
    assert writer.decompress(frame) == data
    assert writer.decoder.stats.device_blocks + writer.decoder.stats.raw_blocks == 1


def test_process_executor_uses_spawn():
    eng = LZ4DecodeEngine(device="cpu", executor="process", workers=2)
    try:
        frame, data = frames()["v3"]
        assert eng.decode(frame) == data and eng.stats.parallel
        ctx = eng._pool._mp_context
        assert isinstance(ctx, type(multiprocessing.get_context("spawn")))
        assert ctx.get_start_method() == "spawn"
    finally:
        eng.close()


def test_refusals_and_keyword_mapping():
    for kw in (dict(mesh=object()), dict(shard_axes=("data",))):
        with pytest.raises(NotImplementedError, match="A8"):
            LZ4DecodeEngine(device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="A8"):
            compat.decode_engine_config(**kw)
    with pytest.raises(NotImplementedError, match="A6"):
        LZ4DecodeEngine(device="cpu", on_error="salvage")
    with pytest.raises(NotImplementedError, match="A6"):
        compat.decode_engine_config(on_error="salvage")
    with pytest.raises(NotImplementedError, match="A6"):
        LZ4DecodeEngine(device="cpu").salvage(frames()["tiny"][0])
    with pytest.raises(NotImplementedError, match="A6"):
        FrameReader(frames()["tiny"][0], engine=LZ4DecodeEngine(device="cpu"),
                    on_error="salvage")
    with pytest.raises(ValueError, match="plan_on_device"):
        LZ4DecodeEngine(device="cpu", executor="serial", plan_on_device=True)
    for bad in (dict(executor="gpu"), dict(micro_batch=0), dict(workers=0),
                dict(on_error="ignore")):
        with pytest.raises(ValueError):
            LZ4DecodeEngine(device="cpu", **bad)
    assert compat.decode_engine_config(
        use_pallas=True, mesh=None, shard_axes=None, on_error="raise",
        micro_batch=4, plan_on_device=True) == dict(
        on_error="raise", micro_batch=4, plan_on_device=True)
    assert set(DecodeStats().as_dict()) == set(
        JaxDecodeEngine().stats.as_dict())


@pytest.mark.parametrize("config", ["serial", "device", "device_plan_on_device"])
def test_telemetry_spans_and_counters_equal_reference(config):
    from repro import obs as jobs
    from repro_torch import obs as tobs

    cfg = dict(CONFIGS[config], telemetry=True)
    port, ref = engines(**cfg)
    frame, data = frames()["v5"]
    names = []
    for obs, eng in ((tobs, port), (jobs, ref)):
        obs.reset()
        assert eng.decode(frame) == data
        eng.decode_to_device(frame)
        spans = {r["name"] for r in obs.tracer().finished()}
        counters = {k for k in str(obs.snapshot()["metrics"]).split("'")
                    if k.startswith("decode.")}
        names.append((spans, counters))
        obs.reset()
    assert names[0] == names[1]
    assert {"decode.total", "decode.verify"} <= names[0][0]
