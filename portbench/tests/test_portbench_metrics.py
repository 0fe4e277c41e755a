"""Each metric reader on a recorded fixture of spans and a profile, and the
reading of a profiler trace, on the CPU."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import harness  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench.tests import checks  # noqa: E402

MIB = 1 << 20
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def span(seconds, count=1):
    return {"seconds": seconds, "count": count}


COMPRESS = dict(
    spans={"compress.total": span(3.0), "compress.dispatch": span(1.0, 128),
           "compress.wait": span(0.25, 128), "compress.drain": span(0.5, 4000),
           "compress.pad": span(0.2, 128), "compress.frame": span(0.1)},
    span_bytes_in=1024 * MIB, span_bytes_out=800 * MIB,
    profile=dict(busy_s=0.1, window_s=2.0, bytes_in=512 * MIB,
                 bytes_out=400 * MIB),
    peaks=PEAKS, counters={})
DECODE = dict(
    spans={"decode.total": span(2.0), "decode.plan_device": span(0.5, 64),
           "decode.verify": span(0.01)},
    span_bytes_in=400 * MIB, span_bytes_out=512 * MIB,
    profile=dict(busy_s=0.9, window_s=1.0, bytes_in=200 * MIB,
                 bytes_out=256 * MIB),
    peaks=PEAKS, counters={})

EXPECTED = {
    "host_loop_ms_per_MiB.compress": (COMPRESS, 1.75e3 / 1024),
    "dispatch_ms_per_MiB.compress": (COMPRESS, 1.0e3 / 1024),
    "drain_ms_per_MiB.compress": (COMPRESS, 0.5e3 / 1024),
    "device_roofline.compress": (COMPRESS, 100 * 912 * MIB / 3.35e12 / 0.1),
    "idle_share.compress": (COMPRESS, 95.0),
    "host_loop_ms_per_MiB.decode": (DECODE, 1.49e3 / 512),
    "plan_device_ms_per_MiB.decode": (DECODE, 0.5e3 / 512),
    "verify_ms_per_MiB.decode": (DECODE, 0.01e3 / 512),
    "device_roofline.decode": (DECODE, 100 * 456 * MIB / 3.35e12 / 0.9),
    "idle_share.decode": (DECODE, 10.0),
}
BENCH = harness.load_json(ROOT.parent / "BENCHMARK.json")
FIXTURES = {**EXPECTED, **checks.fixture_files(ROOT)}


def reader(kind, name):
    return harness.load_module(harness.metric_path(ROOT, kind, name))


def test_every_per_layer_metric_has_a_fixture():
    checks.check_fixtures(BENCH, ROOT, EXPECTED)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_per_layer_metric_reads_its_fixture(name):
    ctx, want = FIXTURES[name]
    assert reader("per_layer", name).read(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_per_layer_metric_reads_nothing_where_there_is_nothing(name):
    ctx, _ = FIXTURES[name]
    read = reader("per_layer", name).read
    assert read(dict(ctx, spans={}, profile=None)) is None
    if "roofline" in name:
        assert read(dict(ctx, peaks=None)) is None
    if name.startswith(("device_roofline", "idle_share")):
        assert read(dict(ctx, profile=dict(ctx["profile"], busy_s=0.0))) is None


def test_end_to_end_metrics():
    w = dict(seconds=10.0, calls=4, bytes_in=4 * 2**28, bytes_out=4 * 2**27,
             setup_s=12.5)
    assert reader("end_to_end", "compress_GBps").read(w) == 4 * 2**28 / 10 / 1e9
    assert reader("end_to_end", "decode_GBps").read(w) == 4 * 2**27 / 10 / 1e9
    assert reader("end_to_end", "ratio").read(w) == 2.0
    assert reader("end_to_end", "setup_s").read(w) == 12.5


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = [
    x("user_annotation", "portbench.profiled", 1000.0, 1000.0),
    x("cpu_op", "aten::copy_", 1000.0, 5.0),
    x("kernel", "void plan_kernel<(int)8>(...)", 1100.0, 200.0),
    x("kernel", "scatter", 1250.0, 100.0),          # overlaps the first
    x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1500.0, 100.0),
    x("kernel", "scatter", 1900.0, 300.0),          # runs past the mark
    x("kernel", "before", 500.0, 100.0),            # outside the mark
]
SPANS = [(1000.0, 1800.0, "decode.total"), (1050.0, 1120.0, "decode.plan_device"),
         (1610.0, 1700.0, "decode.verify")]


def test_trace_summary_busy_idle_and_ops():
    s = tr.summarize(TRACE, "portbench.profiled", SPANS)
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [1100, 1350] + [1500, 1600] + [1900, 2000] = 450 us
    assert s["busy_s"] == pytest.approx(450e-6)
    ops = dict(s["device_ops"])
    assert ops["scatter"] == pytest.approx(200e-6)
    assert ops["void_plan_kernel__int_8__..._"] == pytest.approx(200e-6)
    assert ops["Memcpy_HtoD__Pinned_-__Device_"] == pytest.approx(100e-6)
    gaps = dict(s["idle_gaps"])
    # idle: [1000,1100] mid 1050 -> plan_device; [1350,1500] -> total;
    # [1600,1900] mid 1750 -> total; nothing outside the spans
    assert gaps == pytest.approx({"decode.plan_device": 100e-6,
                                  "decode.total": 450e-6})
    assert s["busy_s"] + sum(gaps.values()) == pytest.approx(s["window_s"])


def test_trace_idle_outside_the_spans():
    s = tr.summarize(TRACE, "portbench.profiled", [])
    assert dict(s["idle_gaps"]) == pytest.approx({tr.OUTSIDE: 550e-6})


def test_trace_needs_its_mark():
    with pytest.raises(ValueError):
        tr.summarize(TRACE[1:], "portbench.profiled", SPANS)
