"""The resilience slice: `repro_torch.resilience` (retry, inject, salvage) and
the decode engine's salvage hooks, held against the JAX package's
`repro.resilience` on the same seeded inputs, tolerance zero.

Retry schedules, corruption bytes and `scan_frame` dicts are compared with
the reference's; the chaos matrix (seeds {0, 1, 2} x every executor, the
device executor on the CPU under both planners) compares `SalvageReport`s
field by field on the SAME corrupted frame, written by either package (the
two writers' frames are byte-identical, and that is checked first).  Then
the counters and spans, and the two places where the port could differ
from the reference without a test noticing: a failed block must leave the
device engine usable, and a kernel wrapper's refusal must reach the caller
instead of passing for damage.
"""
import dataclasses
import functools
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import LZ4DecodeEngine as JaxDecodeEngine
from repro.core import LZ4Engine as JaxEngine
from repro.core import scan_frame as jax_scan_frame
from repro.resilience import inject as jinject
from repro.resilience import retry as jretry
from repro_torch import (
    FrameError,
    FrameFormatError,
    FrameReader,
    LZ4DecodeEngine,
    LZ4Engine,
    SalvageReport,
    frame_info,
    scan_frame,
)
from repro_torch import obs as tobs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import frame as tframe
from repro_torch.core.decoder import LZ4FormatError
from repro_torch.kernels import ops as kops
from repro_torch.kernels._build import KernelRefusal
from repro_torch.resilience import inject, retry
from repro_torch.resilience.inject import (
    FaultInjector,
    InjectedCrash,
    corrupt_frame_block,
    crash_point,
    flip_bits,
    install,
    io_point,
    truncate,
)

from test_torch_util import chaos  # noqa: F401  (fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import trace_report  # noqa: E402

SEEDS = [0, 1, 2]
CONFIGS = {
    "serial": dict(executor="serial"),
    "thread": dict(executor="thread", workers=2),
    "process": dict(executor="process", workers=2),
    "device": dict(executor="device"),
    "device_plan_on_device": dict(executor="device", plan_on_device=True),
}
REPORT_FIELDS = ["data", "block_count", "ok", "reconstructed", "lost",
                 "holes", "errors", "notes", "content_crc_ok"]


def _payload() -> bytes:
    """The reference's chaos corpus: compressible text and noise, so the
    frame has LZ4 and raw-stored blocks (4 blocks, about 220 KB)."""
    rng = np.random.default_rng(20260809)
    return (b"salvage every undamaged block " * 5000
            + rng.integers(0, 256, 70000, np.uint8).tobytes())


def _cpu_engine(**kw) -> LZ4Engine:
    # The associative select writes the same frames as the sequential one
    # and is several times faster through the plain versions.
    return LZ4Engine(device="cpu", scan_impl="associative", **kw)


@functools.lru_cache(maxsize=None)
def frame_pair(parity_group: int | None) -> tuple[bytes, bytes]:
    """(port frame, reference frame) of `_payload()`; v6 with parity."""
    data = _payload()
    return (_cpu_engine(parity_group=parity_group).compress(data),
            JaxEngine(parity_group=parity_group).compress(data))


@pytest.fixture(scope="module")
def engines():
    """(port engine on the CPU, reference engine) per executor, shared by
    the module: one process pool per package."""
    out = {k: (LZ4DecodeEngine(device="cpu", **cfg), JaxDecodeEngine(**cfg))
           for k, cfg in CONFIGS.items()}
    yield out
    for port, ref in out.values():
        port.close()
        ref.close()


@pytest.fixture
def both_obs():
    """Telemetry on in both packages for one test, registries cleared."""
    was = (tobs.is_enabled(), jobs.is_enabled())
    for o in (tobs, jobs):
        o.configure(enabled=True)
        o.reset()
    yield
    for o, w in zip((tobs, jobs), was):
        o.reset()
        o.configure(enabled=w)


def assert_reports_equal(port, ref) -> None:
    assert isinstance(port, SalvageReport)
    assert [f.name for f in dataclasses.fields(port)] == REPORT_FIELDS
    for name in REPORT_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.complete == ref.complete


def corrupted(parity_group, index: int, seed: int, n: int = 3) -> bytes:
    """One block of the frame corrupted, the same bytes from either
    package's frame and `corrupt_frame_block`."""
    port_frame, jax_frame = frame_pair(parity_group)
    assert port_frame == jax_frame
    bad = corrupt_frame_block(port_frame, index, seed=seed, n=n)
    assert bad == jinject.corrupt_frame_block(jax_frame, index, seed=seed, n=n)
    return bad


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

class TestRetry:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_backoffs_equal_reference(self, seed):
        for kw in (dict(max_attempts=6, base_s=0.01, cap_s=0.5),
                   dict(max_attempts=4, base_s=0.02, cap_s=1.0, multiplier=2.0),
                   dict(max_attempts=9, base_s=0.0, cap_s=0.05)):
            got = list(retry.RetryPolicy(seed=seed, **kw).backoffs())
            assert got == list(jretry.RetryPolicy(seed=seed, **kw).backoffs())
            assert len(got) == kw["max_attempts"] - 1
            assert all(kw["base_s"] <= d <= kw["cap_s"] for d in got)

    @pytest.mark.parametrize("fails", [0, 2, 3, 5])
    def test_call_attempts_and_sleeps_equal_reference(self, fails):
        """Attempts, sleeps and `on_retry` calls of the same flaky function
        under both packages' loops; the budget (4 attempts) is the same."""
        runs = []
        for mod in (retry, jretry):
            calls, sleeps, seen = [], [], []

            def flaky():
                calls.append(1)
                if len(calls) <= fails:
                    raise OSError(f"transient {len(calls)}")
                return "ok"
            try:
                out = mod.call(flaky, policy=mod.RetryPolicy(max_attempts=4, seed=0),
                               sleep=sleeps.append,
                               on_retry=lambda n, e, d: seen.append((n, str(e), d)))
            except OSError as e:
                out = f"raised {e}"
            runs.append((out, len(calls), sleeps, seen))
        assert runs[0] == runs[1]
        assert runs[0][0] == ("ok" if fails < 4 else "raised transient 4")

    def test_deadline_non_transient_and_decorator(self):
        for mod in (retry, jretry):
            clock = iter([0.0, 100.0]).__next__
            calls = []

            def doomed():
                calls.append(1)
                raise OSError("x")
            with pytest.raises(OSError):
                mod.call(doomed, policy=mod.RetryPolicy(max_attempts=10, deadline_s=1.0,
                                                        seed=0),
                         sleep=lambda d: None, clock=clock)
            assert len(calls) == 1
            with pytest.raises(ValueError):
                mod.call(lambda: (_ for _ in ()).throw(ValueError("corrupt")),
                         policy=mod.RetryPolicy(seed=0), sleep=lambda d: None)
            state = {"n": 0}

            @mod.retrying(mod.RetryPolicy(max_attempts=3, seed=1), sleep=lambda d: None)
            def sometimes(x):
                state["n"] += 1
                if state["n"] == 1:
                    raise OSError("once")
                return x * 2
            assert sometimes(21) == 42 and state["n"] == 2
            for bad in (dict(max_attempts=0), dict(base_s=0.5, cap_s=0.1),
                        dict(multiplier=0.5)):
                with pytest.raises(ValueError):
                    mod.RetryPolicy(**bad)

    def test_restart_policy_equal_reference(self):
        seqs = []
        for mod in (retry, jretry):
            pol = mod.RestartPolicy(max_failures=3, backoff_s=0.5)
            seq = [pol.record_failure() for _ in range(3)]
            with pytest.raises(RuntimeError, match="giving up after 3 failures"):
                pol.record_failure()
            seqs.append(seq)
        assert seqs[0] == seqs[1] == [0.5, 1.0, 2.0]

    def test_retries_counted(self, both_obs):
        for mod, o in ((retry, tobs), (jretry, jobs)):
            state = {"n": 0}

            def flaky():
                state["n"] += 1
                if state["n"] < 3:
                    raise OSError("t")
            mod.call(flaky, policy=mod.RetryPolicy(seed=0), sleep=lambda d: None)
        t = tobs.snapshot()["metrics"]["counters"]
        assert t["resilience.retries"] == 2
        assert t == jobs.snapshot()["metrics"]["counters"]


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class TestInject:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_corruption_bytes_equal_reference(self, seed):
        data = bytes(range(256)) * 40
        assert flip_bits(data, seed, n=5) == jinject.flip_bits(data, seed, n=5)
        assert flip_bits(data, seed, 9, 100, 300) == \
            jinject.flip_bits(data, seed, 9, 100, 300)
        assert truncate(data, seed) == jinject.truncate(data, seed)
        assert truncate(data, seed, min_keep=77) == jinject.truncate(data, seed, min_keep=77)
        port_frame, jax_frame = frame_pair(4)
        for i in range(frame_info(port_frame)["block_count"]):
            assert inject.frame_payload_region(port_frame, i) == \
                jinject.frame_payload_region(jax_frame, i)
            assert corrupt_frame_block(port_frame, i, seed, n=3) == \
                jinject.corrupt_frame_block(jax_frame, i, seed, n=3)
        # Instance-seeded wrappers draw the same seeds in the same order.
        a, b = FaultInjector(seed=seed), jinject.FaultInjector(seed=seed)
        assert a.flip_bits(data, n=4) == b.flip_bits(data, n=4)
        assert a.truncate(data) == b.truncate(data)
        assert a.corrupt_frame_block(port_frame, 1, n=2) == \
            b.corrupt_frame_block(jax_frame, 1, n=2)
        diff = sum(bin(x ^ y).count("1")
                   for x, y in zip(flip_bits(data, seed, n=5), data))
        assert diff == 5

    def test_crash_and_io_points(self):
        inj = FaultInjector(seed=0, crash_at="seam.x", fail={"op.read": 2})
        with install(inj):
            crash_point("seam.other")
            with pytest.raises(InjectedCrash, match="seam.x"):
                crash_point("seam.x")
            crash_point("seam.x")  # disarmed after firing
            for _ in range(2):
                with pytest.raises(OSError, match="injected transient"):
                    io_point("op.read")
            io_point("op.read")
            with pytest.raises(RuntimeError, match="already installed"):
                install(FaultInjector()).__enter__()
        assert inj.crashes == ["seam.x"]
        assert inj.io_faults == ["op.read", "op.read"]
        assert inject.active() is None
        crash_point("anything")  # unarmed: no-ops
        io_point("anything")
        with pytest.raises(ValueError, match="bad flip region"):
            flip_bits(b"\x00" * 100, seed=0, start=90, end=200)
        with pytest.raises(ValueError):
            truncate(b"x", seed=0)


# ---------------------------------------------------------------------------
# error hierarchy and scan_frame
# ---------------------------------------------------------------------------

def test_error_hierarchy_and_pickling():
    assert issubclass(FrameFormatError, LZ4FormatError)
    assert issubclass(LZ4FormatError, FrameError)
    assert issubclass(LZ4FormatError, ValueError)
    assert issubclass(ckpt.CheckpointError, FrameError)
    assert issubclass(ckpt.CheckpointError, RuntimeError)
    assert not issubclass(KernelRefusal, FrameError)
    e = FrameFormatError("block 3: checksum mismatch", block_index=3, cause="crc")
    e2 = pickle.loads(pickle.dumps(e))
    assert type(e2) is FrameFormatError and str(e2) == str(e)
    assert (e2.block_index, e2.cause) == (3, "crc")


def _scan_cases() -> dict[str, bytes]:
    v3, _ = frame_pair(None)
    v6, _ = frame_pair(4)
    info = frame_info(v3)
    lying = bytearray(v3)
    # block 1's table entry claims usize > MAX_BLOCK (byte 2 of its u32 usize)
    entries = tframe._HEADER.size + tframe._CONTENT_SIZE.size
    lying[entries + tframe._ENTRY_V2.size + 2] = 0xFF
    return {
        "intact_v6": v6,
        "mid_payload": v3[: info["blocks"][2]["offset"] + 10],
        "mid_table": v3[:30],
        "lying_entry": bytes(lying),
        "v6_no_trailer": v6[:-3],
        "v6_parity_cut": v6[: frame_info(v6)["parity"][0]["offset"] + 5],
    }


@pytest.mark.parametrize("case", ["intact_v6", "mid_payload", "mid_table",
                                  "lying_entry", "v6_no_trailer", "v6_parity_cut"])
def test_scan_frame_equal_reference(case):
    frame = _scan_cases()[case]
    got = scan_frame(frame)
    assert got == jax_scan_frame(frame)
    assert got["complete"] == (case == "intact_v6")


def test_scan_frame_unsalvageable_messages():
    frame, _ = frame_pair(None)
    for bad in (b"nope", b"XXXX" + frame[4:]):
        with pytest.raises(FrameFormatError) as et:
            scan_frame(bad)
        with pytest.raises(Exception) as ej:
            jax_scan_frame(bad)
        assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the seeded chaos matrix
# ---------------------------------------------------------------------------

class TestSalvageMatrix:
    @pytest.mark.parametrize("executor", list(CONFIGS))
    @pytest.mark.parametrize("seed", SEEDS)
    def test_parity_reconstructs_single_damage(self, engines, executor, seed):
        data = _payload()
        n = frame_info(frame_pair(4)[0])["block_count"]
        victim = seed % n
        bad = corrupted(4, victim, seed)
        port, ref = engines[executor]
        rep = port.salvage(bad)
        assert_reports_equal(rep, ref.salvage(bad))
        assert rep.complete and rep.lost == [] and rep.holes == []
        assert rep.reconstructed == [victim]
        assert rep.data == data and rep.content_crc_ok is True
        assert "reconstructed from parity" in rep.errors[victim]

    @pytest.mark.parametrize("executor", list(CONFIGS))
    @pytest.mark.parametrize("seed", SEEDS)
    def test_salvage_recovers_every_undamaged_block(self, engines, executor, seed):
        data = _payload()
        info = frame_info(frame_pair(None)[0])
        n = info["block_count"]
        victim = seed % n
        bad = corrupted(None, victim, seed)
        port, ref = engines[executor]
        rep = port.salvage(bad)
        assert_reports_equal(rep, ref.salvage(bad))
        assert rep.lost == [victim] and rep.reconstructed == []
        assert rep.ok == [i for i in range(n) if i != victim]
        start = sum(b["usize"] for b in info["blocks"][:victim])
        span = info["blocks"][victim]["usize"]
        assert rep.holes == [(start, start + span)]
        assert rep.data[start: start + span] == b"\x00" * span
        assert rep.data[:start] == data[:start]
        assert rep.data[start + span:] == data[start + span:]

    @pytest.mark.parametrize("executor", list(CONFIGS))
    def test_truncated_frame_salvages_prefix(self, engines, executor):
        data = _payload()
        frame, _ = frame_pair(None)
        info = frame_info(frame)
        cut = info["blocks"][2]["offset"] + 10
        port, ref = engines[executor]
        rep = port.salvage(frame[:cut])
        assert_reports_equal(rep, ref.salvage(frame[:cut]))
        two = sum(b["usize"] for b in info["blocks"][:2])
        assert rep.ok == [0, 1] and rep.holes == [(two, len(data))]
        assert rep.data == data[:two] + b"\x00" * (len(data) - two)

    @pytest.mark.parametrize("executor", ["serial", "device", "device_plan_on_device"])
    def test_two_damaged_and_damaged_parity(self, engines, executor):
        port, ref = engines[executor]
        two = corrupt_frame_block(corrupted(4, 0, 0), 1, seed=1, n=3)
        rep = port.salvage(two)
        assert_reports_equal(rep, ref.salvage(two))
        assert rep.lost == [0, 1] and rep.reconstructed == []
        assert "damaged" in rep.errors[0]
        p = frame_info(frame_pair(4)[0])["parity"][0]
        bad = flip_bits(corrupted(4, 0, 0), seed=2, n=3, start=p["offset"],
                        end=p["offset"] + p["plen"])
        rep = port.salvage(bad)
        assert_reports_equal(rep, ref.salvage(bad))
        assert rep.lost == [0] and "failed its CRC" in rep.errors[0]

    def test_counters_pinned(self, engines, both_obs):
        """The exact counts the reference's chaos leg pins, in both."""
        n = frame_info(frame_pair(None)[0])["block_count"]
        bad_v6, bad_v3 = corrupted(4, 1, 0), corrupted(None, 1, 0)
        for port_or_ref in (0, 1):
            eng = engines["serial"][port_or_ref]
            eng.salvage(bad_v6)
            eng.salvage(bad_v3)
        counters = []
        for o in (tobs, jobs):
            c = o.snapshot()["metrics"]["counters"]
            counters.append({k: v for k, v in c.items() if k.startswith("resilience.")})
        assert counters[0] == counters[1] == {
            "resilience.salvage_calls": 2, "resilience.reconstructed_blocks": 1,
            "resilience.lost_blocks": 1, "resilience.salvaged_blocks": 2 * (n - 1)}

    def test_salvage_spans_and_trace_report(self, engines, both_obs, tmp_path, capsys):
        bad = corrupted(4, 2, 1)
        names = []
        for j, o in enumerate((tobs, jobs)):
            engines["device"][j].salvage(bad)
            names.append({r["name"] for r in o.tracer().finished()})
        assert names[0] == names[1]
        assert {"salvage.total", "salvage.decode", "salvage.reconstruct"} <= names[0]
        bundle = str(tmp_path / "bundle")
        tobs.dump_artifacts(bundle)
        assert trace_report.main([bundle, "--check"]) == 0
        assert "schema-valid" in capsys.readouterr().out
        assert trace_report.main([bundle]) == 0
        table = capsys.readouterr().out
        for stage in ("salvage.total", "salvage.decode", "salvage.reconstruct",
                      "resilience.salvage_calls"):
            assert stage in table

    def test_decode_engine_on_error_salvage(self):
        data = _payload()
        bad = corrupted(4, 2, 0)
        with pytest.raises(FrameFormatError):
            LZ4DecodeEngine(device="cpu").decode(bad)
        eng = LZ4DecodeEngine(device="cpu", on_error="salvage")
        jeng = JaxDecodeEngine(on_error="salvage")
        assert eng.decode(bad) == jeng.decode(bad) == data
        assert eng.last_salvage is not None and eng.last_salvage.reconstructed == [2]
        assert_reports_equal(eng.last_salvage, jeng.last_salvage)
        intact, _ = frame_pair(None)
        eng.last_salvage = None
        assert eng.decode(intact) == data and eng.last_salvage is None
        with pytest.raises(ValueError, match="on_error"):
            LZ4DecodeEngine(device="cpu", on_error="ignore")

    def test_frame_reader_salvage(self):
        data = _payload()
        frame, _ = frame_pair(None)
        info = frame_info(frame)
        eng = LZ4DecodeEngine(device="cpu")
        rep = FrameReader(corrupted(None, 2, 0), engine=eng).salvage()
        assert isinstance(rep, SalvageReport) and rep.lost == [2]
        cut = info["blocks"][2]["offset"] + 10
        rdr = FrameReader(frame[:cut], engine=eng, on_error="salvage")
        assert rdr.block_count == info["block_count"]
        assert rdr.read_range(100, 50) == data[100:150]
        dev = rdr.read_range_device(70000, 1000)
        assert dev.numpy().tobytes() == data[70000:71000]
        with pytest.raises(FrameFormatError):
            rdr.read_block(2)
        with pytest.raises(FrameFormatError):
            FrameReader(frame[:cut], engine=eng)


# ---------------------------------------------------------------------------
# where the port could differ from the reference unnoticed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan_on_device", [False, True])
def test_failed_block_leaves_device_engine_usable(plan_on_device):
    """A block that fails inside a device dispatch (micro-batch 1, so the
    next block's dispatch is in flight when it fails) leaves nothing behind
    that a later call reads: salvage gets every later block exact, and the
    same engine then decodes the intact frame exactly, with the stats of a
    fresh engine."""
    data = _payload()
    frame, _ = frame_pair(None)
    n = frame_info(frame)["block_count"]
    eng = LZ4DecodeEngine(device="cpu", micro_batch=1, plan_on_device=plan_on_device)
    for k in range(n - 1):
        bad = corrupted(None, k, seed=k)
        with pytest.raises(FrameFormatError):
            eng.decode(bad)
        with pytest.raises(FrameFormatError):
            eng.decode_to_device(bad)
        rep = eng.salvage(bad)
        assert rep.lost == [k] and rep.ok == [i for i in range(n) if i != k]
        end = sum(frame_info(frame)["blocks"][i]["usize"] for i in range(k + 1))
        assert rep.data[end:] == data[end:]
        assert eng.decode(frame) == data
        fresh = LZ4DecodeEngine(device="cpu", micro_batch=1,
                                plan_on_device=plan_on_device)
        assert fresh.decode(frame) == data
        assert eng.stats.as_dict() == fresh.stats.as_dict()
        assert eng.decode_to_device(frame).numpy().tobytes() == data
        assert eng.stats.host_bytes == 0


def _refusing_decode_wave(monkeypatch):
    """Make the `decode_wave` wrapper refuse: the engine calls the real
    wrapper with a `total` one row too long, which it rejects as a shape it
    does not take (`KernelRefusal`), on the CPU as on the card."""
    real = kops.decode_wave

    def refuse(blocks, lit_blk, ptr, total, rounds):
        return real(blocks, lit_blk, ptr, torch.cat([total, total[:1]]), rounds)
    monkeypatch.setattr(kops, "decode_wave", refuse)


def test_kernel_refusal_reaches_caller(monkeypatch, tmp_path, both_obs):
    """A wrapper's refusal is never damage: `restore_with_fallback` does not
    step back past it (it is a ValueError, which the fallback walk treats as
    a bad step), salvage does not count it as a damaged block, and
    `restore(on_error="salvage")` does not zero-fill it."""
    eng = _cpu_engine()
    dec = LZ4DecodeEngine(device="cpu")
    tree = {"w": torch.zeros(20000), "b": torch.arange(300, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 1, tree, engine=eng)
    ckpt.save(str(tmp_path), 2, tree, engine=eng)
    like = {k: torch.empty_like(v) for k, v in tree.items()}
    got, step = ckpt.restore_with_fallback(str(tmp_path), like, decode_engine=dec)
    assert step == 2 and torch.equal(got["w"], tree["w"])
    _refusing_decode_wave(monkeypatch)
    with pytest.raises(KernelRefusal):
        ckpt.restore_with_fallback(str(tmp_path), like, decode_engine=dec)
    assert "checkpoint.fallback_steps" not in tobs.snapshot()["metrics"]["counters"]
    with pytest.raises(KernelRefusal):
        ckpt.restore(str(tmp_path), 2, like, decode_engine=dec, on_error="salvage",
                     report={})
    with pytest.raises(KernelRefusal):
        dec.salvage(frame_pair(None)[0])
