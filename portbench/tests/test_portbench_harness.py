"""The harness on the CPU: cells found by name, a cell added as new files
only, the window's arithmetic on a fake clock, the output sample, the check
for modules the benchmark must not load, and `BENCHMARK.json`'s shape."""
import dataclasses
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import harness  # noqa: E402
from portbench.objects import rng_of  # noqa: E402
from portbench.tests import checks  # noqa: E402

BENCH = harness.load_json(ROOT.parent / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(workload):
    checks.check_cell_files(BENCH, workload, ROOT)


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT.parent / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter")
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[part]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_as_new_files_only_runs(tmp_path):
    """A later change adds a traffic mix, a metric of each kind and a cell as
    new files and new entries; no file that is there changes."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "compress.dummy.json").write_text(json.dumps(
        {"driver": "compress", "object_bytes": 2 * 65536, "replace_every": 64,
         "noise_block_every": 2, "blocks_per_dispatch": 2}))
    (root / "metrics" / "end_to_end" / "calls_per_s.py").write_text(
        "def read(window):\n    return window['calls'] / window['seconds']\n")
    (root / "metrics" / "per_layer" / "spans_seen.dummy.py").write_text(
        "def read(ctx):\n    return len(ctx['spans']) or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "paper.compress.dummy", "config": "lz4-paper",
                               "traffic": "compress.dummy", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["paper.compress.dummy"]})
    bench["per_layer"].append({"name": "spans_seen.dummy", "unit": "1", "better": "higher",
                               "source": "program_span", "layer": "host loop",
                               "moves": "calls_per_s", "workloads": ["paper.compress.dummy"]})
    cell = harness.resolve(bench, "paper.compress.dummy", root=root)
    assert cell.traffic["object_bytes"] == 2 * 65536
    assert [m["name"] for m, _ in cell.per_layer] == ["spans_seen.dummy"]
    r = harness.run_cell(cell, 7, 0.0, False, device="cpu")
    assert r["correct"], r
    assert set(r["metrics"]) == {"calls_per_s", "setup_s"}
    assert list(r)[-1] == "compared"
    assert all(before[p] == p.read_bytes() for p in before)


def test_a_split_metric_shares_the_reader_of_its_first_part(tmp_path):
    for name in ("idle_share", "device_roofline"):
        for part in ("compress", "decode"):
            path = harness.metric_path(ROOT, "per_layer", f"{name}.{part}")
            assert path == ROOT / "metrics" / "per_layer" / f"{name}.py"
    own = ROOT / "metrics" / "per_layer" / "host_loop_ms_per_MiB.decode.py"
    assert harness.metric_path(ROOT, "per_layer", "host_loop_ms_per_MiB.decode") == own
    (tmp_path / "metrics" / "per_layer").mkdir(parents=True)
    assert harness.metric_path(tmp_path, "per_layer", "absent") == \
        tmp_path / "metrics" / "per_layer" / "absent.py"


def test_host_threads_come_from_the_configuration():
    import torch

    before = torch.get_num_threads()
    cell = harness.resolve(BENCH, "paper.compress.bulk")
    for c in BENCH["configs"]:
        assert harness.load_json(ROOT.parent / c["file"])["host_threads"] == 1
    try:
        torch.set_num_threads(2)
        harness.run_cell(dataclasses.replace(cell, config=dict(cell.config, host_threads=0)),
                         7, 0.0, False, device="cpu", object_bytes=65536)
        assert torch.get_num_threads() == 2
        harness.run_cell(cell, 7, 0.0, False, device="cpu", object_bytes=65536)
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(before)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_closes_after_the_call_that_ends_past_its_length():
    clock = FakeClock()

    def call():
        clock.t += 3.0
        return 10, 5, None

    w = harness.run_window(call, 7.0, clock=clock)
    assert len(w.calls) == 3                   # ends at 3, 6, 9: the third closes it
    assert w.seconds == 9.0
    s = w.summary(setup_s=1.5)
    assert s == dict(seconds=9.0, calls=3, bytes_in=30, bytes_out=15, setup_s=1.5)
    rate = harness.load_module(ROOT / "metrics" / "end_to_end" / "compress_GBps.py")
    assert rate.read(s) == 30 / 9.0 / 1e9


def test_window_counts_a_failed_call_and_its_time():
    clock = FakeClock()
    n = [0]

    def call():
        clock.t += 2.0
        n[0] += 1
        if n[0] == 2:
            raise RuntimeError("planted")
        return 4, 4, None

    w = harness.run_window(call, 5.0, clock=clock)
    assert w.failed == 1 and len(w.calls) == 2 and w.seconds == 6.0
    assert w.summary(0.0)["calls"] == 3


def test_window_runs_at_least_min_calls():
    clock = FakeClock()

    def call():
        clock.t += 10.0
        return 1, 1, None

    assert len(harness.run_window(call, 1.0, clock=clock, min_calls=3).calls) == 3


def test_reservoir_keeps_a_seeded_sample_and_the_last():
    def picks(seed, n):
        r = harness.Reservoir(3, rng_of(seed, 1))
        for i in range(n):
            r(i, i)
        return r.outputs()

    assert picks(5, 2) == [0, 1]
    a = picks(5, 50)
    assert len(a) == 4 and a[-1] == 49 and a == sorted(set(a))
    assert a == picks(5, 50)
    assert any(picks(s, 50) != a for s in range(6, 12))


@pytest.mark.parametrize("modules,found", [
    ({"repro_torch": 0, "repro_torch.core": 0, "numpy": 0}, []),
    ({"repro.core.engine": 0, "torch": 0}, ["repro"]),
    ({"jax._src.api": 0, "jaxlib": 0, "flax.linen": 0}, ["flax", "jax", "jaxlib"]),
    ({"reprox": 0, "jax_like": 0}, []),
])
def test_forbidden_modules_compares_top_level_names_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_traced_run_reads_the_programs_spans():
    """A traced run on the CPU: the span metrics are read from the program's
    own spans; the device ones find no device and are left out."""
    checks.check_traced_run(BENCH, "paper.decode.bulk64", ROOT, object_bytes=2 * 65536)
