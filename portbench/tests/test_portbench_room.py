"""Room for a cell with a driver and a per-layer metric of its own, added as
new files and new or appended entries only: on a copy of `portbench/`, a
driver that makes its own inputs from the seed (its traffic's
``object_bytes`` is 0, an empty object), a per-layer reader with its fixture
file and a cell pass the three checks of `checks.py`, and no file that was
there changes.  The checks keep their teeth: a cell whose driver file is
missing fails the first, a per-layer entry with no fixture the second."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import harness  # noqa: E402
from portbench.tests import checks  # noqa: E402
from portbench.tests.test_portbench_metrics import EXPECTED  # noqa: E402

BENCH = harness.load_json(ROOT.parent / "BENCHMARK.json")
CELL = "paper.roundtrip.own"
METRIC = "total_ms_per_MiB.roundtrip"

DRIVER = '''
"""Compress calls of bytes the driver makes from the seed."""
import numpy as np

from portbench.objects import rng_of
from portbench.reference import lz4_paper as ref

LIMITS = {"decode_errors": 0}


class Driver:
    def __init__(self, config, traffic, obj, device, telemetry, control=False, seed=0):
        from repro_torch import LZ4Engine

        assert obj == b""
        self.data = rng_of(seed, 9).integers(
            0, 4, traffic["own_bytes"], dtype=np.uint8).tobytes()
        self.engine = LZ4Engine(hash_bits=config["hash_bits"], pws=config["pws"],
                                max_match=config["max_match"], micro_batch=2,
                                telemetry=telemetry, device=device)

    def call(self):
        frame = self.engine.compress(self.data)
        return len(self.data), len(frame), frame

    def counters(self):
        return {}

    def free(self):
        self.engine = None

    def check(self, frames, seed):
        return {"decode_errors": sum(
            ref.decode_errors(f, ref.read_frame(f), self.data) for f in frames)}
'''

READER = '''
MIB = 1 << 20


def read(ctx):
    spans = ctx["spans"]
    if "compress.total" not in spans or not ctx["span_bytes_in"]:
        return None
    return spans["compress.total"]["seconds"] * 1e3 / (ctx["span_bytes_in"] / MIB)
'''


def add_cell(root: Path, with_driver: bool = True, with_fixture: bool = True) -> dict:
    """New files and entries for CELL under ``root``; the BENCHMARK.json."""
    (root / "traffic" / "roundtrip.own.json").write_text(json.dumps(
        {"driver": "roundtrip", "object_bytes": 0, "own_bytes": 2 * 65536}))
    if with_driver:
        (root / "drivers" / "roundtrip.py").write_text(DRIVER)
    (root / "metrics" / "per_layer" / f"{METRIC}.py").write_text(READER)
    if with_fixture:
        ctx = dict(spans={"compress.total": {"seconds": 0.5, "count": 1}},
                   span_bytes_in=4 << 20, span_bytes_out=1 << 20, profile=None,
                   peaks=None, counters={})
        (root / checks.FIXTURES / f"{METRIC}.json").write_text(
            json.dumps({"ctx": ctx, "value": 125.0}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": CELL, "config": "lz4-paper",
                               "traffic": "roundtrip.own", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "compress_GBps")["workloads"].append(CELL)
    bench["per_layer"].append({"name": METRIC, "unit": "ms/MiB", "better": "lower",
                               "source": "program_span", "layer": "host loop",
                               "moves": "compress_GBps", "workloads": [CELL]})
    return bench


@pytest.mark.parametrize("case", ["added", "driver_file_missing", "fixture_missing"])
def test_a_cell_with_its_own_driver_and_metric_is_added_as_new_files(tmp_path, case):
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = add_cell(root, with_driver=case != "driver_file_missing",
                     with_fixture=case != "fixture_missing")
    if case == "driver_file_missing":
        with pytest.raises(AssertionError, match="no driver file"):
            checks.check_cell_files(bench, CELL, root)
        return
    if case == "fixture_missing":
        with pytest.raises(AssertionError, match=METRIC):
            checks.check_fixtures(bench, root, EXPECTED)
        return
    cell = checks.check_cell_files(bench, CELL, root)
    assert cell.traffic["object_bytes"] == 0
    checks.check_fixtures(bench, root, EXPECTED)
    ctx, want = checks.fixture_files(root)[METRIC]
    assert harness.load_module(harness.metric_path(root, "per_layer", METRIC)).read(ctx) == want
    r = checks.check_traced_run(bench, CELL, root)
    assert set(r["metrics"]) == {METRIC}
    r = harness.run_cell(cell, 2**31 + 7, 0.0, False, device="cpu")
    assert r["correct"] and set(r["metrics"]) == {"compress_GBps", "setup_s"}
    assert r["compared"] == {"decode_errors": {"value": 0, "limit": 0}}
    assert all(before[p] == p.read_bytes() for p in before)
