"""Three checks of the benchmark's files, each a function of a
`BENCHMARK.json` (``bench``) and a `portbench/` tree (``root``), so that the
tests apply them to the tree as committed and to a copy with a cell added as
new files only:

- `check_cell_files`: a cell finds its configuration, traffic, driver and
  metrics by name; any `drivers/<driver>.py` that exists, with a `Driver`
  and non-empty `LIMITS`, is a driver.
- `check_fixtures`: every per-layer metric has exactly one fixture, in the
  test's own table or in `tests/fixtures/per_layer/<name>.json`.
- `check_traced_run`: a traced run on the CPU reads each `program_span`
  metric of its cell, every value above 0, and no `device_trace` one.
"""
from __future__ import annotations

import json
from pathlib import Path

from portbench import harness

FIXTURES = Path("tests", "fixtures", "per_layer")


def check_cell_files(bench: dict, workload: str, root: Path) -> harness.Cell:
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    traffic = harness.load_json(root / "traffic" / f"{entry['traffic']}.json")
    driver = root / "drivers" / f"{traffic['driver']}.py"
    assert driver.is_file(), f"{workload}: no driver file {driver}"
    cell = harness.resolve(bench, workload, root)
    assert hasattr(cell.driver, "Driver") and cell.driver.LIMITS
    assert cell.config["name"] == entry["config"]
    names = [m["name"] for m, _ in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m, module in cell.end_to_end + cell.per_layer:
        assert callable(module.read), m["name"]
    return cell


def fixture_files(root: Path) -> dict:
    """name -> (ctx, value) of each fixture file under ``root``."""
    out = {}
    for path in sorted((root / FIXTURES).glob("*.json")):
        with open(path) as f:
            data = json.load(f)
        out[path.name[: -len(".json")]] = (data["ctx"], data["value"])
    return out


def check_fixtures(bench: dict, root: Path, inline: dict) -> None:
    """Each per-layer metric of ``bench`` has one fixture, in ``inline`` or
    in a file, and each fixture a metric."""
    have = sorted([*inline, *fixture_files(root)])
    want = sorted(m["name"] for m in bench["per_layer"])
    assert have == want, f"fixtures {have} for the per-layer metrics {want}"


def check_traced_run(bench: dict, workload: str, root: Path,
                     object_bytes: int | None = None) -> dict:
    cell = harness.resolve(bench, workload, root)
    r = harness.run_cell(cell, 5, 0.0, True, device="cpu", object_bytes=object_bytes)
    assert r["correct"] and r["attempted"] == 3          # profiled calls 1 and 2

    def named(source):
        return {m["name"] for m, _ in cell.per_layer if m["source"] == source}

    spans = named("program_span")
    assert spans, f"{workload} has no program_span metric"
    # A counter may read 0 and is not held here; device_trace finds no device.
    assert set(r["metrics"]) - named("program_counter") == spans
    assert all(r["metrics"][n]["value"] > 0 for n in spans)
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    return r
