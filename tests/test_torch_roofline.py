"""The port's roofline rows (`repro_torch.launch.roofline`), report
(`launch.report`) and hill-climb (`launch.hillclimb`) against the JAX
package on the CPU.

The reference's `launch.roofline` and `launch.report` run in ONE subprocess
for this module, with its `PEAK_FLOPS`, `HBM_BW` and `LINK_BW` set to the
port's H100 rates, over synthetic dry-run records that carry every term
(FLOPs, bytes, dot bytes, collective bytes by op, compile seconds, XLA temp
bytes) and hit each branch of `suggest`; the port reads the same records and
must give the same rows and text, tolerance zero.  Records the port itself
writes lack the collectives and compiler terms: their rows hold None and
their tables an em dash there, never 0.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per test worker)
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.distributed.sharding import make_mesh, use_mesh
from repro_torch.launch import dryrun, hillclimb, report, roofline

ROOT = Path(__file__).resolve().parent.parent


def _lm(arch, shape, flops, nbytes, dot, coll, coll_by_op, mesh="16x16", **extra):
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256 if mesh == "16x16" else 512,
            "mode": "train", "compile_s": 12.25, "param_bytes": 3_400_000_000,
            "memory": {"temp_size_in_bytes": 7_500_000_000, "argument_size_in_bytes": 10 ** 8},
            "collectives": {op: {"count": 3, "bytes": b} for op, b in coll_by_op.items()},
            "probe": {"total": {"flops": flops, "bytes": nbytes, "dot_bytes": dot,
                                "coll_bytes": coll}, "coll_by_op": coll_by_op}, **extra}


# file name -> record; each carries every term.  Chosen so that the rows
# cover compute (near roofline and wasteful), memory and collective
# dominance (with and without a collective breakdown) and the lz4 cell.
RECORDS = {
    "internlm2-1.8b__train_4k__single": _lm(
        "internlm2-1.8b", "train_4k", 6.1e13, 9.0e10, 2.0e10, 1.0e10, {"all-reduce": 1.0e10}),
    "qwen3-1.7b__train_4k__single": _lm(
        "qwen3-1.7b", "train_4k", 1.0e15, 1.0e12, 1.0e11, 1.0e11,
        {"all-gather": 6.0e10, "reduce-scatter": 4.0e10}),
    "gemma2-9b__decode_32k__single": _lm(
        "gemma2-9b", "decode_32k", 1.0e12, 1.0e12, 3.0e11, 1.0e9, {"all-reduce": 1.0e9}),
    "mixtral-8x7b__prefill_32k__single": _lm(
        "mixtral-8x7b", "prefill_32k", 1.0e14, 2.0e11, 5.0e10, 1.0e12,
        {"all-gather": 6.0e11, "all-to-all": 4.0e11}),
    "whisper-small__prefill_32k__single": _lm(
        "whisper-small", "prefill_32k", 1.0e12, 1.0e11, 1.0e10, 5.0e11, {}),
    "qwen3-1.7b__train_4k__single_opt": _lm(
        "qwen3-1.7b", "train_4k", 6.0e13, 4.0e11, 9.0e10, 0.0, {}),
    "gemma2-9b__decode_32k__single_opt": _lm(
        "gemma2-9b", "decode_32k", 1.0e12, 6.0e11, 3.0e11, 1.0e8, {"all-reduce": 1.0e8}),
    "internlm2-1.8b__train_4k__multi": _lm(
        "internlm2-1.8b", "train_4k", 3.0e13, 5.0e10, 1.0e10, 2.0e10,
        {"all-reduce": 2.0e10}, mesh="2x16x16"),
    "lz4-engine__blocks8192_associative__single": {
        "arch": "lz4-engine", "shape": "blocks8192_associative", "mesh": "16x16",
        "chips": 256, "mode": "compress", "compile_s": 3.5, "bytes_per_step": 8192 * 65536,
        "param_bytes": 0,
        "memory": {"temp_size_in_bytes": 9_000_000},
        "collectives": {},
        "probe": {"total": {"flops": 2.0e9, "bytes": 8.0e9, "coll_bytes": 0.0},
                  "coll_by_op": {}}},
}


def _write(directory: Path, records: dict) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    for name, rec in records.items():
        (directory / f"{name}.json").write_text(json.dumps(rec))


_REFERENCE = textwrap.dedent("""
    import json, os, sys
    from repro.launch import report, roofline

    exp, rates = sys.argv[1], json.loads(sys.argv[2])
    for name, value in rates.items():
        setattr(roofline, name, value)
    roofline.DRYRUN_DIR = os.path.join(exp, "dryrun")
    report.EXP = exp
    rows = roofline.load_all()
    recs = {}
    for name in sorted(os.listdir(roofline.DRYRUN_DIR)):
        with open(os.path.join(roofline.DRYRUN_DIR, name)) as f:
            recs[name] = roofline.analyze_cell(json.load(f))
    print("RESULT:" + json.dumps({
        "rows": recs,
        "suggest": [roofline.suggest(r) for r in rows],
        "markdown": roofline.markdown_table(rows),
        "merged": roofline.merged_table(),
        "dryrun_table": report.dryrun_table(),
        "skipped": report.skipped_cells(),
        "roofline_table": report.roofline_table(),
    }))
""")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The synthetic records, written where each package reads them, and
    the reference's rows and tables over them."""
    exp = tmp_path_factory.mktemp("roofline_exp")
    _write(exp / "dryrun", RECORDS)
    _write(exp / "torch_dryrun", RECORDS)
    rates = {"PEAK_FLOPS": roofline.PEAK_FLOPS, "HBM_BW": roofline.HBM_BW,
             "LINK_BW": roofline.LINK_BW}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(exp), json.dumps(rates)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")][0]
    return exp, json.loads(line[len("RESULT:"):])


@pytest.fixture
def port_dirs(synthetic, monkeypatch):
    exp, _ = synthetic
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(exp / "torch_dryrun"))
    monkeypatch.setattr(report, "EXP", str(exp))
    return exp


@pytest.mark.parametrize("name", sorted(f"{k}.json" for k in RECORDS))
def test_analyze_cell_equals_reference(synthetic, name):
    exp, ref = synthetic
    with open(exp / "torch_dryrun" / name) as f:
        row = roofline.analyze_cell(json.load(f))
    assert json.loads(json.dumps(row)) == ref["rows"][name]


def test_tables_equal_reference(synthetic, port_dirs):
    _, ref = synthetic
    rows = roofline.load_all()
    assert [roofline.suggest(r) for r in rows] == ref["suggest"]
    assert len(set(ref["suggest"])) == 5   # every branch of suggest
    assert roofline.markdown_table(rows) == ref["markdown"]
    assert roofline.merged_table() == ref["merged"]
    assert report.dryrun_table() == ref["dryrun_table"]
    assert report.skipped_cells() == ref["skipped"]
    assert report.roofline_table() == ref["roofline_table"]


# -- records of the port itself: absent terms ---------------------------------------

def _port_record(arch="qwen3-1.7b", shape="train_4k", flops=6.0e13, nbytes=9.0e11):
    """A record as `launch.dryrun.run_cell` writes it (no collectives, no
    compiler terms)."""
    tot = {"flops": flops, "bytes": nbytes, "dot_bytes": 1.3e11}
    return {"arch": arch, "shape": shape, "mesh": "16x16", "optimized": False, "chips": 256,
            "mode": "train", "time": 0.5, "param_bytes": 6_882_299_904,
            "opt_bytes": 13_764_599_808,
            "memory": {"argument_size_in_bytes": 164_970_500, "alias_size_in_bytes": 164_708_356},
            "lower_s": 10.1, "cost": {"flops": flops, "bytes accessed": nbytes},
            "probe": {"total": tot, "global": {k: v * 256 for k, v in tot.items()},
                      "seq_lens": [4096]}}


def test_rows_of_port_records_hold_none_for_absent_terms(tmp_path, monkeypatch):
    rows = {
        "mem": roofline.analyze_cell(_port_record()),
        "comp": roofline.analyze_cell(_port_record(flops=1e15, nbytes=1e11)),
    }
    for row in rows.values():
        assert row["collective_s"] is None and row["memory_fused_s"] is None
        assert row["roofline_fraction_fused"] is None and row["coll_by_op"] is None
        assert row["roofline_fraction"] > 0
    assert rows["mem"]["dominant"] == "memory" and rows["comp"]["dominant"] == "compute"
    assert rows["mem"]["memory_s"] == 9.0e11 / roofline.HBM_BW
    table = roofline.markdown_table(list(rows.values()))
    assert table.splitlines()[2].split(" | ")[4] == "—"    # collective (ms)
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path / "torch_dryrun"))
    monkeypatch.setattr(report, "EXP", str(tmp_path))
    _write(tmp_path / "torch_dryrun", {"qwen3-1.7b__train_4k__single": _port_record()})
    line = report.dryrun_table().splitlines()[2]
    assert line == "| qwen3-1.7b | train_4k | 16x16 | — | 6.88 | — | — | — |"
    merged = roofline.merged_table().splitlines()[2]
    assert merged.endswith("→— | —→— |")
    # main writes the rows next to the records and prints
    roofline.main([])
    with open(tmp_path / "torch_roofline.json") as f:
        assert json.load(f)[0]["collective_s"] is None


def test_report_only_prints(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path / "torch_dryrun"))
    monkeypatch.setattr(report, "EXP", str(tmp_path))
    _write(tmp_path / "torch_dryrun", {"qwen3-1.7b__train_4k__single": _port_record()})
    assert report.bench_summary() == ""
    before = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*"))
    report.main([])
    out = capsys.readouterr().out
    assert "## Dry-run cells" in out and "## Roofline" in out and "qwen3-1.7b" in out
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == before
    (tmp_path / "benchmarks").mkdir()
    (tmp_path / "benchmarks" / "torch_table1.json").write_text('{"rows": [1]}')
    (tmp_path / "benchmarks" / "table1.json").write_text('{"reference": true}')
    assert report.bench_summary() == '### torch_table1\n```json\n{\n "rows": [\n  1\n ]\n}\n```'


def test_hillclimb_measure_over_meta():
    """`hillclimb.measure` on a reduced config over a (2, 2) `meta` mesh:
    the dry run's counts per device, no collective term."""
    cfg = get_config("internlm2-1.8b").reduced()
    shape = ShapeConfig("train_4k", 64, 8, "train")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    with use_mesh(mesh):
        row = hillclimb.measure(cfg, shape, mesh, "baseline")
        tot, _ = dryrun.step_cost(cfg, shape)
    assert row["flops"] == tot["flops"] / 4 and row["bytes"] == tot["bytes"] / 4
    assert row["compute_s"] == row["flops"] / roofline.PEAK_FLOPS
    assert row["collective_s"] is None and row["coll_bytes"] is None
    assert row["memory_fused_s"] is None and row["roofline_fraction_fused"] is None
    assert row["useful_ratio"] == roofline.model_flops(cfg, shape, 4) / row["flops"]
    assert 0 < row["roofline_fraction"] < 1
    assert not torch.is_tensor(row["flops"])
